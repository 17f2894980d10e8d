"""Three-term roofline analysis (``repro.core.roofline``, kept as a copy).

The reference derives the terms structurally from a compiled XLA artifact:

    compute term    = HLO_FLOPs            / (chips x peak_FLOP/s)
    memory term     = HLO_bytes            / (chips x HBM_bw)
    collective term = collective_bytes     / (chips x link_bw)

``compiled.cost_analysis()`` supplies FLOPs and bytes.  Collective bytes are
*not* in cost_analysis: we parse the post-SPMD HLO text and sum operand sizes
of every all-gather / all-reduce / reduce-scatter / all-to-all /
collective-permute op.

Hardware constants: the reference's TPU v5e (197 bf16 TFLOP/s per chip,
819 GB/s HBM, ~50 GB/s per ICI link), and :data:`H100`, the port's card,
from NVIDIA's H100 SXM data sheet.  The collective parse reads HLO text and
stays text parsing: nothing in the port emits HLO yet, so it has no
producer until the distributed slice.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    name: str = "tpu-v5e"
    peak_flops: float = 197e12       # bf16 FLOP/s per chip
    hbm_bw: float = 819e9            # bytes/s per chip
    ici_bw: float = 50e9             # bytes/s per link
    hbm_bytes: float = 16e9          # capacity, for fit checks


V5E = HardwareSpec()

#: NVIDIA H100 SXM, **data-sheet figures, not a measurement**: 989 TFLOP/s
#: bf16 dense (no sparsity) at the 700 W power limit, 3.35 TB/s HBM3, 80 GB,
#: and NVLink 4 at 900 GB/s a GPU (18 links, both directions).  A card set
#: below 700 W runs slower under load.
H100 = HardwareSpec(name="h100-sxm", peak_flops=989e12, hbm_bw=3.35e12,
                    ici_bw=900e9, hbm_bytes=80e9)

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "f8e4m3fn": 1, "f8e5m2": 1, "f8e4m3": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8, "c128": 16,
}

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute")

# e.g. "bf16[256,4096,1024]{2,1,0}" or "f32[]"
_SHAPE_RE = re.compile(r"\b(" + "|".join(_DTYPE_BYTES) + r")\[([0-9,]*)\]")
# a collective instruction line: "%name = <result-type(s)> <op>(<operands>)"
_COLL_LINE_RE = re.compile(
    r"=\s+(\(?[^()=]*?)\s*(" + "|".join(COLLECTIVE_OPS)
    + r")(-start|-done)?\(")
# replica_groups={{0,1,..},{..}} (explicit) or [G,S]<=[...] (iota form)
_GROUPS_BRACE_RE = re.compile(r"replica_groups=\{\{([0-9, ]+)\}")
_GROUPS_IOTA_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")


def _shape_bytes(dtype: str, dims: str) -> float:
    n = 1
    if dims:
        for d in dims.split(","):
            n *= int(d)
    return float(n * _DTYPE_BYTES[dtype])


def _group_size(line: str) -> float:
    m = _GROUPS_IOTA_RE.search(line)
    if m:
        return float(m.group(2))  # [num_groups, group_size]
    m = _GROUPS_BRACE_RE.search(line)
    if m:
        return float(len(m.group(1).split(",")))
    return 1.0


def collective_bytes_from_hlo(hlo_text: str) -> Dict[str, float]:
    """Sum *operand* bytes of every collective in a (post-SPMD) HLO module.

    Post-optimization HLO prints operands as bare ``%names``, so operand size
    is derived from the **result type** (printed on the lhs) and the replica
    group size g:

      all-reduce / all-to-all / collective-permute : operand == result
      all-gather                                   : operand == result / g
      reduce-scatter                               : operand == result * g

    ``*-done`` halves of async pairs are skipped (counted at ``-start``).
    Sizes are per-device (the HLO is the per-device SPMD program).
    """
    per_op: Dict[str, float] = {op: 0.0 for op in COLLECTIVE_OPS}
    count = 0
    for line in hlo_text.splitlines():
        m = _COLL_LINE_RE.search(line)
        if not m:
            continue
        if m.group(3) == "-done":
            continue  # async completion: counted at -start
        op = m.group(2)
        result_bytes = sum(_shape_bytes(d, s)
                           for d, s in _SHAPE_RE.findall(m.group(1)))
        g = _group_size(line)
        if op == "all-gather":
            operand = result_bytes / max(g, 1.0)
        elif op == "reduce-scatter":
            operand = result_bytes * g
        else:
            operand = result_bytes
        per_op[op] += operand
        count += 1
    per_op["total"] = sum(v for k, v in per_op.items() if k in COLLECTIVE_OPS)
    per_op["count"] = float(count)
    return per_op


@dataclasses.dataclass
class RooflineTerms:
    """Per-step roofline terms, in seconds, for one (arch x shape x mesh)."""

    flops: float                  # HLO FLOPs, whole program
    hbm_bytes: float              # HLO bytes accessed, whole program
    collective_bytes: float       # summed collective operand bytes
    chips: int
    model_flops: float = 0.0      # 6*N*D (dense) / 6*N_active*D (MoE)
    hw: HardwareSpec = V5E
    collectives: Optional[Dict[str, float]] = None
    bytes_per_device: float = 0.0  # from memory_analysis

    @property
    def compute_s(self) -> float:
        return self.flops / (self.chips * self.hw.peak_flops)

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / (self.chips * self.hw.hbm_bw)

    @property
    def collective_s(self) -> float:
        return self.collective_bytes / (self.chips * self.hw.ici_bw)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        """Lower bound on step time: the slowest fully-overlapped resource."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / HLO_FLOPs: how much compiled compute is useful.

        Catches remat recompute and redundant-collective waste.  >1 is
        possible when XLA undercounts fused ops; <<1 flags remat overhead.
        """
        return self.model_flops / self.flops if self.flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Useful-compute share of the step-time bound.

        = MODEL_FLOPS / (chips x peak x bound_s).  1.0 means the step is
        MXU-saturated with zero waste; this is the §Perf score.
        """
        denom = self.chips * self.hw.peak_flops * self.bound_s
        return self.model_flops / denom if denom else 0.0

    def summary(self) -> Dict[str, float]:
        return {
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bound_s": self.bound_s,
            "dominant": self.dominant,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "collective_bytes": self.collective_bytes,
            "bytes_per_device": self.bytes_per_device,
        }


def from_compiled(cost: Dict[str, float], hlo_text: str, *, chips: int,
                  model_flops: float, bytes_per_device: float = 0.0,
                  hw: HardwareSpec = V5E) -> RooflineTerms:
    """Build roofline terms from ``compiled.cost_analysis()`` + HLO text."""
    coll = collective_bytes_from_hlo(hlo_text)
    return RooflineTerms(
        flops=float(cost.get("flops", 0.0)),
        hbm_bytes=float(cost.get("bytes accessed", 0.0)),
        collective_bytes=coll["total"],
        chips=chips,
        model_flops=model_flops,
        hw=hw,
        collectives=coll,
        bytes_per_device=bytes_per_device,
    )
