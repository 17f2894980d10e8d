"""Execution modes for the Simultaneous Multi-mode Architecture (SMA).

The paper's central abstraction: one substrate, two *temporally* interleaved
execution modes.

* ``SYSTOLIC`` — GEMM-shaped work.  On the paper's GPU substrate this is the
  reconfigured 8x8 PE array driven by the ``LSMA`` instruction; on our TPU
  target it is the MXU (a literal 128x128 systolic array).
* ``SIMD`` — massively parallel but GEMM-incompatible work (softmax, top-k
  routing, gather/scatter, recurrences, NMS-like control flow).  On the GPU
  substrate these are the CUDA cores; on TPU, the VPU.

``classify_op`` encodes the paper's taxonomy (Sec. II-B): which ops belong to
which mode.  ``core.sma.SMAPolicy`` consumes this to plan temporal mode
switches and fusion groups.  (A copy of ``repro.core.modes``; on the port's
card systolic mode is the tensor cores' ``wgmma`` and SIMD mode the CUDA
cores.)
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Mapping, Sequence


class ExecMode(enum.Enum):
    """The two execution modes temporally integrated by SMA."""

    SYSTOLIC = "systolic"  # GEMM-compatible: runs on the systolic array / MXU
    SIMD = "simd"          # GEMM-incompatible: runs on SIMD lanes / VPU

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return self.value


class OpKind(enum.Enum):
    """Operator taxonomy used by the mode classifier.

    The left column of each comment names the paper's example; the right
    column the LM-framework op that plays the same role today.
    """

    MATMUL = "matmul"              # CONV/FC (img2col GEMM)   | qkv/o/ffn projections
    ATTENTION_MATMUL = "attn_mm"   #                          | q@k^T, p@v
    ELEMENTWISE = "elementwise"    # activation, bias         | gelu/silu, residual add
    REDUCTION = "reduction"        # softmax denom, argmax    | softmax, norms
    NORMALIZATION = "norm"         #                          | rmsnorm/layernorm
    GATHER_SCATTER = "gather"      # RoIAlign interpolation   | MoE dispatch/combine, embedding
    TOPK = "topk"                  # NMS / RegionProposal     | MoE router top-k, sampling
    RECURRENCE = "recurrence"      # CRF message passing      | RG-LRU, sLSTM/mLSTM state scan
    CONTROL_FLOW = "control_flow"  # NMS loops                | cache paging, request scheduling
    EMBED = "embed"                #                          | token embedding lookup
    CAST = "cast"                  # precision conversion     | bf16<->fp32 casts


#: Which mode each op kind natively belongs to.  This is the paper's Table of
#: "GEMM-compatible" vs not, extended with the LM-era ops.
MODE_OF: Mapping[OpKind, ExecMode] = {
    OpKind.MATMUL: ExecMode.SYSTOLIC,
    OpKind.ATTENTION_MATMUL: ExecMode.SYSTOLIC,
    OpKind.ELEMENTWISE: ExecMode.SIMD,
    OpKind.REDUCTION: ExecMode.SIMD,
    OpKind.NORMALIZATION: ExecMode.SIMD,
    OpKind.GATHER_SCATTER: ExecMode.SIMD,
    OpKind.TOPK: ExecMode.SIMD,
    OpKind.RECURRENCE: ExecMode.SIMD,
    OpKind.CONTROL_FLOW: ExecMode.SIMD,
    OpKind.EMBED: ExecMode.SIMD,
    OpKind.CAST: ExecMode.SIMD,
}

#: The port's static route table: the backend a kernel entry's site goes to,
#: by the device type of its tensors.  ``cuda`` is the hand-written kernels
#: (systolic mode: tensor-core GEMMs and their fused SIMD work); ``plain`` is
#: the plain PyTorch versions, for CPU tensors only.  There is no ladder and
#: no failover: a CUDA tensor launches its kernel or the wrapper raises
#: (``repro.core.modes.BACKEND_LADDER`` is the reference's ladder).
BACKEND_ROUTE: Mapping[str, str] = {"cuda": "cuda", "cpu": "plain"}


#: SIMD op kinds that may legally be fused into an adjacent systolic kernel as
#: a prologue/epilogue (they are pointwise or row-local over the GEMM output
#: tile, so they can run on the VPU while the tile is still resident in VMEM).
FUSABLE_INTO_SYSTOLIC = frozenset(
    {
        OpKind.ELEMENTWISE,
        OpKind.NORMALIZATION,
        OpKind.REDUCTION,
        OpKind.CAST,
    }
)


@dataclasses.dataclass(frozen=True)
class Op:
    """A symbolic operator in a layer plan (used by the SMA policy planner)."""

    name: str
    kind: OpKind
    flops: float = 0.0
    bytes_in: float = 0.0
    bytes_out: float = 0.0
    # Row-local epilogues depend only on their producer's output tile; ops that
    # mix information across tiles (e.g. full-softmax over an axis split across
    # tiles) must declare tile_local=False and will not be fused.
    tile_local: bool = True
    # Collective traffic this op moves when executing sharded on a mesh
    # (SUMMA broadcast bytes for mesh-routed GEMMs; 0 on a single device).
    # Costed alongside bytes_in/bytes_out so the planner sees comm and HBM
    # traffic in one ledger.
    comm_bytes: float = 0.0

    @property
    def mode(self) -> ExecMode:
        return MODE_OF[self.kind]


def classify_op(kind: OpKind) -> ExecMode:
    """Return the native execution mode for an op kind."""
    return MODE_OF[kind]


def mode_histogram(ops: Sequence[Op]) -> Mapping[ExecMode, float]:
    """FLOP-weighted share of each mode in a plan — the paper's Fig. 2 view."""
    totals = {ExecMode.SYSTOLIC: 0.0, ExecMode.SIMD: 0.0}
    for op in ops:
        totals[op.mode] += op.flops
    total = sum(totals.values()) or 1.0
    return {mode: value / total for mode, value in totals.items()}
