"""The SMA execution policy (``repro.core.sma``): temporal mode planning
and fusion, and the named epilogues an SMA GEMM can fuse.

:class:`SMAPolicy` decides, over a symbolic op sequence, which ops run in
SYSTOLIC mode and which in SIMD mode, and groups adjacent ops into fusion
groups that run as one kernel with the intermediate kept on chip.  The
compiler (:mod:`repro_torch.compiler`) feeds it the ops it lowers from a
traced program.  The reference's deprecated runtime entry ``sma_matmul``
is not ported (``kernels.ops.sma_gemm`` is the entry).

The CUDA kernels apply :data:`EPILOGUES` to their f32 accumulators; the
codes they take are the positions in :data:`EPILOGUE_CODES`.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.core.modes import FUSABLE_INTO_SYSTOLIC, ExecMode, Op


@dataclasses.dataclass
class FusionGroup:
    """A maximal run of ops executed as one kernel (one mode 'residency')."""

    ops: List[Op]

    @property
    def anchor(self) -> Optional[Op]:
        """The systolic op the group is built around, if any."""
        for op in self.ops:
            if op.mode == ExecMode.SYSTOLIC:
                return op
        return None

    @property
    def mode(self) -> ExecMode:
        return ExecMode.SYSTOLIC if self.anchor is not None else ExecMode.SIMD

    @property
    def fused_simd_ops(self) -> int:
        return sum(1 for op in self.ops if op.mode == ExecMode.SIMD)

    @property
    def bytes_kept_in_vmem(self) -> float:
        """HBM traffic avoided by keeping intermediates resident (on chip:
        registers and shared memory on the card; the reference's name)."""
        if len(self.ops) <= 1:
            return 0.0
        # Each fused boundary avoids one write + one read of the intermediate.
        return sum(2.0 * op.bytes_in for op in self.ops[1:])


@dataclasses.dataclass
class PlanSummary:
    groups: int
    mode_switches: int
    fused_simd_ops: int
    hbm_bytes_avoided: float
    systolic_flop_share: float


class SMAPolicy:
    """Plans temporal mode assignment + fusion over a symbolic op sequence.

    Greedy planning rule (mirrors the paper's SIMD-systolic collaboration):

    * a SYSTOLIC op opens a new group (the GEMM anchor);
    * subsequent SIMD ops that are tile-local and fusable attach to the open
      group as epilogues, up to ``max_epilogue_ops``;
    * non-fusable SIMD ops (cross-tile reductions, gathers, recurrences,
      control flow) close the group and run in SIMD mode;
    * consecutive SIMD ops coalesce into one SIMD group (XLA fuses these).
    """

    def __init__(self, *, fuse_epilogues: bool = True,
                 max_epilogue_ops: int = 4) -> None:
        self.fuse_epilogues = fuse_epilogues
        self.max_epilogue_ops = max_epilogue_ops

    def plan(self, ops: Sequence[Op]) -> List[FusionGroup]:
        groups: List[FusionGroup] = []
        open_group: Optional[FusionGroup] = None
        epilogue_budget = 0
        for op in ops:
            if op.mode == ExecMode.SYSTOLIC:
                open_group = FusionGroup([op])
                groups.append(open_group)
                epilogue_budget = self.max_epilogue_ops
            elif (self.fuse_epilogues and open_group is not None
                  and open_group.anchor is not None
                  and op.kind in FUSABLE_INTO_SYSTOLIC
                  and op.tile_local and epilogue_budget > 0):
                open_group.ops.append(op)
                epilogue_budget -= 1
            else:
                # Pure-SIMD group; coalesce with a preceding SIMD group.
                if (groups and groups[-1].anchor is None):
                    groups[-1].ops.append(op)
                else:
                    groups.append(FusionGroup([op]))
                open_group = None
        return groups

    def summarize(self, ops: Sequence[Op]) -> PlanSummary:
        groups = self.plan(ops)
        switches = 0
        prev: Optional[ExecMode] = None
        for g in groups:
            if prev is not None and g.mode != prev:
                switches += 1
            prev = g.mode
        total_flops = sum(op.flops for op in ops) or 1.0
        systolic = sum(op.flops for op in ops if op.mode == ExecMode.SYSTOLIC)
        return PlanSummary(
            groups=len(groups),
            mode_switches=switches,
            fused_simd_ops=sum(g.fused_simd_ops for g in groups
                               if g.anchor is not None),
            hbm_bytes_avoided=sum(g.bytes_kept_in_vmem for g in groups),
            systolic_flop_share=systolic / total_flops,
        )



EPILOGUES: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "none": lambda x: x,
    "relu": torch.relu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "silu": lambda x: x * torch.sigmoid(x),
    "tanh": torch.tanh,
}

#: epilogue name -> integer code understood by ``csrc/gemm_tile.cuh``.
EPILOGUE_CODES: Dict[str, int] = {name: i for i, name in enumerate(EPILOGUES)}
