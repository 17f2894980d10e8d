"""Stage 3 -- fuse: feed the lowered program through the SMA policy planner
(``repro.compiler.fuse``).

This is where the paper's temporal-mode planning becomes the framework's
front-end: :class:`repro_torch.core.sma.SMAPolicy` walks the lowered ``Op``
sequence, anchors fusion groups on SYSTOLIC ops, attaches tile-local SIMD
epilogues, and coalesces the GEMM-incompatible remainder into SIMD groups.
:class:`ModelPlan` packages the result (groups + summary + lowering stats)
for the dispatcher and the report generator.  A coarsened loop's
``scan_carry`` marker is a ``RECURRENCE`` op, never tile-local, so it
closes the open group: nothing fuses across a loop boundary.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Union

from repro_torch.compiler.lower import LoweredProgram, LowerStats
from repro_torch.core.modes import ExecMode, Op, mode_histogram
from repro_torch.core.sma import FusionGroup, PlanSummary, SMAPolicy


@dataclasses.dataclass
class ModelPlan:
    """A planned program: the compiler's central artifact."""

    name: str
    ops: List[Op]
    groups: List[FusionGroup]
    summary: PlanSummary
    stats: LowerStats
    policy: SMAPolicy

    @property
    def systolic_groups(self) -> List[FusionGroup]:
        return [g for g in self.groups if g.mode == ExecMode.SYSTOLIC]

    @property
    def simd_groups(self) -> List[FusionGroup]:
        return [g for g in self.groups if g.mode == ExecMode.SIMD]

    @property
    def mode_timeline(self) -> List[ExecMode]:
        return [g.mode for g in self.groups]

    @property
    def mode_flop_histogram(self):
        return mode_histogram(self.ops)

    @property
    def total_flops(self) -> float:
        return sum(op.flops for op in self.ops)


def plan_program(program: Union[LoweredProgram, Sequence[Op]], *,
                 name: str = "model",
                 policy: Optional[SMAPolicy] = None) -> ModelPlan:
    """Plan a lowered program (or a bare op list) into fusion groups."""
    if isinstance(program, LoweredProgram):
        ops, stats = list(program.ops), program.stats
    else:
        ops, stats = list(program), LowerStats()
    policy = policy or SMAPolicy()
    groups = policy.plan(ops)
    summary = policy.summarize(ops)
    return ModelPlan(name=name, ops=ops, groups=groups, summary=summary,
                     stats=stats, policy=policy)
