"""``repro_torch.compiler``: the front door's compiler on ``torch.fx``
(``repro.compiler``).

1. :mod:`trace`    -- ``make_fx`` over fake tensors on the call's devices
   (shape-only); the GEMM entries trace as their plain chains, the other
   kernel entries as one custom-op node each;
2. :mod:`lower`    -- aten nodes to the ``Op`` IR of
   :mod:`repro_torch.core.modes`, with FLOP/byte costs from the fakes;
3. :mod:`fuse`     -- :class:`repro_torch.core.sma.SMAPolicy` plans the
   temporal mode timeline and the fusion groups;
4. :mod:`rewrite`  -- every eligible product becomes a GEMM site; the
   ``mm -> bias -> activation`` and ``rmsnorm -> mm`` chains fuse into it,
   with the reference's fallbacks;
5. :mod:`dispatch` -- the rewritten graph as a ``GraphModule`` whose sites
   call ``ops.sma_gemm`` / ``ops.rmsnorm_gemm`` and whose kernel-entry
   nodes call their entries;
6. :mod:`report`   -- the plan report (planned vs realized fusion, the
   static route of each site, the compile stages' times).

The front door is :func:`repro_torch.sma_jit` (:mod:`repro_torch.api`).
"""
from repro_torch.compiler.dispatch import (CompiledModel, build_module,
                                           compile_with_options,
                                           count_dispatch_sites)
from repro_torch.compiler.fuse import ModelPlan, plan_program
from repro_torch.compiler.lower import (LoweredProgram, LowerStats,
                                        lower_graph, sma_eligible)
from repro_torch.compiler.report import (backends_section, fusion_section,
                                         plan_report, render_text,
                                         write_report)
from repro_torch.compiler.rewrite import (FusedGemm, RewriteResult,
                                          RewriteStats, rewrite_program)
from repro_torch.compiler.trace import TensorSpec, TracedModel, trace_model

__all__ = [
    "CompiledModel", "build_module", "compile_with_options",
    "count_dispatch_sites", "ModelPlan", "plan_program", "LoweredProgram",
    "LowerStats", "lower_graph", "sma_eligible", "backends_section",
    "fusion_section", "plan_report", "render_text", "write_report",
    "FusedGemm", "RewriteResult", "RewriteStats", "rewrite_program",
    "TensorSpec", "TracedModel", "trace_model",
]
