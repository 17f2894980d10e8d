"""PyTorch/CUDA port of ``repro``: the serving path on an NVIDIA Hopper card.

The package mirrors ``repro``'s layout and names so each module's
counterpart is easy to find.  It imports ``torch``, numpy and the standard
library only, never ``jax`` and nothing of ``repro``.

Entry points (:class:`repro_torch.serving.ServeEngine`, the step functions
in :mod:`repro_torch.serving.model`, :func:`repro_torch.models.lm.init`)
run on ``cuda`` unless the caller passes ``device="cpu"``.  On the card
every kernel of the path is one written by hand for ``sm_90a``
(:mod:`repro_torch.kernels`); on the CPU each wrapper runs its plain
PyTorch version, which is what the CPU tests compare with the JAX package.

The front door is :func:`sma_jit` (:mod:`repro_torch.api`): it traces a
function with ``torch.fx``, plans its SYSTOLIC/SIMD mode timeline, fuses
epilogues and norm prologues into the GEMM sites and dispatches them to the
kernels (:mod:`repro_torch.compiler`).

Observability: ``with repro_torch.profile(path=...): ...`` records spans
for everything inside (engine calls and compiles, dispatch sites, kernel
launches, serving ticks) and optionally writes a Perfetto-loadable Chrome
trace (:mod:`repro_torch.obs`).  Off by default; never part of any
compile-cache key.

Distribution: :mod:`repro_torch.launch.mesh` lays the ranks of a
``torch.distributed`` group on named axes, :mod:`repro_torch.distributed`
holds the collectives, the sharding rules, the SUMMA sharded GEMM
(``SMAOptions(mesh=...)`` shards a compiled program's GEMM sites) and the
pipeline, and ``train(cfg, loop, mesh=...)`` is data parallelism over the
ranks.

Resilience: ``with repro_torch.inject_faults("sma_gemm@cuda:"
"runtime_error:times=1"): ...`` scopes a deterministic fault schedule at
the kernel entries, the engine's compile and the serving engine's sites;
the rest lives under :mod:`repro_torch.resilience`.
"""
from repro_torch import obs
from repro_torch._device import resolve_device
from repro_torch.api import SMAOptions, options, sma_jit
from repro_torch.obs import profile
from repro_torch.resilience import FaultSpec, inject_faults

__all__ = ["FaultSpec", "SMAOptions", "inject_faults", "obs", "options",
           "profile", "resolve_device", "sma_jit"]
