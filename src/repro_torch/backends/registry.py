"""Static backend selection and site recording (``repro.backends.registry``).

:func:`select_backend` is a pure function of the site: ``cuda`` for CUDA
tensors, ``plain`` for CPU tensors (:data:`repro_torch.core.modes.
BACKEND_ROUTE`), and ``plain`` for the sites :mod:`repro_torch.kernels.ops`
routes by design (a chunked-prefill or windowed paged-attention site,
:func:`repro_torch.kernels.ops.paged_route`, the reasons counted in
``ops.ROUTED``).  A ``cuda`` GEMM site also names the kernel route its
shape and dtype pick (``sma_gemm._route`` / ``norm_gemm._route``, with
16-byte aligned bases).  There is no ladder, no quarantine and no runtime
failover.

While a :func:`record_sites` recorder is active every selection appends a
record; the compiler records its dispatched sites into the plan report's
``backends`` section.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Any, Dict, Iterator, List, Optional, Tuple

from repro_torch.backends.base import BACKENDS, Backend, FallbackReason, \
    OpSite
from repro_torch.core.modes import BACKEND_ROUTE

__all__ = ["available_backends", "record_sites", "select_backend"]


def available_backends() -> Tuple[str, ...]:
    return tuple(BACKENDS)


def _gemm_route(site: OpSite) -> Optional[str]:
    """The kernel route of a ``cuda`` GEMM site."""
    import torch

    from repro_torch.kernels import norm_gemm, sma_gemm
    route_of = {"sma_gemm": sma_gemm._route,
                "rmsnorm_gemm": norm_gemm._route}.get(site.op)
    if route_of is None:
        return None
    a, w = site.shapes[0], site.shapes[2 if site.op == "rmsnorm_gemm" else 1]
    return route_of(math.prod(a[:-1]), w[1], w[0],
                    getattr(torch, site.dtypes[0]), True)


def select_backend(site: OpSite) -> Tuple[Backend, Optional[FallbackReason]]:
    """``(backend, reason)``: ``reason`` is None when the site runs its
    kernel, else why it runs the plain version."""
    name = BACKEND_ROUTE.get(site.device)
    if name is None:
        raise ValueError(f"{site.op}: no backend for {site.device} tensors "
                         f"(the port runs on cuda or cpu)")
    reason = None
    if name == "plain":
        reason = FallbackReason(f"platform:{site.device} tensors run the "
                                f"plain version")
    elif site.op == "paged_decode_attention":
        from repro_torch.kernels import ops
        why = ops.paged_route(site.extra("c", 1), site.extra("window"))
        if why is not None:
            name, reason = "plain", FallbackReason(why)
    backend = BACKENDS[name]
    recorder = _RECORDER.get()
    if recorder is not None:
        recorder.append({
            "op": site.op,
            "shapes": [list(s) for s in site.shapes],
            "dtypes": list(site.dtypes),
            "device": site.device,
            "extras": [[k, v] for k, v in site.extras],
            "backend": name,
            "mode": backend.mode.value,
            "route": _gemm_route(site) if name == "cuda" else None,
            "fallback_reason": str(reason) if reason is not None else None,
        })
    return backend, reason


_RECORDER: contextvars.ContextVar[Optional[List[Dict[str, Any]]]] = \
    contextvars.ContextVar("repro_torch_backend_site_recorder", default=None)


@contextlib.contextmanager
def record_sites(into: Optional[List[Dict[str, Any]]] = None
                 ) -> Iterator[List[Dict[str, Any]]]:
    """Record every :func:`select_backend` in the ``with`` scope; nested
    recorders shadow outer ones."""
    sites: List[Dict[str, Any]] = into if into is not None else []
    token = _RECORDER.set(sites)
    try:
        yield sites
    finally:
        _RECORDER.reset(token)
