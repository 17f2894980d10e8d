"""Public kernel entry points (counterpart of ``repro.kernels.ops``).

Models call these, never the kernel modules directly:

* :func:`sma_gemm` -- ``epilogue(A @ B + bias)`` (every projection);
* :func:`rmsnorm_gemm` -- ``epilogue(rmsnorm(x) @ W)`` (final_norm -> head);
* :func:`flash_attention` -- causal/windowed GQA attention (train/prefill);
* :func:`decode_attention` -- one token against a contiguous cache;
* :func:`paged_decode_attention` -- serving attention over the paged pool,
  with the routing below;
* :func:`rglru_scan` -- the RG-LRU recurrence (recurrentgemma prefill);
* :func:`mlstm_chunkwise` -- the chunkwise mLSTM with its final state
  (xLSTM forward and prefill).

Each entry point:

* dispatches by device: the kernel wrapper launches its CUDA kernel for a
  CUDA tensor (or raises) and runs its plain version for a CPU tensor.
  There is no runtime failover from a kernel to a plain version;
* with grad mode on, goes through the ``torch.autograd.Function`` of
  :mod:`repro_torch.kernels.autograd`, whose backward is kernel launches
  too.  With grad mode off (the serving engine's ``torch.inference_mode()``)
  it calls the wrapper directly: ``Function.apply`` costs about 10 us a
  call on an H100 machine's host, 3.9 % of a full-width decode step
  (``chip_smoke.py``, ``entry_overhead``);
* routes statically, mirroring the JAX package: a paged-attention site with
  more than one query token per row (a chunked-prefill tile) or a window
  goes to the plain :func:`repro_torch.kernels.ref.paged_attention_ref`, as
  ``repro.kernels.decode_attention.paged_constraints`` routes it.  Each such
  call is counted in :data:`ROUTED` under its reason string, when it runs
  (a compiled step calls this entry on every run, not once at its trace);
* records a ``kernel.{op}`` span while a :func:`repro_torch.profile` is
  active (the reference's ``_launch``): tagged with the execution mode of
  the entry's op kind (``sma_gemm``, ``rmsnorm_gemm`` and the attention
  entries systolic, the scans SIMD) and the route the wrapper took (a
  route counter's key, ``kernel`` for the decode kernels, ``plain`` for a
  CPU tensor or a site routed by design, with its ``reason``).  Without a
  profile an entry costs one Python call and one ``ContextVar`` read more;
* probes for faults (:mod:`repro_torch.resilience.faults`), with no
  failover: ``maybe_raise(op, backend)`` before the launch and
  ``corrupt(op, backend, out)`` after it, ``backend`` being the route name
  ``cuda`` or ``plain``; and, under ``check_numerics`` (an
  :func:`repro_torch.api.options.options` context, or an engine call with
  the option), checks the output with
  :func:`repro_torch.resilience.guard.check_numerics_value`.  While no
  fault scope is open and no check is asked for, this costs one module
  attribute read (``faults.QUIET``).  The compiled ``sma_jit`` modules
  call these entries at run time (tracing swaps them only while it
  records), so the probes fire inside a compiled step too;
* counts kernel launches on the wrappers (:func:`launch_counts`), and the
  launches per route (the kernel that shape, dtype and alignment pick) of
  ``sma_gemm.routes`` (``wgmma``, ``splitk``, ``tile``, ``f32``),
  ``rmsnorm_gemm.routes`` (``wgmma``, ``tile``, ``f32``),
  ``mlstm_chunkwise.routes`` (``wgmma``, ``simt``),
  ``mlstm_chunkwise_bwd.routes`` (the route of its recompute of the
  forward: ``wgmma``, ``simt``),
  ``rglru_scan.routes`` and ``rglru_scan_bwd.routes`` (``tma``,
  ``simt``) and the flash wrappers' ``.routes``.

The JAX package's backend registry and ladder are not ported.
"""
from __future__ import annotations

import collections
import functools
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.api.options import ambient_mesh, current_options
from repro_torch.core.modes import BACKEND_ROUTE, OpKind, classify_op
from repro_torch.kernels import autograd as _autograd
from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import mlstm as _mlstm
from repro_torch.kernels import norm_gemm as _norm
from repro_torch.kernels import rglru as _rglru
from repro_torch.kernels import sma_gemm as _gemm
from repro_torch.kernels.ref import paged_attention_ref
from repro_torch.obs import trace as _obs_trace
from repro_torch.resilience import faults as _faults
from repro_torch.resilience import guard as _guard

__all__ = ["ROUTED", "decode_attention", "flash_attention", "launch_counts",
           "mlstm_chunkwise", "paged_decode_attention", "paged_route",
           "reset_counts", "rglru_scan", "rmsnorm_gemm", "sma_gemm"]

#: Calls routed by design away from the one-rank kernel path (to a plain
#: version, to the SUMMA sharded GEMM, a collective through host memory),
#: keyed by reason.
ROUTED: Dict[str, int] = collections.Counter()

#: The reason a GEMM that a mesh shards is counted under.
SHARDED_REASON = "mesh: sma_gemm sharded by SUMMA"

#: The kernel wrappers whose ``.launches`` the counters read.
WRAPPERS = {
    "sma_gemm": _gemm.sma_gemm,
    "rmsnorm_gemm": _norm.rmsnorm_gemm,
    "flash_attention": _flash.flash_attention_fwd,
    "flash_attention_bwd": _flash.flash_attention_bwd,
    "paged_decode_attention": _decode.paged_decode_attention,
    "decode_attention": _decode.decode_attention,
    "rglru_scan": _rglru.rglru_scan,
    "rglru_scan_bwd": _rglru.rglru_scan_bwd,
    "mlstm_chunkwise": _mlstm.mlstm_chunkwise,
    "mlstm_chunkwise_bwd": _mlstm.mlstm_chunkwise_bwd,
}


def launch_counts() -> Dict[str, int]:
    """Kernel launches per wrapper since the last :func:`reset_counts`."""
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_counts() -> None:
    """Zero every wrapper's launches, the routes of ``sma_gemm``,
    ``rmsnorm_gemm``, ``mlstm_chunkwise``, ``decode_attention`` and
    ``rglru_scan`` (forward and backward) and the flash kernels, and
    :data:`ROUTED`."""
    for fn in WRAPPERS.values():
        fn.launches = 0
    for routes in (_gemm.ROUTES, _norm.ROUTES, _mlstm.ROUTES, _decode.ROUTES,
                   _mlstm.BWD_ROUTES, _rglru.ROUTES, _rglru.BWD_ROUTES, _flash.FWD_ROUTES,
                   _flash.BWD_ROUTES):
        routes.update(dict.fromkeys(routes, 0))
    ROUTED.clear()


#: Each entry's op kind (the lowering's, ``compiler/lower.py``), whose
#: execution mode tags its kernel span.
_KINDS = {"sma_gemm": OpKind.MATMUL, "rmsnorm_gemm": OpKind.MATMUL,
          "flash_attention": OpKind.ATTENTION_MATMUL,
          "decode_attention": OpKind.ATTENTION_MATMUL,
          "paged_decode_attention": OpKind.ATTENTION_MATMUL,
          "rglru_scan": OpKind.RECURRENCE,
          "mlstm_chunkwise": OpKind.RECURRENCE}

#: The route counters each entry's wrapper bumps (``ROUTED`` for the paged
#: entry: the sites it sends to the plain version).
_ROUTE_COUNTERS = {"sma_gemm": _gemm.ROUTES, "rmsnorm_gemm": _norm.ROUTES,
                   "flash_attention": _flash.FWD_ROUTES,
                   "rglru_scan": _rglru.ROUTES,
                   "mlstm_chunkwise": _mlstm.ROUTES,
                   "paged_decode_attention": ROUTED}


def _route_taken(x: torch.Tensor, counter: Optional[Dict[str, int]],
                 before: Dict[str, int]) -> Dict[str, str]:
    """The span's route annotation: the counter key the call bumped."""
    for key, n in (counter or {}).items():
        if n != before.get(key, 0):
            if counter is ROUTED:
                return {"route": "plain", "reason": key}
            return {"route": key}
    return {"route": "kernel" if x.device.type == "cuda" else "plain"}


def _backend(op: str, args: tuple, kwargs: dict) -> str:
    """The route name a fault spec's ``@backend`` matches: ``cuda`` for a
    CUDA tensor, ``plain`` for a CPU tensor or a paged site routed to the
    plain version by design."""
    if op == "paged_decode_attention" and paged_route(
            args[0].shape[1], kwargs.get("window")) is not None:
        return "plain"
    return BACKEND_ROUTE.get(args[0].device.type, "plain")


def _spanned(op: str) -> Callable[[Callable], Callable]:
    """The entry's wrapper: a ``kernel.{op}`` span while a profile is
    active, and the resilience probes while a fault scope or a
    ``check_numerics`` context is open (module docstring)."""
    mode = classify_op(_KINDS[op]).value
    counter = _ROUTE_COUNTERS.get(op)

    def wrap(fn: Callable) -> Callable:
        def run(args, kwargs):
            tr = _obs_trace.current_tracer()
            if tr is None:
                return fn(*args, **kwargs)
            before = dict(counter) if counter is not None else {}
            with tr.span(f"kernel.{op}", cat="kernel", mode=mode) as sp:
                out = fn(*args, **kwargs)
                sp.annotate(**_route_taken(args[0], counter, before))
                return sp.block(out)

        def probed(args, kwargs):
            backend = _backend(op, args, kwargs)
            _faults.maybe_raise(op, backend)
            out = _faults.corrupt(op, backend, run(args, kwargs))
            return _guard.check_numerics_value(
                op, backend, out, None, current_options().check_numerics)

        @functools.wraps(fn)
        def entry(*args: Any, **kwargs: Any):
            if _faults.QUIET:
                return run(args, kwargs)
            return probed(args, kwargs)
        return entry
    return wrap


def _mesh_routable(a: torch.Tensor, b: torch.Tensor, mesh: Any) -> bool:
    """True when a resolved ``mesh`` knob routes this GEMM through the
    SUMMA sharded GEMM: a grid of more than one rank and the ``(..., K) @
    (K, N)`` shape."""
    if mesh is None or mesh is False:
        return False
    if getattr(b, "ndim", 0) != 2 or getattr(a, "ndim", 0) < 2:
        return False
    from repro_torch.distributed.summa import summa_grid
    _, _, pr, pc = summa_grid(mesh)
    return pr * pc > 1


def sma_gemm(a: torch.Tensor, b: torch.Tensor, *,
             bias: Optional[torch.Tensor] = None,
             epilogue: str = "none", mesh: Any = None) -> torch.Tensor:
    """``epilogue(A @ B + bias)`` in A's dtype; a (..., K), b (K, N).

    ``mesh`` (a :class:`repro_torch.launch.mesh.Mesh`; ``None`` takes
    ``SMAOptions.mesh`` from the ambient options) routes a call of that
    shape on a grid of more than one rank through
    :func:`repro_torch.distributed.summa.sma_gemm_sharded`, counted in
    :data:`ROUTED` under :data:`SHARDED_REASON`; ``mesh=False`` forces the
    local path (the sharded GEMM's own per-step products)."""
    if mesh is None:
        mesh = ambient_mesh()
    if mesh and _mesh_routable(a, b, mesh):
        if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
            raise NotImplementedError(
                "sma_gemm sharded over a mesh has no backward: call it "
                "under torch.no_grad() (train(mesh=) shards the batch, "
                "not the products)")
        from repro_torch.distributed.summa import sma_gemm_sharded
        ROUTED[SHARDED_REASON] += 1
        return sma_gemm_sharded(a, b, mesh=mesh, bias=bias,
                                epilogue=epilogue)
    return _local_gemm(a, b, bias=bias, epilogue=epilogue)


@_spanned("sma_gemm")
def _local_gemm(a: torch.Tensor, b: torch.Tensor, *,
                bias: Optional[torch.Tensor] = None,
                epilogue: str = "none") -> torch.Tensor:
    """One rank's ``sma_gemm``: the kernel, through its autograd Function
    with grad mode on."""
    if not torch.is_grad_enabled():
        return _gemm.sma_gemm(a, b, bias=bias, epilogue=epilogue)
    return _autograd.SmaGemm.apply(a, b, bias, epilogue)


@_spanned("rmsnorm_gemm")
def rmsnorm_gemm(x: torch.Tensor, scale: torch.Tensor, w: torch.Tensor, *,
                 epilogue: str = "none", eps: float = 1e-6) -> torch.Tensor:
    """``epilogue(rmsnorm(x; scale) @ w)`` in x's dtype."""
    if not torch.is_grad_enabled():
        return _norm.rmsnorm_gemm(x, scale, w, epilogue=epilogue, eps=eps)
    return _autograd.RmsnormGemm.apply(x, scale, w, epilogue, eps)


@_spanned("flash_attention")
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Online-softmax attention (train/prefill).  q (B, Hq, Sq, D); k/v
    (B, Hkv, Skv, D); queries end-aligned.  Returns (B, Hq, Sq, D)."""
    if not torch.is_grad_enabled():
        return _flash.flash_attention_fwd(q, k, v, causal=causal,
                                          window=window, scale=scale)[0]
    return _autograd.FlashAttention.apply(q, k, v, causal, window, scale)


@_spanned("decode_attention")
def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: torch.Tensor, *,
                     scale: Optional[float] = None,
                     return_lse: bool = False):
    """One query token against a contiguous cache.  q (B, Hq, D); k/v_cache
    (B, Hkv, Smax, D); cache_len (B,) valid positions.  Returns
    (B, Hq, D); with ``return_lse`` (a rank's slice of the cache under
    decode context parallelism) the output in float32 and the (B, Hq)
    float32 log-sum-exp."""
    return _decode.decode_attention(q, k_cache, v_cache, cache_len,
                                    scale=scale, return_lse=return_lse)


@_spanned("rglru_scan")
def rglru_scan(a: torch.Tensor, u: torch.Tensor,
               h0: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``h_t = a_t * h_{t-1} + u_t`` with a float32 carry.  a, u (B, S, D);
    h0 (B, D) or None.  Returns (h_seq, h_last) in a's dtype.  With grad
    mode on it goes through :class:`repro_torch.kernels.autograd.RgluScan`,
    whose backward is the ``rglru_scan_bwd`` kernel."""
    if not torch.is_grad_enabled():
        return _rglru.rglru_scan(a, u, h0)
    return _autograd.RgluScan.apply(a, u, h0)


@_spanned("mlstm_chunkwise")
def mlstm_chunkwise(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    log_f: torch.Tensor, log_i: torch.Tensor, *,
                    chunk: int = 128, return_state: bool = False):
    """Stabilized chunkwise mLSTM.  q/k/v (B, H, S, D); log_f/log_i (B, H,
    S).  Returns h (B, H, S, D) in q's dtype and, with ``return_state``,
    also the final (C (B, H, D, D), n (B, H, D), m (B, H)) in float32: the
    kernel computes the state itself, so nothing is routed (the JAX
    package sends such a site down its XLA path).  With grad mode on it
    goes through :class:`repro_torch.kernels.autograd.MlstmChunkwise`,
    whose backward is the ``mlstm_chunkwise_bwd`` kernel."""
    if not torch.is_grad_enabled():
        return _mlstm.mlstm_chunkwise(q, k, v, log_f, log_i, chunk=chunk,
                                      return_state=return_state)
    out = _autograd.MlstmChunkwise.apply(q, k, v, log_f, log_i, chunk,
                                         return_state)
    return (out[0], tuple(out[1:])) if return_state else out


def paged_route(c: int, window: Optional[int]) -> Optional[str]:
    """Why a paged site goes to the plain version, or None for the kernel
    (the reasons of ``repro.kernels.decode_attention.paged_constraints``)."""
    if c != 1:
        return (f"shape:chunked prefill tile (C={c}) needs per-query "
                f"masking (single-token decode kernel only)")
    if window is not None:
        return "param:sliding-window masking runs on the SIMD paged path"
    return None


@_spanned("paged_decode_attention")
def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_table: torch.Tensor,
                           q_pos: torch.Tensor, kv_len: torch.Tensor, *,
                           window: Optional[int] = None,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Block-table GQA attention over a paged pool (serving).

    q (B, C, Hq, D); k/v_pool (NB, Hkv, BS, D); block_table (B, MB) int32
    (entries >= NB unallocated); q_pos (B, C); kv_len (B,) valid lengths
    including this chunk.  Returns (B, C, Hq, D).  Single-token sites
    without a window go to the paged decode kernel (which, like the JAX
    kernel path, takes q_pos as kv_len - 1); the others are routed to
    :func:`paged_attention_ref`.
    """
    why = paged_route(q.shape[1], window)
    if why is not None:
        ROUTED[why] += 1
        return paged_attention_ref(q, k_pool, v_pool, block_table, q_pos,
                                   kv_len, window=window, scale=scale)
    out = _decode.paged_decode_attention(q[:, 0], k_pool, v_pool,
                                         block_table, kv_len, scale=scale)
    return out[:, None]
