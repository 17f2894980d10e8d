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
  (``chip_smoke.py``, ``entry_overhead``).  :func:`rglru_scan` and
  :func:`mlstm_chunkwise` have no backward kernel yet and refuse a
  gradient on the card;
* routes statically, mirroring the JAX package: a paged-attention site with
  more than one query token per row (a chunked-prefill tile) or a window
  goes to the plain :func:`repro_torch.kernels.ref.paged_attention_ref`, as
  ``repro.kernels.decode_attention.paged_constraints`` routes it.  Each such
  call is counted in :data:`ROUTED` under its reason string;
* counts kernel launches on the wrappers (:func:`launch_counts`), and
  ``sma_gemm``'s launches per route in ``sma_gemm.routes`` (the kernel
  that shape, dtype and alignment pick: ``wgmma``, ``splitk``, ``tile``
  or ``f32``; see :mod:`repro_torch.kernels.sma_gemm`).

The JAX package's backend registry and ladder are not ported.
"""
from __future__ import annotations

import collections
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import autograd as _autograd
from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import mlstm as _mlstm
from repro_torch.kernels import norm_gemm as _norm
from repro_torch.kernels import rglru as _rglru
from repro_torch.kernels import sma_gemm as _gemm
from repro_torch.kernels.ref import paged_attention_ref

__all__ = ["ROUTED", "decode_attention", "flash_attention", "launch_counts",
           "mlstm_chunkwise", "paged_decode_attention", "paged_route",
           "reset_counts", "rglru_scan", "rmsnorm_gemm", "sma_gemm"]

#: Calls routed to a plain version by design, keyed by reason.
ROUTED: Dict[str, int] = collections.Counter()

#: The kernel wrappers whose ``.launches`` the counters read.
WRAPPERS = {
    "sma_gemm": _gemm.sma_gemm,
    "rmsnorm_gemm": _norm.rmsnorm_gemm,
    "flash_attention": _flash.flash_attention_fwd,
    "flash_attention_bwd": _flash.flash_attention_bwd,
    "paged_decode_attention": _decode.paged_decode_attention,
    "decode_attention": _decode.decode_attention,
    "rglru_scan": _rglru.rglru_scan,
    "mlstm_chunkwise": _mlstm.mlstm_chunkwise,
}


def launch_counts() -> Dict[str, int]:
    """Kernel launches per wrapper since the last :func:`reset_counts`."""
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_counts() -> None:
    """Zero every wrapper's launches, the routes of ``sma_gemm`` and the
    flash kernels, and :data:`ROUTED`."""
    for fn in WRAPPERS.values():
        fn.launches = 0
    for routes in (_gemm.ROUTES, _flash.FWD_ROUTES, _flash.BWD_ROUTES):
        routes.update(dict.fromkeys(routes, 0))
    ROUTED.clear()


def sma_gemm(a: torch.Tensor, b: torch.Tensor, *,
             bias: Optional[torch.Tensor] = None,
             epilogue: str = "none") -> torch.Tensor:
    """``epilogue(A @ B + bias)`` in A's dtype; a (..., K), b (K, N)."""
    if not torch.is_grad_enabled():
        return _gemm.sma_gemm(a, b, bias=bias, epilogue=epilogue)
    return _autograd.SmaGemm.apply(a, b, bias, epilogue)


def rmsnorm_gemm(x: torch.Tensor, scale: torch.Tensor, w: torch.Tensor, *,
                 epilogue: str = "none", eps: float = 1e-6) -> torch.Tensor:
    """``epilogue(rmsnorm(x; scale) @ w)`` in x's dtype."""
    if not torch.is_grad_enabled():
        return _norm.rmsnorm_gemm(x, scale, w, epilogue=epilogue, eps=eps)
    return _autograd.RmsnormGemm.apply(x, scale, w, epilogue, eps)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Online-softmax attention (train/prefill).  q (B, Hq, Sq, D); k/v
    (B, Hkv, Skv, D); queries end-aligned.  Returns (B, Hq, Sq, D)."""
    if not torch.is_grad_enabled():
        return _flash.flash_attention_fwd(q, k, v, causal=causal,
                                          window=window, scale=scale)[0]
    return _autograd.FlashAttention.apply(q, k, v, causal, window, scale)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: torch.Tensor, *,
                     scale: Optional[float] = None) -> torch.Tensor:
    """One query token against a contiguous cache.  q (B, Hq, D); k/v_cache
    (B, Hkv, Smax, D); cache_len (B,) valid positions.  Returns
    (B, Hq, D)."""
    return _decode.decode_attention(q, k_cache, v_cache, cache_len,
                                    scale=scale)


def rglru_scan(a: torch.Tensor, u: torch.Tensor,
               h0: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``h_t = a_t * h_{t-1} + u_t`` with a float32 carry.  a, u (B, S, D);
    h0 (B, D) or None.  Returns (h_seq, h_last) in a's dtype.

    On the card there is no backward kernel: with grad mode on and an
    input that requires a gradient this raises, and does not fall back to
    the plain version.  On the CPU the plain version is differentiable."""
    _refuse_gradient("rglru_scan", "a reverse scan, csrc/rglru_scan.cu",
                     (a, u) if h0 is None else (a, u, h0))
    return _rglru.rglru_scan(a, u, h0)


def mlstm_chunkwise(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    log_f: torch.Tensor, log_i: torch.Tensor, *,
                    chunk: int = 128, return_state: bool = False):
    """Stabilized chunkwise mLSTM.  q/k/v (B, H, S, D); log_f/log_i (B, H,
    S).  Returns h (B, H, S, D) in q's dtype and, with ``return_state``,
    also the final (C (B, H, D, D), n (B, H, D), m (B, H)) in float32: the
    kernel computes the state itself, so nothing is routed (the JAX
    package sends such a site down its XLA path).

    On the card there is no backward kernel: with grad mode on and an
    input that requires a gradient this raises, and does not fall back to
    the plain version."""
    _refuse_gradient("mlstm_chunkwise", "csrc/mlstm_chunkwise.cu",
                     (q, k, v, log_f, log_i))
    return _mlstm.mlstm_chunkwise(q, k, v, log_f, log_i, chunk=chunk,
                                  return_state=return_state)


def _refuse_gradient(name: str, where: str, ins) -> None:
    if ins[0].device.type == "cuda" and torch.is_grad_enabled() \
            and any(t.requires_grad for t in ins):
        raise NotImplementedError(
            f"{name} has no backward kernel on the card yet ({where}); run "
            f"it without a gradient")


def paged_route(c: int, window: Optional[int]) -> Optional[str]:
    """Why a paged site goes to the plain version, or None for the kernel
    (the reasons of ``repro.kernels.decode_attention.paged_constraints``)."""
    if c != 1:
        return (f"shape:chunked prefill tile (C={c}) needs per-query "
                f"masking (single-token decode kernel only)")
    if window is not None:
        return "param:sliding-window masking runs on the SIMD paged path"
    return None


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
