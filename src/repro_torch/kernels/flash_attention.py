"""Flash attention for Hopper, forward and backward (train/prefill path).

Replaces the Pallas kernel ``repro/kernels/flash_attention.py:101``
(``flash_attention``).  The CUDA kernels (``csrc/flash_attention.cu``) give
one block 64 query rows of one (batch, head) and loop over the visible KV
tiles inside the block, with the online softmax in f32 registers and both
products on the tensor cores (bf16/f16, ``mma.sync``).  KV tiles wholly in
the future or before the window are skipped, keys past ``Skv`` are masked
in the kernel, and query head ``h`` reads KV head ``h // group``.  The
backward (FlashAttention-2) recomputes ``P`` from the forward's ``lse``,
accumulates dK/dV per KV tile summed over the group, and dQ with f32
atomics.

Bound on an H100: operations (``4 * D`` flops per visible (query, key)
pair forward, 2.5x that backward).

Two wrappers, each with its own launch counter:

* :func:`flash_attention_fwd` -- ``(out, lse)``; plain version
  :func:`repro_torch.kernels.ref.flash_attention_ref`.
* :func:`flash_attention_bwd` -- ``(dq, dk, dv)``; plain version
  :func:`repro_torch.kernels.ref.flash_attention_bwd_ref`.  One call
  launches two kernels (``D = rowsum(dO * O)``, then the main pass) and
  counts once.

Each runs its plain version only for CPU tensors; for CUDA tensors it
launches the kernel or raises.  The kernels take bf16/f16 with head_dim
64 or 128; anything else on the card raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (flash_attention_bwd_ref,
                                     flash_attention_ref)
from repro_torch.kernels.sma_gemm import DTYPE_CODES

HEAD_DIMS = (64, 128)

#: q, k, v, out, lse; B, Hq, Hkv, Sq, Skv, D; scale; causal, window,
#: dtype; stream.
_FWD_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                 + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
#: q, k, v, out, dout, lse, delta, dq, dk, dv; then as the forward.
_BWD_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
                 + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def _lib() -> ctypes.CDLL:
    return _build.load("flash_attention",
                       {"flash_attention_fwd_launch": _FWD_ARGTYPES,
                        "flash_attention_bwd_launch": _BWD_ARGTYPES})


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, with a 16-byte aligned start (the kernels copy rows of
    16 bytes with cp.async)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           *more: torch.Tensor) -> Tuple[int, int, int, int, int, int]:
    b, hq, sq, d = q.shape
    b2, hkv, skv, d2 = k.shape
    if b2 != b or d2 != d or v.shape != k.shape or hkv == 0 or hq % hkv:
        raise ValueError(f"shapes do not match: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    for t in (k, v, *more):
        if t.device != q.device:
            raise ValueError(f"all inputs must be on {q.device}")
    if q.dtype not in (torch.bfloat16, torch.float16) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"the flash kernels take bf16/f16 q, k, v of one "
                         f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"the flash kernels take head_dim in {HEAD_DIMS}, "
                         f"got {d}")
    return b, hq, hkv, sq, skv, d


def _window(window: Optional[int]) -> int:
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    return 0 if window is None else int(window)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: Optional[int] = None,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Online-softmax attention.  q (B, Hq, Sq, D); k/v (B, Hkv, Skv, D).

    Returns ``out`` (B, Hq, Sq, D) in q's dtype and ``lse`` (B, Hq, Sq)
    float32, the log-sum-exp of each row's scaled scores (+inf for a row
    that sees no key).
    """
    if not _build.on_card("flash_attention", q):
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   scale=scale)
    b, hq, hkv, sq, skv, d = _check(q, k, v)
    win = _window(window)
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    if out.numel():
        scale = float(scale) if scale is not None else d ** -0.5
        lib = _lib()
        with torch.cuda.device(q.device):
            err = lib.flash_attention_fwd_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr(), b, hq, hkv, sq, skv, d, scale, int(causal),
                win, DTYPE_CODES[q.dtype], _build.stream_of(q))
        _build.check(lib, err, "flash_attention_fwd")
        flash_attention_fwd.launches += 1
    return out, lse


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, *, causal: bool = True,
                        window: Optional[int] = None,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients of :func:`flash_attention_fwd`'s ``out`` with respect to
    q, k and v, given ``out``, ``lse`` and ``dout`` (B, Hq, Sq, D).
    Returns (dq, dk, dv) in the inputs' dtype; dk and dv are summed over
    the query heads of each KV head."""
    if not _build.on_card("flash_attention_bwd", q):
        return flash_attention_bwd_ref(q, k, v, out, lse, dout,
                                       causal=causal, window=window,
                                       scale=scale)
    b, hq, hkv, sq, skv, d = _check(q, k, v, out, lse, dout)
    if out.shape != q.shape or dout.shape != q.shape \
            or lse.shape != (b, hq, sq):
        raise ValueError(f"out {tuple(out.shape)}, dout "
                         f"{tuple(dout.shape)} and lse {tuple(lse.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if out.dtype != q.dtype or dout.dtype != q.dtype \
            or lse.dtype != torch.float32:
        raise ValueError(f"out/dout must be {q.dtype} and lse float32, got "
                         f"{out.dtype}, {dout.dtype}, {lse.dtype}")
    win = _window(window)
    q, k, v, out, dout = (_aligned(t) for t in (q, k, v, out, dout))
    lse = lse.contiguous()
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if q.numel() and k.numel():
        delta = torch.empty((b, hq, sq), dtype=torch.float32,
                            device=q.device)
        scale = float(scale) if scale is not None else d ** -0.5
        lib = _lib()
        with torch.cuda.device(q.device):
            err = lib.flash_attention_bwd_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, hq, hkv, sq,
                skv, d, scale, int(causal), win, DTYPE_CODES[q.dtype],
                _build.stream_of(q))
        _build.check(lib, err, "flash_attention_bwd")
        flash_attention_bwd.launches += 1
    else:
        dk.zero_()
        dv.zero_()
    return dq.to(q.dtype), dk, dv


flash_attention_fwd.launches = 0
flash_attention_bwd.launches = 0
