"""RG-LRU scan for Hopper: ``h_t = a_t * h_{t-1} + u_t`` over (B, S, D).

Replaces the Pallas kernel ``repro/kernels/rglru.py:55`` (``rglru_scan``).
The CUDA kernel (``csrc/rglru_scan.cu``) gives one thread one (batch,
channel) pair for the whole sequence, with the float32 carry in a register
and the time loop inside the thread (the TPU kernel's sequential time grid
axis); loads and stores are coalesced across channels.  It takes any S and
any D: the reference's ``mxu_constraints`` (``D % 8``) is a limit of the
TPU's lowering, so there is no route to a plain version here.

Bound on an H100: bytes (3 * B * S * D elements); this first version is
latency-bound well above it (a chain of S dependent steps per thread).

The wrapper runs the plain version :func:`repro_torch.kernels.ref.
rglru_scan_ref` only for CPU tensors; for CUDA tensors it launches the
kernel or raises, and counts its launches in ``rglru_scan.launches``.
There is no backward kernel yet (the TPU kernel has none either);
:func:`repro_torch.kernels.ops.rglru_scan` refuses a gradient on the card.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import rglru_scan_ref
from repro_torch.kernels.sma_gemm import DTYPE_CODES

#: a, u, h0 (or null), h_seq, h_last; B, S, D, dtype; stream.
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def _lib() -> ctypes.CDLL:
    return _build.load("rglru_scan", {"rglru_scan_launch": _ARGTYPES})


def rglru_scan(a: torch.Tensor, u: torch.Tensor,
               h0: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gated linear recurrence with a float32 carry.

    a, u (B, S, D) of one dtype (f32/bf16/f16); h0 (B, D) in that dtype or
    None (a zero carry).  Returns (h_seq (B, S, D), h_last (B, D)) in a's
    dtype; h_last is the final carry rounded once.
    """
    if not _build.on_card("rglru_scan", a):
        return rglru_scan_ref(a, u, h0)
    if a.dim() != 3 or u.shape != a.shape:
        raise ValueError(f"a and u must share one (B, S, D) shape, got "
                         f"{tuple(a.shape)} and {tuple(u.shape)}")
    b, s, d = a.shape
    ins = (a, u) if h0 is None else (a, u, h0)
    if h0 is not None and h0.shape != (b, d):
        raise ValueError(f"h0 must be {(b, d)}, got {tuple(h0.shape)}")
    if a.dtype not in DTYPE_CODES or any(t.dtype != a.dtype for t in ins):
        raise ValueError(f"a, u and h0 must share one of f32/bf16/f16, got "
                         f"{[t.dtype for t in ins]}")
    if any(t.device != a.device for t in ins):
        raise ValueError(f"all inputs must be on {a.device}")
    a, u = a.contiguous(), u.contiguous()
    h0 = h0.contiguous() if h0 is not None else None
    h_seq = torch.empty_like(a)
    h_last = torch.empty((b, d), dtype=a.dtype, device=a.device)
    if h_seq.numel() == 0:       # S == 0: the carry is h0 itself
        if h0 is None:
            h_last.zero_()
        else:
            h_last.copy_(h0)
        return h_seq, h_last
    lib = _lib()
    with torch.cuda.device(a.device):
        err = lib.rglru_scan_launch(
            a.data_ptr(), u.data_ptr(),
            h0.data_ptr() if h0 is not None else None, h_seq.data_ptr(),
            h_last.data_ptr(), b, s, d, DTYPE_CODES[a.dtype],
            _build.stream_of(a))
    _build.check(lib, err, "rglru_scan")
    rglru_scan.launches += 1
    return h_seq, h_last


rglru_scan.launches = 0
