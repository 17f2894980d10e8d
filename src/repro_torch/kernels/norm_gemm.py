"""Fused RMSNorm + GEMM: ``epilogue((x * r * scale) @ W)`` for Hopper.

Replaces the Pallas kernel ``repro/kernels/norm_gemm.py:62``
(``rmsnorm_gemm``).  It is the ``sma_gemm`` tile skeleton with an A-tile
prologue: once an x tile is in shared memory each element becomes
``x * r * scale`` in f32, rounded to x's dtype before the tensor-core
product, so the normalized matrix never exists in device memory.  The row
inverse RMS ``r`` is computed here with torch ops, as the JAX wrapper
computes it outside its ``pallas_call``.

Bound on an H100: on the serving path this is ``final_norm -> head`` at
M <= 8, bound by the weight bytes.  The plain version is
:func:`repro_torch.kernels.ref.rmsnorm_gemm_ref`.

The wrapper runs the plain version only for CPU tensors; for a CUDA tensor
it launches the kernel or raises.  ``rmsnorm_gemm.launches`` counts
launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.sma import EPILOGUE_CODES
from repro_torch.kernels import _build
from repro_torch.kernels.ref import rms_inverse, rmsnorm_gemm_ref
from repro_torch.kernels.sma_gemm import DTYPE_CODES

#: x, r, scale, w, out; M, N, K, dtype, epilogue; stream.
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def _lib() -> ctypes.CDLL:
    return _build.load("norm_gemm", {"norm_gemm_launch": _ARGTYPES})


def rmsnorm_gemm(x: torch.Tensor, scale: torch.Tensor, w: torch.Tensor, *,
                 epilogue: str = "none", eps: float = 1e-6) -> torch.Tensor:
    """``epilogue(rmsnorm(x; scale) @ w)`` in x's dtype.

    x (..., K); scale (K,); w (K, N).
    """
    if epilogue not in EPILOGUE_CODES:
        raise ValueError(f"unknown epilogue {epilogue!r}")
    k = x.shape[-1]
    if w.ndim != 2 or w.shape[0] != k or scale.shape != (k,):
        raise ValueError(f"shapes do not chain: x {tuple(x.shape)}, scale "
                         f"{tuple(scale.shape)}, w {tuple(w.shape)}")
    if x.device.type == "cpu":
        return rmsnorm_gemm_ref(x, scale, w, epilogue=epilogue, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm_gemm runs on cuda or cpu, not {x.device}")
    if w.device != x.device or w.dtype != x.dtype:
        raise ValueError(f"W must match x: {w.device}/{w.dtype} vs "
                         f"{x.device}/{x.dtype}")
    if x.dtype not in DTYPE_CODES:
        raise ValueError(f"rmsnorm_gemm takes f32/bf16/f16, not {x.dtype}")
    n = w.shape[1]
    x2 = x.reshape(-1, k).contiguous()
    m = x2.shape[0]
    r = rms_inverse(x2, eps).reshape(m).contiguous()
    scale = scale.to(device=x.device, dtype=torch.float32).contiguous()
    w = w.contiguous()
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m and n:
        lib = _lib()
        with torch.cuda.device(x.device):
            err = lib.norm_gemm_launch(
                x2.data_ptr(), r.data_ptr(), scale.data_ptr(), w.data_ptr(),
                out.data_ptr(), m, n, k, DTYPE_CODES[x.dtype],
                EPILOGUE_CODES[epilogue], _build.stream_of(x))
        _build.check(lib, err, "rmsnorm_gemm")
        rmsnorm_gemm.launches += 1
    return out.reshape(*x.shape[:-1], n)


rmsnorm_gemm.launches = 0
