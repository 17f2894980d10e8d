"""SMA GEMM: ``C = epilogue(A @ B + bias)``, written by hand for Hopper.

Replaces the Pallas kernel ``repro/kernels/sma_gemm.py:83`` (``sma_gemm``).
The TPU kernel's sequential K grid axis, with its VMEM-resident
accumulator, becomes a K loop inside each CUDA block with the accumulator
in registers; bias and the epilogue are applied to the f32 sums and the
output is stored once (``csrc/gemm_tile.cuh``).  bf16/f16 run on the
tensor cores (WMMA), f32 on the CUDA cores without TF32.  Ragged shapes are
masked in the kernel instead of padded by copy.

Bound on an H100: weight bytes at decode (M <= 16), tensor-core operations
at prefill.  The plain version is :func:`repro_torch.kernels.ref.gemm_ref`.

The wrapper runs the plain version only for CPU tensors; for a CUDA tensor
it launches the kernel or raises.  ``sma_gemm.launches`` counts launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.sma import EPILOGUE_CODES
from repro_torch.kernels import _build
from repro_torch.kernels.ref import gemm_ref

#: torch dtype -> dtype code of csrc/common.cuh.
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


#: a, b, bias, out; M, N, K, dtype, epilogue; stream.
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def _lib() -> ctypes.CDLL:
    return _build.load("sma_gemm", {"sma_gemm_launch": _ARGTYPES})


def sma_gemm(a: torch.Tensor, b: torch.Tensor, *,
             bias: Optional[torch.Tensor] = None,
             epilogue: str = "none") -> torch.Tensor:
    """``epilogue(A @ B + bias)`` in A's dtype.

    a (..., K), leading dims collapsed into M; b (K, N); bias (N,) or None.
    """
    if epilogue not in EPILOGUE_CODES:
        raise ValueError(f"unknown epilogue {epilogue!r}")
    if b.ndim != 2 or b.shape[0] != a.shape[-1]:
        raise ValueError(f"A/B contraction mismatch: {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    if a.device.type == "cpu":
        return gemm_ref(a, b, bias=bias, epilogue=epilogue)
    if a.device.type != "cuda":
        raise ValueError(f"sma_gemm runs on cuda or cpu, not {a.device}")
    if b.device != a.device or b.dtype != a.dtype:
        raise ValueError(f"B must match A: {b.device}/{b.dtype} vs "
                         f"{a.device}/{a.dtype}")
    if a.dtype not in DTYPE_CODES:
        raise ValueError(f"sma_gemm takes f32/bf16/f16, not {a.dtype}")
    k, n = b.shape
    a2 = a.reshape(-1, k).contiguous()
    m = a2.shape[0]
    b = b.contiguous()
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    if bias is not None:
        bias = bias.to(device=a.device, dtype=torch.float32).contiguous()
        if bias.shape != (n,):
            raise ValueError(f"bias must be ({n},), got {tuple(bias.shape)}")
    if m and n:
        lib = _lib()
        with torch.cuda.device(a.device):
            err = lib.sma_gemm_launch(
                a2.data_ptr(), b.data_ptr(),
                None if bias is None else bias.data_ptr(), out.data_ptr(),
                m, n, k, DTYPE_CODES[a.dtype], EPILOGUE_CODES[epilogue],
                _build.stream_of(a))
        _build.check(lib, err, "sma_gemm")
        sma_gemm.launches += 1
    return out.reshape(*a.shape[:-1], n)


sma_gemm.launches = 0
