"""SMA GEMM: ``C = epilogue(A @ B + bias)``, written by hand for Hopper.

Replaces the Pallas kernel ``repro/kernels/sma_gemm.py:83`` (``sma_gemm``).
The TPU kernel's sequential K grid axis, with its VMEM-resident
accumulator, becomes a K loop with the f32 accumulator on chip; bias and
the epilogue are applied to the f32 sums and the output is stored once.
Ragged shapes are masked or zero-filled in the kernel, never padded by
copy.

Bound on an H100: weight bytes at decode (M <= 16), tensor-core operations
at prefill and training.  :func:`_route` picks one of four kernels
statically, from shape, dtype and alignment (never because another
failed), and ``sma_gemm.routes`` counts the launches of each:

* ``"wgmma"`` -- bf16/f16, M > 16, K and N multiples of 8 and 16-byte
  aligned bases (TMA's rules): a TMA + ``wgmma`` pipeline
  (``csrc/sma_gemm.cu``);
* ``"splitk"`` -- bf16/f16, M <= 16 and the same alignment: the weight
  streamed once in K slices (:func:`_slices`), f32 partials (a scratch
  tensor) summed in fixed order by a second launch;
* ``"tile"`` -- bf16/f16 operands TMA cannot take: the WMMA kernel of
  ``csrc/gemm_tile.cuh``;
* ``"f32"`` -- f32: the CUDA-core kernel of ``csrc/gemm_tile.cuh``, no
  TF32.

The plain version is :func:`repro_torch.kernels.ref.gemm_ref`.  The
wrapper runs it only for CPU tensors; for a CUDA tensor it launches its
route's kernel or raises.  ``sma_gemm.launches`` counts one per call.
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


#: a, b, bias, out, part; M, N, K, dtype, epilogue, route, slices, kslice;
#: stream.
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]

#: Route name -> route code of ``sma_gemm_launch`` (``csrc/sma_gemm.cu``;
#: the tile and f32 kernels share one code, told apart by dtype).
_ROUTE_CODES = {"tile": 0, "f32": 0, "wgmma": 1, "splitk": 2}
#: Split-K: column block width and K rows per pass (``splitk::BN``,
#: ``splitk::ROWS``), and the blocks to aim for (two per SM of 132).
_SPLITK_BN = 64
_SPLITK_ROWS = 32
_BLOCKS = 264


def _route(m: int, n: int, k: int, dtype: torch.dtype, aligned: bool) -> str:
    """The kernel for an (M, K) @ (K, N) product: ``"f32"`` for f32;
    ``"tile"`` where TMA cannot take the operands (K or N not a multiple of
    8, a base not 16-byte aligned, K = 0); else ``"splitk"`` for M <= 16
    and ``"wgmma"`` above."""
    if dtype == torch.float32:
        return "f32"
    if not aligned or k % 8 or n % 8 or k == 0:
        return "tile"
    return "splitk" if m <= 16 else "wgmma"


def _slices(n: int, k: int):
    """Split-K's (slices, rows per slice): enough slices that column blocks
    x slices >= ``_BLOCKS``, as far as slices of at least one pass of
    ``_SPLITK_ROWS`` rows allow.  The last slice may be short, or empty
    where the rows do not divide (its partial is 0)."""
    blocks = -(-n // _SPLITK_BN)
    slices = max(1, min(-(-_BLOCKS // blocks), k // _SPLITK_ROWS))
    return slices, -(-k // slices)


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
        aligned = a2.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0
        route = _route(m, n, k, a.dtype, aligned)
        slices, kslice = _slices(n, k) if route == "splitk" else (1, k)
        part = (torch.empty(slices * m * n, dtype=torch.float32,
                            device=a.device) if route == "splitk" else None)
        lib = _lib()
        with torch.cuda.device(a.device):
            err = lib.sma_gemm_launch(
                a2.data_ptr(), b.data_ptr(),
                None if bias is None else bias.data_ptr(), out.data_ptr(),
                None if part is None else part.data_ptr(), m, n, k,
                DTYPE_CODES[a.dtype], EPILOGUE_CODES[epilogue],
                _ROUTE_CODES[route], slices, kslice, _build.stream_of(a))
        _build.check(lib, err, f"sma_gemm ({route})")
        sma_gemm.launches += 1
        ROUTES[route] += 1
    return out.reshape(*a.shape[:-1], n)


#: Launches per route (:func:`_route`), read as ``sma_gemm.routes``;
#: ``ops.reset_counts`` clears them.  A module dict, so a stand-in that
#: takes the wrapper's name (a planted fault) still counts into it.
ROUTES = dict.fromkeys(("wgmma", "splitk", "tile", "f32"), 0)
sma_gemm.launches = 0
sma_gemm.routes = ROUTES
