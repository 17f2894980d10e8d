"""Fused RMSNorm + GEMM: ``epilogue((x * r * scale) @ W)`` for Hopper.

Replaces the Pallas kernel ``repro/kernels/norm_gemm.py:62``
(``rmsnorm_gemm``).  Once an x tile is in shared memory each element
becomes ``x * r * scale`` in f32, rounded to x's dtype before the
tensor-core product, so the normalized matrix never exists in device
memory.  The row inverse RMS ``r`` is computed here with torch ops, as the
JAX wrapper computes it outside its ``pallas_call``.

Bound on an H100: on the serving path this is ``final_norm -> head`` at
M <= 8, bound by the weight bytes; in training (M = 8192 tokens) by the
tensor-core operations.  :func:`_route` picks the kernel statically, from
shape, dtype and alignment, and ``rmsnorm_gemm.routes`` counts the
launches of each:

* ``"wgmma"`` -- bf16/f16, M > 16, K and N multiples of 8 and 16-byte
  aligned bases (TMA's rules, as ``sma_gemm``'s): the TMA + ``wgmma``
  kernel of ``csrc/gemm_wgmma.cuh`` with its norm prologue applied to the
  resident A tile;
* ``"tile"`` -- bf16/f16 at M <= 16 (the decode heads) or what TMA cannot
  take: the WMMA kernel of ``csrc/gemm_tile.cuh`` with the same prologue;
* ``"f32"`` -- f32: the CUDA-core kernel of ``csrc/gemm_tile.cuh``.

The plain version is :func:`repro_torch.kernels.ref.rmsnorm_gemm_ref`.
The wrapper runs it only for CPU tensors; for a CUDA tensor it launches
its route's kernel or raises.  ``rmsnorm_gemm.launches`` counts launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.core.sma import EPILOGUE_CODES
from repro_torch.kernels import _build
from repro_torch.kernels import sma_gemm as _gemm
from repro_torch.kernels.ref import rms_inverse, rmsnorm_gemm_ref
from repro_torch.kernels.sma_gemm import DTYPE_CODES

#: x, r, scale, w, out; M, N, K, dtype, epilogue, route; stream.
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]

#: Route name -> route code of ``norm_gemm_launch`` (``csrc/norm_gemm.cu``;
#: the tile and f32 kernels share one code, told apart by dtype).
_ROUTE_CODES = {"tile": 0, "f32": 0, "wgmma": 1}


def _route(m: int, n: int, k: int, dtype: torch.dtype, aligned: bool) -> str:
    """The kernel for an (M, K) x, (K, N) W: ``sma_gemm``'s choice
    (:func:`repro_torch.kernels.sma_gemm._route`), with its split-K (M <=
    16) taken by ``"tile"``: the head at decode stays on the kernel that
    streams the weight at 58 % of its byte bound."""
    route = _gemm._route(m, n, k, dtype, aligned)
    return "tile" if route == "splitk" else route


def _lib() -> ctypes.CDLL:
    return _build.load("norm_gemm", {"norm_gemm_launch": _ARGTYPES})


def _launch(x2: torch.Tensor, r: torch.Tensor, scale: torch.Tensor,
            w: torch.Tensor, *, epilogue: str = "none",
            route: Optional[str] = None) -> Tuple[torch.Tensor, str]:
    """One launch on (M, K) x2 with the wrapper's row inverse RMS ``r``
    (M,) f32, ``scale`` (K,) f32 and ``w`` (K, N), all contiguous on one
    card, on ``route`` (default :func:`_route`'s; ``"tile"`` may stand in
    for ``"wgmma"``).  Returns (out (M, N), the route).  Counts nothing:
    :func:`rmsnorm_gemm` counts its own launches; ``chip_smoke.py`` calls
    this directly to time the other route and to feed planted faults
    (a wrong r) on the same inputs."""
    m, k = x2.shape
    n = w.shape[1]
    aligned = x2.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    auto = _route(m, n, k, x2.dtype, aligned)
    route = route or auto
    if route != auto and (route, auto) != ("tile", "wgmma"):
        raise ValueError(f"rmsnorm_gemm cannot take route {route!r} for "
                         f"M {m}, K {k}, N {n}, {x2.dtype}")
    out = torch.empty((m, n), dtype=x2.dtype, device=x2.device)
    if m and n:
        lib = _lib()
        with torch.cuda.device(x2.device):
            err = lib.norm_gemm_launch(
                x2.data_ptr(), r.data_ptr(), scale.data_ptr(), w.data_ptr(),
                out.data_ptr(), m, n, k, DTYPE_CODES[x2.dtype],
                EPILOGUE_CODES[epilogue], _ROUTE_CODES[route],
                _build.stream_of(x2))
        _build.check(lib, err, f"rmsnorm_gemm ({route})")
    return out, route


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
    out, route = _launch(x2, r, scale, w.contiguous(), epilogue=epilogue)
    if m and n:
        rmsnorm_gemm.launches += 1
        ROUTES[route] += 1
    return out.reshape(*x.shape[:-1], n)


#: Launches per route (:func:`_route`), read as ``rmsnorm_gemm.routes``;
#: ``ops.reset_counts`` clears them.  A module dict, so a stand-in that
#: takes the wrapper's name (a planted fault) still counts into it.
ROUTES = dict.fromkeys(("wgmma", "tile", "f32"), 0)
rmsnorm_gemm.launches = 0
rmsnorm_gemm.routes = ROUTES
