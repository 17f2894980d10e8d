"""RG-LRU scan for Hopper: ``h_t = a_t * h_{t-1} + u_t`` over (B, S, D).

Replaces the Pallas kernel ``repro/kernels/rglru.py:55`` (``rglru_scan``).
Both CUDA kernels (``csrc/rglru_scan.cu``) keep the time axis sequential
inside one thread per (batch, channel) pair, with the float32 carry in a
register (the TPU kernel's sequential time grid axis), so the output is the
plain version's bit for bit.  They take any S and any D: the reference's
``mxu_constraints`` (``D % 8``) is a limit of the TPU's lowering.

Bound on an H100: bytes (3 * B * S * D elements; 0.0751 ms at the
RecurrentGemma prefill's B 4, S 4096, D 2560, bf16).

:func:`_route` picks the kernel statically, from D, dtype and alignment,
and ``rglru_scan.routes`` counts the launches of each:

* ``"tma"`` -- D * element size a multiple of 16 bytes and 16-byte-aligned
  bases: a block of four warps takes 128 channels of one batch row, one a
  thread; a ring of shared-memory stages of (steps x 128 channels) boxes of
  a and u kept full by TMA, the rounded h stored a stage at a time by TMA;
* ``"simt"`` -- the strides TMA refuses: one thread a channel, loading the
  next 32 steps of a and u into registers before it runs them.

The wrapper runs the plain version :func:`repro_torch.kernels.ref.
rglru_scan_ref` only for CPU tensors; for CUDA tensors it launches its
route's kernel or raises, and counts one launch a call in
``rglru_scan.launches``.  There is no backward kernel yet (the TPU kernel
has none either); :func:`repro_torch.kernels.ops.rglru_scan` refuses a
gradient on the card.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import rglru_scan_ref
from repro_torch.kernels.sma_gemm import DTYPE_CODES

#: simt: a, u, h0 (or null), h_seq, h_last; B, S, D, dtype; stream.
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
#: tma: the same with the planted faults' mask after the dtype.
_TMA_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                 + [ctypes.c_void_p])


def _lib() -> ctypes.CDLL:
    return _build.load("rglru_scan",
                       {"rglru_scan_launch": _ARGTYPES,
                        "rglru_scan_tma_launch": _TMA_ARGTYPES,
                        "rglru_scan_tma_tile": [ctypes.c_int] * 2})


def tma_tile(dtype: torch.dtype) -> dict:
    """The ``tma`` kernel's tile for ``dtype`` as the built library sizes
    it: steps a ring stage (``rows``, where the planted faults of
    ``ref.rglru_scan_planted_ref`` act), ring ``stages`` and dynamic shared
    memory a block (``smem_bytes``)."""
    fn = _lib().rglru_scan_tma_tile
    return {key: fn(DTYPE_CODES[dtype], i)
            for i, key in enumerate(("rows", "stages", "smem_bytes"))}


def _route(b: int, s: int, d: int, dtype: torch.dtype,
           aligned: bool) -> str:
    """``"tma"`` where TMA can take the strides -- a row of D elements a
    multiple of 16 bytes, and 16-byte-aligned bases -- else ``"simt"``.
    Every B and S streams the same way."""
    if aligned and d * torch.finfo(dtype).bits // 8 % 16 == 0:
        return "tma"
    return "simt"


def _run(a: torch.Tensor, u: torch.Tensor, h0: Optional[torch.Tensor],
         route: str, plant: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of ``route`` on contiguous (B, S, D) a, u (S >= 1) and h0
    or None on one card; returns (h_seq, h_last).  Counts nothing:
    :func:`rglru_scan` counts its own launches; ``chip_smoke.py`` calls
    this directly to time the ``simt`` kernel beside the ``tma`` one on
    the same inputs and to feed the ``tma`` kernel the planted faults of
    ``plant`` (``ref.SCAN_PLANT_*``, 0 otherwise).  A planted run's
    outputs start zeroed, so a dropped store reads as zeros and not as
    whatever the allocator's block last held."""
    b, s, d = a.shape
    new = torch.zeros if plant else torch.empty
    h_seq = new((b, s, d), dtype=a.dtype, device=a.device)
    h_last = new((b, d), dtype=a.dtype, device=a.device)
    lib = _lib()
    args = (a.data_ptr(), u.data_ptr(),
            h0.data_ptr() if h0 is not None else None, h_seq.data_ptr(),
            h_last.data_ptr(), b, s, d, DTYPE_CODES[a.dtype])
    with torch.cuda.device(a.device):
        if route == "tma":
            err = lib.rglru_scan_tma_launch(*args, plant,
                                            _build.stream_of(a))
        elif route == "simt" and not plant:
            err = lib.rglru_scan_launch(*args, _build.stream_of(a))
        else:
            raise ValueError(f"rglru_scan has no route {route!r} with "
                             f"plant {plant}")
    _build.check(lib, err, f"rglru_scan ({route})")
    return h_seq, h_last


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
    if a.numel() == 0:       # S == 0: the carry is h0 itself
        h_last = torch.zeros((b, d), dtype=a.dtype, device=a.device)
        if h0 is not None:
            h_last.copy_(h0)
        return torch.empty_like(a), h_last
    ins = tuple(t.contiguous() for t in ins)
    # The outputs come from the caching allocator, 512-byte aligned.
    aligned = all(t.data_ptr() % 16 == 0 for t in ins)
    route = _route(b, s, d, a.dtype, aligned)
    out = _run(ins[0], ins[1], ins[2] if h0 is not None else None, route)
    rglru_scan.launches += 1
    ROUTES[route] += 1
    return out


#: Launches per route (:func:`_route`), read as ``rglru_scan.routes``;
#: ``ops.reset_counts`` clears them.  A module dict, so a stand-in that
#: takes the wrapper's name (a planted fault) still counts into it.
ROUTES = dict.fromkeys(("tma", "simt"), 0)
rglru_scan.launches = 0
rglru_scan.routes = ROUTES
