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
``rglru_scan.launches``.

:func:`rglru_scan_bwd` is the scan's gradient, which the TPU kernel does
not have (the reference's gradient comes from its XLA associative scan):
the reverse recurrence ``g = dh_t + c``, ``du_t = g``, ``da_t = g *
h_{t-1}``, ``c = a_t * g`` with the f32 carry c, from t = S - 1 down.  It
reads h_{t-1} from the forward's saved ``h_seq`` rather than recomputing
the f32 carry: the gradients are returned in a's dtype, so the 16-bit
h_seq adds one rounding of the same size as the output's own, where a
recomputation would stream a and u once more (and in f32 h_seq is the
carry, so the result is the plain gradient's bit for bit).  Bound: bytes
(read a, h_seq, dh, write da, du: 5 * B * S * D elements; 0.063 ms at
B 2, S 4096, D 2560 in bf16).  Its own routes (``rglru_scan_bwd.routes``,
:func:`_route`'s rule on a, h_seq, dh): ``tma``, the forward's ring walked
from the last stage down with the three inputs in and da, du out, the
h_{t-1} box one row behind (TMA zero-fills row -1); ``simt``, one thread
a channel walking back in register chunks.  Plain version
:func:`repro_torch.kernels.ref.rglru_scan_bwd_ref`.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import rglru_scan_bwd_ref, rglru_scan_ref
from repro_torch.kernels.sma_gemm import DTYPE_CODES

#: simt: a, u, h0 (or null), h_seq, h_last; B, S, D, dtype; stream.
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
#: tma: the same with the planted faults' mask after the dtype.
_TMA_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                 + [ctypes.c_void_p])
#: backward, both routes: a, h_seq, dh, h0, dh_last (or null), da, du, dh0
#: (or null); B, S, D, dtype; stream.
_BWD_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [
    ctypes.c_void_p]


def _lib() -> ctypes.CDLL:
    return _build.load("rglru_scan",
                       {"rglru_scan_launch": _ARGTYPES,
                        "rglru_scan_tma_launch": _TMA_ARGTYPES,
                        "rglru_scan_bwd_launch": _BWD_ARGTYPES,
                        "rglru_scan_bwd_tma_launch": _BWD_ARGTYPES,
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


def _run_bwd(a: torch.Tensor, h_seq: torch.Tensor, dh: torch.Tensor,
             h0: Optional[torch.Tensor], dh_last: Optional[torch.Tensor],
             route: str) -> Tuple[torch.Tensor, torch.Tensor,
                                  Optional[torch.Tensor]]:
    """One launch of the backward's ``route`` on contiguous (B, S, D) a,
    h_seq, dh (S >= 1) and contiguous (B, D) h0, dh_last or None; returns
    (da, du, dh0 or None).  Counts nothing (``chip_smoke.py`` times the
    ``simt`` kernel beside the ``tma`` one with it)."""
    b, s, d = a.shape
    da, du = torch.empty_like(a), torch.empty_like(a)
    dh0 = torch.empty_like(h0) if h0 is not None else None
    lib = _lib()
    fn = {"tma": lib.rglru_scan_bwd_tma_launch,
          "simt": lib.rglru_scan_bwd_launch}.get(route)
    if fn is None:
        raise ValueError(f"rglru_scan_bwd has no route {route!r}")

    def ptr(t):
        return t.data_ptr() if t is not None else None
    with torch.cuda.device(a.device):
        err = fn(a.data_ptr(), h_seq.data_ptr(), dh.data_ptr(), ptr(h0),
                 ptr(dh_last), da.data_ptr(), du.data_ptr(), ptr(dh0), b, s,
                 d, DTYPE_CODES[a.dtype], _build.stream_of(a))
    _build.check(lib, err, f"rglru_scan_bwd ({route})")
    return da, du, dh0


def rglru_scan_bwd(a: torch.Tensor, h_seq: torch.Tensor, dh: torch.Tensor,
                   h0: Optional[torch.Tensor] = None,
                   dh_last: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor,
                              Optional[torch.Tensor]]:
    """Gradients of :func:`rglru_scan` with respect to a, u and h0, given
    the forward's ``h_seq`` and the incoming gradients ``dh`` of h_seq and
    ``dh_last`` of h_last (None: zero).  a, h_seq, dh (B, S, D) of one
    dtype; h0, dh_last (B, D) in that dtype or None.  Returns (da, du,
    dh0), dh0 None without h0 (module docstring)."""
    if not _build.on_card("rglru_scan_bwd", a):
        return rglru_scan_bwd_ref(a, h_seq, dh, h0, dh_last)
    if a.dim() != 3 or h_seq.shape != a.shape or dh.shape != a.shape:
        raise ValueError(f"a, h_seq and dh must share one (B, S, D) shape, "
                         f"got {tuple(a.shape)}, {tuple(h_seq.shape)} and "
                         f"{tuple(dh.shape)}")
    b, s, d = a.shape
    vecs = tuple(t for t in (h0, dh_last) if t is not None)
    if any(t.shape != (b, d) for t in vecs):
        raise ValueError(f"h0 and dh_last must be {(b, d)}, got "
                         f"{[tuple(t.shape) for t in vecs]}")
    ins = (a, h_seq, dh) + vecs
    if a.dtype not in DTYPE_CODES or any(t.dtype != a.dtype for t in ins):
        raise ValueError(f"a, h_seq, dh, h0 and dh_last must share one of "
                         f"f32/bf16/f16, got {[t.dtype for t in ins]}")
    if any(t.device != a.device for t in ins):
        raise ValueError(f"all inputs must be on {a.device}")
    if a.numel() == 0:       # S == 0: dh0 is dh_last itself
        dh0 = None
        if h0 is not None:
            dh0 = (dh_last.clone() if dh_last is not None
                   else torch.zeros_like(h0))
        return torch.empty_like(a), torch.empty_like(a), dh0
    a, h_seq, dh = (t.contiguous() for t in (a, h_seq, dh))
    h0, dh_last = (t.contiguous() if t is not None else None
                   for t in (h0, dh_last))
    aligned = all(t.data_ptr() % 16 == 0 for t in (a, h_seq, dh))
    route = _route(b, s, d, a.dtype, aligned)
    out = _run_bwd(a, h_seq, dh, h0, dh_last, route)
    rglru_scan_bwd.launches += 1
    BWD_ROUTES[route] += 1
    return out


#: Launches per route (:func:`_route`), read as ``rglru_scan.routes`` and
#: ``rglru_scan_bwd.routes``; ``ops.reset_counts`` clears them.  Module
#: dicts, so a stand-in that takes a wrapper's name (a planted fault) still
#: counts into them.
ROUTES = dict.fromkeys(("tma", "simt"), 0)
BWD_ROUTES = dict.fromkeys(("tma", "simt"), 0)
rglru_scan.launches = 0
rglru_scan.routes = ROUTES
rglru_scan_bwd.launches = 0
rglru_scan_bwd.routes = BWD_ROUTES
