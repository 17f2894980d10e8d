"""Chunkwise mLSTM for Hopper (xLSTM's matrix memory), with its state.

Replaces the Pallas kernel ``repro/kernels/mlstm.py:108``
(``mlstm_chunkwise``).  Unlike the TPU kernel, which streams h only (the
JAX package sends a site that needs the state down its XLA path), the
kernels here also write the final (C, n, m): the serving prefill takes its
decode state from them.  A ragged tail (S not a multiple of the chunk) is
read as the reference pads it (log f 0, log i -1e30, q = k = v = 0), so
the state written is the state after S steps.

Bound on an H100: operations (141.8 GFLOP at the xLSTM prefill shape B 4,
H 4, S 2048, D 1024, chunk 128, counting the causal (query, key) pairs only
and no q C0 on the first chunk: 0.143 ms at 989 TFLOP/s).

:func:`_route` picks the kernel statically, from dtype, shape, chunk and
alignment, and ``mlstm_chunkwise.routes`` counts the launches of each
(``csrc/mlstm_chunkwise.cu``):

* ``"wgmma"`` -- bf16/f16 q, k, v, D a multiple of 64, chunks of
  :data:`WGMMA_CHUNK` steps (so S >= 128), 16-byte-aligned bases: four
  launches split by what depends on the state.  A gate pass scans the
  gates and the stabilizer chain; a pass over (batch * head, chunk)
  computes S = q k^T once on ``wgmma`` and stores S . D in hi + lo 16-bit
  halves with its f32 row sums; a pass over (batch * head, 128 x 128 tile
  of C) walks the chunks with the tile as the f32 ``wgmma`` accumulator and
  hands each chunk's C_k to the output pass in hi + lo; the output pass
  over (batch * head, chunk, 128 value columns) computes h on ``wgmma``.
  In every product one side is exact in the 16-bit type (q, k or v) and the
  f32 side is split into hi = round(x) and lo = round(x - hi): two
  products into one f32 accumulator keep ~16 mantissa bits, which the
  1e-5 state limit needs (:func:`repro_torch.kernels.ref.
  mlstm_chunkwise_two_pass_ref` is this algorithm in plain PyTorch).  The
  wrapper allocates the scratch, ~1.0 GB of it C_k at the prefill shape;
* ``"simt"`` -- everything else (f32, other chunks and head dims): one
  block per (batch * head, 128 value columns) walking the chunks in order,
  all arithmetic f32 on the CUDA cores.

The wrapper runs the plain version :func:`repro_torch.kernels.ref.
mlstm_chunkwise_ref` only for CPU tensors; for CUDA tensors it launches its
route's kernel or raises, and counts one launch a call in
``mlstm_chunkwise.launches``.

:func:`mlstm_chunkwise_bwd` is the gradient, which the TPU kernel does not
have (the reference's comes from JAX differentiating its XLA chunkwise
path): (dq, dk, dv, dlog_f, dlog_i) of h and, where given, of the final C
and n.  It first recomputes the forward's chunk states with the forward's
own route (:func:`_route`), then runs the backward on the same route,
counted in ``mlstm_chunkwise_bwd.routes`` (``csrc/mlstm_chunkwise.cu``,
``mlstm_bwd``):

* ``"wgmma"`` -- the forward's gate and state passes hand over every
  chunk's C_k in hi + lo; then four launches on the tensor cores: Y = dh
  C_k^T with its row dots q . Y (a pass of its own: the denominators'
  gradient needs the whole row before any G exists); per chunk S = q k^T
  and W = dh v^T, the per-step factors, G and Sd / Dv in hi + lo; the
  reverse walk of the state's gradient G_k from (dC, dn) down, the tile
  the f32 ``wgmma`` accumulator (the forward's state pass in reverse),
  handing each G_k over in hi + lo; dq, dk, dv with the f32 row and
  column sums of P o dP; then dlog_i and dlog_f's reverse cumulative sum
  on the CUDA cores.  Every product has one side exact in the 16-bit type
  and the f32 side split into hi + lo (:func:`repro_torch.kernels.ref.
  mlstm_chunkwise_bwd_split_ref` is this algorithm in plain PyTorch);
  2.46 GB of scratch and outputs at the xLSTM training shape (C_k and G_k
  of every chunk in hi + lo, Y in f32);
* ``"simt"`` -- after the ``simt`` forward kernel writes its gates, C_k
  and n_k in f32, six launches f32 on the CUDA cores in 128 x 128 tiles:
  per chunk S = q k^T, W = dh v^T and the denominators; C_k dh; the
  per-step dnum / dden factors; the reverse walk of G_k; dq, dk, dv with
  the partial row and column sums; dlog_i and dlog_f.

Bound: operations (:func:`bwd_flops`, 343.8 GFLOP at B 4, H 4, S 2048, D
1024, chunk 128: 0.348 ms at 989 TFLOP/s; the ``wgmma`` route runs about
twice that on the tensor cores, the hi + lo halves).  A gradient of the
final m raises on the card (training never returns the state).  On CPU
tensors the wrapper returns the gradient of the plain forward by autograd
(:func:`repro_torch.kernels.ref.mlstm_chunkwise_autograd_ref`); its closed
form, the kernel's plain version on the card, is
:func:`repro_torch.kernels.ref.mlstm_chunkwise_bwd_ref`.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (BWD_PLANT_DQ_INTER, BWD_PLANT_RESET,
                                     BWD_PLANT_SHIFT,
                                     mlstm_chunkwise_autograd_ref,
                                     mlstm_chunkwise_ref)
from repro_torch.kernels.sma_gemm import DTYPE_CODES

#: The longest chunk the kernels hold.
MAX_CHUNK = 128
#: The chunk of the ``wgmma`` route.
WGMMA_CHUNK = 128

#: simt: q, k, v, log_f, log_i, out, C, n, m, gates, chunks, ck, nk; B*H,
#: S, D, L, dtype; stream.
_ARGTYPES = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
#: wgmma: q, k, v, log_f, log_i, out, C, n, m, gates, chunks, sd, rowsum,
#: ck, nk; B*H, S, D, dtype, plant, state_only; stream.
_WG_ARGTYPES = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 6
                + [ctypes.c_void_p])


#: backward, route simt: q, k, v, log_f, log_i, dh, dc, dn, C, n, gates,
#: chunks, ck, nk, dq, dk, dv, dlog_f, dlog_i, rows, gk, gn, sdm, wm, y, qy,
#: rp, cp, ep; B*H, S, D, L, dtype, plant; stream.
_BWD_ARGTYPES = ([ctypes.c_void_p] * 29 + [ctypes.c_int] * 6
                 + [ctypes.c_void_p])
#: backward, route wgmma: q, k, v, log_f, log_i, dh, dc, dn, C, n, gates,
#: chunks, ck, nk, dq, dk, dv, dlog_f, dlog_i, rows, y, qy, gp, gk, gn, rp,
#: cp, ep; B*H, S, D, dtype, plant; stream.
_BWD_WG_ARGTYPES = ([ctypes.c_void_p] * 28 + [ctypes.c_int] * 5
                    + [ctypes.c_void_p])
#: The backward's planted faults, ``BWD_PLANT_*`` (from ``ref``, shared
#: with its plain version ``ref.mlstm_chunkwise_bwd_split_ref``): the
#: reverse state gradient reset at chunk nc // 2; dq's inter-chunk terms
#: dropped; dlog_f's reverse cumulative sum shifted by one step.
#: Per-step scratch slots of the forward's gates (``repro::SLOTS``) and
#: of the backward's own (``mlstm_bwd::RSLOTS``).
_SLOTS, _BWD_SLOTS = 5, 4
_TILE = 128


def _lib() -> ctypes.CDLL:
    return _build.load("mlstm_chunkwise",
                       {"mlstm_chunkwise_launch": _ARGTYPES,
                        "mlstm_chunkwise_wgmma_launch": _WG_ARGTYPES,
                        "mlstm_chunkwise_wgmma_smem": [ctypes.c_int],
                        "mlstm_chunkwise_bwd_launch": _BWD_ARGTYPES,
                        "mlstm_chunkwise_bwd_wgmma_launch": _BWD_WG_ARGTYPES,
                        "mlstm_chunkwise_bwd_wgmma_smem": [ctypes.c_int]})


def wgmma_smem() -> dict:
    """Dynamic shared memory (bytes) of the ``wgmma`` route's S . D, state
    and output kernels, as the built library sizes them."""
    lib = _lib()
    return {name: lib.mlstm_chunkwise_wgmma_smem(i)
            for i, name in enumerate(("intra", "state", "output"))}


def bwd_smem() -> dict:
    """Dynamic shared memory (bytes) of the backward's ``wgmma`` kernels
    (Y, intra, walk, grads), as the built library sizes them."""
    lib = _lib()
    return {name: lib.mlstm_chunkwise_bwd_wgmma_smem(i)
            for i, name in enumerate(("y", "intra", "walk", "grads"))}


def _route(s: int, d: int, chunk: int, dtype: torch.dtype,
           aligned: bool) -> str:
    """``"wgmma"`` for 16-bit q/k/v with D % 64 == 0, chunks of exactly
    :data:`WGMMA_CHUNK` steps (L = min(chunk, S)) and aligned bases, else
    ``"simt"``."""
    if (dtype in (torch.bfloat16, torch.float16) and aligned
            and d % 64 == 0 and min(chunk, s) == WGMMA_CHUNK):
        return "wgmma"
    return "simt"


def _route_of(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              chunk: int) -> str:
    """:func:`_route` of contiguous q, k, v: the forward's, and the route of
    the backward's recompute."""
    _, _, s, d = q.shape
    aligned = all(t.data_ptr() % 16 == 0 for t in (q, k, v))
    return _route(s, d, chunk, q.dtype, aligned)


def _run(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         lf: torch.Tensor, li: torch.Tensor, L: int, route: str,
         plant: int = 0) -> Tuple[torch.Tensor, ...]:
    """One launch of ``route`` on contiguous (B, H, S, D) q, k, v and f32
    gates on one card, chunks of L steps; returns (h, C, n, m).  Counts
    nothing: :func:`mlstm_chunkwise` counts its own launches;
    ``chip_smoke.py`` calls this directly to time the ``simt`` kernel
    beside the ``wgmma`` one on the same inputs and to feed the ``wgmma``
    kernels the planted faults of ``plant`` (``ref.PLANT_*``, 0
    otherwise)."""
    return _launch(q, k, v, lf, li, L, route, plant, False)[:4]


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            lf: torch.Tensor, li: torch.Tensor, L: int, route: str,
            plant: int, recompute: bool) -> Tuple:
    """:func:`_run`, returning (h, C, n, m, scratch).  With ``recompute``
    (the backward's) the launch also hands over what the backward reads,
    scratch = (gates, chunks, C_k, n_k), C_k f32 (route ``simt``) or its
    hi halves followed by its lo halves in q's dtype (``wgmma``), and route
    ``wgmma`` runs its gate and state passes alone (h is neither written
    nor allocated: None)."""
    b, h, s, d = q.shape
    bh, nc = b * h, -(-s // L)
    slabs = bh * max(nc - 1, 1)
    f32 = dict(dtype=torch.float32, device=q.device)
    # Route wgmma's recompute writes no h.
    out = None if recompute and route == "wgmma" else torch.empty_like(q)
    c = torch.empty((b, h, d, d), **f32)
    n = torch.empty((b, h, d), **f32)
    m = torch.empty((b, h), **f32)
    lib = _lib()
    scratch = None
    if route == "wgmma" or recompute:
        gates = torch.empty(bh * (_SLOTS * nc * L + 3 * nc), **f32)
        chunks = gates[bh * _SLOTS * nc * L:]
        nk = torch.empty(slabs * d, **f32)
    if route == "simt":
        if plant:
            raise ValueError("the simt kernel takes no planted faults")
        ptrs = [None] * 4
        if recompute:
            ck = torch.empty((slabs, d, d), **f32)
            scratch = (gates, chunks, ck, nk)
            ptrs = [t.data_ptr() for t in (gates, chunks, ck, nk)]
        with torch.cuda.device(q.device):
            err = lib.mlstm_chunkwise_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), lf.data_ptr(),
                li.data_ptr(), out.data_ptr(), c.data_ptr(), n.data_ptr(),
                m.data_ptr(), *ptrs, bh, s, d, L, DTYPE_CODES[q.dtype],
                _build.stream_of(q))
    elif route == "wgmma" and L == WGMMA_CHUNK:
        sd = rowsum = None
        if not recompute:
            sd = torch.empty((2, bh * nc, L, L), dtype=q.dtype,
                             device=q.device)
            rowsum = torch.empty(bh * nc * L, **f32)
        ck = torch.empty((2, slabs, d, d), dtype=q.dtype, device=q.device)
        scratch = (gates, chunks, ck, nk)
        with torch.cuda.device(q.device):
            err = lib.mlstm_chunkwise_wgmma_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), lf.data_ptr(),
                li.data_ptr(), out.data_ptr() if out is not None else None,
                c.data_ptr(), n.data_ptr(), m.data_ptr(), gates.data_ptr(),
                chunks.data_ptr(),
                sd.data_ptr() if sd is not None else None,
                rowsum.data_ptr() if rowsum is not None else None,
                ck.data_ptr(), nk.data_ptr(), bh, s, d,
                DTYPE_CODES[q.dtype], plant, int(recompute),
                _build.stream_of(q))
    else:
        raise ValueError(f"mlstm_chunkwise has no route {route!r} for "
                         f"chunks of {L}")
    _build.check(lib, err, f"mlstm_chunkwise ({route})")
    return out, c, n, m, scratch


def mlstm_chunkwise(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    log_f: torch.Tensor, log_i: torch.Tensor, *,
                    chunk: int = 128, return_state: bool = False):
    """Stabilized chunkwise mLSTM.

    q/k/v (B, H, S, D) of one dtype (f32/bf16/f16); log_f/log_i (B, H, S),
    read as float32.  Chunks of L = min(chunk, S) steps, L <= 128 on the
    card.  Returns h (B, H, S, D) in q's dtype and, with ``return_state``,
    also (C (B, H, D, D), n (B, H, D), m (B, H)) in float32.
    """
    if not _build.on_card("mlstm_chunkwise", q):
        return mlstm_chunkwise_ref(q, k, v, log_f, log_i, chunk=chunk,
                                   return_state=return_state)
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k and v must share one (B, H, S, D) shape, "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, s, d = q.shape
    if log_f.shape != (b, h, s) or log_i.shape != (b, h, s):
        raise ValueError(f"log_f and log_i must be {(b, h, s)}, got "
                         f"{tuple(log_f.shape)} and {tuple(log_i.shape)}")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"q, k and v must share one of f32/bf16/f16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if any(t.device != q.device for t in (k, v, log_f, log_i)):
        raise ValueError(f"all inputs must be on {q.device}")
    if s < 1 or d < 1:
        raise ValueError(f"S and D must be positive, got {(s, d)}")
    L = min(chunk, s)
    if not 1 <= L <= MAX_CHUNK:
        raise ValueError(f"the kernel takes chunks of 1..{MAX_CHUNK} steps, "
                         f"got {chunk}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    route = _route_of(q, k, v, chunk)
    out, c, n, m = _run(q, k, v, log_f.float().contiguous(),
                        log_i.float().contiguous(), L, route)
    mlstm_chunkwise.launches += 1
    ROUTES[route] += 1
    return (out, (c, n, m)) if return_state else out


def bwd_flops(b: int, h: int, s: int, d: int, chunk: int) -> float:
    """Operations of the backward's products at these shapes with the
    gradient of h alone (the trainer's call), counting the causal (query,
    key) pairs only: per chunk the five L x L x D products (S, W, G k, G^T
    q, (Sd / Dv)^T dh); the D x D products of the chunks that have a state
    before them (C_k dh, the reverse walk) and of those that have a
    gradient after them (C_k's update, dk's and dv's inter-chunk terms)."""
    L = min(chunk, s)
    rows = [min(L, s - c) for c in range(0, s, L)]
    pairs = sum(r * (r + 1) // 2 for r in rows)
    before, after = sum(rows[1:]), sum(rows[:-1])
    return float(2 * b * h * (5 * pairs * d + d * d * (2 * before
                                                        + 3 * after)))


def _run_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             lf: torch.Tensor, li: torch.Tensor, dh: torch.Tensor,
             dc: Optional[torch.Tensor], dn: Optional[torch.Tensor], L: int,
             plant: int = 0, route: Optional[str] = None
             ) -> Tuple[torch.Tensor, ...]:
    """The backward on contiguous (B, H, S, D) q, k, v, dh, f32 gates and
    f32 dc, dn or None, chunks of L steps: the forward's recompute on
    ``route`` (default :func:`_route_of`, the forward's), then the
    backward's launches on the same route; returns (dq, dk, dv, dlog_f,
    dlog_i), the last two f32.  Counts nothing (``chip_smoke.py`` feeds it
    the planted faults of ``plant``, ``BWD_PLANT_*``, 0 otherwise, and
    times route ``simt`` beside ``wgmma`` on the same inputs)."""
    b, h, s, d = q.shape
    bh, nc, td = b * h, -(-s // L), -(-d // _TILE)
    sp = nc * L
    route = route or _route_of(q, k, v, L)
    _, c, n, _, (gates, chunks, ck, nk) = _launch(
        q, k, v, lf, li, L, route, 0, True)
    f32 = dict(dtype=torch.float32, device=q.device)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    dlf, dli = torch.empty((b, h, s), **f32), torch.empty((b, h, s), **f32)
    rows = torch.empty(bh * _BWD_SLOTS * sp, **f32)
    qy, rp, cp = (torch.empty((td, bh, sp), **f32) for _ in range(3))
    ep = torch.empty((bh, td * td), **f32)
    lib = _lib()

    def ptr(t):
        return t.data_ptr() if t is not None else None
    with torch.cuda.device(q.device):
        if route == "wgmma":
            y = torch.empty((bh, sp, d), **f32) if nc > 1 else None
            gp = torch.empty((4, bh * nc, L, L), dtype=q.dtype,
                             device=q.device)
            # G_k of the chunks with a gradient after them: the last only
            # with dc or dn.
            ncs = nc if dc is not None or dn is not None else nc - 1
            gk = torch.empty((2, bh * max(ncs, 1), d, d), dtype=q.dtype,
                             device=q.device)
            gn = torch.empty((bh, nc, d), **f32)
            err = lib.mlstm_chunkwise_bwd_wgmma_launch(
                *(ptr(t) for t in (q, k, v, lf, li, dh, dc, dn, c, n, gates,
                                   chunks, ck, nk, dq, dk, dv, dlf, dli,
                                   rows, y, qy, gp, gk, gn, rp, cp, ep)),
                bh, s, d, DTYPE_CODES[q.dtype], plant, _build.stream_of(q))
        else:
            gk = torch.empty((bh, nc, d, d), **f32)
            gn = torch.empty((bh, nc, d), **f32)
            sdm, wm = (torch.empty((bh, nc, L, L), **f32) for _ in range(2))
            y = torch.empty((bh, sp, d), **f32)
            err = lib.mlstm_chunkwise_bwd_launch(
                *(ptr(t) for t in (q, k, v, lf, li, dh, dc, dn, c, n, gates,
                                   chunks, ck, nk, dq, dk, dv, dlf, dli,
                                   rows, gk, gn, sdm, wm, y, qy, rp, cp,
                                   ep)),
                bh, s, d, L, DTYPE_CODES[q.dtype], plant,
                _build.stream_of(q))
    _build.check(lib, err, f"mlstm_chunkwise_bwd ({route})")
    return dq, dk, dv, dlf, dli


def mlstm_chunkwise_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        log_f: torch.Tensor, log_i: torch.Tensor,
                        dh: Optional[torch.Tensor],
                        dc: Optional[torch.Tensor] = None,
                        dn: Optional[torch.Tensor] = None,
                        dm: Optional[torch.Tensor] = None, *,
                        chunk: int = 128) -> Tuple[torch.Tensor, ...]:
    """Gradients (dq, dk, dv, dlog_f, dlog_i) of :func:`mlstm_chunkwise`
    given the gradients of h (``dh``, None: zero) and of the final state
    (``dc``, ``dn``, ``dm``; None where not read), each in its input's
    dtype.  On the card ``dm`` must be None (module docstring)."""
    if not _build.on_card("mlstm_chunkwise_bwd", q):
        return mlstm_chunkwise_autograd_ref((q, k, v, log_f, log_i), chunk,
                                            (dh, dc, dn, dm))
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k and v must share one (B, H, S, D) shape, "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, s, d = q.shape
    if dm is not None:
        raise NotImplementedError(
            "mlstm_chunkwise_bwd takes no gradient of the final m on the "
            "card (csrc/mlstm_chunkwise.cu); read the state without m")
    if dh is None:
        dh = torch.zeros_like(q)
    if dh.shape != q.shape or log_f.shape != (b, h, s) \
            or log_i.shape != (b, h, s):
        raise ValueError(f"dh must be {tuple(q.shape)} and log_f, log_i "
                         f"{(b, h, s)}, got {tuple(dh.shape)}, "
                         f"{tuple(log_f.shape)}, {tuple(log_i.shape)}")
    if (dc is not None and dc.shape != (b, h, d, d)) or \
            (dn is not None and dn.shape != (b, h, d)):
        raise ValueError(f"dc must be {(b, h, d, d)} and dn {(b, h, d)}")
    if q.dtype not in DTYPE_CODES or any(t.dtype != q.dtype
                                         for t in (k, v, dh)):
        raise ValueError(f"q, k, v and dh must share one of f32/bf16/f16, "
                         f"got {[t.dtype for t in (q, k, v, dh)]}")
    ins = [t for t in (k, v, log_f, log_i, dh, dc, dn) if t is not None]
    if any(t.device != q.device for t in ins):
        raise ValueError(f"all inputs must be on {q.device}")
    if s < 1 or d < 1:
        raise ValueError(f"S and D must be positive, got {(s, d)}")
    L = min(chunk, s)
    if not 1 <= L <= MAX_CHUNK:
        raise ValueError(f"the kernel takes chunks of 1..{MAX_CHUNK} steps, "
                         f"got {chunk}")
    q, k, v, dh = (t.contiguous() for t in (q, k, v, dh))
    dc, dn = (t.float().contiguous() if t is not None else None
              for t in (dc, dn))
    dq, dk, dv, dlf, dli = _run_bwd(q, k, v, log_f.float().contiguous(),
                                    log_i.float().contiguous(), dh, dc, dn, L)
    mlstm_chunkwise_bwd.launches += 1
    BWD_ROUTES[_route_of(q, k, v, L)] += 1
    return dq, dk, dv, dlf.to(log_f.dtype), dli.to(log_i.dtype)


#: Launches per route (:func:`_route`), read as ``mlstm_chunkwise.routes``
#: and ``mlstm_chunkwise_bwd.routes``; ``ops.reset_counts`` clears them.
#: Module dicts, so a stand-in that takes a wrapper's name (a planted fault)
#: still counts into them.
ROUTES = dict.fromkeys(("wgmma", "simt"), 0)
BWD_ROUTES = dict.fromkeys(("wgmma", "simt"), 0)
mlstm_chunkwise.launches = 0
mlstm_chunkwise.routes = ROUTES
mlstm_chunkwise_bwd.launches = 0
mlstm_chunkwise_bwd.routes = BWD_ROUTES
