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
``mlstm_chunkwise.launches``.  There is no backward kernel (the TPU kernel
has none either); :func:`repro_torch.kernels.ops.mlstm_chunkwise` refuses
a gradient on the card.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import mlstm_chunkwise_ref
from repro_torch.kernels.sma_gemm import DTYPE_CODES

#: The longest chunk the kernels hold.
MAX_CHUNK = 128
#: The chunk of the ``wgmma`` route.
WGMMA_CHUNK = 128

#: simt: q, k, v, log_f, log_i, out, C, n, m; B*H, S, D, L, dtype; stream.
_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
#: wgmma: q, k, v, log_f, log_i, out, C, n, m, gates, chunks, sd, rowsum,
#: ck, nk; B*H, S, D, dtype, plant; stream.
_WG_ARGTYPES = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 5
                + [ctypes.c_void_p])


def _lib() -> ctypes.CDLL:
    return _build.load("mlstm_chunkwise",
                       {"mlstm_chunkwise_launch": _ARGTYPES,
                        "mlstm_chunkwise_wgmma_launch": _WG_ARGTYPES,
                        "mlstm_chunkwise_wgmma_smem": [ctypes.c_int]})


def wgmma_smem() -> dict:
    """Dynamic shared memory (bytes) of the ``wgmma`` route's S . D, state
    and output kernels, as the built library sizes them."""
    lib = _lib()
    return {name: lib.mlstm_chunkwise_wgmma_smem(i)
            for i, name in enumerate(("intra", "state", "output"))}


def _route(s: int, d: int, chunk: int, dtype: torch.dtype,
           aligned: bool) -> str:
    """``"wgmma"`` for 16-bit q/k/v with D % 64 == 0, chunks of exactly
    :data:`WGMMA_CHUNK` steps (L = min(chunk, S)) and aligned bases, else
    ``"simt"``."""
    if (dtype in (torch.bfloat16, torch.float16) and aligned
            and d % 64 == 0 and min(chunk, s) == WGMMA_CHUNK):
        return "wgmma"
    return "simt"


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
    b, h, s, d = q.shape
    bh = b * h
    out = torch.empty_like(q)
    c = torch.empty((b, h, d, d), dtype=torch.float32, device=q.device)
    n = torch.empty((b, h, d), dtype=torch.float32, device=q.device)
    m = torch.empty((b, h), dtype=torch.float32, device=q.device)
    lib = _lib()
    if route == "simt":
        if plant:
            raise ValueError("the simt kernel takes no planted faults")
        with torch.cuda.device(q.device):
            err = lib.mlstm_chunkwise_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), lf.data_ptr(),
                li.data_ptr(), out.data_ptr(), c.data_ptr(), n.data_ptr(),
                m.data_ptr(), bh, s, d, L, DTYPE_CODES[q.dtype],
                _build.stream_of(q))
    elif route == "wgmma" and L == WGMMA_CHUNK:
        nc = -(-s // L)
        slabs = bh * max(nc - 1, 1)
        f32 = dict(dtype=torch.float32, device=q.device)
        gates = torch.empty(bh * (5 * nc * L + 3 * nc), **f32)
        chunks = gates[bh * 5 * nc * L:]
        sd = torch.empty((2, bh * nc, L, L), dtype=q.dtype, device=q.device)
        rowsum = torch.empty(bh * nc * L, **f32)
        ck = torch.empty((2, slabs, d, d), dtype=q.dtype, device=q.device)
        nk = torch.empty(slabs * d, **f32)
        with torch.cuda.device(q.device):
            err = lib.mlstm_chunkwise_wgmma_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), lf.data_ptr(),
                li.data_ptr(), out.data_ptr(), c.data_ptr(), n.data_ptr(),
                m.data_ptr(), gates.data_ptr(), chunks.data_ptr(),
                sd.data_ptr(), rowsum.data_ptr(), ck.data_ptr(),
                nk.data_ptr(), bh, s, d, DTYPE_CODES[q.dtype], plant,
                _build.stream_of(q))
    else:
        raise ValueError(f"mlstm_chunkwise has no route {route!r} for "
                         f"chunks of {L}")
    _build.check(lib, err, f"mlstm_chunkwise ({route})")
    return out, c, n, m


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
    aligned = all(t.data_ptr() % 16 == 0 for t in (q, k, v))
    route = _route(s, d, chunk, q.dtype, aligned)
    out, c, n, m = _run(q, k, v, log_f.float().contiguous(),
                        log_i.float().contiguous(), L, route)
    mlstm_chunkwise.launches += 1
    ROUTES[route] += 1
    return (out, (c, n, m)) if return_state else out


#: Launches per route (:func:`_route`), read as ``mlstm_chunkwise.routes``;
#: ``ops.reset_counts`` clears them.  A module dict, so a stand-in that
#: takes the wrapper's name (a planted fault) still counts into it.
ROUTES = dict.fromkeys(("wgmma", "simt"), 0)
mlstm_chunkwise.launches = 0
mlstm_chunkwise.routes = ROUTES
