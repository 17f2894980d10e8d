"""Decode attention for Hopper: one new token against a paged KV pool.

Replaces the Pallas kernel ``repro/kernels/decode_attention.py:78``
(``decode_attention``) and the page gather that
``repro/backends/pallas_backend.py:82`` puts in front of it.  The CUDA
kernels (``csrc/decode_attention.cu``) read pages in place through the
block table and walk only positions below ``kv_len``, so sentinel table
entries are never read.  Online softmax in f32 with a -1e30 mask;
``kv_len == 0`` gives 0.  An entry outside ``[0, NB)`` below ``kv_len``
(or ``kv_len`` past the table) is not clamped: that request's output is
NaN, where the plain version clamps into a real block as JAX's gather does.

Bound on an H100: bytes (each valid K/V row is read once).

Split-KV ("flash-decoding") design, two launches on the current stream:
the partial pass, grid (Hkv, B, splits), walks one range of positions for
a (request, KV head) and its g = Hq/Hkv query rows, the head_dim spread
across the lanes of a warp (16-byte loads straight into registers, scores
reduced by shuffles), and writes an f32 (m, l, accumulator) per query row
into a scratch tensor this wrapper allocates; the merge pass folds the
partials in split order.  :func:`_splits` picks the ranges from B, Hkv and
the table's capacity alone, so a call shape always has one launch shape;
:func:`repro_torch.kernels.ref.decode_attention_split_ref` is the same
split-then-merge in plain PyTorch.

Two entries share the kernels:

* :func:`paged_decode_attention` -- q (B, Hq, D) against (NB, Hkv, BS, D)
  pools through a (B, MB) table; plain version
  :func:`repro_torch.kernels.ref.paged_decode_attention_ref`.
* :func:`decode_attention` -- q (B, Hq, D) against a contiguous
  (B, Hkv, Smax, D) cache, passed as a pool of B blocks of Smax positions
  with no table (block b is request b's); ``cache_len`` past Smax is
  clamped (every position valid, as in the plain version).  Plain version
  :func:`repro_torch.kernels.ref.decode_attention_ref`.  With
  ``return_lse`` (decode context parallelism,
  :mod:`repro_torch.distributed.context_parallel`) the merge pass writes
  the output unrounded in f32 and each row's log-sum-exp ``m + log l``
  beside it: ``-inf`` and 0 for a row with no position, a rank whose slice
  of the cache holds none yet.

Each wrapper runs its plain version only for CPU tensors; for CUDA tensors
it launches the kernels or raises, and counts one launch per call in
``.launches``; :data:`ROUTES` counts the contiguous entry's launches by
output (``out``, or ``lse``: the f32 output and its log-sum-exp).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (decode_attention_ref,
                                     paged_decode_attention_ref)
from repro_torch.kernels.sma_gemm import DTYPE_CODES

#: Partial-pass blocks to aim for: two per SM on an H100's 132.
_BLOCKS = 264
#: Fewest positions a split walks (one tile), and the most splits the merge
#: pass takes (``kMaxSplits`` in ``csrc/decode_attention.cu``).
_TILE = 32
_MAX_SPLITS = 512
#: The most query rows per KV head that a partial block holds.
_MAX_G = 16

#: q, k_pool, v_pool, table, kv_len, part, out; B, Hq, Hkv, D, NB, BS, MB,
#: splits; scale; dtype; stream; out32, lse (null but for ``return_lse``).
_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_float]
             + [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_void_p] * 2)

#: The contiguous entry's launches by output (``ops.reset_counts`` zeroes
#: them).
ROUTES = {"out": 0, "lse": 0}


def _lib() -> ctypes.CDLL:
    return _build.load("decode_attention",
                       {"paged_decode_attention_launch": _ARGTYPES})


def _splits(b: int, hkv: int, max_len: int) -> int:
    """Position ranges per (request, KV head): enough for ``_BLOCKS``
    partial blocks, each range at least ``_TILE`` positions of the table's
    capacity ``max_len``.  Depends on the call shape only, never on
    ``kv_len``."""
    want = -(-_BLOCKS // max(b * hkv, 1))
    return max(1, min(want, max_len // _TILE, _MAX_SPLITS))


def _check_head(g: int, d: int, vec: int) -> None:
    """A lane holds one or two 16-byte chunks of a row, so head_dim is at
    most 32 chunks (one each, lanes in groups of a power of two) or 64."""
    chunks = d // vec
    if d % vec or not (chunks <= 32 or (chunks % 32 == 0 and chunks <= 64)):
        raise ValueError(f"head_dim {d} must be a multiple of {vec} and at "
                         f"most {32 * vec}, or {64 * vec}")
    if g > _MAX_G:
        raise ValueError(f"decode attention serves at most {_MAX_G} query "
                         f"heads per KV head, got {g}")


def _launch(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
            block_table: Optional[torch.Tensor], kv_len: torch.Tensor,
            scale: Optional[float], return_lse: bool = False):
    """Check and launch the kernels; q (B, Hq, D), pools (NB, Hkv, BS, D),
    table (B, MB), or None for a contiguous cache (pool block b is request
    b's, kv_len clamped to BS).  Returns (B, Hq, D), or with
    ``return_lse`` its f32 form and the (B, Hq) f32 log-sum-exp."""
    b, hq, d = q.shape
    nb, hkv, bs, d2 = k_pool.shape
    if d2 != d or v_pool.shape != k_pool.shape or hq % hkv:
        raise ValueError(f"shapes do not match: q {tuple(q.shape)}, pools "
                         f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)}")
    rows = nb if block_table is None else block_table.shape[0]
    if rows != b or kv_len.shape != (b,):
        raise ValueError(f"table/cache rows {rows} / kv_len "
                         f"{tuple(kv_len.shape)} do not match B={b}")
    for t in (k_pool, v_pool, kv_len) + (
            () if block_table is None else (block_table,)):
        if t.device != q.device:
            raise ValueError(f"all inputs must be on {q.device}")
    if q.dtype not in DTYPE_CODES or k_pool.dtype != q.dtype \
            or v_pool.dtype != q.dtype:
        raise ValueError(f"q and pools must share one of f32/bf16/f16, got "
                         f"{q.dtype}, {k_pool.dtype}, {v_pool.dtype}")
    _check_head(hq // hkv, d, 16 // q.element_size())
    if not (k_pool.is_contiguous() and v_pool.is_contiguous()):
        raise ValueError("pools must be contiguous (they are read in place)")
    q = q.contiguous()
    table = None if block_table is None else \
        block_table.to(torch.int32).contiguous()
    lens = kv_len.to(torch.int32).contiguous()
    out = torch.empty(q.shape, dtype=torch.float32 if return_lse
                      else q.dtype, device=q.device)
    lse = (torch.empty((b, hq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if b == 0:
        return (out, lse) if return_lse else out
    mb = 1 if table is None else table.shape[1]
    splits = _splits(b, hkv, mb * bs)
    part = torch.empty(b * hq * splits * (d + 2), dtype=torch.float32,
                       device=q.device)
    scale = float(scale) if scale is not None else d ** -0.5
    lib = _lib()
    with torch.cuda.device(q.device):
        err = lib.paged_decode_attention_launch(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            None if table is None else table.data_ptr(), lens.data_ptr(),
            part.data_ptr(), None if return_lse else out.data_ptr(), b, hq,
            hkv, d, nb, bs, mb, splits, scale, DTYPE_CODES[q.dtype],
            _build.stream_of(q), out.data_ptr() if return_lse else None,
            lse.data_ptr() if return_lse else None)
    _build.check(lib, err, "decode_attention")
    return (out, lse) if return_lse else out


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_table: torch.Tensor,
                           kv_len: torch.Tensor, *,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Single-token GQA attention through a block table.

    q (B, Hq, D); k/v_pool (NB, Hkv, BS, D); block_table (B, MB) int32 with
    entries >= NB unallocated; kv_len (B,) valid lengths including the new
    token.  Returns (B, Hq, D).
    """
    if not _build.on_card("paged_decode_attention", q):
        return paged_decode_attention_ref(q, k_pool, v_pool, block_table,
                                          kv_len, scale=scale)
    out = _launch(q, k_pool, v_pool, block_table, kv_len, scale)
    paged_decode_attention.launches += 1
    return out


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: torch.Tensor, *,
                     scale: Optional[float] = None,
                     return_lse: bool = False):
    """Single-token GQA attention over a contiguous cache.

    q (B, Hq, D); k/v_cache (B, Hkv, Smax, D); cache_len (B,).  Returns
    (B, Hq, D) in q's dtype; with ``return_lse``, (out (B, Hq, D) float32,
    lse (B, Hq) float32), lse = -inf and out = 0 where cache_len is 0.
    """
    if not _build.on_card("decode_attention", q):
        return decode_attention_ref(q, k_cache, v_cache, cache_len,
                                    scale=scale, return_lse=return_lse)
    out = _launch(q, k_cache, v_cache, None, cache_len, scale, return_lse)
    decode_attention.launches += 1
    ROUTES["lse" if return_lse else "out"] += 1
    return out


paged_decode_attention.launches = 0
decode_attention.launches = 0
decode_attention.routes = ROUTES
