"""Decode attention for Hopper: one new token against a paged KV pool.

Replaces the Pallas kernel ``repro/kernels/decode_attention.py:78``
(``decode_attention``) and the page gather that
``repro/backends/pallas_backend.py:82`` puts in front of it.  The CUDA
kernel (``csrc/decode_attention.cu``) reads pages in place through the
block table, one block per (request, KV head) serving its g = Hq/Hkv query
rows, and walks only pages below ``ceil(kv_len / BS)``, so sentinel table
entries are never read.  Online softmax in f32 with a -1e30 mask;
``kv_len == 0`` gives 0.  An entry outside ``[0, NB)`` below ``kv_len``
(or ``kv_len`` past the table) is not clamped: that request's output is
NaN, where the plain version clamps into a real block as JAX's gather does.

Bound on an H100: bytes (each valid K/V row is read once).

Two entries share the kernel:

* :func:`paged_decode_attention` -- q (B, Hq, D) against (NB, Hkv, BS, D)
  pools through a (B, MB) table; plain version
  :func:`repro_torch.kernels.ref.paged_decode_attention_ref`.
* :func:`decode_attention` -- q (B, Hq, D) against a contiguous
  (B, Hkv, Smax, D) cache; the wrapper passes the cache as a pool of B
  blocks of Smax positions and the table ``arange(B)[:, None]``.  Plain
  version :func:`repro_torch.kernels.ref.decode_attention_ref`.

Each wrapper runs its plain version only for CPU tensors; for CUDA tensors
it launches the kernel or raises, and counts its launches in ``.launches``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (decode_attention_ref,
                                     paged_decode_attention_ref)
from repro_torch.kernels.sma_gemm import DTYPE_CODES

#: Shared memory one block may take without opting in to more.
_SMEM_LIMIT = 48 * 1024
_TILES = (64, 32, 16)

#: q, k_pool, v_pool, table, kv_len, out; B, Hq, Hkv, D, NB, BS, MB, tile;
#: scale; dtype; stream.
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_float]
             + [ctypes.c_int, ctypes.c_void_p])


def _lib() -> ctypes.CDLL:
    return _build.load("decode_attention",
                       {"paged_decode_attention_launch": _ARGTYPES})


def _tile(g: int, d: int) -> int:
    """Tokens per shared-memory step: the largest that fits one block."""
    for tile in _TILES:
        if 4 * (2 * tile * (d + 1) + g * tile + 2 * g * d + 3 * g) \
                <= _SMEM_LIMIT:
            return tile
    raise ValueError(f"decode attention with g={g}, head_dim={d} does not "
                     f"fit {_SMEM_LIMIT} bytes of shared memory")


def _launch(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
            block_table: torch.Tensor, kv_len: torch.Tensor,
            scale: Optional[float]) -> torch.Tensor:
    """Check and launch the paged kernel; q (B, Hq, D), pools
    (NB, Hkv, BS, D), table (B, MB).  Returns (B, Hq, D)."""
    b, hq, d = q.shape
    nb, hkv, bs, d2 = k_pool.shape
    if d2 != d or v_pool.shape != k_pool.shape or hq % hkv:
        raise ValueError(f"shapes do not match: q {tuple(q.shape)}, pools "
                         f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)}")
    if block_table.shape[0] != b or kv_len.shape != (b,):
        raise ValueError(f"table {tuple(block_table.shape)} / kv_len "
                         f"{tuple(kv_len.shape)} do not match B={b}")
    for t in (k_pool, v_pool, block_table, kv_len):
        if t.device != q.device:
            raise ValueError(f"all inputs must be on {q.device}")
    if q.dtype not in DTYPE_CODES or k_pool.dtype != q.dtype \
            or v_pool.dtype != q.dtype:
        raise ValueError(f"q and pools must share one of f32/bf16/f16, got "
                         f"{q.dtype}, {k_pool.dtype}, {v_pool.dtype}")
    vec = 16 // q.element_size()
    if d % vec:
        raise ValueError(f"head_dim {d} must be a multiple of {vec}")
    if not (k_pool.is_contiguous() and v_pool.is_contiguous()):
        raise ValueError("pools must be contiguous (they are read in place)")
    q = q.contiguous()
    table = block_table.to(torch.int32).contiguous()
    lens = kv_len.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    if b == 0:
        return out
    scale = float(scale) if scale is not None else d ** -0.5
    lib = _lib()
    with torch.cuda.device(q.device):
        err = lib.paged_decode_attention_launch(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            table.data_ptr(), lens.data_ptr(), out.data_ptr(), b, hq, hkv, d,
            nb, bs, table.shape[1], _tile(hq // hkv, d), scale,
            DTYPE_CODES[q.dtype], _build.stream_of(q))
    _build.check(lib, err, "decode_attention")
    return out


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
                     scale: Optional[float] = None) -> torch.Tensor:
    """Single-token GQA attention over a contiguous cache.

    q (B, Hq, D); k/v_cache (B, Hkv, Smax, D); cache_len (B,).  Returns
    (B, Hq, D).
    """
    if not _build.on_card("decode_attention", q):
        return decode_attention_ref(q, k_cache, v_cache, cache_len,
                                    scale=scale)
    b = q.shape[0]
    table = torch.arange(b, dtype=torch.int32, device=q.device)[:, None]
    out = _launch(q, k_cache, v_cache, table, cache_len, scale)
    decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
decode_attention.launches = 0
