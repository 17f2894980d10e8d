"""Plain PyTorch versions of the ported kernels (``repro.kernels.ref``).

Each function is the ground truth its CUDA kernel is held against on the
card, and what the kernel wrappers run for a CPU tensor.  Arithmetic is in
float32, as in the JAX oracles.  On the card a float32 matrix product must
not use TF32: callers that compare keep
``torch.backends.cuda.matmul.allow_tf32`` False (PyTorch's default).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.core.sma import EPILOGUES

#: Mask value of the paged oracle: finite, so a fully-masked row stays
#: finite (``repro.kernels.ref.paged_attention_ref``).
NEG_INF = -1e30


def gemm_ref(a: torch.Tensor, b: torch.Tensor, *,
             bias: Optional[torch.Tensor] = None,
             epilogue: str = "none") -> torch.Tensor:
    """C = epilogue(A @ B + bias), accumulated in float32, returned in
    A's dtype.  a (..., K); b (K, N); bias (N,)."""
    out = torch.matmul(a.float(), b.float())
    if bias is not None:
        out = out + bias.float()
    return EPILOGUES[epilogue](out).to(a.dtype)


def rms_inverse(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Row inverse RMS ``rsqrt(mean(x^2) + eps)`` in float32, (..., 1)."""
    x32 = x.float()
    return torch.rsqrt(x32.square().mean(-1, keepdim=True) + eps)


def rmsnorm_gemm_ref(x: torch.Tensor, scale: torch.Tensor, w: torch.Tensor,
                     *, epilogue: str = "none",
                     eps: float = 1e-6) -> torch.Tensor:
    """epilogue(rmsnorm(x; scale) @ w); the normalized rows are rounded to
    x's dtype before the product, as in the JAX oracle."""
    normed = (x.float() * rms_inverse(x, eps) * scale.float()).to(x.dtype)
    out = torch.matmul(normed.float(), w.float())
    return EPILOGUES[epilogue](out).to(x.dtype)


def _masked_softmax_pv(logits: torch.Tensor, valid: torch.Tensor,
                       v: torch.Tensor, pattern: str) -> torch.Tensor:
    """softmax over the valid keys, then the product with v; a row with no
    valid key gives 0 (the kernel's ``l == 0`` rule), never NaN."""
    logits = torch.where(valid, logits, torch.full_like(logits, NEG_INF))
    p = torch.exp(logits - logits.amax(-1, keepdim=True)) * valid
    l = p.sum(-1, keepdim=True)
    out = torch.einsum(pattern, p, v)
    return out / torch.where(l == 0, torch.ones_like(l), l)


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, cache_len: torch.Tensor, *,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Single-token GQA attention over a partly filled cache.

    q (B, Hq, D); k/v_cache (B, Hkv, Smax, D); cache_len (B,).  Returns
    (B, Hq, D).  Each KV head serves its g = Hq/Hkv query rows (the cache
    is never expanded).  A row with ``cache_len == 0`` gives 0, as the
    kernel does.
    """
    b, hq, d = q.shape
    hkv, smax = k_cache.shape[1], k_cache.shape[2]
    g = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    q4 = q.reshape(b, hkv, g, d).float() * scale
    logits = torch.einsum("bhgd,bhkd->bhgk", q4, k_cache.float())
    pos = torch.arange(smax, device=q.device)
    valid = (pos[None, :] < cache_len[:, None].to(pos.dtype))[:, None, None]
    out = _masked_softmax_pv(logits, valid, v_cache.float(),
                             "bhgk,bhkd->bhgd")
    return out.reshape(b, hq, d).to(q.dtype)


def _gather_pages(pool: torch.Tensor, block_table: torch.Tensor
                  ) -> torch.Tensor:
    """(NB, Hkv, BS, D) pool -> (B, Hkv, MB*BS, D) per-request cache.
    Sentinel entries clamp into a real block whose positions the callers'
    masks exclude."""
    nb, hkv, bs, d = pool.shape
    b, mb = block_table.shape
    bt = block_table.long().clamp(0, nb - 1)
    return pool[bt].permute(0, 2, 1, 3, 4).reshape(b, hkv, mb * bs, d)


def paged_decode_attention_ref(q: torch.Tensor, k_pool: torch.Tensor,
                               v_pool: torch.Tensor,
                               block_table: torch.Tensor,
                               kv_len: torch.Tensor, *,
                               scale: Optional[float] = None
                               ) -> torch.Tensor:
    """Plain version of the paged decode kernel: gather each request's
    pages, then :func:`decode_attention_ref`.  q (B, Hq, D); returns
    (B, Hq, D).  Matches the JAX kernel path (page gather + decode kernel),
    including 0 for ``kv_len == 0``."""
    k = _gather_pages(k_pool, block_table)
    v = _gather_pages(v_pool, block_table)
    return decode_attention_ref(q, k, v, kv_len, scale=scale)


def flash_mask(sq: int, skv: int, *, causal: bool, window: Optional[int],
               device: torch.device) -> torch.Tensor:
    """(Sq, Skv) visibility of the flash kernel: queries end-aligned (row
    i at position i + Skv - Sq), causal keys <= position, windowed keys >
    position - window."""
    q_pos = torch.arange(sq, device=device)[:, None] + (skv - sq)
    k_pos = torch.arange(skv, device=device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    return mask


def _flash_scores(q: torch.Tensor, k: torch.Tensor, scale: float
                  ) -> torch.Tensor:
    """Scaled f32 scores (B, Hkv, g, Sq, Skv); each KV head serves its
    g = Hq / Hkv query heads (never replicated)."""
    b, hq, sq, d = q.shape
    hkv = k.shape[1]
    q5 = q.reshape(b, hkv, hq // hkv, sq, d).float()
    return torch.einsum("bhgqd,bhkd->bhgqk", q5, k.float()) * scale


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: Optional[int] = None,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the flash kernel, with its semantics (those of the
    TPU kernel, not of ``mha_ref``): q (B, Hq, Sq, D), k/v (B, Hkv, Skv,
    D), queries end-aligned, query head h reads KV head h // group.  Masked
    scores are -1e30 and contribute exactly 0; a row that sees no key has
    l == 0 and gives 0.  Returns (out in q's dtype, lse (B, Hq, Sq) f32,
    +inf where l == 0)."""
    b, hq, sq, d = q.shape
    skv = k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    mask = flash_mask(sq, skv, causal=causal, window=window, device=q.device)
    s = torch.where(mask, _flash_scores(q, k, scale), NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m) * mask
    l = p.sum(-1, keepdim=True)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    out = out / torch.where(l == 0, torch.ones_like(l), l)
    lse = torch.where(l > 0, m + torch.log(l), torch.full_like(l, math.inf))
    return (out.reshape(b, hq, sq, d).to(q.dtype),
            lse.reshape(b, hq, sq))


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, out: torch.Tensor,
                            lse: torch.Tensor, dout: torch.Tensor, *,
                            causal: bool = True,
                            window: Optional[int] = None,
                            scale: Optional[float] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Plain version of the flash backward kernel, written out (not
    autograd of the forward): P = exp(S * scale - lse) on the visible
    pairs, D = rowsum(dO * O), dS = P * (dP - D) with dP = dO V^T; then
    dV = P^T dO, dK = dS^T Q * scale, dQ = dS K * scale, with dK and dV
    summed over each KV head's query heads.  Returns (dq, dk, dv) in the
    inputs' dtype."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    mask = flash_mask(sq, skv, causal=causal, window=window, device=q.device)
    s = _flash_scores(q, k, scale)
    lse5 = lse.reshape(b, hkv, g, sq, 1).float()
    p = torch.exp(torch.where(mask, s - lse5, -math.inf))
    do5 = dout.reshape(b, hkv, g, sq, d).float()
    delta = (do5 * out.reshape(b, hkv, g, sq, d).float()).sum(-1,
                                                               keepdim=True)
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p, do5)
    dp = torch.einsum("bhgqd,bhkd->bhgqk", do5, v.float())
    ds = p * (dp - delta)
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, k.float()) * scale
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds,
                      q.reshape(b, hkv, g, sq, d).float()) * scale
    return (dq.reshape(b, hq, sq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def paged_attention_ref(q: torch.Tensor, k_pool: torch.Tensor,
                        v_pool: torch.Tensor, block_table: torch.Tensor,
                        q_pos: torch.Tensor, kv_len: torch.Tensor, *,
                        window: Optional[int] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Block-table attention over a paged pool (decode and chunked prefill).

    q (B, C, Hq, D); k/v_pool (NB, Hkv, BS, D); block_table (B, MB), entries
    >= NB unallocated; q_pos (B, C) absolute query positions; kv_len (B,)
    valid length including this chunk.  Returns (B, C, Hq, D).  Masking
    uses -1e30, so a fully masked row is a finite (uniform) average, as in
    ``repro.kernels.ref.paged_attention_ref``.
    """
    b, c, hq, d = q.shape
    hkv = k_pool.shape[1]
    g = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    k = _gather_pages(k_pool, block_table).float()
    v = _gather_pages(v_pool, block_table).float()
    q5 = q.reshape(b, c, hkv, g, d).float() * scale
    logits = torch.einsum("bchgd,bhkd->bchgk", q5, k)
    k_pos = torch.arange(k.shape[2], device=q.device)
    qp = q_pos.long()
    mask = k_pos[None, None, :] < kv_len.long()[:, None, None]
    mask = mask & (k_pos[None, None, :] <= qp[:, :, None])
    if window is not None:
        mask = mask & (k_pos[None, None, :] > qp[:, :, None] - window)
    logits = torch.where(mask[:, :, None, None, :], logits,
                         torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bchgk,bhkd->bchgd", probs, v)
    return out.reshape(b, c, hq, d).to(q.dtype)
