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
    A's dtype.  a (..., K); b (K, N); bias (N,).  The leading dims of a
    are collapsed by a reshape before one ``mm``, so the product runs as
    the same op eagerly and in a traced graph (``matmul`` of a strided
    3-D operand may take ``bmm`` in one and ``mm`` in the other)."""
    a32 = a.float()
    if a32.dim() == 2:
        out = torch.mm(a32, b.float())
    else:
        out = torch.mm(a32.reshape(-1, a32.shape[-1]), b.float()).view(
            *a32.shape[:-1], b.shape[-1])
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
                       v: torch.Tensor, pattern: str, with_lse: bool = False):
    """softmax over the valid keys, then the product with v; a row with no
    valid key gives 0 (the kernel's ``l == 0`` rule), never NaN.  With
    ``with_lse`` also each row's log-sum-exp ``m + log l`` over the valid
    keys (-inf where there is none)."""
    logits = torch.where(valid, logits, torch.full_like(logits, NEG_INF))
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m) * valid
    l = p.sum(-1, keepdim=True)
    out = torch.einsum(pattern, p, v)
    out = out / torch.where(l == 0, torch.ones_like(l), l)
    if not with_lse:
        return out
    lse = torch.where(l > 0, m + torch.log(l), -math.inf)
    return out, lse[..., 0]


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, cache_len: torch.Tensor, *,
                         scale: Optional[float] = None,
                         return_lse: bool = False):
    """Single-token GQA attention over a partly filled cache.

    q (B, Hq, D); k/v_cache (B, Hkv, Smax, D); cache_len (B,).  Returns
    (B, Hq, D).  Each KV head serves its g = Hq/Hkv query rows (the cache
    is never expanded).  A row with ``cache_len == 0`` gives 0, as the
    kernel does.  With ``return_lse``: (out (B, Hq, D) float32, unrounded;
    lse (B, Hq) float32, the log of each row's softmax denominator over
    the scaled scores, -inf where ``cache_len`` is 0).
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
                             "bhgk,bhkd->bhgd", with_lse=return_lse)
    if return_lse:
        out, lse = out
        return out.reshape(b, hq, d), lse.reshape(b, hq)
    return out.reshape(b, hq, d).to(q.dtype)


def decode_attention_split_ref(q: torch.Tensor, k_cache: torch.Tensor,
                               v_cache: torch.Tensor, cache_len: torch.Tensor,
                               splits: int, *,
                               scale: Optional[float] = None) -> torch.Tensor:
    """:func:`decode_attention_ref` as the split-KV kernel computes it.

    Positions are cut into ``splits`` ranges of ``ceil(Smax / splits)``;
    each range gives, per query row, the f32 partial (m, l, acc) of its
    valid positions (m = -1e30, l = 0 where it has none), and the partials
    are folded in split order: m = max m_i, l = sum l_i e^(m_i - m),
    out = sum acc_i e^(m_i - m) / l, 0 where l == 0.
    """
    b, hq, d = q.shape
    hkv, smax = k_cache.shape[1], k_cache.shape[2]
    g = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    q4 = q.reshape(b, hkv, g, d).float() * scale
    chunk = -(-smax // splits)
    lens = cache_len.to(torch.int64)[:, None, None]
    ms, ls, accs = [], [], []
    for s in range(splits):
        p0, p1 = s * chunk, min((s + 1) * chunk, smax)
        k = k_cache[:, :, p0:p1].float()
        logits = torch.einsum("bhgd,bhkd->bhgk", q4, k)
        pos = torch.arange(p0, p0 + logits.shape[-1], device=q.device)
        valid = pos[None, None, None, :] < lens[..., None]
        logits = torch.where(valid, logits, torch.full_like(logits, NEG_INF))
        m = logits.amax(-1) if p1 > p0 else torch.full(
            (b, hkv, g), NEG_INF, device=q.device)
        m = torch.where(valid.any(-1), m, torch.full_like(m, NEG_INF))
        p = torch.exp(logits - m[..., None]) * valid
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("bhgk,bhkd->bhgd", p,
                                 v_cache[:, :, p0:p1].float()))
    m = torch.stack(ms).amax(0)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(accs[0])
    for m_i, l_i, acc_i in zip(ms, ls, accs):
        w = torch.exp(m_i - m)
        l = l + l_i * w
        acc = acc + acc_i * w[..., None]
    out = acc / torch.where(l == 0, torch.ones_like(l), l)[..., None]
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


#: Rows of a query tile, keys of a key tile and of a dS slot in the flash
#: backward at head_dim 256 (``csrc/flash_attention.cu``, ``Bwd256``).
BWD256_TILE = 64
#: Planted faults of the flash backward at head_dim 256 and of
#: :func:`flash_attention_bwd256_split_ref` (a bit mask; must match
#: ``csrc/flash_attention.cu``): pass 1 skips the middle key tile (its dK,
#: dV zeros, its dS slots zeros); pass 2 leaves the last key tile out of
#: every query tile's sum.
FLASH_PLANT_KEY_TILE, FLASH_PLANT_DQ_TILE = 1, 2


def bwd256_scratch_layout(sq: int, skv: int, *, causal: bool,
                          window: Optional[int]
                          ) -> Tuple[list, list, int]:
    """The banded dS scratch of the flash backward at head_dim 256: for
    each 64-row query tile, the key tiles ``[kt0, kt1)`` it sees (the
    forward's ``run`` bounds) and its first slot, one 64 x 64 dS tile a
    (query tile, key tile) pair in ascending key order.  Returns (bands,
    bases, slots), ``slots`` those of one (batch, query head); the kernel
    computes the same (``key_band``, ``slot_base``)."""
    t = BWD256_TILE
    off = skv - sq
    bands, bases, total = [], [], 0
    for it in range(-(-sq // t)):
        first, last = it * t + off, min(it * t + t, sq) - 1 + off
        lo, hi = 0, skv
        if causal:
            hi = min(hi, last + 1)
        if window:
            lo = max(lo, first - window + 1)
        kt0 = lo // t
        kt1 = -(-hi // t) if hi > lo else kt0
        bands.append((kt0, kt1))
        bases.append(total)
        total += kt1 - kt0
    return bands, bases, total


def flash_attention_bwd256_split_ref(q: torch.Tensor, k: torch.Tensor,
                                     v: torch.Tensor, out: torch.Tensor,
                                     lse: torch.Tensor, dout: torch.Tensor, *,
                                     causal: bool = True,
                                     window: Optional[int] = None,
                                     scale: Optional[float] = None,
                                     plant: int = 0
                                     ) -> Tuple[torch.Tensor, torch.Tensor,
                                                torch.Tensor]:
    """The algorithm of the flash backward's two passes at head_dim 256 in
    plain PyTorch: the function of :func:`flash_attention_bwd_ref`,
    computed in the kernels' passes and with their roundings, for the
    tests (never on a main path).

    1. Per 64-key tile: dV = sum of P^T dO with P rounded to q's dtype; dS
       = P (dP - D) in f32, rounded once to q's dtype; dK = scale * sum of
       dS^T Q; each dS tile the tile's query tiles see goes to its slot of
       the banded scratch (:func:`bwd256_scratch_layout`).
    2. Per 64-row query tile: dQ = scale * the sum of dS K over the key
       tiles it sees, in ascending order.

    ``plant`` is a mask of ``FLASH_PLANT_*`` faults (0: none).  Returns
    (dq, dk, dv) in the inputs' dtype."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    t = BWD256_TILE
    scale = scale if scale is not None else d ** -0.5
    bands, bases, slots = bwd256_scratch_layout(sq, skv, causal=causal,
                                                window=window)
    mask = flash_mask(sq, skv, causal=causal, window=window, device=q.device)
    q5 = q.reshape(b, hkv, g, sq, d).float()
    s = _flash_scores(q, k, scale)
    p = torch.exp(torch.where(mask, s - lse.reshape(b, hkv, g, sq, 1).float(),
                              -math.inf))
    do5 = dout.reshape(b, hkv, g, sq, d).float()
    delta = (do5 * out.reshape(b, hkv, g, sq, d).float()).sum(-1,
                                                               keepdim=True)
    dp = torch.einsum("bhgqd,bhkd->bhgqk", do5, v.float())
    ds = (p * (dp - delta)).to(q.dtype)
    p16 = p.to(q.dtype).float()
    # 1. dK, dV and the dS scratch, [slot][key][query], a key tile at a time
    dk = q5.new_zeros((b, hkv, skv, d))
    dv = torch.zeros_like(dk)
    scratch = q.new_zeros((b, hkv, g, slots, t, t))
    nkt = -(-skv // t)
    skip = nkt // 2 if plant & FLASH_PLANT_KEY_TILE else -1
    for jt in range(nkt):
        if jt == skip:
            continue
        keys = slice(jt * t, min(jt * t + t, skv))
        dv[:, :, keys] = torch.einsum("bhgqk,bhgqd->bhkd", p16[..., keys],
                                      do5)
        dk[:, :, keys] = torch.einsum("bhgqk,bhgqd->bhkd",
                                      ds[..., keys].float(), q5) * scale
        for it, (kt0, kt1) in enumerate(bands):
            if kt0 <= jt < kt1:
                rows = slice(it * t, min(it * t + t, sq))
                scratch[:, :, :, bases[it] + jt - kt0,
                        :keys.stop - keys.start, :rows.stop - rows.start] = \
                    ds[:, :, :, rows, keys].transpose(-1, -2)
    # 2. dQ, a query tile at a time, its key tiles in ascending order
    dq = torch.zeros_like(q5)
    kf = k.float()
    for it, (kt0, kt1) in enumerate(bands):
        rows = slice(it * t, min(it * t + t, sq))
        if plant & FLASH_PLANT_DQ_TILE and kt1 > kt0:
            kt1 -= 1
        acc = torch.zeros_like(dq[:, :, :, rows])
        for jt in range(kt0, kt1):
            keys = slice(jt * t, min(jt * t + t, skv))
            tile = scratch[:, :, :, bases[it] + jt - kt0,
                           :keys.stop - keys.start, :rows.stop - rows.start]
            acc = acc + torch.einsum("bhgkq,bhkd->bhgqd", tile.float(),
                                     kf[:, :, keys])
        dq[:, :, :, rows] = acc * scale
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


def rglru_scan_ref(a: torch.Tensor, u: torch.Tensor,
                   h0: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the RG-LRU scan ``h_t = a_t * h_{t-1} + u_t``: a
    sequential loop over time with a float32 carry (a product, then a sum,
    each rounded to f32).  a, u (B, S, D); h0 (B, D) or None (zeros).
    Returns (h_seq (B, S, D), h_last (B, D)), both in a's dtype as the TPU
    kernel returns them (``repro.kernels.ref.rglru_ref`` returns h_last in
    f32; the kernel rounds it)."""
    b, s, d = a.shape
    h = (torch.zeros((b, d), dtype=torch.float32, device=a.device)
         if h0 is None else h0.float())
    out = torch.empty((b, s, d), dtype=a.dtype, device=a.device)
    for t in range(s):
        h = a[:, t].float() * h + u[:, t].float()
        out[:, t] = h
    return out, h.to(a.dtype)


def rglru_scan_bwd_ref(a: torch.Tensor, h_seq: torch.Tensor,
                       dh: torch.Tensor, h0: Optional[torch.Tensor] = None,
                       dh_last: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor,
                                  Optional[torch.Tensor]]:
    """Plain version of the RG-LRU scan's backward: the explicit reverse
    loop with a float32 carry c (``dh_last``, or zeros), for t = S - 1
    down to 0: ``g = dh_t + c`` (the gradient of h_t), ``du_t = g``,
    ``da_t = g * h_{t-1}``, ``c = a_t * g``; each product and sum rounded
    to f32.  h_{t-1} is read from the forward's ``h_seq`` (h0, or zeros,
    at t = 0), so in f32 this is the gradient of :func:`rglru_scan_ref`
    exactly; in a 16-bit dtype h_seq is the carry rounded once.  a, h_seq,
    dh (B, S, D); h0, dh_last (B, D) or None.  Returns (da, du, dh0 = c
    after t = 0, or None without h0), in a's (and h0's) dtype."""
    b, s, d = a.shape
    c = (torch.zeros((b, d), dtype=torch.float32, device=a.device)
         if dh_last is None else dh_last.float())
    zero = torch.zeros((b, d), dtype=torch.float32, device=a.device)
    da = torch.empty_like(a)
    du = torch.empty_like(a)
    for t in range(s - 1, -1, -1):
        g = dh[:, t].float() + c
        du[:, t] = g
        prev = h_seq[:, t - 1].float() if t > 0 else (
            h0.float() if h0 is not None else zero)
        da[:, t] = g * prev
        c = a[:, t].float() * g
    return da, du, (c.to(h0.dtype) if h0 is not None else None)


#: Planted faults of the ``tma`` scan kernel and of
#: :func:`rglru_scan_planted_ref` (a bit mask; must match
#: ``csrc/rglru_scan.cu``), each at ring stage nst // 2 of nst: the stage
#: consumed one ring phase early (it reads the slot's previous fill, the
#: stage ``stages`` before; only where nst // 2 >= stages); the carry run
#: on through the zero-filled rows past S before h_last is taken; the
#: stage's store dropped.
SCAN_PLANT_EARLY, SCAN_PLANT_TAIL, SCAN_PLANT_STORE = 1, 2, 4


def rglru_scan_planted_ref(a: torch.Tensor, u: torch.Tensor,
                           h0: Optional[torch.Tensor], plant: int,
                           rows: int, stages: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`rglru_scan_ref` with the ``SCAN_PLANT_*`` faults of
    ``plant`` made as the ``tma`` kernel makes them, for ring stages of
    ``rows`` steps in a ring of ``stages`` (the output a planted kernel
    run must reproduce; its outputs start zeroed)."""
    s = a.shape[1]
    nst = -(-s // rows)
    kp = nst // 2
    lo, hi = kp * rows, min((kp + 1) * rows, s)
    if plant & SCAN_PLANT_EARLY and kp >= stages:
        a, u = a.clone(), u.clone()
        back = stages * rows
        a[:, lo:hi] = a[:, lo - back:hi - back]
        u[:, lo:hi] = u[:, lo - back:hi - back]
    h_seq, h_last = rglru_scan_ref(a, u, h0)
    if plant & SCAN_PLANT_TAIL and s % rows:
        h_last = torch.zeros_like(h_last)  # a = u = 0: the carry is 0
    if plant & SCAN_PLANT_STORE:
        h_seq[:, lo:hi] = 0
    return h_seq, h_last


def mlstm_chunkwise_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        log_f: torch.Tensor, log_i: torch.Tensor, *,
                        chunk: int, return_state: bool = False):
    """Plain version of the chunkwise mLSTM kernel (the stabilized chunkwise
    algebra of ``repro.kernels.mlstm`` and of the JAX package's XLA path,
    ``repro.backends.xla_backend.mlstm_chunkwise``), in float32.

    q/k/v (B, H, S, D); log_f/log_i (B, H, S).  Chunks of L = min(chunk,
    S) steps; a ragged tail is padded with log_f 0 and log_i -1e30 (i = 0),
    so padded steps change neither the output nor the state.  The state
    starts at zeros with m = 0.  Returns h (B, H, S, D) in q's dtype and,
    with ``return_state``, also the final (C (B, H, D, D), n (B, H, D),
    m (B, H)) in float32, the state after S steps."""
    b, h, s, d = q.shape
    scale = d ** -0.5
    L = min(chunk, s)
    pad = (-s) % L
    q32, k32, v32 = q.float() * scale, k.float(), v.float()
    lf, li = log_f.float(), log_i.float()
    if pad:
        q32, k32, v32 = (torch.nn.functional.pad(t, (0, 0, 0, pad))
                         for t in (q32, k32, v32))
        lf = torch.nn.functional.pad(lf, (0, pad))
        li = torch.nn.functional.pad(li, (0, pad), value=NEG_INF)
    c = q.new_zeros((b, h, d, d), dtype=torch.float32)
    n = q.new_zeros((b, h, d), dtype=torch.float32)
    m = q.new_zeros((b, h), dtype=torch.float32)
    tri = torch.ones((L, L), dtype=torch.bool, device=q.device).tril()
    outs = []
    for t0 in range(0, s + pad, L):
        qq, kk, vv = (t[:, :, t0:t0 + L] for t in (q32, k32, v32))
        b_cum = lf[..., t0:t0 + L].cumsum(-1)                  # (B, H, L)
        a = li[..., t0:t0 + L] - b_cum
        g = torch.maximum(m[..., None], torch.cummax(a, -1).values)
        decay0 = torch.exp(m[..., None] - g)
        s_mat = qq @ kk.transpose(-1, -2)
        d_mat = torch.where(tri, torch.exp(a[..., None, :] - g[..., None]),
                            0.0)
        sd = s_mat * d_mat
        num = decay0[..., None] * (qq @ c) + sd @ vv
        qn0 = (qq @ n[..., None])[..., 0]
        den = torch.maximum((decay0 * qn0 + sd.sum(-1)).abs(),
                            torch.exp(-(b_cum + g)))
        outs.append(num / den[..., None])
        g_last = g[..., -1]
        scale_c = torch.exp(m - g_last)
        wk = torch.exp(a - g_last[..., None])[..., None] * kk
        c = scale_c[..., None, None] * c + wk.transpose(-1, -2) @ vv
        n = scale_c[..., None] * n + wk.sum(-2)
        m = b_cum[..., -1] + g_last
    out = torch.cat(outs, 2)[:, :, :s].to(q.dtype)
    return (out, (c, n, m)) if return_state else out


def mlstm_chunkwise_autograd_ref(ins, chunk: int, grads):
    """(dq, dk, dv, dlog_f, dlog_i) of :func:`mlstm_chunkwise_ref`'s (h, C,
    n, m) by autograd of the plain forward: ``ins`` = (q, k, v, log_f,
    log_i), ``grads`` the gradients of h, C, n and m, None where the output
    is not read (what the ``mlstm_chunkwise_bwd`` wrapper returns for CPU
    tensors)."""
    with torch.enable_grad():
        live = [t.detach().requires_grad_() for t in ins]
        h, state = mlstm_chunkwise_ref(*live, chunk=chunk, return_state=True)
        outs = [(o, g) for o, g in zip((h, *state), grads) if g is not None]
        if not outs:
            return tuple(torch.zeros_like(t) for t in ins)
        return torch.autograd.grad([o for o, _ in outs], live,
                                   [g for _, g in outs])


def mlstm_final_m(log_f: torch.Tensor, log_i: torch.Tensor, *,
                  chunk: int) -> torch.Tensor:
    """The stabilizer m of :func:`mlstm_chunkwise_ref`'s final state (B, H),
    from the gates alone: per chunk of L = min(chunk, S) steps (the ragged
    tail padded as there), g_L = max(m, max(log i - cumsum(log f))) and m
    <- sum(log f) + g_L, from m = 0."""
    s = log_f.shape[-1]
    L = min(chunk, s)
    pad = (-s) % L
    lf = torch.nn.functional.pad(log_f.float(), (0, pad))
    li = torch.nn.functional.pad(log_i.float(), (0, pad), value=NEG_INF)
    m = lf.new_zeros(lf.shape[:-1])
    for t0 in range(0, s + pad, L):
        b_cum = lf[..., t0:t0 + L].cumsum(-1)
        g_last = torch.maximum(m, (li[..., t0:t0 + L] - b_cum).amax(-1))
        m = b_cum[..., -1] + g_last
    return m


def _mlstm_gate_grads(r: torch.Tensor, c: torch.Tensor,
                      log_f: torch.Tensor, log_i: torch.Tensor,
                      extra: Optional[torch.Tensor] = None,
                      shift: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dlog_f, dlog_i) (B, H, S) from the row sums r_t = q_t . dq_t and
    the column sums c_s = k_s . dk_s of P o dP (c with the final state's
    own terms): dlog_i = c and dlog_f_j = sum_{t >= j} (r - c)_t (with
    ``shift``, a planted fault, t > j).  ``extra`` (B, H) = <C, dC> + <n,
    dn> where the final state has a gradient: the returned state is C
    exp(-m) with m = F_{S-1} + max(0, li_s* - F_s*) (F = cumsum(log f), s*
    the first argmax), so its gradient moves log f up to s* by ``extra``,
    which the frame's exp(-m) takes back after s* and from li_s*."""
    diff = r - c
    dlog_f = diff.flip(-1).cumsum(-1).flip(-1)
    if shift:
        dlog_f = dlog_f - diff
    if extra is not None:
        top, star = (log_i.float() - log_f.float().cumsum(-1)).max(-1)
        wins = top > 0
        steps = torch.arange(r.shape[-1], device=r.device)
        dlog_f = dlog_f + extra[..., None] * ((steps <= star[..., None])
                                              & wins[..., None])
        c = c - torch.where(wins[..., None] & (steps == star[..., None]),
                            extra[..., None], 0.0)
    return dlog_f, c


def mlstm_chunkwise_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, log_f: torch.Tensor,
                            log_i: torch.Tensor, dh: torch.Tensor,
                            dc: Optional[torch.Tensor] = None,
                            dn: Optional[torch.Tensor] = None, *,
                            chunk: int) -> Tuple[torch.Tensor, ...]:
    """Plain version of the ``mlstm_chunkwise_bwd`` kernel: the gradients
    (dq, dk, dv, dlog_f, dlog_i) of :func:`mlstm_chunkwise_ref`'s h, and of
    its final (C, n) where ``dc`` (B, H, D, D) / ``dn`` (B, H, D) are given,
    in closed form over the whole causal (S, S) matrix, in float32.

    With F = cumsum(log f), P_ts = exp(F_t - F_s + li_s) (q_t . k_s) / sqrt(D)
    for s <= t, h_t = num_t / max(|den_t|, 1), num = P v, den = P 1: dnum_t
    = dh_t / max(|den_t|, 1); dden_t = -sign(den_t) (dh_t . h_t) / |den_t|
    where |den_t| > 1, else 0; dP_ts = dnum_t . v_s + dden_t.  Then dq = (P
    / (q k^T) o dP) k, dk = its transpose times q, dv = P^T dnum; dlog_i the
    column sums of P o dP, dlog_f_j = sum_{t>=j} (row sum - column sum)_t
    plus <C, dC> + <n, dn>.  Each row is stabilized by its own max
    exponent M_t (the max compares |den_t| with exp(-M_t)), which cancels.
    The final state carries the forward's stabilizer m
    (:func:`mlstm_final_m`), so ``chunk`` matters only with ``dc``/``dn``.
    Returns dq, dk, dv in q's dtype, dlog_f and dlog_i in their inputs'."""
    b, h, s, d = q.shape
    scale = d ** -0.5
    q32, k32, v32, dh32 = q.float(), k.float(), v.float(), dh.float()
    lf, li = log_f.float(), log_i.float()
    fc = lf.cumsum(-1)
    causal = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    expo = torch.where(causal, fc[..., :, None] - fc[..., None, :]
                       + li[..., None, :], -math.inf)        # (B, H, t, s)
    row_max = expo.amax(-1)
    e = torch.exp(expo - row_max[..., None])
    p = e * (q32 @ k32.transpose(-1, -2)) * scale
    den = p.sum(-1)
    floor = torch.exp(-row_max)
    div = torch.maximum(den.abs(), floor)
    hh = (p @ v32) / div[..., None]
    dnum = dh32 / div[..., None]
    dden = torch.where(den.abs() > floor,
                       -torch.sign(den) * (dh32 * hh).sum(-1) / div, 0.0)
    dp = dnum @ v32.transpose(-1, -2) + dden[..., None]
    g = e * dp * scale
    dq = g @ k32
    dk = g.transpose(-1, -2) @ q32
    dv = p.transpose(-1, -2) @ dnum
    r = (p * dp).sum(-1)
    c = (p * dp).sum(-2)
    extra = None
    if dc is not None or dn is not None:
        m = mlstm_final_m(log_f, log_i, chunk=chunk)
        w = torch.exp(fc[..., -1:] - fc + li - m[..., None])   # (B, H, S)
        inner = torch.zeros_like(k32)
        if dc is not None:
            inner = inner + v32 @ dc.float().transpose(-1, -2)
            dv = dv + w[..., None] * (k32 @ dc.float())
        if dn is not None:
            inner = inner + dn.float()[..., None, :]
        dk = dk + w[..., None] * inner
        fin = w * (k32 * inner).sum(-1)
        c = c + fin
        extra = fin.sum(-1)
    dlog_f, c = _mlstm_gate_grads(r, c, log_f, log_i, extra)
    return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
            dlog_f.to(log_f.dtype), c.to(log_i.dtype))


#: Planted faults of the mLSTM ``wgmma`` kernels and of
#: :func:`mlstm_chunkwise_two_pass_ref` (a bit mask; must match
#: ``csrc/mlstm_chunkwise.cu``): the lo half of the state update (w k)
#: dropped; the outputs of chunk nc // 2 (when >= 2) given the C of the
#: chunk before; that chunk's S . D row sums dropped; the outputs given
#: C_k's hi half only.
PLANT_LO, PLANT_LATE, PLANT_ROWSUM, PLANT_CK_HI = 1, 2, 4, 8


def _split16(x: torch.Tensor, dtype: torch.dtype
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 x as hi = x rounded to ``dtype`` and lo = (x - hi) rounded to
    ``dtype``, both returned in f32."""
    hi = x.to(dtype).float()
    return hi, (x - hi).to(dtype).float()


def _two_pass_chunks(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     log_f: torch.Tensor, log_i: torch.Tensor, L: int,
                     *more: torch.Tensor):
    """q, k, v (and ``more`` of their shape) in f32, padded to whole chunks
    of L steps as the reference pads them and reshaped (B, H, nc, L, D);
    log_f, log_i likewise (B, H, nc, L)."""
    b, h, s, d = q.shape
    nc = -(-s // L)
    pad = nc * L - s
    xs = [torch.nn.functional.pad(t.float(), (0, 0, 0, pad))
          .reshape(b, h, nc, L, d) for t in (q, k, v, *more)]
    lf = torch.nn.functional.pad(log_f.float(), (0, pad)).reshape(b, h, nc, L)
    li = torch.nn.functional.pad(log_i.float(), (0, pad), value=NEG_INF
                                 ).reshape(b, h, nc, L)
    return xs, lf, li


def _two_pass_gates(lf: torch.Tensor, li: torch.Tensor) -> dict:
    """The ``wgmma`` route's gate pre-scan over (B, H, nc, L) gates: per
    chunk b = cumsum(log f), a = log i - b, cm = cummax(a); the stabilizer
    chain g_L = max(m0, cm_L), m0' = b_L + g_L over the chunks from m0 = 0;
    then g = max(m0, cm), decay0 = exp(m0 - g), minv = exp(-(b + g)), w =
    exp(a - g_L), scale_c = exp(m0 - g_L) and the final m."""
    bc = lf.cumsum(-1)
    a = li - bc
    cm = torch.cummax(a, -1).values
    m = lf.new_zeros(lf.shape[:2])
    m0s = []
    for c in range(lf.shape[2]):
        m0s.append(m)
        m = bc[..., c, -1] + torch.maximum(m, cm[..., c, -1])
    m0 = torch.stack(m0s, -1)                                  # (B, H, nc)
    g = torch.maximum(m0[..., None], cm)
    g_last = g[..., -1]
    return dict(a=a, g=g, decay0=torch.exp(m0[..., None] - g),
                minv=torch.exp(-(bc + g)),
                w=torch.exp(a - g_last[..., None]),
                scale_c=torch.exp(m0 - g_last), m=m)


def _two_pass_chain(k32: torch.Tensor, v32: torch.Tensor, gates: dict,
                    half: torch.dtype, drop_lo: bool = False):
    """The ``wgmma`` route's C_k chain: C_0 = 0, C_{k+1} = scale_c C_k +
    (hi + lo of w k)^T v (the lo half dropped with ``drop_lo``), n from the
    unsplit w k.  Returns the states entering each chunk, [C_k], [n_k], and
    the final C and n."""
    b, h, nc, _, d = k32.shape
    wk = gates["w"][..., None] * k32
    wk_hi, wk_lo = _split16(wk, half)
    if drop_lo:
        wk_lo = torch.zeros_like(wk_lo)
    c_state = k32.new_zeros((b, h, d, d))
    n = k32.new_zeros((b, h, d))
    cs, ns = [], []
    for c in range(nc):
        cs.append(c_state)
        ns.append(n)
        sc = gates["scale_c"][..., c]
        c_state = (sc[..., None, None] * c_state
                   + (wk_hi[:, :, c] + wk_lo[:, :, c]).transpose(-1, -2)
                   @ v32[:, :, c])
        n = sc[..., None] * n + wk[:, :, c].sum(-2)
    return cs, ns, c_state, n


def _half_of(dtype: torch.dtype) -> torch.dtype:
    """The 16-bit type the split halves take: q's, or bf16 for f32."""
    return dtype if dtype in (torch.bfloat16, torch.float16) \
        else torch.bfloat16


def mlstm_chunkwise_two_pass_ref(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, log_f: torch.Tensor,
                                 log_i: torch.Tensor, *, chunk: int,
                                 return_state: bool = False,
                                 plant: int = 0):
    """The algorithm of the mLSTM ``wgmma`` route in plain PyTorch: the
    function of :func:`mlstm_chunkwise_ref`, computed in its passes and
    with its roundings, for the tests and ``chip_smoke.py`` (never on a
    main path).

    1. Gate pre-scan: per chunk b = cumsum(log f), a = log i - b,
       cm = cummax(a); the stabilizer chain g_L = max(m0, cm_L), m0' =
       b_L + g_L over the chunks; then g = max(m0, cm), decay0 = exp(m0 -
       g), minv = exp(-(b + g)), w = exp(a - g_L), scale_c = exp(m0 - g_L).
    2. Stored S . D = (q k^T) * D^-0.5 * exp(a_s - g_j) (s <= j) in f32,
       its f32 row sums, and its hi + lo split.
    3. The C_k chain: C_0 = 0, C_{k+1} = scale_c C_k + (hi + lo of w k)^T
       v; n likewise from the unsplit w k.
    4. h = (decay0 D^-0.5 q (hi + lo of C_k) + (hi + lo of S . D) v) /
       max(|decay0 D^-0.5 q . n_k + row sum|, minv).

    The split type is q's (bf16 for f32 inputs); q, k, v are read as exact
    in it.  ``plant`` is a mask of ``PLANT_*`` faults (0: none).  Returns
    what :func:`mlstm_chunkwise_ref` returns."""
    b, h, s, d = q.shape
    half = _half_of(q.dtype)
    scale = d ** -0.5
    L = min(chunk, s)
    (q32, k32, v32), lf, li = _two_pass_chunks(q, k, v, log_f, log_i, L)
    nc = q32.shape[2]
    # 1. gates
    gates = _two_pass_gates(lf, li)
    a, g, decay0, minv = (gates[x] for x in ("a", "g", "decay0", "minv"))
    # 2. S . D, once per chunk
    tri = torch.ones((L, L), dtype=torch.bool, device=q.device).tril()
    sd = (q32 @ k32.transpose(-1, -2)) * scale * torch.where(
        tri, torch.exp(a[..., None, :] - g[..., :, None]), 0.0)
    rowsum = sd.sum(-1)
    sd_hi, sd_lo = _split16(sd, half)
    # 3. the C_k chain
    cs, ns, c_state, n = _two_pass_chain(k32, v32, gates, half,
                                         drop_lo=bool(plant & PLANT_LO))
    # 4. outputs
    cf = nc // 2
    outs = []
    for c in range(nc):
        src = c - 1 if plant & PLANT_LATE and c == cf and cf >= 2 else c
        ck_hi, ck_lo = _split16(cs[src], half)
        if plant & PLANT_CK_HI:
            ck_lo = torch.zeros_like(ck_lo)
        qc = q32[:, :, c]
        dec = decay0[:, :, c] * scale
        num = (dec[..., None] * (qc @ (ck_hi + ck_lo))
               + (sd_hi[:, :, c] + sd_lo[:, :, c]) @ v32[:, :, c])
        rs = rowsum[:, :, c]
        if plant & PLANT_ROWSUM and c == cf:
            rs = torch.zeros_like(rs)
        qn = (qc @ ns[c][..., None])[..., 0]
        den = torch.maximum((dec * qn + rs).abs(), minv[:, :, c])
        outs.append(num / den[..., None])
    out = torch.stack(outs, 2).reshape(b, h, nc * L, d)[:, :, :s]
    out = out.to(q.dtype)
    return (out, (c_state, n, gates["m"])) if return_state else out


#: Planted faults of the mLSTM backward kernels (both routes) and of
#: :func:`mlstm_chunkwise_bwd_split_ref` (a bit mask; must match
#: ``csrc/mlstm_chunkwise.cu``, ``mlstm_bwd``): the reverse state gradient
#: reset at chunk nc // 2; dq's inter-chunk terms dropped; dlog_f's reverse
#: cumulative sum shifted by one step.
BWD_PLANT_RESET, BWD_PLANT_DQ_INTER, BWD_PLANT_SHIFT = 1, 2, 4


def mlstm_chunkwise_bwd_split_ref(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, log_f: torch.Tensor,
                                  log_i: torch.Tensor, dh: torch.Tensor,
                                  dc: Optional[torch.Tensor] = None,
                                  dn: Optional[torch.Tensor] = None, *,
                                  chunk: int, plant: int = 0
                                  ) -> Tuple[torch.Tensor, ...]:
    """The algorithm of the mLSTM backward's ``wgmma`` route in plain
    PyTorch: the function of :func:`mlstm_chunkwise_bwd_ref`, computed in
    the route's passes and with its roundings, for the tests (never on a
    main path).  Per chunk of L steps, in the forward's stabilized frame
    (E_ts = D^-0.5 exp(a_s - g_t) for s <= t, else 0; dec = decay0 D^-0.5):

    0. The forward's gate and state passes (:func:`_two_pass_gates`,
       :func:`_two_pass_chain`): C_k entering each chunk, split hi + lo.
    1. Y = dh (hi + lo of C_k)^T and qy = q . Y per step (0 in chunk 0).
    2. S = q k^T, W = dh v^T (both sides exact); Sd = S o E, den = dec q .
       n_k + sum_s Sd, Dv = max(|den|, minv), dden = -sign(den) (dec qy +
       sum_s Sd o W) / Dv^2 where |den| > minv, else 0; u = dec / Dv, z =
       dec dden; G = E o (W / Dv + dden), P = Sd / Dv, each split hi + lo.
    3. From (dC, dn) down, G_k the gradient of the state after chunk k, in
       f32, handed over split hi + lo: G_{k-1} = scale_c G_k + (hi + lo of
       u q)^T dh, gn_{k-1} = scale_c gn_k + sum_t z_t q_t.
    4. dq = G k + u Y + z n_k; dk = w (v G_k^T + gn_k) + G^T q; dv = w (k
       G_k) + P^T dh, with the f32 sums q . dq and k . dk.
    5. dlog_i, dlog_f from them and <C, dC> + <n, dn> (C, n the final
       state of pass 0), as :func:`_mlstm_gate_grads`.

    The split type is q's (bf16 for f32 inputs); q, k, v and dh are read
    as exact in it.  ``plant`` is a mask of ``BWD_PLANT_*`` faults (0:
    none).  Returns what :func:`mlstm_chunkwise_bwd_ref` returns."""
    b, h, s, d = q.shape
    half = _half_of(q.dtype)
    scale = d ** -0.5
    L = min(chunk, s)
    (q32, k32, v32, dh32), lf, li = _two_pass_chunks(q, k, v, log_f, log_i,
                                                     L, dh)
    nc = q32.shape[2]
    # 0. the forward's recompute
    gates = _two_pass_gates(lf, li)
    a, g, minv, w = (gates[x] for x in ("a", "g", "minv", "w"))
    dec = gates["decay0"] * scale
    cs, ns, c_fin, n_fin = _two_pass_chain(k32, v32, gates, half)
    ck = torch.stack([sum(_split16(x, half)) for x in cs], 2)
    nk = torch.stack(ns, 2)                                  # (B, H, nc, D)
    # 1. Y = dh C_k^T
    y = dh32 @ ck.transpose(-1, -2)
    qy = (q32 * y).sum(-1)
    # 2. the chunk's own products and the per-step factors
    tri = torch.ones((L, L), dtype=torch.bool, device=q.device).tril()
    e = torch.where(tri, scale * torch.exp(a[..., None, :] - g[..., :, None]),
                    0.0)
    sd = (q32 @ k32.transpose(-1, -2)) * e
    wm = dh32 @ v32.transpose(-1, -2)
    den = dec * (q32 @ nk[..., None])[..., 0] + sd.sum(-1)
    dv_ = torch.maximum(den.abs(), minv)
    dden = torch.where(den.abs() > minv, -torch.sign(den)
                       * (dec * qy + (sd * wm).sum(-1)) / dv_ ** 2, 0.0)
    u, z = dec / dv_, dec * dden
    gm = sum(_split16(e * (wm / dv_[..., None] + dden[..., None]), half))
    pm = sum(_split16(sd / dv_[..., None], half))
    # 3. the reverse walk of the state's gradient
    gk = dc.float() if dc is not None else q32.new_zeros((b, h, d, d))
    gn = dn.float() if dn is not None else q32.new_zeros((b, h, d))
    uq = sum(_split16(u[..., None] * q32, half))
    gks, gns = [None] * nc, [None] * nc
    for c in range(nc - 1, -1, -1):
        if plant & BWD_PLANT_RESET and c == nc // 2:
            gk, gn = torch.zeros_like(gk), torch.zeros_like(gn)
        gks[c], gns[c] = sum(_split16(gk, half)), gn
        sc = gates["scale_c"][..., c]
        gk = sc[..., None, None] * gk + uq[:, :, c].transpose(-1, -2) \
            @ dh32[:, :, c]
        gn = sc[..., None] * gn + (z[:, :, c, :, None] * q32[:, :, c]).sum(-2)
    gks, gns = torch.stack(gks, 2), torch.stack(gns, 2)
    # 4. the gradients
    dq = gm @ k32
    if not plant & BWD_PLANT_DQ_INTER:
        dq = dq + u[..., None] * y + z[..., None] * nk[..., None, :]
    dk = (w[..., None] * (v32 @ gks.transpose(-1, -2) + gns[..., None, :])
          + gm.transpose(-1, -2) @ q32)
    dv = w[..., None] * (k32 @ gks) + pm.transpose(-1, -2) @ dh32
    # 5. the gates' gradients
    r, cc = ((x * dx).sum(-1).reshape(b, h, -1)[..., :s]
             for x, dx in ((q32, dq), (k32, dk)))
    extra = None
    if dc is not None or dn is not None:
        extra = q32.new_zeros((b, h))
        if dc is not None:
            extra = extra + (c_fin * dc.float()).sum((-1, -2))
        if dn is not None:
            extra = extra + (n_fin * dn.float()).sum(-1)
    dlog_f, dlog_i = _mlstm_gate_grads(r, cc, log_f, log_i, extra,
                                       shift=bool(plant & BWD_PLANT_SHIFT))
    dq, dk, dv = (x.reshape(b, h, -1, d)[:, :, :s] for x in (dq, dk, dv))
    return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
            dlog_f.to(log_f.dtype), dlog_i.to(log_i.dtype))


def mlstm_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              log_f: torch.Tensor, log_i: torch.Tensor) -> torch.Tensor:
    """The mLSTM's sequential oracle (``repro.kernels.ref.mlstm_ref``): one
    step at a time in float32, with the stabilizer m_t = max(log f_t +
    m_{t-1}, log i_t):

        C_t = f'_t C_{t-1} + i'_t k_t v_t^T,  n_t = f'_t n_{t-1} + i'_t k_t
        h_t = C_t^T q_t / max(|n_t . q_t|, exp(-m_t))

    q/k/v (B, H, S, D); log_f/log_i (B, H, S).  Returns (B, H, S, D) in
    q's dtype."""
    b, h, s, d = q.shape
    q32 = q.float() * d ** -0.5
    k32, v32, lf, li = k.float(), v.float(), log_f.float(), log_i.float()
    c = q.new_zeros((b, h, d, d), dtype=torch.float32)
    n = q.new_zeros((b, h, d), dtype=torch.float32)
    m = q.new_zeros((b, h), dtype=torch.float32)
    out = torch.empty((b, h, s, d), dtype=q.dtype, device=q.device)
    for t in range(s):
        m_new = torch.maximum(lf[..., t] + m, li[..., t])
        f_t = torch.exp(lf[..., t] + m - m_new)[..., None]
        i_t = torch.exp(li[..., t] - m_new)[..., None]
        k_t, v_t, q_t = k32[:, :, t], v32[:, :, t], q32[:, :, t]
        c = (f_t[..., None] * c
             + i_t[..., None] * (k_t[..., :, None] * v_t[..., None, :]))
        n = f_t * n + i_t * k_t
        num = torch.einsum("bhde,bhd->bhe", c, q_t)
        den = torch.maximum(torch.einsum("bhd,bhd->bh", n, q_t).abs(),
                            torch.exp(-m_new))[..., None]
        out[:, :, t] = num / den
        m = m_new
    return out
