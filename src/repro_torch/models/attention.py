"""GQA attention block: parameters, projections, the dense forward and the
contiguous-cache serving steps (counterpart of ``repro.models.attention``).

``_project_qkv`` serves every path: the paged serving steps
(:mod:`repro_torch.serving.model`); :func:`attn_apply`, the train forward,
and :func:`attn_prefill`, both of which reach the flash kernel; and
:func:`attn_decode`, which reaches the contiguous decode kernel.  A
windowed (``local``) layer keeps a cache of ``window`` slots as a ring.

Under tensor parallelism (:mod:`repro_torch.distributed.tensor_parallel`)
:func:`attn_apply` runs on the rank's heads: ``wq`` (and ``wk`` / ``wv``
where the KV heads split too) are column blocks by heads behind *f*, the
flash kernel runs on the local heads, ``wo`` is a row block before *g*.
Where the KV heads stay whole (MQA, or a KV count the axis does not
divide), ``wk`` / ``wv`` are whole on every rank and each rank projects
the KV heads its query heads read: its query head h is global head
``index * Hq/m + h``, whose KV head is ``global // (Hq / Hkv)``.  Where the
query heads stay whole too, attention is computed whole on every rank.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.kernels import ops
from repro_torch.models.layers import (apply_rope, compute_cast,
                                       variance_scaling_init)


def attn_init(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
              lead: Tuple[int, ...] = ()) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    return {
        "wq": variance_scaling_init(gen, lead + (d, nq * hd), dtype),
        "wk": variance_scaling_init(gen, lead + (d, nkv * hd), dtype),
        "wv": variance_scaling_init(gen, lead + (d, nkv * hd), dtype),
        "wo": variance_scaling_init(gen, lead + (nq * hd, d), dtype),
    }


def _project_qkv(params: dict, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor,
                 ax: Optional[tp.ModelAxis] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (..., S, D) -> roped q (..., S, Hq, hd), roped k and v
    (..., S, Hkv, hd); one SMA GEMM per projection.  With ``ax`` (tensor
    parallelism) x passes *f*, q holds this rank's query heads and k, v
    the KV heads they read (module docstring)."""
    hd = cfg.resolved_head_dim
    lead = x.shape[:-1]
    if ax is not None:
        x = ax.enter(x)

    def proj(w: torch.Tensor) -> torch.Tensor:
        return ops.sma_gemm(x, compute_cast(w, x.dtype)).reshape(
            *lead, -1, hd)

    q = apply_rope(proj(params["wq"]), positions, theta=cfg.rope_theta)
    wk, wv, idx = params["wk"], params["wv"], None
    if ax is not None and not tp.split_of(wk.shape[-1],
                                          cfg.num_kv_heads * hd):
        wk, wv, idx = _kv_of_heads(ax, params, q.shape[-2], cfg, x)
    k = apply_rope(proj(wk), positions, theta=cfg.rope_theta)
    v = proj(wv)
    if idx is not None:
        k, v = k.index_select(-2, idx), v.index_select(-2, idx)
    return q, k, v


def _kv_of_heads(ax: tp.ModelAxis, params: dict, nq: int, cfg: ModelConfig,
                 x: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor,
                            Optional[torch.Tensor]]:
    """Where ``wk`` / ``wv`` are whole: their columns of the KV heads this
    rank's ``nq`` query heads read, behind *f* in x's dtype, and the index
    that gives each query head its own KV head where flash's grouping
    cannot (else None)."""
    hd = cfg.resolved_head_dim
    group = cfg.num_heads // cfg.num_kv_heads
    want = [(ax.index * nq + h) // group for h in range(nq)]
    lo, n = want[0], want[-1] - want[0] + 1
    wk, wv = (compute_cast(ax.enter(params[w]).narrow(-1, lo * hd, n * hd),
                           x.dtype).contiguous() for w in ("wk", "wv"))
    idx = None
    if nq % n or want != [lo + h // (nq // n) for h in range(nq)]:
        idx = torch.tensor([w - lo for w in want], device=x.device)
    return wk, wv, idx


def attn_apply(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
               window: Optional[int] = None,
               positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Training / prefill forward.  x (B, S, D) -> (B, S, D).

    Project and rope at ``positions`` ((1 or B, S) integers; default
    ``arange(S)``), then causal (optionally windowed) flash attention in
    the kernel's (B, H, S, hd) layout -- the transposes are copies -- and
    the output projection; on the rank's heads under tensor parallelism
    (module docstring)."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    ax = tp.split_of(params["wq"].shape[-1],
                     cfg.num_heads * cfg.resolved_head_dim)
    if ax is None and tp.model_axis() is not None:
        ops.ROUTED[tp.WHOLE_ATTENTION_REASON] += 1
    q, k, v = _project_qkv(params, x, cfg, positions, ax)   # (B, S, H, hd)
    out = ops.flash_attention(q.transpose(1, 2).contiguous(),
                              k.transpose(1, 2).contiguous(),
                              v.transpose(1, 2).contiguous(),
                              causal=True, window=window)
    out = out.transpose(1, 2).reshape(b, s, -1)
    y = ops.sma_gemm(out, compute_cast(params["wo"], x.dtype))
    return y if ax is None else ax.exit(y)


def attn_prefill(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
                 window: Optional[int] = None, cache_size: int
                 ) -> Tuple[torch.Tensor, dict]:
    """:func:`attn_apply` that also returns the populated cache ``{"k",
    "v"}`` (B, Hkv, cache_size, hd): the prompt's keys and values, padded
    with zeros to ``cache_size`` or, when longer, cut to their last
    ``cache_size`` positions (as the JAX function does; a windowed layer's
    decode then writes position p at slot p % cache_size, which matches
    this layout only when the prompt length is a multiple of the window:
    ROADMAP.md, faults of the reference)."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = _project_qkv(params, x, cfg, positions)
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    out = ops.flash_attention(qh, kh, vh, causal=True, window=window)
    y = ops.sma_gemm(out.transpose(1, 2).reshape(b, s, -1),
                     compute_cast(params["wo"], x.dtype))
    pad = cache_size - s
    if pad > 0:
        kh = torch.nn.functional.pad(kh, (0, 0, 0, pad))
        vh = torch.nn.functional.pad(vh, (0, 0, 0, pad))
    elif pad < 0:
        kh = kh[:, :, -cache_size:].contiguous()
        vh = vh[:, :, -cache_size:].contiguous()
    return y, {"k": kh, "v": vh}


def attn_decode(params: dict, x: torch.Tensor, cache: dict,
                cache_len: torch.Tensor, cfg: ModelConfig, *,
                window: Optional[int] = None) -> Tuple[torch.Tensor, dict]:
    """One decode step.  x (B, 1, D); cache k/v (B, Hkv, Smax, hd), written
    **in place** (the JAX function returns new arrays); cache_len (B,), the
    position this step writes.

    The new key and value go to slot ``cache_len % Smax`` in a windowed
    layer (a ring of Smax = window slots) and ``min(cache_len, Smax - 1)``
    otherwise; attention then reads ``min(cache_len + 1, Smax)`` slots
    (windowed) or ``cache_len + 1``.  Returns (y (B, 1, D), cache)."""
    b = x.shape[0]
    pos = cache_len.long()
    q, k, v = _project_qkv(params, x, cfg, pos[:, None])    # (B, 1, H, hd)
    smax = cache["k"].shape[2]
    slot = pos % smax if window is not None else pos.clamp(max=smax - 1)
    rows = torch.arange(b, device=x.device)
    cache["k"][rows, :, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][rows, :, slot] = v[:, 0].to(cache["v"].dtype)
    eff_len = (pos + 1).clamp(max=smax) if window is not None else pos + 1
    out = ops.decode_attention(q[:, 0], cache["k"], cache["v"],
                               eff_len.to(torch.int32))
    y = ops.sma_gemm(out.reshape(b, -1), compute_cast(params["wo"], x.dtype))
    return y[:, None, :], cache
