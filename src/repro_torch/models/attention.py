"""GQA attention block: parameters, projections, the dense forward and the
contiguous-cache serving steps (counterpart of ``repro.models.attention``).

``_project_qkv`` serves every path: the paged serving steps
(:mod:`repro_torch.serving.model`); :func:`attn_apply`, the train forward,
and :func:`attn_prefill`, both of which reach the flash kernel; and
:func:`attn_decode`, which reaches the contiguous decode kernel.  A
windowed (``local``) layer keeps a cache of ``window`` slots as a ring.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
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
                 positions: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (..., S, D) -> roped q (..., S, Hq, hd), roped k and v
    (..., S, Hkv, hd); one SMA GEMM per projection."""
    hd = cfg.resolved_head_dim
    lead = x.shape[:-1]

    def proj(name: str, heads: int) -> torch.Tensor:
        w = compute_cast(params[name], x.dtype)
        return ops.sma_gemm(x, w).reshape(*lead, heads, hd)

    q = apply_rope(proj("wq", cfg.num_heads), positions, theta=cfg.rope_theta)
    k = apply_rope(proj("wk", cfg.num_kv_heads), positions,
                   theta=cfg.rope_theta)
    return q, k, proj("wv", cfg.num_kv_heads)


def attn_apply(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
               window: Optional[int] = None,
               positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Training / prefill forward.  x (B, S, D) -> (B, S, D).

    Project and rope at ``positions`` ((1 or B, S) integers; default
    ``arange(S)``), then causal (optionally windowed) flash attention in
    the kernel's (B, H, S, hd) layout -- the transposes are copies -- and
    the output projection."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = _project_qkv(params, x, cfg, positions)       # (B, S, H, hd)
    out = ops.flash_attention(q.transpose(1, 2).contiguous(),
                              k.transpose(1, 2).contiguous(),
                              v.transpose(1, 2).contiguous(),
                              causal=True, window=window)
    out = out.transpose(1, 2).reshape(b, s, -1)
    return ops.sma_gemm(out, compute_cast(params["wo"], x.dtype))


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
