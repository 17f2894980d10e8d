"""GQA attention block: parameters, projections and the dense forward
(counterpart of ``repro.models.attention``).

``_project_qkv`` serves both paths: the paged serving steps
(:mod:`repro_torch.serving.model`) and :func:`attn_apply`, the train
forward, which reaches the flash kernel.  ``attn_prefill`` and
``attn_decode`` (the JAX package's contiguous-cache serving) are not
ported; the port serves through the paged steps.
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
               window: Optional[int] = None) -> torch.Tensor:
    """Training / prefill forward.  x (B, S, D) -> (B, S, D).

    Project and rope, then causal (optionally windowed) flash attention in
    the kernel's (B, H, S, hd) layout -- the transposes are copies -- and
    the output projection."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = _project_qkv(params, x, cfg, positions)       # (B, S, H, hd)
    out = ops.flash_attention(q.transpose(1, 2).contiguous(),
                              k.transpose(1, 2).contiguous(),
                              v.transpose(1, 2).contiguous(),
                              causal=True, window=window)
    out = out.transpose(1, 2).reshape(b, s, -1)
    return ops.sma_gemm(out, compute_cast(params["wo"], x.dtype))
