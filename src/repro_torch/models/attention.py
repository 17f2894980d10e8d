"""GQA attention block parameters and projections
(counterpart of ``repro.models.attention``).

Only what the paged serving path uses is ported: ``attn_init`` and
``_project_qkv``.  The dense train/prefill path (``attn_apply``, which
reaches ``flash_attention``) comes with the next slice.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, variance_scaling_init


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
    q = ops.sma_gemm(x, params["wq"]).reshape(*lead, cfg.num_heads, hd)
    k = ops.sma_gemm(x, params["wk"]).reshape(*lead, cfg.num_kv_heads, hd)
    v = ops.sma_gemm(x, params["wv"]).reshape(*lead, cfg.num_kv_heads, hd)
    q = apply_rope(q, positions, theta=cfg.rope_theta)
    k = apply_rope(k, positions, theta=cfg.rope_theta)
    return q, k, v
