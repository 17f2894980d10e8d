"""Layer functions on tensors (counterpart of ``repro.models.layers``).

Parameters are plain nested dicts of tensors, as in the JAX package.
``*_init`` functions draw from an explicit ``torch.Generator`` on the
target device and take a ``lead`` shape for stacked (per-group) copies.
Matrices are held in the activation dtype for serving and in the
parameter dtype (float32 masters) for training; :func:`compute_cast`
brings them to the compute dtype at each use, so a master gets its
gradient through the cast.  Norm scales stay float32, as the JAX code
reads them in float32.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import ops


def compute_cast(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A stored parameter in the compute dtype (``repro.models.layers.
    compute_cast`` without the sharding constraint): a no-op for weights
    already held in ``dtype``; for an f32 master, a cast whose backward
    casts the gradient back."""
    return w.to(dtype)


def variance_scaling_init(gen: torch.Generator, shape: Tuple[int, ...],
                          dtype: torch.dtype,
                          fan_in: Optional[int] = None) -> torch.Tensor:
    """N(0, 1/fan_in) drawn in float32, then cast; ``fan_in`` defaults to
    the second-to-last dim (the input dim of a (…, in, out) matrix)."""
    fan_in = fan_in if fan_in is not None else shape[-2]
    w = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * fan_in ** -0.5).to(dtype)


def rmsnorm_init(d: int, device: torch.device,
                 lead: Tuple[int, ...] = ()) -> dict:
    return {"scale": torch.ones(lead + (d,), dtype=torch.float32,
                                device=device)}


def rmsnorm_apply(params: dict, x: torch.Tensor, *,
                  eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    y = x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True) + eps)
    return (y * params["scale"].float()).to(x.dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype: torch.dtype) -> dict:
    table = torch.randn((vocab, d), generator=gen, device=gen.device,
                        dtype=torch.float32)
    return {"table": table.to(dtype)}


def embed_apply(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    return params["table"][tokens.long()]


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *,
               theta: float = 10000.0) -> torch.Tensor:
    """x (..., S, H, hd); positions broadcastable to the S axis.  Angles
    are float32, as in the JAX code."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    angles = positions[..., None].float() * freq
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    rot = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return rot.to(x.dtype)


def gated_mlp_init(gen: torch.Generator, d: int, d_ff: int,
                   dtype: torch.dtype, lead: Tuple[int, ...] = ()) -> dict:
    return {
        "wi": variance_scaling_init(gen, lead + (d, d_ff), dtype),
        "wg": variance_scaling_init(gen, lead + (d, d_ff), dtype),
        "wo": variance_scaling_init(gen, lead + (d_ff, d), dtype),
    }


def gated_mlp_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP: three SMA GEMMs, the silu fused as the epilogue of the
    gate projection (the ``rewrite.py`` epilogue-fusion rule)."""
    h = ops.sma_gemm(x, compute_cast(params["wi"], x.dtype))
    g = ops.sma_gemm(x, compute_cast(params["wg"], x.dtype), epilogue="silu")
    return ops.sma_gemm(g * h, compute_cast(params["wo"], x.dtype))
