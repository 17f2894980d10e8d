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

from repro_torch.distributed import tensor_parallel as tp
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
    the second-to-last dim (the input dim of a (…, in, out) matrix).  A
    leaf of three dims or more (stacked over groups, or over experts) is
    drawn one leading slice at a time into a tensor of ``dtype``, so the
    float32 draw never holds more than one slice (a Qwen3 expert leaf is
    9.66 G elements)."""
    fan_in = fan_in if fan_in is not None else shape[-2]
    scale = fan_in ** -0.5

    def draw(part: Tuple[int, ...]) -> torch.Tensor:
        return torch.randn(part, generator=gen, device=gen.device,
                           dtype=torch.float32).mul_(scale)

    if len(shape) < 3:
        return draw(shape).to(dtype)
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    for i in range(shape[0]):
        out[i] = draw(shape[1:])
    return out


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


def gated_mlp_apply(params: dict, x: torch.Tensor, d_ff: int
                    ) -> torch.Tensor:
    """SwiGLU MLP of hidden width ``d_ff``: three SMA GEMMs, the silu fused
    as the epilogue of the gate projection (the ``rewrite.py``
    epilogue-fusion rule).  When the weights hold a block of ``d_ff``
    (tensor parallelism, :mod:`repro_torch.distributed.tensor_parallel`),
    ``wi`` / ``wg`` are column blocks behind *f* and ``wo`` a row block
    before *g*."""
    ax = tp.split_of(params["wo"].shape[-2], d_ff)
    if ax is not None:
        x = ax.enter(x)
    h = ops.sma_gemm(x, compute_cast(params["wi"], x.dtype))
    g = ops.sma_gemm(x, compute_cast(params["wg"], x.dtype), epilogue="silu")
    y = ops.sma_gemm(g * h, compute_cast(params["wo"], x.dtype))
    return y if ax is None else ax.exit(y)
