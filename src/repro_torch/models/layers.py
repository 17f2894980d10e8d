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

import contextlib
import threading
from typing import Callable, Iterator, Optional, Tuple

import torch

from repro_torch.distributed import tensor_parallel as tp
from repro_torch.kernels import ops


def compute_cast(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A stored parameter in the compute dtype (``repro.models.layers.
    compute_cast`` without the sharding constraint): a no-op for weights
    already held in ``dtype``; for an f32 master, a cast whose backward
    casts the gradient back."""
    return w.to(dtype)


class _Draws(threading.local):
    hook: Optional[Callable] = None


_DRAWS = _Draws()


@contextlib.contextmanager
def deferred_draws(hook: Callable) -> Iterator[None]:
    """Within it, every random draw of an ``*_init`` function (on this
    thread) calls ``hook(make, shape, dtype)`` in its place and puts what
    the hook returns into the tree: ``make(keep)`` draws the leaf from the
    init's generator, where ``keep`` (a
    :class:`repro_torch.distributed.sharding.LeafSharding`, or None for the
    whole leaf) is the block of it to return; a stacked leaf is drawn a
    leading slice at a time and only each slice's block kept.  Calling
    the ``make`` functions later, in the order the hook saw them, draws
    exactly what the init would have
    (:func:`repro_torch.models.lm.init_blocks`)."""
    old, _DRAWS.hook = _DRAWS.hook, hook
    try:
        yield
    finally:
        _DRAWS.hook = old


def _drawn(make: Callable, shape: Tuple[int, ...], dtype: torch.dtype
           ) -> torch.Tensor:
    hook = _DRAWS.hook
    return make(None) if hook is None else hook(make, tuple(shape), dtype)


def _kept(x: torch.Tensor, keep, dtype: torch.dtype) -> torch.Tensor:
    """``x`` in ``dtype``, or a new tensor of its block under ``keep``."""
    if keep is None or not keep.splits:
        return x.to(dtype)
    part = keep.local(x)
    return torch.empty(part.shape, dtype=dtype,
                       device=x.device).copy_(part)


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

    def make(keep) -> torch.Tensor:
        if len(shape) < 3:
            return _kept(draw(shape), keep, dtype)
        split = keep is not None and bool(keep.splits)
        if split and any(d == 0 for d, _, _, _ in keep.splits):
            return _kept(make(None), keep, dtype)
        inner = keep.inner() if split else None
        rest = inner.local_shape(shape[1:]) if split else shape[1:]
        out = torch.empty((shape[0],) + tuple(rest), dtype=dtype,
                          device=gen.device)
        for i in range(shape[0]):
            out[i] = inner.local(draw(shape[1:])) if split \
                else draw(shape[1:])
        return out

    return _drawn(make, shape, dtype)


def uniform_init(gen: torch.Generator, shape: Tuple[int, ...], lo: float,
                 hi: float) -> torch.Tensor:
    """U[lo, hi) drawn in float32 (held so)."""
    def make(keep) -> torch.Tensor:
        x = torch.rand(shape, generator=gen, device=gen.device,
                       dtype=torch.float32) * (hi - lo) + lo
        return _kept(x, keep, torch.float32)
    return _drawn(make, shape, torch.float32)


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
    def make(keep) -> torch.Tensor:
        return _kept(torch.randn((vocab, d), generator=gen,
                                 device=gen.device, dtype=torch.float32),
                     keep, dtype)
    return {"table": _drawn(make, (vocab, d), dtype)}


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
