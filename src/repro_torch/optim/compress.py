"""Gradient compression with error feedback, int8 with a per-tensor scale
(counterpart of ``repro.optim.compress``).

The optimizer-side round trip the trainer applies inside its compiled
step: each gradient plus its carried error is quantized to int8 against
a float32 scale ``max(max|g + e|, 1e-12) / 127`` (rounding half to even,
as ``jnp.round`` does), dequantized, and what the int8 payload lost is
carried to the next step.  The payloads, scales and errors equal the JAX
functions' exactly on the same float32 inputs.  Under ``train(mesh=)`` a
gradient is held as blocks, and each block is quantized against its
whole leaf's scale (``amax``: the largest magnitude over the blocks), so
the round trip is the unmeshed one's, block by block.

Trees are nested dicts and tuples of tensors (:mod:`repro_torch.tree`);
``grads`` and ``error`` have one structure.  :func:`compressed_psum` is
the collective: each rank's int8 payload and scale are all-gathered over
a mesh axis (:mod:`repro_torch.distributed.collectives`) and the mean of
the dequantized values is taken in float32 on every rank.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

import torch

from repro_torch.tree import leaves, tree_map, unflatten


def _quant_one(g32: torch.Tensor, amax: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Quantize g32 (a gradient plus its error) against its largest
    magnitude ``amax``: (q, scale, new error)."""
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    return q, scale, g32 - q.float() * scale


def init_error(params: Any) -> Any:
    """Zero float32 errors beside each parameter."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compress_grads(grads: Any, error: Any,
                   amax: Optional[Callable[[List[torch.Tensor]],
                                           List[torch.Tensor]]] = None):
    """``((q_tree, scale_tree), new_error_tree)``: int8 payloads, float32
    scalar scales and float32 errors, each a tree like ``grads``.
    ``amax``: each leaf's largest magnitude from this rank's (a gradient
    held as blocks, ``train(mesh=)``: the largest over the blocks, so a
    block is quantized against its whole leaf's scale)."""
    g32 = [g.float() + e for g, e in zip(leaves(grads), leaves(error))]
    maxes = [g.abs().amax() for g in g32]
    if amax is not None:
        maxes = amax(maxes)
    out = [_quant_one(g, m) for g, m in zip(g32, maxes)]
    q, scale, err = (unflatten(grads, [o[i] for o in out]) for i in range(3))
    return (q, scale), err


def decompress(compressed) -> Any:
    """float32 gradients from ``(q_tree, scale_tree)``."""
    q_tree, scale_tree = compressed
    return tree_map(lambda q, s: q.float() * s, q_tree, scale_tree)


def roundtrip(grads: Any, error: Any, amax=None):
    """Quantize and dequantize with error feedback (the trainer's hook):
    ``(dequantized grads, new error)``; ``amax`` as
    :func:`compress_grads`'."""
    compressed, new_error = compress_grads(grads, error, amax)
    return decompress(compressed), new_error


def compression_ratio(grads: Any) -> float:
    """float32 bytes over int8 bytes plus one float32 scale a tensor."""
    flat = leaves(grads)
    n = sum(g.numel() for g in flat)
    return (4.0 * n) / (n + 4.0 * len(flat))


def compressed_psum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The mean over ``mesh``'s ``axis`` of each rank's int8-quantized
    ``x`` (scale ``max(max|x|, 1e-12) / 127``, rounding half to even):
    an all-gather of the int8 payloads and the float32 scales, then the
    mean of the dequantized values in float32, in ``x``'s dtype.  A
    quarter of an f32 all-reduce's bytes on the wire, at int8 rounding
    (``repro.optim.compress.compressed_psum``)."""
    from repro_torch.distributed import collectives
    key = mesh.group_key(axis)
    x32 = x.float()
    scale = torch.clamp_min(x32.abs().amax(), 1e-12) / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    qs = collectives.all_gather(q[None], key, dim=0,
                                span="comm.compressed_psum")
    ss = collectives.all_gather(scale.reshape(1), key, dim=0,
                                span="comm.compressed_psum")
    deq = qs.float() * ss.reshape((-1,) + (1,) * x.dim())
    return deq.mean(dim=0).to(x.dtype)
