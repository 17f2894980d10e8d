"""Gradient compression with error feedback, int8 with a per-tensor scale
(counterpart of ``repro.optim.compress``).

The optimizer-side round trip the trainer applies inside its compiled
step: each gradient plus its carried error is quantized to int8 against
a float32 scale ``max(max|g + e|, 1e-12) / 127`` (rounding half to even,
as ``jnp.round`` does), dequantized, and what the int8 payload lost is
carried to the next step.  The payloads, scales and errors equal the JAX
functions' exactly on the same float32 inputs.

Trees are nested dicts and tuples of tensors (:mod:`repro_torch.tree`);
``grads`` and ``error`` have one structure.  The reference's
``compressed_psum`` (the int8 all-gather over a mesh axis) waits for the
distributed slice (ROADMAP.md §1 item 10).
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.tree import leaves, tree_map, unflatten


def _quant_one(g: torch.Tensor, e: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Quantize g + e to int8: (q, scale, new error)."""
    g32 = g.float() + e
    scale = torch.clamp_min(g32.abs().amax(), 1e-12) / 127.0
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    return q, scale, g32 - q.float() * scale


def init_error(params: Any) -> Any:
    """Zero float32 errors beside each parameter."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compress_grads(grads: Any, error: Any):
    """``((q_tree, scale_tree), new_error_tree)``: int8 payloads, float32
    scalar scales and float32 errors, each a tree like ``grads``."""
    out = [_quant_one(g, e) for g, e in zip(leaves(grads), leaves(error))]
    q, scale, err = (unflatten(grads, [o[i] for o in out]) for i in range(3))
    return (q, scale), err


def decompress(compressed) -> Any:
    """float32 gradients from ``(q_tree, scale_tree)``."""
    q_tree, scale_tree = compressed
    return tree_map(lambda q, s: q.float() * s, q_tree, scale_tree)


def roundtrip(grads: Any, error: Any):
    """Quantize and dequantize with error feedback (the trainer's hook):
    ``(dequantized grads, new error)``."""
    compressed, new_error = compress_grads(grads, error)
    return decompress(compressed), new_error


def compression_ratio(grads: Any) -> float:
    """float32 bytes over int8 bytes plus one float32 scale a tensor."""
    flat = leaves(grads)
    n = sum(g.numel() for g in flat)
    return (4.0 * n) / (n + 4.0 * len(flat))
