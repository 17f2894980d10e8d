"""AdamW with global-norm clipping and LR schedules
(counterpart of ``repro.optim.adamw``).

The same arithmetic, in float32 on tensors: ``lr_at``, ``init``,
``global_norm`` and ``update``.  Unlike the JAX function, :func:`update`
works **in place**: the parameters and the moments ``m`` and ``v`` are
overwritten (the clipped gradients too), so a step holds no second copy
of the model or of the optimizer state.  It returns the same (params,
state, metrics) triple, with ``params`` and the state the objects passed
in.

Under ``train(mesh=)`` the masters, moments and gradients are each this
rank's block of the leaf (FSDP and tensor parallelism,
:mod:`repro_torch.launch.train`), and the update is elementwise, so it
runs on the blocks as they are and a split changes no bit of it.  The
gradient norm is taken over the whole model: ``axis_sum`` sums the
squares of the blocks over the axes each leaf is split over (``split``),
and each replicated leaf counts once, so every rank clips by the same
scale.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.tree import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    end_lr_ratio: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    schedule: str = "cosine"  # cosine | linear | constant


def lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Learning rate at ``step`` (a tensor), in float32 on its device."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    if cfg.schedule == "cosine":
        decay = cfg.end_lr_ratio + (1 - cfg.end_lr_ratio) * 0.5 * (
            1.0 + torch.cos(math.pi * frac))
    elif cfg.schedule == "linear":
        decay = 1.0 - (1.0 - cfg.end_lr_ratio) * frac
    else:
        decay = torch.ones_like(frac)
    return cfg.peak_lr * warm * decay


def init(params) -> Dict:
    """Zero moments in float32 beside each parameter (beside each block of
    one under ``train(mesh=)``), and step 0."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    dev = leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree, split: Optional[Sequence[Tuple[str, ...]]] = None,
                axis_sum: Optional[Callable] = None) -> torch.Tensor:
    """The 2-norm of every leaf together.  With ``split`` (a leaf's mesh
    axes when it is a block of a leaf split over them, else ``()``) and
    ``axis_sum(x, axes)`` (a sum over those axes), the squares of the
    blocks of one set of axes are summed over those axes, and each whole
    leaf's counted once."""
    squares = [g.float().square().sum() for g in leaves(tree)]
    if axis_sum is None:
        return torch.sqrt(sum(squares))
    by_axes: Dict[Tuple[str, ...], list] = {}
    for q, axes in zip(squares, split):
        by_axes.setdefault(tuple(axes), []).append(q)
    total = torch.zeros((), device=squares[0].device)
    for axes in sorted(by_axes, key=lambda a: (len(a), a), reverse=True):
        part = sum(by_axes[axes])
        total = total + (axis_sum(part, axes) if axes else part)
    return torch.sqrt(total)


@torch.no_grad()
def update(grads, state: Dict, params, cfg: AdamWConfig, *,
           split: Optional[Sequence[Tuple[str, ...]]] = None,
           axis_sum: Optional[Callable] = None
           ) -> Tuple[object, Dict, Dict[str, torch.Tensor]]:
    """One AdamW step, in place.  Returns (params, state, metrics).
    ``split`` / ``axis_sum``: the gradient norm of blocks
    (:func:`global_norm`)."""
    step = state["step"] + 1
    gnorm = global_norm(grads, split, axis_sum)
    flat_g = [g.float() for g in leaves(grads)]
    if cfg.clip_norm is not None:
        scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
        for g in flat_g:
            g.mul_(scale)
    lr = lr_at(cfg, step)
    b1c = 1.0 - cfg.b1 ** step.to(torch.float32)
    b2c = 1.0 - cfg.b2 ** step.to(torch.float32)
    for p, g, m, v in zip(leaves(params), flat_g, leaves(state["m"]),
                          leaves(state["v"])):
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g.square())
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        p32 = p.float()
        if cfg.weight_decay:
            delta.add_(cfg.weight_decay * p32)
        p.copy_(p32 - lr * delta)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}


def state_specs(param_specs) -> Dict:
    """Optimizer-state logical specs mirror the parameter specs (ZeRO):
    ``{"m": param_specs, "v": param_specs, "step": ()}``."""
    return {"m": param_specs, "v": param_specs, "step": ()}
