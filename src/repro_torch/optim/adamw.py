"""AdamW with global-norm clipping and LR schedules
(counterpart of ``repro.optim.adamw``).

The same arithmetic, in float32 on tensors: ``lr_at``, ``init``,
``global_norm`` and ``update``.  Unlike the JAX function, :func:`update`
works **in place**: the parameters and the moments ``m`` and ``v`` are
overwritten (the clipped gradients too), so a step holds no second copy
of the model or of the optimizer state.  It returns the same (params,
state, metrics) triple, with ``params`` and the state the objects passed
in.

ZeRO-1 (``train(mesh=)``): with ``shardings`` (a tree of
:class:`repro_torch.distributed.sharding.LeafSharding` like the
parameters) :func:`init` makes each moment this rank's block of it, and
:func:`update` updates this rank's block of each split master from the
full (all-reduced) gradient, then ``gather`` (an all-gather over the
split's axes) puts the whole master back on every rank.  The update is
elementwise, so a split changes no bit of it.

Tensor parallelism: the masters are each rank's ``model`` blocks (the
moments a block of that block where ZeRO-1 splits it further over
``data``), and the gradient norm is taken over the whole model:
``model_sum`` sums the squares of the split leaves' blocks over the
``model`` line, and each replicated leaf counts once, so every rank clips
by the same scale.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

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


def init(params, shardings=None) -> Dict:
    """Zero moments in float32 beside each parameter (this rank's block of
    it under ``shardings``), and step 0."""
    def zeros(p, sh=None):
        shape = p.shape if sh is None else sh.local_shape(p.shape)
        return torch.zeros(shape, dtype=torch.float32, device=p.device)
    dev = leaves(params)[0].device
    if shardings is None:
        m, v = tree_map(zeros, params), tree_map(zeros, params)
    else:
        m = tree_map(zeros, params, shardings)
        v = tree_map(zeros, params, shardings)
    return {"m": m, "v": v,
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree, split=None,
                model_sum: Optional[Callable] = None) -> torch.Tensor:
    """The 2-norm of every leaf together.  With ``split`` (one flag a
    leaf: a block of a leaf split over the model line) and ``model_sum``
    (a sum over that line), the blocks' squares are summed over the line
    and each whole leaf's counted once."""
    if model_sum is None:
        return torch.sqrt(sum(g.float().square().sum()
                              for g in leaves(tree)))
    squares = [g.float().square().sum() for g in leaves(tree)]
    blocks = sum((q for q, sp in zip(squares, split) if sp),
                 torch.zeros((), device=squares[0].device))
    whole = sum((q for q, sp in zip(squares, split) if not sp),
                torch.zeros((), device=squares[0].device))
    return torch.sqrt(model_sum(blocks) + whole)


@torch.no_grad()
def update(grads, state: Dict, params, cfg: AdamWConfig, *,
           shardings=None, gather: Optional[Callable] = None,
           split=None, model_sum: Optional[Callable] = None
           ) -> Tuple[object, Dict, Dict[str, torch.Tensor]]:
    """One AdamW step, in place.  Returns (params, state, metrics).
    ``shardings`` / ``gather``: ZeRO-1 (module docstring); ``gather(x,
    sharding)`` returns the whole tensor of every rank's block ``x``.
    ``split`` / ``model_sum``: the gradient norm under tensor parallelism
    (:func:`global_norm`)."""
    step = state["step"] + 1
    gnorm = global_norm(grads, split, model_sum)
    flat_g = [g.float() for g in leaves(grads)]
    if cfg.clip_norm is not None:
        scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
        for g in flat_g:
            g.mul_(scale)
    lr = lr_at(cfg, step)
    b1c = 1.0 - cfg.b1 ** step.to(torch.float32)
    b2c = 1.0 - cfg.b2 ** step.to(torch.float32)
    flat_sh = (leaves(shardings) if shardings is not None
               else [None] * len(flat_g))
    for p, g, m, v, sh in zip(leaves(params), flat_g, leaves(state["m"]),
                              leaves(state["v"]), flat_sh):
        split = sh is not None and sh.splits
        if split:
            g = sh.local(g)
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g.square())
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        p32 = (sh.local(p) if split else p).float()
        if cfg.weight_decay:
            delta.add_(cfg.weight_decay * p32)
        new = p32 - lr * delta
        if split:
            new = gather(new.to(p.dtype), sh)
        p.copy_(new)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}


def state_specs(param_specs) -> Dict:
    """Optimizer-state logical specs mirror the parameter specs (ZeRO):
    ``{"m": param_specs, "v": param_specs, "step": ()}``."""
    return {"m": param_specs, "v": param_specs, "step": ()}
