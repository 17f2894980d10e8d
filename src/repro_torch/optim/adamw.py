"""AdamW with global-norm clipping and LR schedules
(counterpart of ``repro.optim.adamw``).

The same arithmetic, in float32 on tensors: ``lr_at``, ``init``,
``global_norm`` and ``update``.  Unlike the JAX function, :func:`update`
works **in place**: the parameters and the moments ``m`` and ``v`` are
overwritten (the clipped gradients too), so a step holds no second copy
of the model or of the optimizer state.  It returns the same (params,
state, metrics) triple, with ``params`` and the state the objects passed
in.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

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
    """Zero moments in float32 beside each parameter, and step 0."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    dev = leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(g.float().square().sum() for g in leaves(tree)))


@torch.no_grad()
def update(grads, state: Dict, params, cfg: AdamWConfig
           ) -> Tuple[object, Dict, Dict[str, torch.Tensor]]:
    """One AdamW step, in place.  Returns (params, state, metrics)."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
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
