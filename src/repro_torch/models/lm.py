"""Decoder LM: parameters, the dense forward and the loss
(counterpart of ``repro.models.lm``, ``attn`` blocks).

``init`` returns the same parameter tree as ``repro.models.lm.init``
(without the sharding specs): ``embed``, ``blocks`` (a tuple, one dict per
pattern position, each tensor stacked over ``num_groups`` on its leading
axis), ``final_norm`` and ``head``.  :func:`forward` and :func:`loss_fn`
are the train path (the trainer is :mod:`repro_torch.launch.train`); the
serving steps are in :mod:`repro_torch.serving.model`.  ``prefill`` and
``decode_step`` over a contiguous cache are not ported.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import attention
from repro_torch.models.layers import (compute_cast, embed_init,
                                       gated_mlp_apply, gated_mlp_init,
                                       rmsnorm_apply, rmsnorm_init,
                                       variance_scaling_init)

VOCAB_PAD = 256


def padded_vocab(cfg: ModelConfig) -> int:
    return -(-cfg.vocab_size // VOCAB_PAD) * VOCAB_PAD


def check_pattern(cfg: ModelConfig) -> None:
    for btype in cfg.block_pattern:
        if btype != "attn":
            raise NotImplementedError(
                f"block type {btype!r} is not ported yet (attn only)")


def init(cfg: ModelConfig, *, seed: int = 0, device: DeviceLike = None,
         dtype: Optional[torch.dtype] = None) -> dict:
    """Random parameters drawn from ``torch.Generator(device).manual_seed
    (seed)``.  Matrices are held in ``dtype`` (default: the activation
    dtype, which serving computes in; the trainer passes
    ``cfg.parameter_dtype`` for f32 masters), norm scales in float32.  Runs
    on ``cuda`` unless ``device`` says otherwise."""
    check_pattern(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = dtype or cfg.activation_dtype
    d, lead = cfg.d_model, (cfg.num_groups,)
    vpad = padded_vocab(cfg)
    params = {"embed": embed_init(gen, vpad, d, dt)}
    params["blocks"] = tuple({
        "norm1": rmsnorm_init(d, dev, lead),
        "mixer": attention.attn_init(gen, cfg, dt, lead),
        "norm2": rmsnorm_init(d, dev, lead),
        "ffn": gated_mlp_init(gen, d, cfg.d_ff, dt, lead),
    } for _ in cfg.block_pattern)
    params["final_norm"] = rmsnorm_init(d, dev)
    params["head"] = {"w": variance_scaling_init(gen, (d, vpad), dt)}
    return params


def unstack(tree, n: int) -> List:
    """``n`` per-group trees of a stacked tree (views, no copy), by one
    ``unbind`` per leaf (its backward is one stack of the group
    gradients)."""
    if isinstance(tree, dict):
        parts = {k: unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][g] for k in tree} for g in range(n)]
    return list(tree.unbind(0))


def _block(bparams: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """One ``attn`` block: x + attn(norm1 x), then + mlp(norm2 x)."""
    x = x + attention.attn_apply(bparams["mixer"],
                                 rmsnorm_apply(bparams["norm1"], x), cfg)
    return x + gated_mlp_apply(bparams["ffn"],
                               rmsnorm_apply(bparams["norm2"], x))


def forward(params: dict, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            *, remat: bool = False) -> torch.Tensor:
    """Logits (B, S, Vpad) in the activation dtype; padded-vocab columns
    are -1e30.

    ``remat`` recomputes each group in the backward
    (``torch.utils.checkpoint``, the counterpart of ``Runtime.remat`` with
    policy ``"full"``): every forward launch of a group runs twice a step.
    ``final_norm -> head`` is one fused ``rmsnorm_gemm`` (the JAX
    compiler's prologue-fusion rule)."""
    check_pattern(cfg)
    dt = cfg.activation_dtype
    x = compute_cast(params["embed"]["table"][batch["tokens"].long()], dt)
    groups = [unstack(p, cfg.num_groups) for p in params["blocks"]]

    def group_body(x: torch.Tensor, g: int) -> torch.Tensor:
        for p in range(len(cfg.block_pattern)):
            x = _block(groups[p][g], x, cfg)
        return x

    for g in range(cfg.num_groups):
        if remat:
            x = checkpoint(group_body, x, g, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = group_body(x, g)
    logits = ops.rmsnorm_gemm(x, params["final_norm"]["scale"],
                              compute_cast(params["head"]["w"], dt))
    if logits.shape[-1] != cfg.vocab_size:
        col = torch.arange(logits.shape[-1], device=logits.device)
        logits = logits.masked_fill(col >= cfg.vocab_size, -1e30)
    return logits


def loss_fn(params: dict, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            *, remat: bool = False
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross-entropy in float32; labels -1 are ignored.
    Returns (loss, {"ce_loss", "loss", "accuracy"}), as ``repro``'s
    ``loss_fn`` for a dense model."""
    logits32 = forward(params, cfg, batch, remat=remat).float()
    labels = batch["labels"].long()
    valid = labels >= 0
    safe = torch.where(valid, labels, 0)
    lse = torch.logsumexp(logits32, dim=-1)
    label_logit = logits32.gather(-1, safe[..., None])[..., 0]
    ce = torch.where(valid, lse - label_logit, 0.0)
    denom = valid.float().sum().clamp(min=1.0)
    loss = ce.sum() / denom
    with torch.no_grad():
        hit = (logits32.argmax(-1) == safe) & valid
        acc = hit.float().sum() / denom
    return loss, {"ce_loss": loss.detach(), "loss": loss.detach(),
                  "accuracy": acc}
