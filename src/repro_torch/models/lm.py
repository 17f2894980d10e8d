"""Decoder LM parameters (counterpart of ``repro.models.lm``).

Only ``init`` for ``attn`` blocks is ported; it returns the same parameter
tree as ``repro.models.lm.init`` (without the sharding specs): ``embed``,
``blocks`` (a tuple, one dict per pattern position, each tensor stacked
over ``num_groups`` on its leading axis), ``final_norm`` and ``head``.
The dense forward/prefill/decode functions come with the next slice; the
serving steps are in :mod:`repro_torch.serving.model`.
"""
from __future__ import annotations

import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention
from repro_torch.models.layers import (embed_init, gated_mlp_init,
                                       rmsnorm_init, variance_scaling_init)

VOCAB_PAD = 256


def padded_vocab(cfg: ModelConfig) -> int:
    return -(-cfg.vocab_size // VOCAB_PAD) * VOCAB_PAD


def init(cfg: ModelConfig, *, seed: int = 0,
         device: DeviceLike = None) -> dict:
    """Random parameters drawn from ``torch.Generator(device).manual_seed
    (seed)``.  Matrices are held in the activation dtype, norm scales in
    float32.  Runs on ``cuda`` unless ``device`` says otherwise."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = cfg.activation_dtype
    d, lead = cfg.d_model, (cfg.num_groups,)
    vpad = padded_vocab(cfg)
    params = {"embed": embed_init(gen, vpad, d, dt)}
    blocks = []
    for btype in cfg.block_pattern:
        if btype != "attn":
            raise NotImplementedError(
                f"block type {btype!r} is not ported yet (attn only)")
        blocks.append({
            "norm1": rmsnorm_init(d, dev, lead),
            "mixer": attention.attn_init(gen, cfg, dt, lead),
            "norm2": rmsnorm_init(d, dev, lead),
            "ffn": gated_mlp_init(gen, d, cfg.d_ff, dt, lead),
        })
    params["blocks"] = tuple(blocks)
    params["final_norm"] = rmsnorm_init(d, dev)
    params["head"] = {"w": variance_scaling_init(gen, (d, vpad), dt)}
    return params
