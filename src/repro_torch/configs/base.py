"""Model configuration (counterpart of ``repro.configs.base``).

Only the fields the ported paths read are kept; ``dtype`` (the compute
dtype) and ``param_dtype`` (the trainer's master weights) resolve to torch
dtypes.  ``reduced()`` derives the same tiny CPU-test variant as the JAX
package.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional, Tuple

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    block_pattern: Tuple[str, ...]
    num_groups: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    rope_theta: float = 10000.0
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    source: str = ""

    @property
    def num_layers(self) -> int:
        return self.num_groups * len(self.block_pattern)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def activation_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def parameter_dtype(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]


REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    """Load an architecture config by id (imports its module on demand)."""
    if name not in REGISTRY:
        mod = name.replace("-", "_").replace(".", "_")
        importlib.import_module(f"repro_torch.configs.{mod}")
    return REGISTRY[name]


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family variant for CPU tests (same rules as ``repro``)."""
    if cfg.num_kv_heads == 1:
        kv = 1
    elif cfg.num_kv_heads == cfg.num_heads:
        kv = 4
    else:
        kv = 2
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        num_groups=max(1, min(2, cfg.num_groups)),
        d_model=64,
        num_heads=4,
        num_kv_heads=kv,
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        dtype="float32",
        param_dtype="float32",
    )
