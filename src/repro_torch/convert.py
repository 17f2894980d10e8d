"""Load the JAX package's parameters into the port.

``from_jax_params`` takes the tree ``repro.models.lm.init`` returns, with
its leaves already turned into numpy arrays (the port imports no JAX):
nested dicts, ``blocks`` a tuple of dicts whose leaves are stacked on a
leading ``num_groups`` axis.  It returns the same tree of tensors on
``device``.  Matrices are cast once, here, to ``dtype``: by default the
activation dtype the card computes in (the values JAX's per-call
``compute_cast`` produces), which serving uses; the trainer's tests pass
``cfg.parameter_dtype`` for float32 masters.  Norm scales stay float32, as
the JAX code reads them.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig


def from_jax_params(tree: Any, cfg: ModelConfig, device: DeviceLike = None,
                    dtype: Optional[torch.dtype] = None) -> dict:
    dev = resolve_device(device)
    mat_dtype = dtype or cfg.activation_dtype

    def convert(node: Any, name: str = "") -> Any:
        if isinstance(node, dict):
            return {k: convert(v, k) for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            return tuple(convert(v, name) for v in node)
        arr = np.array(node, dtype=np.float32)
        return torch.from_numpy(arr).to(
            device=dev,
            dtype=torch.float32 if name == "scale" else mat_dtype)

    return convert(tree)
