"""Load the JAX package's parameters and decode state into the port.

``from_jax_params`` takes the tree ``repro.models.lm.init`` returns, with
its leaves already turned into numpy arrays (the port imports no JAX):
nested dicts, ``blocks`` a tuple of dicts whose leaves are stacked on a
leading ``num_groups`` axis.  It returns the same tree of tensors on
``device``.  Matrices and biases are cast once, here, to ``dtype``: by
default the activation dtype the card computes in (the values JAX's
per-call casts produce), which serving uses; the trainer's tests pass
``cfg.parameter_dtype`` for float32 masters.  The leaves the JAX code reads
in float32 stay float32: norm scales, the RG-LRU's ``lambda_raw``, the
mLSTM's gate bias ``b_if``, the xLSTM blocks' ``gn_scale`` and the sLSTM's
recurrent matrix ``r_gates``.  An MoE block's ``ffn`` leaves (``router``,
``wi``, ``wg``, ``wo``) are matrices like any other and take ``dtype``:
the reference casts each, the router included, to the activation dtype
where it is used.

``from_jax_state`` takes the state ``repro.models.lm.init_state`` or
``prefill`` returns (a tuple of dicts of stacked numpy arrays) and returns
the port's :data:`repro_torch.models.lm.State`: the recurrent states (the
RG-LRU carry ``h``, the mLSTM's ``c``, ``n``, ``m``, the sLSTM's ``c``,
``n``, ``m``, ``h``) in float32, every other leaf (KV caches, conv tails)
in ``dtype``.

``model_blocks`` lays whole parameters (these, or ``lm.init``'s) out for a
rank of a mesh: each leaf its block under a tree of
:class:`repro_torch.distributed.sharding.LeafSharding`
(``train(mesh=)``'s :class:`repro_torch.launch.train.MeshPlan` ``layout``:
``model`` blocks, and their FSDP ``data`` blocks), one leaf at a time.
``state_blocks`` does the same for a decode state (``launch.common``'s
state layout), and ``relayout_state`` takes a rank's state from the
prefill rules' layout to the decode rules' by local slicing alone.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig

#: Leaves held in float32 whatever the matrices' dtype.
F32_PARAMS = ("scale", "lambda_raw", "b_if", "gn_scale", "r_gates")
F32_STATE = ("h", "c", "n", "m")


def _convert(node: Any, dev: torch.device, dtype: torch.dtype,
             f32_names, name: str = "") -> Any:
    if isinstance(node, dict):
        return {k: _convert(v, dev, dtype, f32_names, k)
                for k, v in node.items()}
    if isinstance(node, (tuple, list)):
        return tuple(_convert(v, dev, dtype, f32_names, name) for v in node)
    arr = np.array(node, dtype=np.float32)
    return torch.from_numpy(arr).to(
        device=dev, dtype=torch.float32 if name in f32_names else dtype)


def from_jax_params(tree: Any, cfg: ModelConfig, device: DeviceLike = None,
                    dtype: Optional[torch.dtype] = None) -> dict:
    return _convert(tree, resolve_device(device),
                    dtype or cfg.activation_dtype, F32_PARAMS)


def from_jax_state(state: Any, cfg: ModelConfig, device: DeviceLike = None,
                   dtype: Optional[torch.dtype] = None) -> tuple:
    return _convert(tuple(state), resolve_device(device),
                    dtype or cfg.activation_dtype, F32_STATE)


def model_blocks(params: Any, layout: Any) -> Any:
    """This rank's block of each whole parameter under ``layout`` (a tree
    like ``params`` of ``LeafSharding``): a new contiguous tensor where
    the leaf is split, the leaf itself where it is not."""
    from repro_torch.tree import tree_map
    return tree_map(lambda p, sh: sh.local(p).contiguous().clone()
                    if sh.splits else p, params, layout)


def state_blocks(state: Any, layout: Any) -> Any:
    """This rank's block of each leaf of a whole decode state under
    ``layout`` (a tree like the state of ``LeafSharding``):
    :func:`model_blocks` for a state."""
    return model_blocks(state, layout)


def relayout_state(state: Any, src: Any, dst: Any) -> Any:
    """A rank's state under the layout ``src`` as the same rank's blocks
    under ``dst``, each leaf by local slicing: every split of ``src`` must
    be one of ``dst`` (the prefill rules' layout, whose ``kv_seq`` is
    whole, to the decode rules', which may put it over ``model``); a split
    ``dst`` adds keeps this rank's block of a dim the source held whole."""
    from repro_torch.distributed.sharding import LeafSharding
    from repro_torch.tree import tree_map

    def one(x, a, b):
        missing = [sp for sp in a.splits if sp not in b.splits]
        if missing:
            raise ValueError(f"a leaf split {missing} under the source "
                             f"layout is not under the target's {b.splits}:"
                             f" the relayout needs a gather")
        extra = tuple(sp for sp in b.splits if sp not in a.splits)
        if not extra:
            return x
        return LeafSharding(b.spec, extra).local(x).contiguous().clone()

    return tree_map(one, state, src, dst)
