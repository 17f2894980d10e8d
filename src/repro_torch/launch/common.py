"""Shared launch machinery: abstract parameters, input specs, step builders
and the per-cell plan (counterpart of ``repro.launch.common``).

The reference lowers one jitted step a cell on a device mesh and lets
GSPMD lay the arrays out by their logical specs.  The port runs each rank
of a ``torch.distributed`` mesh (:class:`repro_torch.launch.mesh.Mesh`) on
its own blocks under the same rules (:func:`repro_torch.distributed.
sharding.rules_for` with the cell's kind):

* **parameters**: each rank's ``model`` block of every leaf whose spec
  resolves a dim to ``"model"`` (heads, KV heads, MLP, vocab, experts,
  recurrent channels), whole over the other axes: the serving cells hold
  no FSDP ``data`` split (the rules' ``embed -> data`` is the trainer's
  storage split, :class:`repro_torch.launch.train.MeshPlan`);
* **batch**: each rank's rows over the rules' batch axes;
* **decode state**: each rank's block of every leaf under
  ``lm.state_specs`` (the batch's rows, the KV heads or, under the decode
  rules where the KV heads do not divide ``model``, the KV cache's slots:
  decode context parallelism, :mod:`repro_torch.distributed.
  context_parallel`), whole over ``head_dim`` (the serving steps compute
  attention whole where ``head_dim`` resolves to ``model``).

The layers read their split from their blocks' shapes and the mesh
:func:`repro_torch.distributed.sharding.use_rules` installs
(:mod:`repro_torch.distributed.tensor_parallel`).  Under the prefill
rules ``kv_seq`` is whole, so a prefill's state reaches the decode rules'
layout by local slicing (:func:`repro_torch.convert.relayout_state`).

:func:`build_cell` returns one rank's step and that rank's arguments:
blocks drawn from a seed (bit for bit the blocks of ``lm.init``'s whole
parameters), or ``meta`` tensors of the local shapes.  The train cell is
``train(mesh=)``'s step on its :class:`~repro_torch.launch.train.MeshPlan`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.distributed.sharding import (MeshRules, logical_to_spec,
                                              rules_for,
                                              spec_tree_to_shardings,
                                              use_rules)
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.tree import tree_map

__all__ = ["DECODE_MARGIN", "abstract_opt_state", "abstract_params",
           "batch_abstract", "batch_rows", "build_cell", "cell_rules",
           "decode_state_abstract", "make_decode_step", "make_prefill_step",
           "make_train_step", "param_layout", "param_specs", "state_layout"]

DECODE_MARGIN = 16  # cache capacity beyond seq_len (keeps dims TP-divisible)


# ---------------------------------------------------------------------------
# Abstract parameter / state trees + logical specs
# ---------------------------------------------------------------------------
def param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    """The logical-axis spec tree of the parameters."""
    return lm.param_specs(cfg)


def abstract_params(cfg: ModelConfig,
                    dtype: Optional[torch.dtype] = None) -> dict:
    """The whole parameters as ``meta`` tensors (nothing is drawn)."""
    return lm.abstract_params(cfg, dtype)


def abstract_opt_state(aparams: dict) -> dict:
    """AdamW's state beside ``aparams`` (``meta`` tensors for ``meta``
    parameters)."""
    return adamw.init(aparams)


def batch_abstract(cfg: ModelConfig, shape: ShapeConfig
                   ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Tuple]]:
    """(``meta`` tensors, logical specs) of one step's global batch, by the
    config's input mode; a decode step takes one position and no vision
    prefix."""
    b = shape.global_batch
    s = 1 if shape.kind == "decode" else shape.seq_len
    act = cfg.activation_dtype

    def sd(dims, dtype):
        return torch.empty(dims, dtype=dtype, device="meta")

    batch: Dict[str, torch.Tensor] = {}
    specs: Dict[str, Tuple] = {}
    seq_ax = None if shape.kind == "decode" else "seq"
    if cfg.input_mode == "embeds":
        batch["embeds"] = sd((b, s, cfg.d_model), act)
        specs["embeds"] = ("batch", seq_ax, "embed_act")
    elif cfg.input_mode == "tokens+vision":
        nv = cfg.num_vision_tokens if shape.kind != "decode" else 0
        batch["tokens"] = sd((b, s - nv), torch.int32)
        specs["tokens"] = ("batch", seq_ax)
        if shape.kind != "decode":
            batch["vision_embeds"] = sd((b, nv, cfg.d_model), act)
            specs["vision_embeds"] = ("batch", None, "embed_act")
    else:
        batch["tokens"] = sd((b, s), torch.int32)
        specs["tokens"] = ("batch", seq_ax)
    if shape.kind == "train":
        batch["labels"] = sd((b, shape.seq_len), torch.int32)
        specs["labels"] = ("batch", "seq")
    return batch, specs


def decode_state_abstract(cfg: ModelConfig, shape: ShapeConfig) -> tuple:
    """The whole decode state of a cell as ``meta`` tensors."""
    return lm.init_state(cfg, shape.global_batch,
                         shape.seq_len + DECODE_MARGIN, device="meta")


# ---------------------------------------------------------------------------
# Layouts: this rank's blocks under a cell's rules
# ---------------------------------------------------------------------------
def cell_rules(cfg: ModelConfig, shape: ShapeConfig, mesh) -> MeshRules:
    """The rules of one cell: ``rules_for`` with its batch and kind."""
    return rules_for(cfg, mesh, batch_size=shape.global_batch,
                     kind=shape.kind)


def param_layout(cfg: ModelConfig, rules: MeshRules, mesh) -> Any:
    """Each parameter's ``model`` block on this rank (a tree like the
    parameters of ``LeafSharding``; whole over the other axes)."""
    specs = logical_to_spec(lm.param_specs(cfg), rules, mesh.axis_names)
    laid = spec_tree_to_shardings(mesh, specs, like=abstract_params(cfg),
                                  groups=lm.param_groups(cfg))
    return tree_map(lambda sh: sh.only(("model",)), laid)


def state_layout(cfg: ModelConfig, shape: ShapeConfig, rules: MeshRules,
                 mesh) -> Any:
    """Each decode-state leaf's block on this rank under ``rules``
    (``lm.state_specs``; whole over ``head_dim``)."""
    rules = dataclasses.replace(rules, head_dim=None)
    specs = logical_to_spec(lm.state_specs(cfg), rules, mesh.axis_names)
    return spec_tree_to_shardings(mesh, specs,
                                  like=decode_state_abstract(cfg, shape))


def batch_rows(batch: Dict[str, torch.Tensor], rules: MeshRules,
               mesh) -> Dict[str, torch.Tensor]:
    """This rank's rows of a global batch (any tree of tensors led by the
    batch dim) over the rules' batch axes."""
    named = ((rules.batch,) if isinstance(rules.batch, str)
             else rules.batch or ())
    axes = [a for a in named if mesh.shape.get(a, 1) > 1]
    ranks, index = 1, 0
    for a in axes:
        index = index * mesh.shape[a] + mesh.coords[a]
        ranks *= mesh.shape[a]
    if ranks == 1:
        return batch
    return tree_map(lambda t: t.narrow(0, index * (t.shape[0] // ranks),
                                       t.shape[0] // ranks), batch)


# ---------------------------------------------------------------------------
# Step builders
# ---------------------------------------------------------------------------
def make_train_step(cfg: ModelConfig, loop, mesh):
    """``train(mesh=)``'s compiled step on its plan for ``loop`` (a
    :class:`repro_torch.launch.train.TrainLoopConfig`): (step, plan)."""
    from repro_torch.launch.train import MeshPlan, make_step
    plan = MeshPlan(cfg, loop, mesh,
                    abstract_params(cfg, cfg.parameter_dtype))
    ocfg = adamw.AdamWConfig(peak_lr=loop.peak_lr,
                             warmup_steps=max(loop.steps // 10, 1),
                             total_steps=loop.steps)
    return make_step(cfg, ocfg, remat=loop.remat,
                     grad_compression=loop.grad_compression,
                     plan=plan), plan


def make_decode_step(cfg: ModelConfig, cache_size: int,
                     rules: Optional[MeshRules], mesh) -> Callable:
    """``step(params, state, cache_len, batch) -> (logits, state,
    cache_len)``: ``lm.decode_step`` under ``rules`` on this rank's
    blocks, whose caches are blocks of caches of ``cache_size``."""
    axes = () if mesh is None else mesh.axis_names

    def serve_step(params, state, cache_len, batch):
        with use_rules(rules, axes, mesh=mesh):
            return lm.decode_step(params, state, cache_len, cfg, batch,
                                  cache_size=cache_size)

    return serve_step


def make_prefill_step(cfg: ModelConfig, cache_size: int,
                      rules: Optional[MeshRules], mesh) -> Callable:
    """``step(params, batch) -> (logits, state, cache_len)``:
    ``lm.prefill`` under ``rules`` on this rank's blocks."""
    axes = () if mesh is None else mesh.axis_names

    def serve_step(params, batch):
        with use_rules(rules, axes, mesh=mesh):
            return lm.prefill(params, cfg, batch, cache_size=cache_size)

    return serve_step


# ---------------------------------------------------------------------------
# One (arch x shape x mesh) cell on this rank
# ---------------------------------------------------------------------------
def _data_batch(cfg: ModelConfig, shape: ShapeConfig, seed: int,
                dev: torch.device) -> Dict[str, torch.Tensor]:
    """The cell's global batch from the synthetic pipeline (batch 0 of
    ``seed``): a train batch with labels, a prefill's without, a decode
    step's one token (or frame) a row."""
    decode = shape.kind == "decode"
    mode = ("tokens" if decode and cfg.input_mode == "tokens+vision"
            else cfg.input_mode)
    data = make_batch(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=1 if decode else shape.seq_len,
        global_batch=shape.global_batch, seed=seed, input_mode=mode,
        d_model=cfg.d_model, num_vision_tokens=cfg.num_vision_tokens), 0)
    if shape.kind != "train":
        data.pop("labels")
    return {k: torch.from_numpy(v).to(dev) for k, v in data.items()}


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
               seed: int = 0, device: DeviceLike = None,
               abstract: bool = False) -> Tuple[Callable, tuple]:
    """(step, args) of one cell on this rank (``step(*args)`` runs it):

    * ``train``: ``train(mesh=)``'s step, args (masters, AdamW state, the
      error-feedback state, this rank's batch rows);
    * ``prefill``: args (parameters, this rank's batch rows), the caches
      sized ``seq_len + DECODE_MARGIN``;
    * ``decode``: args (parameters, a zeroed decode state, cache_len 0,
      one token a row), each this rank's blocks and rows.

    The blocks are drawn from ``seed`` (``lm.init_blocks``: the blocks of
    ``lm.init(cfg, seed=seed)``; the trainer's in float32), the batch is
    the synthetic pipeline's; with ``abstract`` every argument is a
    ``meta`` tensor of this rank's shape.  Runs on ``cuda`` unless
    ``device`` says otherwise."""
    dev = torch.device("meta") if abstract else resolve_device(device)
    rules = cell_rules(cfg, shape, mesh)
    whole = (batch_abstract(cfg, shape)[0] if abstract
             else _data_batch(cfg, shape, seed, dev))
    batch = batch_rows(whole, rules, mesh)
    if abstract:
        batch = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                               device="meta"), batch)

    def blocks(layout, dtype=None):
        if abstract:
            return tree_map(lambda t, sh: torch.empty(
                sh.local_shape(t.shape), dtype=t.dtype, device="meta"),
                abstract_params(cfg, dtype), layout)
        return lm.init_blocks(cfg, layout, seed=seed, device=dev,
                              dtype=dtype)

    if shape.kind == "train":
        from repro_torch.launch.train import TrainLoopConfig
        loop = TrainLoopConfig(steps=1, seq_len=shape.seq_len,
                               global_batch=shape.global_batch, seed=seed)
        step, plan = make_train_step(cfg, loop, mesh)
        params = blocks(plan.layout, cfg.parameter_dtype)
        return step, (params, abstract_opt_state(params), {}, batch)
    cache_size = shape.seq_len + DECODE_MARGIN
    params = blocks(param_layout(cfg, rules, mesh))
    if shape.kind == "prefill":
        return make_prefill_step(cfg, cache_size, rules, mesh), (params,
                                                                  batch)
    rows = next(iter(batch.values())).shape[0]
    state = lm.init_state(cfg, shape.global_batch, cache_size, device=dev,
                          layout=state_layout(cfg, shape, rules, mesh))
    cache_len = torch.zeros((rows,), dtype=torch.int32, device=dev)
    return (make_decode_step(cfg, cache_size, rules, mesh),
            (params, state, cache_len, batch))
