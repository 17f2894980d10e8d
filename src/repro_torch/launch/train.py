"""Training driver (counterpart of ``repro.launch.train``).

    python -m repro_torch.launch.train --arch stablelm-1.6b --steps 5 \\
        --seq-len 2048 --batch 4 [--checkpoint-dir D] [--grad-compression]

Float32 master weights and AdamW state, compute in the config's activation
dtype (bf16 for the full configs), as in the JAX package; the data are the
JAX package's synthetic token pipeline (copied).

The step is built on the ``sma_jit`` front door, as the reference's is
(:func:`make_step`): the engine traces :func:`direct_step` -- ``lm.loss_fn``
and its ``torch.autograd.grad``, the optional int8 error-feedback round
trip (:mod:`repro_torch.optim.compress`) and the in-place
:func:`repro_torch.optim.adamw.update` -- as one joint program, and caches
it per signature: steps 2..N are cache hits.  On the card every
projection, forward, recomputed and backward, is an ``sma_gemm`` launch,
the head an ``rmsnorm_gemm`` and every attention the flash kernels, each a
node of that program.  Parameters, moments and step are updated in place
(the port's counterpart of the reference's ``donate_argnums``); the
masters do not require grad outside the step.

:func:`train` auto-resumes from the latest checkpoint in
``checkpoint_dir`` (parameters, optimizer state, error-feedback state and
the data cursor travel together), checkpoints every ``checkpoint_every``
steps, and with ``halt_at_step`` checkpoints and stops there (a simulated
fault: the resumed run equals an unbroken one).

``train(cfg, loop, mesh=...)`` runs over the ranks of a
:class:`repro_torch.launch.mesh.Mesh` (:class:`MeshPlan`), as the
reference's ``train(mesh=)`` runs its step under
``rules_for(cfg, mesh, batch_size=loop.global_batch, kind="train")``:

* **data parallelism** over the batch axes: every rank draws the same
  global batch from one data cursor and keeps its own rows; inside the
  compiled step the count of valid labels and every gradient are
  all-reduced over the batch axes (the loss and its gradient are the
  global batch's);
* **tensor parallelism** over a ``model`` axis of more than one rank:
  each rank holds its ``model`` block of every parameter whose spec
  resolves a dim to ``model`` (heads, MLP, vocab, experts, recurrent
  channels; laid out from the whole parameters by
  :func:`repro_torch.convert.model_blocks`)
  and the layers compute on their blocks through differentiable
  collectives (:mod:`repro_torch.distributed.tensor_parallel`); the grad
  norm sums the blocks' squares over ``model`` and counts each replicated
  leaf once;
* **FSDP**: every master, moment and gradient is split along its
  ``embed`` dim over ``data`` where it divides (the rules' ``embed ->
  data``; a ``data`` block of the ``model`` block where both split it),
  and each rank holds only its block (:attr:`MeshPlan.layout`).  The
  masters are drawn a rank's block at a time
  (:func:`repro_torch.models.lm.init_blocks`), never whole.  Each group's
  body gathers the group's weights in the compute dtype as its first act,
  inside its remat checkpoint, and the table and the head are gathered
  just before their use (:mod:`repro_torch.distributed.fsdp`); each
  gather's gradient is a float32 reduce-scatter over ``data``, so such a
  leaf's gradient arrives summed, and only the leaves with no ``data``
  split are all-reduced over the batch axes.  AdamW updates each rank's
  blocks in place, with no gather; the grad norm sums the blocks' squares
  over the axes each leaf is split over and counts each replicated leaf
  once.

Every collective is a node of the compiled program
(:mod:`repro_torch.distributed.collectives`).  Checkpoints stay
unsharded: a save gathers one leaf at a time to host, and the first rank
writes; a restore lays them out for the ranks and the layout it runs on,
so a run saved on a 1 x 2 or a 2 x 1 mesh resumes on the other or on 1.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch import convert
from repro_torch._device import DeviceLike, resolve_device
from repro_torch.api import SMAOptions, sma_jit
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ModelConfig, get_config, reduced
from repro_torch.data.pipeline import DataConfig, DataPipeline, PipelineState
from repro_torch.distributed import collectives, fsdp
from repro_torch.distributed.sharding import (logical_to_spec, rules_for,
                                              spec_tree_to_shardings,
                                              use_rules)
from repro_torch.models import lm
from repro_torch.obs import trace as _obs_trace
from repro_torch.optim import adamw
from repro_torch.optim import compress as gcomp
from repro_torch.tree import leaves, tree_map, unflatten


@dataclasses.dataclass
class TrainLoopConfig:
    steps: int = 100
    seq_len: int = 128
    global_batch: int = 8
    log_every: int = 10
    checkpoint_every: int = 50
    checkpoint_dir: Optional[str] = None
    # Simulated fault injection: checkpoint and halt after this step (the
    # resumed run must equal an unbroken one: the schedule and the data
    # cursor key off the global step).
    halt_at_step: Optional[int] = None
    grad_compression: bool = False
    seed: int = 0
    peak_lr: float = 3e-3
    remat: bool = True


class MeshPlan:
    """``train(mesh=)``'s plan on one rank (module docstring): the batch
    axes and this rank's rows, the all-reduce over them; the ``model``
    line and each parameter's block on it (``tp``); each ``model`` block's
    splits over the other axes (``shardings``: FSDP's ``data`` blocks,
    the layout the model gathers); both together (``layout``: every
    master, moment, gradient and error-feedback state on this rank)."""

    def __init__(self, cfg: ModelConfig, loop: "TrainLoopConfig", mesh,
                 params: dict) -> None:
        """``params``: the whole parameters (shapes only are read; ``meta``
        tensors will do)."""
        self.mesh = mesh
        self.rules = rules_for(cfg, mesh, batch_size=loop.global_batch,
                               kind="train")
        axes = tuple(a for a in (self.rules.batch or ())
                     if mesh.shape.get(a, 1) > 1)
        self.axes = axes
        self.ranks, self.index = 1, 0
        for a in axes:
            self.index = self.index * mesh.shape[a] + mesh.coords[a]
            self.ranks *= mesh.shape[a]
        self.model_key = (mesh.group_key("model")
                          if mesh.shape.get("model", 1) > 1 else None)
        specs = logical_to_spec(lm.param_specs(cfg), self.rules,
                                mesh.axis_names)
        laid = spec_tree_to_shardings(mesh, specs, like=params,
                                      groups=lm.param_groups(cfg))
        self.tp = tree_map(lambda sh: sh.only(("model",)), laid)
        local = tree_map(lambda p, sh: torch.empty(
            sh.local_shape(p.shape), device="meta"), params, self.tp)
        others = tuple(a for a in mesh.axis_names if a != "model")
        self.shardings = tree_map(
            lambda sh: sh.only(others),
            spec_tree_to_shardings(mesh, specs, like=local))
        self.layout = tree_map(lambda tp, sh: tp.with_splits(sh), self.tp,
                               self.shardings)
        #: Each leaf's split axes (the grad norm's sums), and the batch
        #: axes its gather's reduce-scatter already summed its gradient
        #: over.
        self.split = [sh.axes() for sh in leaves(self.layout)]
        self.summed = [tuple(a for a in sh.axes() if a in axes)
                       for sh in leaves(self.shardings)]

    def rows(self, batch: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        """This rank's rows of the global batch."""
        b = next(iter(batch.values())).shape[0] // self.ranks
        return {k: v[self.index * b:(self.index + 1) * b]
                for k, v in batch.items()}

    def sum(self, x: torch.Tensor, skip: Tuple[str, ...] = ()
            ) -> torch.Tensor:
        """``x`` summed over the batch axes but ``skip`` (an all-reduce a
        non-trivial axis)."""
        for a in self.axes:
            if a not in skip:
                x = collectives.all_reduce(x, self.mesh.group_key(a),
                                           span="comm.grad_all_reduce")
        return x

    def axis_sum(self, x: torch.Tensor, axes: Tuple[str, ...]
                 ) -> torch.Tensor:
        """``x`` summed over ``axes`` (the grad norm's squares of blocks)."""
        for a in axes:
            x = collectives.all_reduce(
                x, self.mesh.group_key(a),
                span="comm.tp_norm" if a == "model" else "comm.fsdp_norm")
        return x

    def _by_leaf(self, v: torch.Tensor, axes: List[Tuple[str, ...]],
                 op: str, span: str) -> torch.Tensor:
        """``v`` (one entry a leaf) reduced by ``op``, entry by entry, over
        the axes each leaf is split over (``axes``, one tuple a leaf): one
        all-reduce an axis, in one order on every rank."""
        for a in sorted({a for ax in axes for a in ax}):
            mask = torch.tensor([a in ax for ax in axes], device=v.device)
            total = collectives.all_reduce(torch.where(mask, v, 0),
                                           self.mesh.group_key(a), op=op,
                                           span=span)
            v = torch.where(mask, total, v)
        return v

    def leaf_max(self, maxes: List[torch.Tensor]) -> List[torch.Tensor]:
        """Each leaf's largest of ``maxes`` (one a leaf, this rank's
        block's) over the axes the leaf is split over (the compressed
        gradient's whole-leaf scale)."""
        return list(self._by_leaf(torch.stack(maxes), self.split, "max",
                                  "comm.compress_max").unbind())

    def gather(self, x: torch.Tensor, sharding,
               span: str = "comm.checkpoint_gather") -> torch.Tensor:
        """Every rank's block ``x`` of a split leaf, whole (a grouped dim
        put back in its order), in ``x``'s dtype."""
        return fsdp.gather_param(x, sharding, None, mesh=self.mesh,
                                 span=span)

    def whole(self, tree: dict) -> dict:
        """Every rank's blocks of ``tree`` (masters, a moment, the
        error-feedback state), whole on every rank."""
        return tree_map(lambda p, sh: self.gather(p, sh) if sh.splits
                        else p, tree, self.layout)

    def layouts(self) -> Dict[str, Any]:
        """``restore(shardings=)``'s layout of a trainer state (and
        :meth:`host`'s): masters and moments each this rank's blocks."""
        return {"params": self.layout,
                "opt": {"m": self.layout, "v": self.layout}}

    def host(self, tree: Any, layout: Any, keep: bool) -> Any:
        """``tree`` (a trainer state) on the host for a checkpoint, each
        leaf split under ``layout`` (a like tree; a missing key: whole)
        gathered first, one leaf at a time, each copied to host before the
        next is gathered, so no rank's device holds more than one whole
        leaf.  Every rank calls it (the gathers are collectives); a rank
        that does not write (``keep`` False) gets None leaves."""
        if isinstance(tree, dict):
            return {k: self.host(v, layout.get(k) if isinstance(
                layout, dict) else None, keep) for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            return tuple(self.host(v, None if layout is None else layout[i],
                                   keep) for i, v in enumerate(tree))
        if layout is not None and layout.splits:
            tree = self.gather(tree, layout)
        if not keep:
            return None
        return (tree.detach().to("cpu", copy=True).numpy()
                if isinstance(tree, torch.Tensor) else tree)

    def digest(self, params: dict) -> List[int]:
        """:func:`masters_digest` of each ``model`` block of the masters,
        whole over the other axes: the digest is a sum, so a block's
        digests are summed over the axes the block is split over (one
        all-reduce of the digests an axis; none without such a split).
        Every rank of a ``data`` line reads the same digests where its
        replicas agree.  Only a leaf whole over ``data`` (a norm scale)
        can show ranks parting: a split leaf's blocks each live on one
        rank, and the summed digest is the same on all of them by
        construction."""
        d = torch.tensor(masters_digest(params), dtype=torch.int64,
                         device=leaves(params)[0].device)
        return self._by_leaf(d, [sh.axes() for sh in leaves(self.shardings)],
                             "sum", "comm.digest").tolist()


def direct_step(params, opt_state, ef, batch, *, cfg: ModelConfig,
                ocfg: adamw.AdamWConfig, remat: bool,
                grad_compression: bool, plan: Optional[MeshPlan] = None):
    """One step, run as written: ``(params, opt_state, ef, metrics)``.

    The gradient is taken with respect to detached copies of the masters
    (so the masters need not require grad); ``params`` and the moments are
    then updated in place and returned, ``opt_state["step"]`` and ``ef``
    replaced.  With ``plan`` (``train(mesh=)``), ``batch`` is this rank's
    rows, ``params`` its blocks, and the step is the meshed one of the
    module docstring.  This is the function :func:`make_step` compiles."""
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    if plan is None:
        loss, metrics = lm.loss_fn(live, cfg, batch, remat=remat)
        grads = unflatten(live, torch.autograd.grad(loss, leaves(live)))
    else:
        with use_rules(plan.rules, plan.mesh.axis_names, mesh=plan.mesh):
            loss, metrics = lm.loss_fn(live, cfg, batch, remat=remat,
                                       dp_sum=plan.sum, dp_ranks=plan.ranks,
                                       fsdp=plan.shardings)
            grads = unflatten(live, [
                plan.sum(g, skip) for g, skip in zip(
                    torch.autograd.grad(loss, leaves(live)), plan.summed)])
    if grad_compression:
        grads, ef = gcomp.roundtrip(
            grads, ef, plan.leaf_max if plan is not None else None)
    params, opt_state, om = adamw.update(
        grads, opt_state, params, ocfg,
        split=plan.split if plan is not None else None,
        axis_sum=plan.axis_sum if plan is not None else None)
    return params, opt_state, ef, {**metrics, **om}


def make_step(cfg: ModelConfig, ocfg: adamw.AdamWConfig, *, remat: bool,
              grad_compression: bool, options: Optional[SMAOptions] = None,
              plan: Optional[MeshPlan] = None):
    """The train step on the ``sma_jit`` front door:
    ``step(params, opt_state, ef, batch) -> (params, opt_state, ef,
    metrics)``, :func:`direct_step` traced forward, backward and optimizer
    as one program and cached per abstract signature (a new sequence
    length or batch compiles once)."""
    step = functools.partial(direct_step, cfg=cfg, ocfg=ocfg, remat=remat,
                             grad_compression=grad_compression, plan=plan)
    return sma_jit(step, options=options, name=f"{cfg.name}.train_step")


def masters_digest(params) -> List[int]:
    """One checksum a master: the sum of its bits read as integers of
    its width (equal masters give equal digests; one changed element
    changes its leaf's)."""
    ints = {2: torch.int16, 4: torch.int32}
    return torch.stack([p.view(ints[p.element_size()]).sum(dtype=torch.int64)
                        for p in leaves(params)]).tolist()


def _state(params, opt_state, ef, pipe: DataPipeline) -> Dict[str, Any]:
    return {"params": params, "opt": opt_state, "ef": ef,
            "data": pipe.state.to_dict()}


def train(cfg: ModelConfig, loop: TrainLoopConfig, *,
          device: DeviceLike = None, params: Optional[dict] = None,
          options: Optional[SMAOptions] = None, mesh=None
          ) -> Dict[str, Any]:
    """Train for ``loop.steps`` steps through :func:`make_step`'s engine.
    Runs on ``cuda`` unless ``device`` says otherwise.  ``params`` (float32
    masters on ``device``, whole; updated in place without a ``mesh``)
    default to ``lm.init(cfg, seed=loop.seed)`` in ``cfg.parameter_dtype``
    (with a ``mesh``, this rank's blocks of them, drawn by
    :func:`repro_torch.models.lm.init_blocks`; given ``params`` are laid
    out a leaf at a time).  ``mesh``: data, tensor and FSDP parallelism over
    its ranks (module docstring; every rank calls ``train`` with the same
    arguments).  Returns ``{"history", "params", "opt", "engine", "plan"}``
    (``"params"`` this rank's masters, its block of each split one;
    ``"opt"`` the optimizer state, its block of each split moment;
    ``"plan"`` the :class:`MeshPlan`, or None): history has one entry per
    logged step with the metrics, ``step`` and ``wall_s`` (host seconds
    since the first step of this run began, taken after the metrics reach
    the host), and with a ``mesh`` ``masters_digest`` (:meth:`MeshPlan.
    digest`: of each ``model`` block whole over ``data``, so the replicas
    agree at that step when their digests do); ``engine`` is the step
    engine's cache statistics."""
    dev = resolve_device(device)
    plan = None
    if mesh is not None:
        plan = MeshPlan(cfg, loop, mesh, params if params is not None
                        else lm.abstract_params(cfg, cfg.parameter_dtype))
        params = (lm.init_blocks(cfg, plan.layout, seed=loop.seed,
                                 device=dev, dtype=cfg.parameter_dtype)
                  if params is None
                  else convert.model_blocks(params, plan.layout))
    elif params is None:
        params = lm.init(cfg, seed=loop.seed, device=dev,
                         dtype=cfg.parameter_dtype)
    for p in leaves(params):
        p.requires_grad_(False)
    lead = plan is None or mesh.rank == 0
    opt_state = adamw.init(params)
    ef = gcomp.init_error(params) if loop.grad_compression else {}
    pipe = DataPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                   seq_len=loop.seq_len,
                                   global_batch=loop.global_batch,
                                   seed=loop.seed,
                                   input_mode=cfg.input_mode,
                                   d_model=cfg.d_model,
                                   num_vision_tokens=cfg.num_vision_tokens),
                        device=dev)
    start_step = 0

    mgr = (CheckpointManager(loop.checkpoint_dir)
           if loop.checkpoint_dir else None)
    if mgr is not None and mgr.latest_step() is not None:
        layout = None
        if plan is not None:
            layout = plan.layouts()
            if ef:
                layout["ef"] = plan.layout
        start_step, restored = mgr.restore(_state(params, opt_state, ef,
                                                  pipe), shardings=layout)
        params, opt_state, ef = (restored["params"], restored["opt"],
                                 restored["ef"])
        pipe.state = PipelineState.from_dict(restored["data"])
        print(f"[train] resumed from step {start_step}")

    ocfg = adamw.AdamWConfig(peak_lr=loop.peak_lr,
                             warmup_steps=max(loop.steps // 10, 1),
                             total_steps=loop.steps)
    step_fn = make_step(cfg, ocfg, remat=loop.remat,
                        grad_compression=loop.grad_compression,
                        options=options, plan=plan)

    def save(step: int) -> None:
        """Every rank gathers the split leaves, one at a time, each to
        host before the next (:meth:`MeshPlan.host`); the first one
        writes."""
        state = _state(params, opt_state, ef, pipe)
        if plan is not None:
            layout = plan.layouts()
            if ef:
                layout["ef"] = plan.layout
            state = plan.host(state, layout, keep=lead)
        if lead:
            mgr.save(step, state)

    def commit() -> None:
        if lead:
            mgr.wait()
        if plan is not None:       # no rank reads before the commit
            for key in [mesh.group_key(a) for a in plan.axes] + \
                    [plan.model_key] * bool(plan.model_key):
                collectives.all_reduce(torch.zeros((), device=dev), key)

    def finish() -> Dict[str, Any]:
        return {"history": history, "params": params, "opt": opt_state,
                "engine": step_fn.stats.asdict(), "plan": plan}

    history = []
    t0 = time.perf_counter()
    for i in range(start_step, loop.steps):
        batch = next(pipe)
        if plan is not None:
            batch = plan.rows(batch)
        with _obs_trace.span("train.step", cat="train", step=i):
            params, opt_state, ef, metrics = step_fn(params, opt_state, ef,
                                                     batch)
        if (i + 1) % loop.log_every == 0 or i == loop.steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = i + 1
            if plan is not None:
                m["masters_digest"] = plan.digest(params)
            m["wall_s"] = time.perf_counter() - t0
            history.append(m)
            if lead:
                print(f"[train] step {i + 1:5d} loss={m['loss']:.4f} "
                      f"acc={m['accuracy']:.3f} "
                      f"gnorm={m['grad_norm']:.2f}", flush=True)
        if mgr is not None and (i + 1) % loop.checkpoint_every == 0:
            save(i + 1)
        if loop.halt_at_step is not None and (i + 1) == loop.halt_at_step:
            if mgr is not None:
                if (i + 1) % loop.checkpoint_every != 0:
                    save(i + 1)
                commit()
            if lead:
                print(f"[train] simulated fault: halted at step {i + 1}")
            return finish()
    if mgr is not None:
        save(loop.steps)
        commit()
    return finish()


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--device", default=None,
                    help="default cuda; 'cpu' runs the plain versions")
    ap.add_argument("--out", default=None, help="write history JSON here")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    loop = TrainLoopConfig(steps=args.steps, seq_len=args.seq_len,
                           global_batch=args.batch,
                           checkpoint_dir=args.checkpoint_dir,
                           grad_compression=args.grad_compression,
                           peak_lr=args.lr)
    result = train(cfg, loop, device=args.device)
    print(f"[train] engine {json.dumps(result['engine'])}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result["history"], f, indent=1)


if __name__ == "__main__":
    main()
