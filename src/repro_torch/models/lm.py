"""Decoder LM: parameters, the forward and the loss, and the
contiguous-state serving steps (counterpart of ``repro.models.lm``, block
types ``attn``, ``local``, ``rglru``, ``mlstm`` and ``slstm``; an
``attn``/``local`` block's FFN is a mixture of experts when ``cfg.moe`` is
set, :mod:`repro_torch.models.moe`).

``init`` returns the same parameter tree as ``repro.models.lm.init``
(without the sharding specs): ``embed`` (not in ``embeds`` mode),
``blocks`` (a tuple, one dict per pattern position, each tensor stacked
over ``num_groups`` on its leading axis; an xLSTM block has ``norm1`` and
``mixer`` only; an MoE block's ``ffn`` is ``router``, ``wi``, ``wg``,
``wo``), ``final_norm`` and ``head``.  :func:`forward` and :func:`loss_fn`
are the train path (the trainer is :mod:`repro_torch.launch.train`);
:func:`loss_fn` adds an MoE model's auxiliary losses, which
:func:`forward_aux` returns beside the logits.
:func:`init_state`, :func:`prefill` and :func:`decode_step` serve over a
contiguous state (KV caches and recurrent states, stacked over groups like
the parameters); the paged serving steps of the engine are in
:mod:`repro_torch.serving.model`.

Under tensor parallelism (``train(mesh=)`` with a ``model`` axis,
:mod:`repro_torch.distributed.tensor_parallel`) the parameters are the
rank's blocks (:func:`param_groups` names the one grouped split): the
embedding is vocab-parallel, the head runs on the rank's vocab columns
with its pad mask by global column, and :func:`loss_fn` is the
vocab-parallel cross entropy.  The serving steps (:func:`prefill`,
:func:`decode_step`, ``launch.common``'s cells) run the same way on the
rank's blocks of the parameters and the state (:func:`init_state`'s
``layout``), the KV cache over the line by its slots where the decode
rules say so (decode context parallelism), and gather the logits whole.

Inputs follow ``cfg.input_mode`` (:func:`embed_inputs`): ``tokens``;
``embeds`` (the audio stub: ``batch["embeds"]`` (B, S, D) frame
embeddings, no table); ``tokens+vision`` (the VLM stub:
``batch["vision_embeds"]`` (B, Sv, D) ahead of the token embeddings, so
the logits cover Sv + S positions).  :func:`decode_step` takes
``batch["embeds"]`` (B, 1, D) in ``embeds`` mode and tokens otherwise.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, \
    Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import collectives
from repro_torch.distributed import fsdp as _fsdp
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.distributed.sharding import ambient, map_specs, use_rules
from repro_torch.kernels import ops
from repro_torch.models import attention, moe, recurrent
from repro_torch.models.layers import (compute_cast, deferred_draws,
                                       embed_init, gated_mlp_apply,
                                       gated_mlp_init, rmsnorm_apply,
                                       rmsnorm_init, variance_scaling_init)
from repro_torch.tree import leaves, tree_map

VOCAB_PAD = 256


def padded_vocab(cfg: ModelConfig) -> int:
    return -(-cfg.vocab_size // VOCAB_PAD) * VOCAB_PAD


#: Block types the port runs.
BLOCK_TYPES = ("attn", "local", "rglru", "mlstm", "slstm")

#: Block types that are ``norm1`` + ``mixer`` only, with no MLP after.
_MIXER_ONLY = ("mlstm", "slstm")

#: The auxiliary values of an MoE model (:func:`forward_aux`).
AUX_KEYS = ("moe_lb_loss", "moe_z_loss", "moe_drop_frac")


class _Recurrent(NamedTuple):
    """A recurrent mixer's functions in :mod:`repro_torch.models.recurrent`."""
    init: Callable
    apply: Callable
    prefill: Callable
    init_state: Callable
    decode: Callable


_RECURRENT = {
    name: _Recurrent(*(getattr(recurrent, f"{name}_block_{fn}")
                       for fn in _Recurrent._fields))
    for name in ("rglru", "mlstm", "slstm")}

#: State: one dict per pattern position, each tensor stacked over groups.
State = Tuple[Dict[str, torch.Tensor], ...]


def check_pattern(cfg: ModelConfig,
                  allowed: Sequence[str] = BLOCK_TYPES) -> None:
    for btype in cfg.block_pattern:
        if btype not in allowed:
            raise NotImplementedError(
                f"block type {btype!r} is not ported for this path (it "
                f"takes {tuple(allowed)})")


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
    params = {}
    if cfg.input_mode in ("tokens", "tokens+vision"):
        params["embed"] = embed_init(gen, vpad, d, dt)

    def block(btype: str) -> dict:
        mixer = (_RECURRENT[btype].init(gen, cfg, dt, lead)
                 if btype in _RECURRENT
                 else attention.attn_init(gen, cfg, dt, lead))
        out = {"norm1": rmsnorm_init(d, dev, lead), "mixer": mixer}
        if btype not in _MIXER_ONLY:
            out.update(norm2=rmsnorm_init(d, dev, lead),
                       ffn=moe.moe_init(gen, cfg, dt, lead)
                       if _is_moe(btype, cfg)
                       else gated_mlp_init(gen, d, cfg.d_ff, dt, lead))
        return out

    params["blocks"] = tuple(block(bt) for bt in cfg.block_pattern)
    params["final_norm"] = rmsnorm_init(d, dev)
    params["head"] = {"w": variance_scaling_init(gen, (d, vpad), dt)}
    return params


def _deferred_init(cfg: ModelConfig, seed: int, device: DeviceLike,
                   dtype: Optional[torch.dtype]) -> Tuple[dict, List]:
    """:func:`init`'s tree with a ``meta`` tensor in place of every drawn
    leaf, and each draw's ``(meta tensor, make)`` in the order the init
    made them (:func:`repro_torch.models.layers.deferred_draws`)."""
    draws: List = []

    def hook(make, shape, dt):
        t = torch.empty(shape, dtype=dt, device="meta")
        draws.append((t, make))
        return t

    with deferred_draws(hook):
        tree = init(cfg, seed=seed, device=device, dtype=dtype)
    return tree, draws


def abstract_params(cfg: ModelConfig,
                    dtype: Optional[torch.dtype] = None) -> dict:
    """:func:`init`'s tree of ``meta`` tensors (shapes and dtypes only;
    nothing is drawn)."""
    tree, _ = _deferred_init(cfg, 0, "cpu", dtype)
    return tree_map(lambda t: t.to("meta"), tree)


def init_blocks(cfg: ModelConfig, layout: Any, *, seed: int = 0,
                device: DeviceLike = None,
                dtype: Optional[torch.dtype] = None) -> dict:
    """This rank's block of every leaf of :func:`init` under ``layout`` (a
    tree like it of :class:`repro_torch.distributed.sharding.LeafSharding`;
    ``train(mesh=)``'s ``model`` and ``data`` splits), bit for bit
    ``convert.model_blocks(init(cfg, ...), layout)``, with no whole model
    on the device: every leaf is drawn in :func:`init`'s order from its one
    generator and only its block kept before the next is drawn (a stacked
    leaf a group's slice at a time, :func:`repro_torch.models.layers.
    variance_scaling_init`).  Runs on ``cuda`` unless ``device`` says
    otherwise."""
    tree, draws = _deferred_init(cfg, seed, device, dtype)
    keep = {id(t): sh for t, sh in zip(leaves(tree), leaves(layout))}
    made = {id(t): make(keep[id(t)]) for t, make in draws}
    return tree_map(lambda t, sh: made[id(t)] if id(t) in made
                    else sh.local(t).contiguous().clone() if sh.splits
                    else t, tree, layout)


#: Logical-axis specs of one group's mixer and FFN, by block type: the
#: spec trees the reference's ``*_init`` functions return beside their
#: parameters (``repro.models.{attention,layers,moe,recurrent}``).
_MIXER_SPECS = {
    "attn": {"wq": ("embed", "heads"), "wk": ("embed", "kv_heads"),
             "wv": ("embed", "kv_heads"), "wo": ("heads", "embed")},
    "rglru": {"w_in": ("embed", "mlp"), "w_gate": ("embed", "mlp"),
              "conv_w": (None, "mlp"), "conv_b": ("mlp",),
              "w_a": ("embed", "mlp"), "b_a": ("mlp",),
              "w_x": ("embed", "mlp"), "b_x": ("mlp",),
              "lambda_raw": ("mlp",), "w_out": ("mlp", "embed")},
    "mlstm": {"w_up": ("embed", "mlp"), "conv_w": (None, "mlp"),
              "conv_b": ("mlp",), "w_q": ("embed", "mlp"),
              "w_k": ("embed", "mlp"), "w_v": ("embed", "mlp"),
              "w_if": ("embed", None), "b_if": (None,),
              "gn_scale": ("mlp",), "w_down": ("mlp", "embed")},
    "slstm": {"w_gates": ("embed", "mlp"), "r_gates": ("heads", None, None),
              "b_gates": ("mlp",), "gn_scale": (None,),
              "w_ff1": ("embed", "mlp"), "w_ff2": ("mlp", "embed")},
}
_MIXER_SPECS["local"] = _MIXER_SPECS["attn"]
_MLP_SPECS = {"wi": ("embed", "mlp"), "wg": ("embed", "mlp"),
              "wo": ("mlp", "embed")}
_MOE_SPECS = {"router": ("embed", None), "wi": ("expert", "embed", None),
              "wg": ("expert", "embed", None),
              "wo": ("expert", None, "embed")}
_NORM_SPECS = {"scale": (None,)}


def param_specs(cfg: ModelConfig) -> dict:
    """The logical-axis spec tree of :func:`init`'s parameters: one tuple
    of logical axis names (or ``None``) a tensor, stacked block tensors
    led by ``"layers"`` (the tree ``repro.models.lm.init`` returns as its
    second output)."""
    check_pattern(cfg)

    def block(btype: str) -> dict:
        out = {"norm1": _NORM_SPECS, "mixer": _MIXER_SPECS[btype]}
        if btype not in _MIXER_ONLY:
            out.update(norm2=_NORM_SPECS,
                       ffn=_MOE_SPECS if _is_moe(btype, cfg) else _MLP_SPECS)
        return {k: {n: ("layers",) + spec for n, spec in v.items()}
                for k, v in out.items()}

    specs: dict = {}
    if cfg.input_mode in ("tokens", "tokens+vision"):
        specs["embed"] = {"table": ("vocab", "embed")}
    specs["blocks"] = tuple(block(bt) for bt in cfg.block_pattern)
    specs["final_norm"] = dict(_NORM_SPECS)
    specs["head"] = {"w": ("embed", "vocab")}
    return specs


def param_groups(cfg: ModelConfig) -> dict:
    """A tree like :func:`init`'s of the parts a leaf's split dim is made
    of, side by side (:class:`repro_torch.distributed.sharding.
    LeafSharding` ``groups``): 2 for mLSTM's ``w_up`` (the cell input's
    columns, then the output gate's), so a rank's block holds its heads'
    columns of both; 1 for every other leaf."""
    out = map_specs(lambda spec: 1, param_specs(cfg))
    for p, btype in enumerate(cfg.block_pattern):
        if btype == "mlstm":
            out["blocks"][p]["mixer"]["w_up"] = 2
    return out


def state_specs(cfg: ModelConfig) -> Tuple[Any, ...]:
    """Logical-axis specs matching :func:`init_state`'s structure."""
    specs = []
    for btype in cfg.block_pattern:
        if btype in ("attn", "local"):
            kv = ("layers", "batch", "kv_heads", "kv_seq", "head_dim")
            specs.append({"k": kv, "v": kv})
        elif btype == "rglru":
            specs.append({"h": ("layers", "batch", "mlp"),
                          "conv_tail": ("layers", "batch", None, "mlp")})
        elif btype == "mlstm":
            specs.append({"c": ("layers", "batch", None, None, None),
                          "n": ("layers", "batch", None, None),
                          "m": ("layers", "batch", None),
                          "conv_tail": ("layers", "batch", None, "mlp")})
        elif btype == "slstm":
            z = ("layers", "batch", None, None)
            specs.append({"c": z, "n": z, "m": z, "h": z})
    return tuple(specs)


def unstack(tree, n: int) -> List:
    """``n`` per-group trees of a stacked tree (views, no copy), by one
    ``unbind`` per leaf (its backward is one stack of the group
    gradients)."""
    if isinstance(tree, dict):
        parts = {k: unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][g] for k in tree} for g in range(n)]
    return list(tree.unbind(0))


def _window(btype: str, cfg: ModelConfig) -> Optional[int]:
    return cfg.window if btype == "local" else None


def _cache_slots(btype: str, cfg: ModelConfig, cache_size: int) -> int:
    """KV slots of an attention layer: a ``local`` one keeps a ring of
    ``min(window, cache_size)``."""
    return min(cfg.window, cache_size) if btype == "local" else cache_size


def _is_moe(btype: str, cfg: ModelConfig) -> bool:
    """Whether a block's FFN is a mixture of experts: an ``attn`` or
    ``local`` block of an MoE config (the reference's rule)."""
    return cfg.moe is not None and btype in ("attn", "local")


def mlp_residual(bparams: dict, x: torch.Tensor, d_ff: int
                 ) -> torch.Tensor:
    """A dense block's second half: x + mlp(norm2 x), of hidden width
    ``d_ff`` (the config's)."""
    return x + gated_mlp_apply(bparams["ffn"],
                               rmsnorm_apply(bparams["norm2"], x), d_ff)


def ffn_residual(bparams: dict, btype: str, x: torch.Tensor,
                 cfg: ModelConfig,
                 aux: Optional[Dict[str, torch.Tensor]] = None
                 ) -> torch.Tensor:
    """After the mixer's residual: + ffn(norm2 x), the gated MLP or the
    mixture of experts, except in an xLSTM block.  An MoE layer adds its
    auxiliary values into ``aux`` when one is given."""
    if btype in _MIXER_ONLY:
        return x
    if not _is_moe(btype, cfg):
        return mlp_residual(bparams, x, cfg.d_ff)
    h = rmsnorm_apply(bparams["norm2"], x)
    if aux is None:
        return x + moe.moe_ffn(bparams["ffn"], h, cfg)[0]
    y, layer_aux = moe.moe_apply(bparams["ffn"], h, cfg)
    for k, v in layer_aux.items():
        aux[k] = aux[k] + v
    return x + y


def _block(bparams: dict, btype: str, x: torch.Tensor, cfg: ModelConfig,
           aux: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
    """One block: x + mixer(norm1 x), then + ffn(norm2 x)."""
    h = rmsnorm_apply(bparams["norm1"], x)
    if btype in _RECURRENT:
        y = _RECURRENT[btype].apply(bparams["mixer"], h, cfg)
    else:
        y = attention.attn_apply(bparams["mixer"], h, cfg,
                                 window=_window(btype, cfg))
    return ffn_residual(bparams, btype, x + y, cfg, aux)


def step_inputs(params: dict, cfg: ModelConfig,
                batch: Dict[str, torch.Tensor],
                fsdp: Optional[dict] = None) -> torch.Tensor:
    """The embeddings of a batch without its vision prefix, in the
    activation dtype: ``batch["embeds"]`` in ``embeds`` mode, the tokens'
    rows of the table otherwise (what a decode or paged step takes).
    ``fsdp``: the parameters' FSDP layout (:func:`forward_aux`); the table
    is gathered, in the activation dtype, just before the lookup."""
    if cfg.input_mode == "embeds":
        return batch["embeds"].to(cfg.activation_dtype)
    table = params["embed"]["table"]
    if fsdp is not None:
        table = _fsdp.gather_param(table, fsdp["embed"]["table"],
                                   cfg.activation_dtype)
    ax = tp.split_of(table.shape[0], padded_vocab(cfg))
    if ax is not None:                  # vocab-parallel
        return tp.vocab_embed(ax, table, batch["tokens"],
                              cfg.activation_dtype)
    return compute_cast(table[batch["tokens"].long()], cfg.activation_dtype)


def embed_inputs(params: dict, cfg: ModelConfig,
                 batch: Dict[str, torch.Tensor],
                 fsdp: Optional[dict] = None) -> torch.Tensor:
    """The decoder's input (B, S, D) in the activation dtype, by
    ``cfg.input_mode``: :func:`step_inputs`, after the vision prefix in
    ``tokens+vision`` mode."""
    x = step_inputs(params, cfg, batch, fsdp)
    if cfg.input_mode == "tokens+vision":
        x = torch.cat([batch["vision_embeds"].to(x.dtype), x], dim=1)
    return x


def forward(params: dict, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            *, remat: bool = False) -> torch.Tensor:
    """Logits (B, S, Vpad) in the activation dtype; padded-vocab columns
    are -1e30 (:func:`forward_aux` without its auxiliary values)."""
    return forward_aux(params, cfg, batch, remat=remat)[0]


def forward_aux(params: dict, cfg: ModelConfig,
                batch: Dict[str, torch.Tensor], *, remat: bool = False,
                fsdp: Optional[dict] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(logits (B, S, Vpad) in the activation dtype, padded-vocab columns
    -1e30; the auxiliary values).  An MoE model's are :data:`AUX_KEYS`,
    float32 scalars: each summed over its MoE layers and divided by their
    number; a dense model has none.

    ``remat`` recomputes each group in the backward
    (``torch.utils.checkpoint``, the counterpart of ``Runtime.remat`` with
    policy ``"full"``): every forward launch of a group runs twice a step.
    ``final_norm -> head`` is one fused ``rmsnorm_gemm`` (the JAX
    compiler's prologue-fusion rule).

    ``fsdp`` (FSDP, ``train(mesh=)``): a tree like ``params`` of each
    leaf's splits over the axes other than ``model``
    (:class:`repro_torch.distributed.sharding.LeafSharding`); ``params``
    are this rank's blocks.  Each group's body gathers that group's split
    leaves, and only those, as its first act (inside the remat
    checkpoint: the recomputation gathers again), in the activation dtype
    and in one bucket (:func:`repro_torch.distributed.fsdp.gather_tree`);
    the table and the head are gathered just before their use."""
    check_pattern(cfg)
    x = embed_inputs(params, cfg, batch, fsdp)
    groups = [unstack(p, cfg.num_groups) for p in params["blocks"]]
    layouts = (None if fsdp is None else
               [tree_map(lambda sh: sh.inner(), b) for b in fsdp["blocks"]])
    aux = ({k: torch.zeros((), device=x.device) for k in AUX_KEYS}
           if cfg.moe is not None else {})

    rules = ambient()

    def group_body(x: torch.Tensor, aux: Dict[str, torch.Tensor], g: int
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        aux = dict(aux)
        # A remat recomputation runs on autograd's thread for a CUDA
        # tensor: the rules (a model axis) the forward ran under go along.
        with use_rules(*rules):
            whole = _fsdp.gather_tree([gp[g] for gp in groups], layouts,
                                      cfg.activation_dtype)
            for p, btype in enumerate(cfg.block_pattern):
                x = _block(whole[p], btype, x, cfg, aux)
        return x, aux

    for g in range(cfg.num_groups):
        if remat:
            x, aux = checkpoint(group_body, x, aux, g, use_reentrant=False,
                                preserve_rng_state=False)
        else:
            x, aux = group_body(x, aux, g)
    ax = tp.split_of(params["head"]["w"].shape[-1], padded_vocab(cfg))
    if fsdp is not None:
        params = {"final_norm": params["final_norm"],
                  "head": _fsdp.gather_tree(params["head"], fsdp["head"],
                                            cfg.activation_dtype)}
    logits = head(params, x, ax)
    if padded_vocab(cfg) != cfg.vocab_size:
        n = logits.shape[-1]
        first = 0 if ax is None else ax.index * n
        col = torch.arange(first, first + n, device=logits.device)
        logits = logits.masked_fill(col >= cfg.vocab_size, -1e30)
    n_moe = cfg.num_groups * sum(_is_moe(bt, cfg) for bt in cfg.block_pattern)
    return logits, {k: v / float(n_moe) for k, v in aux.items()}


def head(params: dict, x: torch.Tensor,
         ax: Optional[tp.ModelAxis] = None) -> torch.Tensor:
    """final_norm -> head as one fused ``rmsnorm_gemm`` (the JAX compiler's
    prologue-fusion rule: the only norm -> dot chain with one consumer).
    With ``ax`` (tensor parallelism) ``head.w`` is this rank's vocab
    columns: x and the fused norm scale pass *f*, since each rank's
    gradient of them is partial."""
    scale = params["final_norm"]["scale"]
    if ax is not None:
        x, scale = ax.enter(x), ax.enter(scale)
    return ops.rmsnorm_gemm(x, scale,
                            compute_cast(params["head"]["w"], x.dtype))


def loss_fn(params: dict, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            *, remat: bool = False,
            dp_sum: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
            dp_ranks: int = 1, fsdp: Optional[dict] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross-entropy in float32; labels -1 are ignored.
    With ``cfg.logits_softcap`` = c the logits are first capped as
    ``tanh(l / c) * c``.  An MoE model adds its load-balance and z losses.
    Returns (loss, {"ce_loss", the auxiliary values, "loss",
    "accuracy"}), as ``repro``'s ``loss_fn``.  Under tensor parallelism
    the logits are the rank's vocab columns and the cross entropy and the
    accuracy are :func:`repro_torch.distributed.tensor_parallel.
    vocab_cross_entropy`'s (the loss the same on every rank of the line).

    Data parallelism (``train(mesh=)``): ``batch`` is this rank's rows of
    the global batch and ``dp_sum`` sums a tensor over the ``dp_ranks``
    ranks.  The loss is a ratio, so the count of valid labels is summed
    first: the returned loss is this rank's share, sum of its
    cross-entropies over the global count (plus its auxiliary losses over
    ``dp_ranks``), whose gradient summed over the ranks is the global
    batch's; the metrics are the global batch's (each numerator summed).
    ``fsdp``: :func:`forward_aux`'s.
    """
    logits, aux = forward_aux(params, cfg, batch, remat=remat, fsdp=fsdp)
    logits32 = logits.float()
    if cfg.logits_softcap:
        c = cfg.logits_softcap
        logits32 = torch.tanh(logits32 / c) * c
    labels = batch["labels"].long()
    valid = labels >= 0
    safe = torch.where(valid, labels, 0)
    ax = tp.split_of(params["head"]["w"].shape[-1], padded_vocab(cfg))
    if ax is None:
        lse = torch.logsumexp(logits32, dim=-1)
        label_logit = logits32.gather(-1, safe[..., None])[..., 0]
        ce = torch.where(valid, lse - label_logit, 0.0)
    else:
        ce, tp_hit = tp.vocab_cross_entropy(ax, logits32, labels)
    count = valid.float().sum()
    if dp_sum is not None:
        count = dp_sum(count)
        aux = {k: v / dp_ranks for k, v in aux.items()}
    denom = count.clamp(min=1.0)
    loss = ce.sum() / denom
    total = loss
    if cfg.moe is not None:
        total = total + aux["moe_lb_loss"] + aux["moe_z_loss"]
    with torch.no_grad():
        hit = ((logits32.argmax(-1) == safe) & valid if ax is None
               else tp_hit)
        hits = hit.float().sum()
        metrics = {"ce_loss": loss.detach(),
                   **{k: v.detach() for k, v in aux.items()},
                   "loss": total.detach()}
        if dp_sum is not None:
            metrics = {k: dp_sum(v) for k, v in metrics.items()}
            hits = dp_sum(hits)
        metrics["accuracy"] = hits / denom
    return total, metrics


# ---------------------------------------------------------------------------
# Serving over a contiguous state: init_state, prefill, decode_step
# ---------------------------------------------------------------------------
def init_state(cfg: ModelConfig, batch: int, cache_size: int,
               dtype: Optional[torch.dtype] = None,
               device: DeviceLike = None, layout: Any = None) -> State:
    """Zeroed decode state, one entry per pattern position stacked over
    groups: ``{"k", "v"}`` (G, B, Hkv, size, hd) for attention, where a
    ``local`` layer's size is ``min(window, cache_size)``; ``{"h"}`` (G, B,
    lru) float32 and ``{"conv_tail"}`` (G, B, 3, lru) for ``rglru``;
    ``{"c", "n", "m"}`` float32 and ``{"conv_tail"}`` for ``mlstm``;
    ``{"c", "n", "m", "h"}`` (G, B, H, dh) float32 for ``slstm``.  Runs on
    ``cuda`` unless ``device`` says otherwise.  ``layout`` (a tree like the
    state of :class:`repro_torch.distributed.sharding.LeafSharding`): only
    this rank's block of every leaf is made."""
    check_pattern(cfg)
    if layout is not None:
        whole = init_state(cfg, batch, cache_size, dtype, "meta")
        # Every leaf holds one value throughout (0, or the sLSTM's n).
        fill = init_state(cfg, 1, 1, dtype, "cpu")
        dev = resolve_device(device)
        return tree_map(lambda t, f, sh: torch.full(
            sh.local_shape(t.shape), f.reshape(-1)[0].item(), dtype=t.dtype,
            device=dev), whole, fill, layout)
    dev = resolve_device(device)
    dtype = dtype or cfg.activation_dtype
    hd, g = cfg.resolved_head_dim, cfg.num_groups
    state = []
    for btype in cfg.block_pattern:
        if btype in _RECURRENT:
            one = _RECURRENT[btype].init_state(cfg, batch, dtype, dev)
            state.append({k: v.expand((g,) + v.shape).contiguous()
                          for k, v in one.items()})
            continue
        shape = (g, batch, cfg.num_kv_heads,
                 _cache_slots(btype, cfg, cache_size), hd)
        state.append({"k": torch.zeros(shape, dtype=dtype, device=dev),
                      "v": torch.zeros(shape, dtype=dtype, device=dev)})
    return tuple(state)


def _stack_state(per_group: List[List[dict]]) -> State:
    """[group][position] dicts -> one dict a position, stacked over
    groups."""
    return tuple({k: torch.stack([grp[p][k] for grp in per_group])
                  for k in per_group[0][p]}
                 for p in range(len(per_group[0])))


@torch.no_grad()
def prefill(params: dict, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            *, cache_size: int) -> Tuple[torch.Tensor, State, torch.Tensor]:
    """The whole prompt through every layer, populating the decode state.

    batch ``tokens`` (B, S), or the input mode's (:func:`embed_inputs`).
    Returns (logits of the last position (B,
    Vpad), state, cache_len (B,) int32 = S).  A recurrent layer keeps the
    state its ``*_block_prefill`` returns (an ``mlstm`` layer the
    chunkwise kernel's final (C, n, m)); an attention layer its cache from
    :func:`repro_torch.models.attention.attn_prefill`."""
    check_pattern(cfg)
    x = embed_inputs(params, cfg, batch)
    b, s, _ = x.shape
    groups = [unstack(p, cfg.num_groups) for p in params["blocks"]]
    per_group = []
    for g in range(cfg.num_groups):
        entries = []
        for p, btype in enumerate(cfg.block_pattern):
            bp = groups[p][g]
            h = rmsnorm_apply(bp["norm1"], x)
            if btype in _RECURRENT:
                y, st = _RECURRENT[btype].prefill(bp["mixer"], h, cfg)
            else:
                y, st = attention.attn_prefill(
                    bp["mixer"], h, cfg, window=_window(btype, cfg),
                    cache_size=_cache_slots(btype, cfg, cache_size))
            entries.append(st)
            x = ffn_residual(bp, btype, x + y, cfg)
        per_group.append(entries)
    cache_len = torch.full((b,), s, dtype=torch.int32, device=x.device)
    return (_whole_logits(params, x[:, -1:], cfg)[:, 0],
            _stack_state(per_group), cache_len)


def _whole_logits(params: dict, x: torch.Tensor, cfg: ModelConfig
                  ) -> torch.Tensor:
    """The head's logits (B, S, Vpad): under tensor parallelism computed
    on this rank's vocab columns and gathered over the line in rank order
    (span ``comm.tp_logits``)."""
    ax = tp.split_of(params["head"]["w"].shape[-1], padded_vocab(cfg))
    logits = head(params, x, ax)
    if ax is None:
        return logits
    return collectives.all_gather(logits, ax.key, dim=-1,
                                  span="comm.tp_logits")


@torch.no_grad()
def decode_step(params: dict, state: State, cache_len: torch.Tensor,
                cfg: ModelConfig, batch: Dict[str, torch.Tensor], *,
                cache_size: Optional[int] = None
                ) -> Tuple[torch.Tensor, State, torch.Tensor]:
    """One token for every row.  batch ``tokens`` (B, 1), or ``embeds``
    (B, 1, D) in ``embeds`` mode; cache_len (B,), the position this step
    writes.  Returns (logits (B, Vpad), state,
    cache_len + 1).  **The state is updated in place** and returned (the
    JAX function returns a new one).

    On a mesh (tensor parallelism: ``params`` and ``state`` this rank's
    blocks) ``cache_size`` is the whole caches' size, which a KV cache
    held as this rank's slice of its slots (decode context parallelism,
    :mod:`repro_torch.distributed.context_parallel`) is read against; the
    logits are whole (:func:`_whole_logits`)."""
    check_pattern(cfg)
    x = step_inputs(params, cfg, batch)
    groups = [unstack(p, cfg.num_groups) for p in params["blocks"]]
    for g in range(cfg.num_groups):
        for p, btype in enumerate(cfg.block_pattern):
            bp, entry = groups[p][g], state[p]
            h = rmsnorm_apply(bp["norm1"], x)
            if btype in _RECURRENT:
                y, new = _RECURRENT[btype].decode(
                    bp["mixer"], h, {k: v[g] for k, v in entry.items()}, cfg)
                for k, v in new.items():
                    entry[k][g].copy_(v)
            else:
                y, _ = attention.attn_decode(
                    bp["mixer"], h, {"k": entry["k"][g], "v": entry["v"][g]},
                    cache_len, cfg, window=_window(btype, cfg),
                    slots=None if cache_size is None
                    else _cache_slots(btype, cfg, cache_size))
            x = ffn_residual(bp, btype, x + y, cfg)
    return _whole_logits(params, x, cfg)[:, 0], state, cache_len + 1
