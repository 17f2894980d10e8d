"""Logical-axis sharding rules (counterpart of
``repro.distributed.sharding``).

Every parameter and major activation is annotated with *logical* axis
names; a :class:`MeshRules` table maps those to physical mesh axes, and
the same model code runs on any mesh (a single rank resolves every rule to
``None``).  A spec is the port's plain tuple of physical axes, one entry a
dimension (``None``, an axis name, or a tuple of axis names): the
counterpart of ``PartitionSpec``.

Default placement:

==============  =====================  ====================================
logical axis    physical axes          role
==============  =====================  ====================================
batch           ("pod", "data")        data parallelism (hierarchical)
vocab           "model"                TP: embedding/logits shards
heads/kv_heads  "model"                TP: attention head shards
mlp             "model"                TP: FFN hidden shards
expert          "model"                EP: MoE expert shards
embed           "data"                 FSDP / ZeRO: parameter and
                                       optimizer storage
seq             None | "model"         sequence parallelism (perf lever)
kv_seq          None | "data"          context parallelism for long decode
layers          None                   the stacked groups' axis
==============  =====================  ====================================

What the port does with them today: ``train(mesh=)`` reads ``batch``
(the data-parallel axes) and ``embed`` (the axis its AdamW moments are
split over, ZeRO-1), through :func:`spec_tree_to_shardings`.  The port has
no GSPMD to propagate a constraint, so :func:`shard` resolves its spec
under the ambient rules and returns ``x`` unchanged: tensor parallelism by
the rules (``heads``, ``mlp``, ``vocab``, ``expert`` on ``"model"``) is
queued (ROADMAP.md §1 item 3), and ``train()`` refuses a ``model`` axis
larger than one.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Optional, Sequence, Tuple, Union

import torch

AxisVal = Union[None, str, Tuple[str, ...]]
#: A physical spec: one entry a dimension.
Spec = Tuple[AxisVal, ...]

__all__ = ["LeafSharding", "MeshRules", "current_rules", "logical_spec",
           "logical_to_spec", "rules_for", "shard", "spec_tree_to_shardings",
           "use_rules"]


@dataclasses.dataclass(frozen=True)
class MeshRules:
    """Mapping from logical axis names to physical mesh axes."""

    batch: AxisVal = ("pod", "data")
    vocab: AxisVal = "model"
    heads: AxisVal = "model"
    kv_heads: AxisVal = "model"
    mlp: AxisVal = "model"
    expert: AxisVal = "model"
    embed: AxisVal = "data"       # FSDP / ZeRO storage axis for params
    embed_act: AxisVal = None     # activations' feature axis
    seq: AxisVal = None           # sequence inside mixers: unsharded
    seq_res: AxisVal = None       # residual-stream sequence ("model" under
                                  # Megatron-SP)
    kv_seq: AxisVal = None        # "data" under decode context parallelism
    layers: AxisVal = None
    expert_group: AxisVal = None
    head_dim: AxisVal = None
    stats: AxisVal = None

    def resolve(self, logical: Optional[str],
                mesh_axes: Sequence[str]) -> AxisVal:
        """Logical name -> physical axes, dropping axes absent in the mesh."""
        if logical is None:
            return None
        val = getattr(self, logical)
        if val is None:
            return None
        if isinstance(val, str):
            return val if val in mesh_axes else None
        kept = tuple(a for a in val if a in mesh_axes)
        return kept if kept else None

    def spec(self, *logical_axes: Optional[str],
             mesh_axes: Sequence[str]) -> Spec:
        """One entry a dimension; a single axis in a tuple reads as its
        name, as in a ``PartitionSpec``."""
        out = []
        for ax in logical_axes:
            val = self.resolve(ax, mesh_axes)
            out.append(val[0] if isinstance(val, tuple) and len(val) == 1
                       else val)
        return tuple(out)


# ---------------------------------------------------------------------------
# Ambient rule context
# ---------------------------------------------------------------------------
class _Ctx(threading.local):
    def __init__(self) -> None:
        self.rules: Optional[MeshRules] = None
        self.mesh_axes: Tuple[str, ...] = ()


_CTX = _Ctx()


class use_rules:
    """Context manager installing the (rules, mesh-axes) pair for a trace."""

    def __init__(self, rules: Optional[MeshRules],
                 mesh_axes: Sequence[str]) -> None:
        self._new = (rules, tuple(mesh_axes))
        self._old: Tuple[Optional[MeshRules], Tuple[str, ...]] = (None, ())

    def __enter__(self) -> "use_rules":
        self._old = (_CTX.rules, _CTX.mesh_axes)
        _CTX.rules, _CTX.mesh_axes = self._new
        return self

    def __exit__(self, *exc) -> None:
        _CTX.rules, _CTX.mesh_axes = self._old


def current_rules() -> Optional[MeshRules]:
    return _CTX.rules


def logical_spec(*logical_axes: Optional[str]) -> Optional[Spec]:
    """Resolve logical axes under the ambient rules (None if no rules set)."""
    if _CTX.rules is None:
        return None
    return _CTX.rules.spec(*logical_axes, mesh_axes=_CTX.mesh_axes)


def shard(x: torch.Tensor, *logical_axes: Optional[str]) -> torch.Tensor:
    """Resolve the spec under the ambient rules and return ``x``: the port
    has no GSPMD to hand a constraint to (module docstring)."""
    logical_spec(*logical_axes)
    return x


def _is_spec_leaf(x: Any) -> bool:
    """A spec: a tuple of ``None``, axis names and tuples of axis names."""
    return isinstance(x, tuple) and all(
        a is None or isinstance(a, str) or (
            isinstance(a, tuple) and all(isinstance(b, str) for b in a))
        for a in x)


def map_specs(fn, tree: Any) -> Any:
    """``fn`` over the spec leaves (tuples of axis names) of a nested dict
    or tuple of specs."""
    if isinstance(tree, dict):
        return {k: map_specs(fn, v) for k, v in tree.items()}
    if _is_spec_leaf(tree):
        return fn(tree)
    if isinstance(tree, (tuple, list)):
        return tuple(map_specs(fn, v) for v in tree)
    return fn(tree)


def logical_to_spec(spec_tree: Any, rules: MeshRules,
                    mesh_axes: Sequence[str]) -> Any:
    """A logical spec tree -> the physical spec tree under ``rules``."""
    return map_specs(lambda leaf: rules.spec(*leaf, mesh_axes=mesh_axes),
                     spec_tree)


# ---------------------------------------------------------------------------
# Shardings: where a leaf is split on this rank
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class LeafSharding:
    """How one leaf is laid out on this rank: ``splits`` is one ``(dim,
    axes, parts, index)`` per dimension split over axes of more than one
    rank (``axes`` a tuple of mesh axes, ``parts`` their product,
    ``index`` this rank's block along them)."""

    spec: Spec
    splits: Tuple[Tuple[int, Tuple[str, ...], int, int], ...]

    def local_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        out = list(shape)
        for dim, _, parts, _ in self.splits:
            out[dim] //= parts
        return tuple(out)

    def local(self, x):
        """This rank's block of the full ``x`` (a view of a tensor; a copy
        of a numpy array)."""
        for dim, _, parts, index in self.splits:
            size = x.shape[dim] // parts
            if isinstance(x, torch.Tensor):
                x = x.narrow(dim, index * size, size)
            else:
                x = x.take(range(index * size, (index + 1) * size), axis=dim)
        return x


def _axes_of(entry: AxisVal) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_tree_to_shardings(mesh, specs: Any, like: Any = None) -> Any:
    """A physical spec tree -> a tree of :class:`LeafSharding` on
    ``mesh``: for each leaf, the dims and axes it is split along on this
    rank.  Axes of one rank split nothing.  With ``like`` (a tree of
    tensors of the same structure), a dim that its axes do not divide is
    left whole (a leaf that does not divide stays replicated there)."""
    sizes = dict(mesh.shape)
    coords = dict(mesh.coords)

    def one(spec: Spec, shape=None) -> LeafSharding:
        splits = []
        for dim, entry in enumerate(spec):
            axes = tuple(a for a in _axes_of(entry) if sizes.get(a, 1) > 1)
            if not axes:
                continue
            parts, index = 1, 0
            for a in axes:
                index = index * sizes[a] + coords[a]
                parts *= sizes[a]
            if shape is not None and shape[dim] % parts:
                continue
            splits.append((dim, axes, parts, index))
        return LeafSharding(tuple(spec), tuple(splits))

    if like is None:
        return map_specs(one, specs)

    def walk(spec_node, like_node):
        if isinstance(spec_node, dict):
            return {k: walk(spec_node[k], like_node[k]) for k in spec_node}
        if _is_spec_leaf(spec_node):
            return one(spec_node, tuple(like_node.shape))
        return tuple(walk(s, l) for s, l in zip(spec_node, like_node))

    return walk(specs, like)


def rules_for(cfg, mesh, *, batch_size: Optional[int] = None,
              kind: str = "train",
              sequence_parallel: bool = False) -> MeshRules:
    """Divisibility-aware rules for one (architecture, shape-kind, mesh).

    * Head counts that do not divide the "model" axis fall back to
      replication for the activation head axis (the flattened weight
      columns still shard over "model").  When both head axes are
      replicated, ``head_dim`` picks up the TP axis (train), or the KV
      cache's sequence does (decode context parallelism): never both, a
      spec may not reuse a mesh axis.
    * Batches smaller than the DP degree drop the batch rule.
    """
    sizes = dict(mesh.shape)
    model = sizes.get("model", 1)

    def fit_model(n: int) -> AxisVal:
        return "model" if n % model == 0 else None

    n_heads = getattr(cfg, "num_heads", 1)
    n_kv = getattr(cfg, "num_kv_heads", 1)
    hd = getattr(cfg, "head_dim", None) or (
        getattr(cfg, "d_model", 0) // max(n_heads, 1))

    heads_r = fit_model(n_heads)
    kv_r = fit_model(n_kv)
    head_dim_r: AxisVal = None
    kv_seq_r: AxisVal = None
    if kind == "decode" and kv_r is None:
        kv_seq_r = "model"
    elif heads_r is None and kv_r is None and hd and hd % model == 0:
        head_dim_r = "model"

    batch_axes: AxisVal = ("pod", "data")
    if batch_size is not None:
        kept = []
        width = 1
        for ax in ("pod", "data"):
            if ax in sizes and batch_size % (width * sizes[ax]) == 0:
                kept.append(ax)
                width *= sizes[ax]
        batch_axes = tuple(kept) if kept else None

    d_model = getattr(cfg, "d_model", 1)
    data = sizes.get("data", 1)
    return MeshRules(
        batch=batch_axes,
        vocab="model",
        heads=heads_r,
        kv_heads=kv_r,
        mlp="model",
        expert="model",
        embed="data" if d_model % data == 0 else None,
        seq=None,
        seq_res="model" if sequence_parallel else None,
        kv_seq=kv_seq_r,
        head_dim=head_dim_r,
    )
