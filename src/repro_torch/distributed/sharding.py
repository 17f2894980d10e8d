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

What the port does with them: ``train(mesh=)`` reads ``batch`` (the
data-parallel axes), ``embed`` (the axis its masters, moments and
gradients are split over, FSDP: :mod:`repro_torch.distributed.fsdp`
gathers each group's weights inside the group's body) and every logical
axis that resolves to ``"model"``
(``heads``, ``kv_heads``, ``mlp``, ``vocab``, ``expert``): through
:func:`spec_tree_to_shardings` each rank holds only its ``model`` block of
every parameter split so, and the layers compute on their blocks with the
explicit collectives of :mod:`repro_torch.distributed.tensor_parallel`
(tensor parallelism in the Megatron form GSPMD derives from the same
specs).  The port has no GSPMD to propagate a constraint, so
:func:`shard` resolves its spec under the ambient rules and returns ``x``
unchanged; the layers read the split from their weights' local shapes and
the ambient mesh (:func:`use_rules`' ``mesh``).  Where ``head_dim``
resolves to ``"model"`` (neither head count divides the axis), the
attention weights stay whole and attention is computed whole on every
rank of the line (a static route, counted in ``ops.ROUTED``).

A split dim may be *grouped* (:class:`LeafSharding` ``groups``): the dim
is G equal parts side by side (mLSTM's ``w_up`` is the cell input's
columns, then the output gate's), and a rank's block is its block of each
part, so its columns line up with whole heads in both.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Optional, Sequence, Tuple, Union

import torch

AxisVal = Union[None, str, Tuple[str, ...]]
#: A physical spec: one entry a dimension.
Spec = Tuple[AxisVal, ...]

__all__ = ["LeafSharding", "MeshRules", "ambient", "current_mesh",
           "current_rules",
           "logical_spec", "logical_to_spec", "regroup", "rules_for", "shard",
           "spec_tree_to_shardings", "use_rules"]


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
        self.mesh: Any = None


_CTX = _Ctx()


class use_rules:
    """Context manager installing the (rules, mesh-axes) pair for a trace.
    With ``mesh`` (a :class:`repro_torch.launch.mesh.Mesh`), a ``model``
    axis of more than one rank makes the layers tensor-parallel over it
    (:func:`repro_torch.distributed.tensor_parallel.model_axis`)."""

    def __init__(self, rules: Optional[MeshRules],
                 mesh_axes: Sequence[str], mesh: Any = None) -> None:
        self._new = (rules, tuple(mesh_axes), mesh)
        self._old: Tuple[Any, ...] = (None, (), None)

    def __enter__(self) -> "use_rules":
        self._old = (_CTX.rules, _CTX.mesh_axes, _CTX.mesh)
        _CTX.rules, _CTX.mesh_axes, _CTX.mesh = self._new
        return self

    def __exit__(self, *exc) -> None:
        _CTX.rules, _CTX.mesh_axes, _CTX.mesh = self._old


def current_rules() -> Optional[MeshRules]:
    return _CTX.rules


def current_mesh() -> Any:
    """The mesh :func:`use_rules` installed, or None."""
    return _CTX.mesh


def ambient() -> Tuple[Any, ...]:
    """The installed ``(rules, mesh_axes, mesh)``: ``use_rules(*ambient())``
    installs them again on another thread (the context is per thread, and
    autograd runs a CUDA tensor's backward, remat recomputations included,
    on a thread of its own)."""
    return (_CTX.rules, _CTX.mesh_axes, _CTX.mesh)


def logical_spec(*logical_axes: Optional[str]) -> Optional[Spec]:
    """Resolve logical axes under the ambient rules (None if no rules set)."""
    if _CTX.rules is None:
        return None
    return _CTX.rules.spec(*logical_axes, mesh_axes=_CTX.mesh_axes)


def shard(x: torch.Tensor, *logical_axes: Optional[str]) -> torch.Tensor:
    """Resolve the spec under the ambient rules and return ``x``: the port
    has no GSPMD to hand a constraint to; the layers split their work by
    their weights' blocks (module docstring)."""
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
    ``index`` this rank's block along them); ``groups`` one ``(dim, G)``
    per split dim made of G parts side by side, whose block is this rank's
    block of each part (module docstring)."""

    spec: Spec
    splits: Tuple[Tuple[int, Tuple[str, ...], int, int], ...]
    groups: Tuple[Tuple[int, int], ...] = ()

    def local_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        out = list(shape)
        for dim, _, parts, _ in self.splits:
            out[dim] //= parts
        return tuple(out)

    def local(self, x):
        """This rank's block of the full ``x`` (a view of a tensor, a copy
        where a dim is grouped; a copy of a numpy array)."""
        groups = dict(self.groups)
        for dim, _, parts, index in self.splits:
            g = groups.get(dim, 1)
            shape = tuple(x.shape)
            size = shape[dim] // g // parts
            if g > 1:               # each part's block, side by side
                x = x.reshape(shape[:dim] + (g, -1) + shape[dim + 1:])
                dim += 1
            if isinstance(x, torch.Tensor):
                x = x.narrow(dim, index * size, size)
            else:
                x = x.take(range(index * size, (index + 1) * size), axis=dim)
            if g > 1:
                x = x.reshape(shape[:dim - 1] + (g * size,) + shape[dim:])
        return x

    def only(self, axes: Sequence[str]) -> "LeafSharding":
        """The splits over ``axes`` alone."""
        keep = tuple(s for s in self.splits if set(s[1]) <= set(axes))
        dims = {s[0] for s in keep}
        return LeafSharding(self.spec, keep,
                            tuple(g for g in self.groups if g[0] in dims))

    def with_splits(self, other: "LeafSharding") -> "LeafSharding":
        """This layout's splits, then ``other``'s (a block of a block)."""
        return LeafSharding(self.spec, self.splits + other.splits,
                            self.groups + other.groups)

    def axes(self) -> Tuple[str, ...]:
        """The mesh axes the leaf is split over, in split order."""
        return tuple(a for _, axes, _, _ in self.splits for a in axes)

    def inner(self) -> "LeafSharding":
        """The layout of one slice along dim 0 (a stacked leaf's group):
        every split one dim lower.  Dim 0 itself must be whole."""
        if any(dim == 0 for dim, _, _, _ in self.splits):
            raise ValueError(f"a leaf split along its dim 0 ({self.spec}) "
                             f"has no per-slice layout")
        return LeafSharding(
            self.spec[1:],
            tuple((d - 1, ax, p, i) for d, ax, p, i in self.splits),
            tuple((d - 1, g) for d, g in self.groups))


def regroup(x: torch.Tensor, dim: int, parts: int, groups: int
            ) -> torch.Tensor:
    """The whole dim of a grouped leaf from its ``parts`` blocks
    concatenated along ``dim`` in rank order (each block its G parts'
    blocks side by side)."""
    if groups == 1:
        return x
    shape = x.shape
    x = x.reshape(shape[:dim] + (parts, groups, -1) + shape[dim + 1:])
    return x.transpose(dim, dim + 1).reshape(shape)


def _axes_of(entry: AxisVal) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_tree_to_shardings(mesh, specs: Any, like: Any = None,
                           groups: Any = None) -> Any:
    """A physical spec tree -> a tree of :class:`LeafSharding` on
    ``mesh``: for each leaf, the dims and axes it is split along on this
    rank.  Axes of one rank split nothing.  With ``like`` (a tree of
    tensors of the same structure), a dim that its axes do not divide is
    left whole (a leaf that does not divide stays replicated there).
    ``groups`` (a tree like ``like`` of ints, None for 1 everywhere): a
    leaf's split dims made of that many parts side by side (a dim whose
    parts its axes do not divide is left whole)."""
    sizes = dict(mesh.shape)
    coords = dict(mesh.coords)

    def one(spec: Spec, shape=None, g: int = 1) -> LeafSharding:
        splits, grouped = [], []
        for dim, entry in enumerate(spec):
            axes = tuple(a for a in _axes_of(entry) if sizes.get(a, 1) > 1)
            if not axes:
                continue
            parts, index = 1, 0
            for a in axes:
                index = index * sizes[a] + coords[a]
                parts *= sizes[a]
            if shape is not None and shape[dim] % (parts * g):
                continue
            splits.append((dim, axes, parts, index))
            if g > 1:
                grouped.append((dim, g))
        return LeafSharding(tuple(spec), tuple(splits), tuple(grouped))

    if like is None:
        return map_specs(one, specs)

    def walk(spec_node, like_node, g_node):
        if isinstance(spec_node, dict):
            return {k: walk(spec_node[k], like_node[k],
                            None if g_node is None else g_node[k])
                    for k in spec_node}
        if _is_spec_leaf(spec_node):
            return one(spec_node, tuple(like_node.shape), g_node or 1)
        return tuple(walk(s, l, None if g_node is None else gn)
                     for s, l, gn in zip(
                         spec_node, like_node,
                         g_node if g_node is not None
                         else [None] * len(spec_node)))

    return walk(specs, like, groups)


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
