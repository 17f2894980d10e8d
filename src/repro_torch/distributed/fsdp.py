"""FSDP by the rules' ``embed -> data``: the counterpart of the reference's
"parameter/optimizer storage (gathered per layer inside the scan)".

Under ``train(mesh=)`` every master, moment and gradient whose ``embed``
dim the ``data`` axis divides is held on a rank only as its ``data``
block (of its ``model`` block, where tensor parallelism splits it too).
The model gathers a group's weights as the group's first act, inside its
remat body (:func:`repro_torch.models.lm.forward_aux`), so a remat
recomputation gathers again and no group's whole weights live from the
forward to the backward; the embedding table and the head are gathered
just before their use.

:func:`gather_tree` gathers a group's split leaves as one bucket: their
blocks flattened end to end, cast to the compute dtype (the reference's
``compute_cast`` before GSPMD's per-layer all-gather, which halves the
gather's bytes) and all-gathered over the split's axis in one call
(:func:`repro_torch.distributed.collectives.param_gather`), each leaf
then put back whole.  The bucket's gradient is cast back to the blocks'
dtype (float32 for a master) and reduce-scattered in one call: each rank
receives the float32 sum over ``data`` of every rank's partial gradient
of its blocks, the sum ZeRO-1's all-reduce made, so the trainer sums no
such gradient again.  Where the ``data`` axis is not a batch axis of the
ambient rules (a global batch it does not divide), every rank computed
the same whole gradient, and the block's is its part of it, with no
collective.  :func:`gather_param` is the same for one leaf.

Leaves the layers read in float32 (norm scales, the recurrent gates'
float32 leaves, :data:`repro_torch.convert.F32_PARAMS`) are gathered in
their stored dtype, in a bucket of their own; the rules leave all of them
whole over ``data``, so today none is gathered.  Without a split (no
mesh, or an ``embed`` dim the axis does not divide) every function here
is the identity, so unmeshed code and its numbers do not change.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.convert import F32_PARAMS
from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import (LeafSharding, _axes_of,
                                              current_mesh, current_rules,
                                              regroup)
from repro_torch.tree import leaves, unflatten

__all__ = ["gather_param", "gather_tree"]


def gather_param(w: torch.Tensor, sharding: Optional[LeafSharding],
                 dtype: Optional[torch.dtype], *, mesh: Any = None,
                 span: str = "comm.fsdp_gather") -> torch.Tensor:
    """The whole of a leaf held as this rank's block ``w`` under
    ``sharding`` (the model passes its non-``model`` splits, so a
    ``model`` block stays one; a checkpoint all of them), in ``dtype``
    (None: ``w``'s), a grouped dim put back in its order.  Gathered over
    ``mesh``'s axes (default the ambient mesh), the cast first; the
    gradient of ``w`` is the float32 reduce-scatter of the whole one's
    (module docstring).  ``w`` itself when nothing is split."""
    return _gather_bucket([w], [sharding], dtype, mesh, span)[0]


def gather_tree(tree: Any, layout: Any, dtype: torch.dtype) -> Any:
    """The leaves of ``tree`` (a group's weights, a list of such trees,
    the head) whole under ``layout``: every split leaf in ``dtype`` but
    those the layers read in float32, which keep their own.  The split
    leaves of one dtype and one chain of axes are one bucket: one
    ``param_gather`` an axis, one reduce-scatter an axis in the
    backward (module docstring)."""
    if layout is None:
        return tree
    flat, shs = leaves(tree), leaves(layout)
    out = list(flat)
    buckets: Dict[Tuple, List[int]] = {}
    for i, (name, w, sh) in enumerate(_named(tree, layout)):
        if sh is not None and sh.splits:
            dt = w.dtype if name in F32_PARAMS else dtype
            buckets.setdefault((sh.axes(), dt), []).append(i)
    for (_, dt), idx in buckets.items():
        wholes = _gather_bucket([flat[i] for i in idx],
                                [shs[i] for i in idx], dt, None,
                                "comm.fsdp_gather")
        for i, w in zip(idx, wholes):
            out[i] = w
    return unflatten(tree, out)


def _named(tree: Any, layout: Any, name: str = ""):
    """(its dict key, leaf, sharding) of every leaf of ``tree``, in
    :func:`repro_torch.tree.leaves` order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named(tree[k], layout[k], k)
    elif isinstance(tree, (tuple, list)):
        for t, sh in zip(tree, layout):
            yield from _named(t, sh, name)
    else:
        yield name, tree, layout


def _steps(sh: LeafSharding) -> List[Tuple[str, int, Optional[Tuple]]]:
    """A leaf's gather, an entry an axis in the order they are gathered:
    (axis, dim, ``regroup``'s (parts, groups) after the dim's last axis,
    else None)."""
    groups = dict(sh.groups)
    out = []
    for dim, axes, parts, _ in reversed(sh.splits):
        for j, axis in enumerate(reversed(axes)):
            out.append((axis, dim, (parts, groups.get(dim, 1))
                        if j == len(axes) - 1 else None))
    return out


def _gather_bucket(ws: List[torch.Tensor], shs: List[Optional[LeafSharding]],
                   dtype: Optional[torch.dtype], mesh: Any, span: str
                   ) -> List[torch.Tensor]:
    """Each block of ``ws`` whole under ``shs`` (one chain of axes for
    all), in ``dtype`` (None: the blocks'): an axis at a time, the blocks
    flattened end to end in their own dtype (the gradient comes back in
    it), cast and all-gathered in one call, then each leaf's rank blocks
    side by side along its dim."""
    if shs[0] is None or not shs[0].splits:
        return ws
    mesh = mesh if mesh is not None else current_mesh()
    rules = current_rules()
    batch = set(_axes_of(rules.batch)) if rules is not None else set()
    steps = [_steps(sh) for sh in shs]
    xs = list(ws)
    for k, (axis, _, _) in enumerate(steps[0]):
        flat = (xs[0].reshape(-1) if len(xs) == 1
                else torch.cat([x.reshape(-1) for x in xs]))
        got = collectives.param_gather(flat, mesh.group_key(axis), 0,
                                       dtype or flat.dtype,
                                       summed=axis in batch, span=span)
        n = got.shape[0] // flat.shape[0]
        rows = got.view(n, -1)
        pieces = ((rows,) if len(xs) == 1 else
                  torch.split(rows, [x.numel() for x in xs], dim=1))
        for i, (x, piece) in enumerate(zip(xs, pieces)):
            _, dim, regrouped = steps[i][k]
            y = piece.reshape((n,) + tuple(x.shape)).movedim(0, dim)
            y = y.flatten(dim, dim + 1)
            xs[i] = y if regrouped is None else regroup(y, dim, *regrouped)
    return xs
