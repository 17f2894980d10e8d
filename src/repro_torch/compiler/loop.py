"""The loop primitive: ``scan(body, carry, xs, consts)``, the port's
counterpart of ``jax.lax.scan`` as the reference's serving steps use it
(``repro.serving.model._chunk_mixer_scan``).

``body(carry, x, consts) -> (new_carry, y)`` runs once per index ``t`` of
the leading axis of ``xs`` (every leaf of ``xs`` has the same length L),
with ``x`` the pytree of ``xs`` leaves at ``t``; ``scan`` returns the
final carry and the ``y`` leaves stacked over a new leading axis of L.
``carry``, ``xs`` and ``consts`` are pytrees of tensors.  ``consts`` are
the loop's read-only inputs (a layer's weights): the body must take every
tensor it reads through them, never from its closure.  The carry keeps
its structure, shapes and dtypes from step to step.  Leaves of ``carry``
and ``xs`` are made contiguous first, on both paths below, so the body
sees the same strides whether it runs eagerly or compiled.

* **Eagerly** it is a Python loop over ``t``.
* **While** :func:`repro_torch.compiler.trace.trace_model` **records**
  (:func:`tracing`), it is one graph node, ``repro_torch::scan_loop``,
  whatever L is.  The body is traced once on fake tensors of the outer
  trace's ``FakeTensorMode`` (its own ``make_fx``, with the outer proxy
  mode set aside) into a :class:`LoopBody`, a ``GraphModule`` whose inputs
  are the flattened carry, one step's ``xs`` and the consts.  Bodies are
  registered process-wide under a key of the body function (its code, or
  a ``functools.partial``'s function and arguments), the node name and
  the inputs' structure, shapes, strides and dtypes; so every layer of one
  block type shares one body graph, since its weights are inputs.  The
  node's arguments are the body's id and the three flat tensor lists; its
  fake returns the final carry and the stacked ``y``.

A body that closes over a tensor raises (the trace would bake a fake in as
a constant), as does one whose closure or partial holds an unhashable
value, or whose carry changes shape or dtype.

The compiler takes the node from there: :mod:`~repro_torch.compiler.lower`
unrolls the body up to ``SMAOptions.max_scan_unroll`` times and otherwise
costs it once x L behind a ``RECURRENCE`` marker,
:mod:`~repro_torch.compiler.rewrite` rewrites the body graph on its own,
and :mod:`~repro_torch.compiler.dispatch` builds it once into its own
module, which the loop node calls L times.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch
import torch.fx
import torch.utils._pytree as pytree

__all__ = ["LOOP_OP", "LoopBody", "body_of", "run_body", "scan", "tracing"]

_TRACING = False


@contextlib.contextmanager
def tracing() -> Iterator[None]:
    """For the ``with`` scope, :func:`scan` records one loop node (the
    tracer holds this open while it records)."""
    global _TRACING
    saved, _TRACING = _TRACING, True
    try:
        yield
    finally:
        _TRACING = saved


@dataclasses.dataclass(frozen=True)
class LoopBody:
    """One traced loop body.  ``graph_module`` takes ``n_carry`` carry
    leaves, ``n_xs`` step leaves and ``n_consts`` const leaves, and returns
    the new carry's leaves then the ``y`` leaves (one step's, whose shapes
    and dtypes are ``y_specs``)."""

    name: str
    graph_module: torch.fx.GraphModule
    n_carry: int
    n_xs: int
    n_consts: int
    y_specs: Tuple[Tuple[Tuple[int, ...], torch.dtype], ...]
    carry_tree: Any
    y_tree: Any

    @property
    def num_nodes(self) -> int:
        return len(self.graph_module.graph.nodes)


_BODIES: List[LoopBody] = []
_IDS: Dict[Any, int] = {}


def body_of(body_id: int) -> LoopBody:
    """The registered body of a loop node (its first argument)."""
    return _BODIES[body_id]


def run_body(body: LoopBody, module: Callable, carry: List[torch.Tensor],
             xs: List[torch.Tensor], consts: List[torch.Tensor]
             ) -> List[torch.Tensor]:
    """Run ``module`` (the body's graph, or its dispatched module) over the
    leading axis of ``xs``: the final carry's leaves, then each ``y`` leaf
    stacked."""
    ys: List[List[torch.Tensor]] = [[] for _ in body.y_specs]
    for t in range(xs[0].shape[0]):
        out = module(*carry, *(x[t] for x in xs), *consts)
        carry = list(out[:body.n_carry])
        for acc, y in zip(ys, out[body.n_carry:]):
            acc.append(y)
    return carry + [torch.stack(acc) for acc in ys]


@torch.library.custom_op("repro_torch::scan_loop", mutates_args=())
def _scan_loop(body_id: int, carry: List[torch.Tensor],
               xs: List[torch.Tensor], consts: List[torch.Tensor]
               ) -> List[torch.Tensor]:
    body = _BODIES[body_id]
    out = run_body(body, body.graph_module, carry, xs, consts)
    return [t.clone() for t in out]     # a custom op returns no input


@_scan_loop.register_fake
def _scan_loop_fake(body_id, carry, xs, consts):
    body = _BODIES[body_id]
    length, dev = xs[0].shape[0], xs[0].device
    return ([torch.empty_like(c) for c in carry]
            + [torch.empty((length,) + shape, dtype=dtype, device=dev)
               for shape, dtype in body.y_specs])


#: The loop node's target.
LOOP_OP = torch.ops.repro_torch.scan_loop.default


def _closure_key(fn: Callable) -> Any:
    """A hashable identity of a body function: what it runs and every
    value it closes over.  Raises for a tensor or an unhashable value."""
    if isinstance(fn, functools.partial):
        parts = (_closure_key(fn.func), fn.args,
                 tuple(sorted(fn.keywords.items())))
        values = list(fn.args) + list(fn.keywords.values())
    else:
        code = getattr(fn, "__code__", None)
        if code is None:
            raise TypeError(f"scan body {fn!r} is neither a function nor a "
                            f"functools.partial of one")
        values = [c.cell_contents for c in (fn.__closure__ or ())]
        values += list(fn.__defaults__ or ())
        parts = (code, tuple(values))
    for v in values:
        if isinstance(v, torch.Tensor):
            raise TypeError(
                f"scan body {fn!r} closes over a tensor of shape "
                f"{tuple(v.shape)}; pass it through consts")
    try:
        hash(parts)
    except TypeError as exc:
        raise TypeError(f"scan body {fn!r} closes over an unhashable value "
                        f"({exc}); pass tensors through consts and make "
                        f"the rest hashable") from exc
    return parts


def _spec(t: torch.Tensor, *, step: bool = False) -> Tuple[Any, ...]:
    """(shape, stride, dtype, device) of a leaf, or of one step of it."""
    shape, stride = tuple(t.shape), tuple(t.stride())
    if step:
        shape, stride = shape[1:], stride[1:]
    return shape, stride, t.dtype, t.device


def _fake_mode(leaves: List[torch.Tensor]):
    for t in leaves:
        mode = getattr(t, "fake_mode", None)
        if mode is not None:
            return mode
    raise RuntimeError("scan is recording, but its inputs are not fake "
                       "tensors of the trace")


def _trace_body(body: Callable, name: str, specs, trees,
                mode) -> LoopBody:
    """Trace ``body`` once on fakes of ``specs`` (carry, step, consts) in
    the outer trace's fake ``mode``, with the outer proxy mode set
    aside."""
    from torch.fx.experimental.proxy_tensor import (
        disable_proxy_modes_tracing, make_fx)
    c_tree, x_tree, k_tree = trees
    n_c, n_x = len(specs[0]), len(specs[1])
    y_trees: List[Any] = []

    def flat_body(*flat):
        carry = pytree.tree_unflatten(list(flat[:n_c]), c_tree)
        x = pytree.tree_unflatten(list(flat[n_c:n_c + n_x]), x_tree)
        consts = pytree.tree_unflatten(list(flat[n_c + n_x:]), k_tree)
        new_carry, y = body(carry, x, consts)
        nc_flat, nc_tree = pytree.tree_flatten(new_carry)
        if nc_tree != c_tree:
            raise TypeError(f"scan body {name!r} returns a carry of "
                            f"structure {nc_tree}, not {c_tree}")
        for new, (shape, _, dtype, _) in zip(nc_flat, specs[0]):
            if tuple(new.shape) != shape or new.dtype != dtype:
                raise TypeError(
                    f"scan body {name!r} changes a carry leaf from "
                    f"{shape} {dtype} to {tuple(new.shape)} {new.dtype}")
        y_flat, y_tree = pytree.tree_flatten(y)
        y_trees.append(y_tree)
        return [t.contiguous() for t in nc_flat + y_flat]

    with disable_proxy_modes_tracing():
        with mode:
            fakes = [torch.empty_strided(shape, stride, dtype=dtype,
                                         device=dev)
                     for group in specs
                     for shape, stride, dtype, dev in group]
        gm = make_fx(flat_body, tracing_mode="fake")(*fakes)
    baked = [n.target for n in gm.graph.nodes if n.op == "get_attr"]
    if baked:
        raise TypeError(f"scan body {name!r} reads tensors that are not "
                        f"its inputs ({baked}); pass them through consts")
    outs = [n for n in gm.graph.nodes if n.op == "output"][0].args[0]
    y_specs = tuple((tuple(o.meta["val"].shape), o.meta["val"].dtype)
                    for o in outs[n_c:])
    return LoopBody(name=name, graph_module=gm, n_carry=n_c, n_xs=n_x,
                    n_consts=len(specs[2]), y_specs=y_specs,
                    carry_tree=c_tree, y_tree=y_trees[-1])


def scan(body: Callable, carry: Any, xs: Any, consts: Any, *,
         name: Optional[str] = None) -> Tuple[Any, Any]:
    """``body`` over the leading axis of ``xs`` (module docstring).
    Returns (final carry, stacked ys)."""
    c_flat, c_tree = pytree.tree_flatten(carry)
    x_flat, x_tree = pytree.tree_flatten(xs)
    k_flat, k_tree = pytree.tree_flatten(consts)
    for leaf in c_flat + x_flat + k_flat:
        if not isinstance(leaf, torch.Tensor):
            raise TypeError(f"scan inputs are tensors, got {leaf!r}")
    if not x_flat or len({x.shape[0] for x in x_flat}) != 1:
        raise ValueError("scan needs xs leaves of one leading length")
    c_flat = [t.contiguous() for t in c_flat]
    x_flat = [t.contiguous() for t in x_flat]
    name = name or getattr(getattr(body, "func", body), "__name__", "body")
    if not _TRACING:
        ys: List[Any] = []
        for t in range(x_flat[0].shape[0]):
            step = pytree.tree_unflatten([x[t] for x in x_flat], x_tree)
            carry, y = body(pytree.tree_unflatten(c_flat, c_tree), step,
                            consts)
            c_flat = [leaf.contiguous()
                      for leaf in pytree.tree_leaves(carry)]
            ys.append(y)
        stacked = pytree.tree_map(lambda *leaves: torch.stack(leaves), *ys)
        return pytree.tree_unflatten(c_flat, c_tree), stacked
    specs = (tuple(_spec(t) for t in c_flat),
             tuple(_spec(t, step=True) for t in x_flat),
             tuple(_spec(t) for t in k_flat))
    key = (_closure_key(body), name, c_tree, x_tree, k_tree, specs)
    body_id = _IDS.get(key)
    if body_id is None:
        loop_body = _trace_body(body, name, specs, (c_tree, x_tree, k_tree),
                                _fake_mode(c_flat + x_flat + k_flat))
        body_id = _IDS[key] = len(_BODIES)
        _BODIES.append(loop_body)
    loop_body = _BODIES[body_id]
    outs = torch.ops.repro_torch.scan_loop(body_id, c_flat, x_flat, k_flat)
    n = loop_body.n_carry
    return (pytree.tree_unflatten(list(outs[:n]), c_tree),
            pytree.tree_unflatten(list(outs[n:]), loop_body.y_tree))
