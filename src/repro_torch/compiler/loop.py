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

**The gradient.**  The loop node carries a backward
(``register_autograd``), the counterpart of JAX differentiating
``lax.scan``.  Where a gradient is asked for (grad mode on and a
floating-point leaf that requires it), :func:`scan` records the node with
``save_carries=True``, so that it also returns each step's input carry,
stacked; serving's nodes keep their outputs.  The backward is one more
loop node walked from t = L - 1 down to 0 (``reverse=True``), whose body
is the VJP of the forward body, traced once by ``make_fx``
(:func:`_vjp_step`): its carry is the carry's gradient plus float32
accumulators of the consts' gradients, its step inputs the saved carry,
the step's x and the gradient of its y, and its ys the gradient of x.
The accumulators take the steps' const gradients from the last step down,
the order autograd's engine sums them in for the eager loop.  Carries are
floating-point; integer xs and consts get no gradient.  A remat group's
recomputation reruns the forward node.

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
             xs: List[torch.Tensor], consts: List[torch.Tensor],
             reverse: bool = False, save_carries: bool = False
             ) -> List[torch.Tensor]:
    """Run ``module`` (the body's graph, or its dispatched module) over the
    leading axis of ``xs``, from the last index down with ``reverse``: the
    final carry's leaves, then each ``y`` leaf stacked by index, then with
    ``save_carries`` each carry leaf as it entered each step, stacked."""
    ys: List[List[torch.Tensor]] = [[] for _ in body.y_specs]
    saved: List[List[torch.Tensor]] = [[] for _ in carry]
    steps = list(zip(*(x.unbind(0) for x in xs)))
    for step in (reversed(steps) if reverse else steps):
        if save_carries:
            for acc, c in zip(saved, carry):
                acc.append(c)
        out = module(*carry, *step, *consts)
        carry = list(out[:body.n_carry])
        for acc, y in zip(ys, out[body.n_carry:]):
            acc.append(y)
    if reverse:
        for acc in ys:
            acc.reverse()
    return (carry + [torch.stack(acc) for acc in ys]
            + [torch.stack(acc) for acc in saved if save_carries])


@torch.library.custom_op("repro_torch::scan_loop", mutates_args=())
def _scan_loop(body_id: int, carry: List[torch.Tensor],
               xs: List[torch.Tensor], consts: List[torch.Tensor],
               reverse: bool = False, save_carries: bool = False
               ) -> List[torch.Tensor]:
    body = _BODIES[body_id]
    out = run_body(body, body.graph_module, carry, xs, consts, reverse,
                   save_carries)
    return [t.clone() for t in out]     # a custom op returns no input


@_scan_loop.register_fake
def _scan_loop_fake(body_id, carry, xs, consts, reverse=False,
                    save_carries=False):
    body = _BODIES[body_id]
    length, dev = xs[0].shape[0], xs[0].device
    return ([torch.empty_like(c) for c in carry]
            + [torch.empty((length,) + shape, dtype=dtype, device=dev)
               for shape, dtype in body.y_specs]
            + [torch.empty((length,) + tuple(c.shape), dtype=c.dtype,
                           device=dev) for c in carry if save_carries])


def _vjp_step(fwd_id: int, n_x: int, carry: List[torch.Tensor],
              x: List[torch.Tensor], consts: List[torch.Tensor]):
    """One step of a forward body's backward, as a scan body: carry = (the
    carry's gradient, the consts' f32 gradient accumulators), x = (the
    carry that entered the step, the step's xs, the gradient of its ys).
    Returns (the gradient of the carry before the step, the accumulators
    plus this step's const gradients) and the gradients of the step's
    floating-point xs."""
    body = _BODIES[fwd_id]
    n_c = body.n_carry
    dcarry, dacc = carry[:n_c], carry[n_c:]
    c_t, x_t, dy_t = x[:n_c], x[n_c:n_c + n_x], x[n_c + n_x:]
    with torch.enable_grad():
        c_in = [t.detach().requires_grad_() for t in c_t]
        x_in = [t.detach().requires_grad_() if t.is_floating_point() else t
                for t in x_t]
        k_in = [t.detach().requires_grad_() if t.is_floating_point() else t
                for t in consts]
        out = body.graph_module(*c_in, *x_in, *k_in)
        wrt = [t for t in c_in + x_in + k_in if t.requires_grad]
        pairs = [(o, g) for o, g in zip(out, list(dcarry) + list(dy_t))
                 if o.requires_grad]
        grads = iter(torch.autograd.grad(
            [o for o, _ in pairs], wrt, [g for _, g in pairs],
            allow_unused=True)) if pairs else iter([None] * len(wrt))
    got = {id(t): next(grads) for t in wrt}

    def grad_of(t: torch.Tensor) -> torch.Tensor:
        g = got.get(id(t))
        return torch.zeros_like(t) if g is None else g
    dx = [grad_of(t) for t in x_in if t.is_floating_point()]
    acc = [a if got.get(id(t)) is None else a + got[id(t)].float()
           for a, t in zip(dacc, [t for t in k_in if t.is_floating_point()])]
    return [grad_of(t) for t in c_in] + acc, dx


def _register(key: Any, trace: Callable[[], LoopBody]) -> int:
    body_id = _IDS.get(key)
    if body_id is None:
        loop_body = trace()
        body_id = _IDS[key] = len(_BODIES)
        _BODIES.append(loop_body)
    return body_id


def _scan_setup(ctx, inputs, output) -> None:
    body_id, carry, xs, consts, reverse, save_carries = inputs
    body = _BODIES[body_id]
    ctx.body_id, ctx.n_x = body_id, len(xs)
    ctx.ok = save_carries and not reverse
    saved = output[body.n_carry + len(body.y_specs):] if ctx.ok else []
    ctx.save_for_backward(*xs, *consts, *saved)


def _scan_backward(ctx, grads):
    if not ctx.ok:
        raise RuntimeError("this scan_loop node saved no carries (or runs "
                           "reversed) and has no gradient")
    body = _BODIES[ctx.body_id]
    n_c, n_y, n_x = body.n_carry, len(body.y_specs), ctx.n_x
    saved = list(ctx.saved_tensors)
    xs, consts, carries = (saved[:n_x], saved[n_x:len(saved) - n_c],
                           saved[len(saved) - n_c:])
    length = xs[0].shape[0]
    dcarry = [g if g is not None else torch.zeros_like(c[0])
              for g, c in zip(grads[:n_c], carries)]
    dys = [g if g is not None else
           torch.zeros((length,) + shape, dtype=dtype, device=xs[0].device)
           for g, (shape, dtype) in zip(grads[n_c:n_c + n_y], body.y_specs)]
    fconsts = [k for k in consts if k.is_floating_point()]
    dacc = [torch.zeros(k.shape, dtype=torch.float32, device=k.device)
            for k in fconsts]
    carry = [c.contiguous() for c in dcarry] + dacc
    steps = [t.contiguous() for t in carries + xs + dys]
    specs = (tuple(_spec(t) for t in carry),
             tuple(_spec(t, step=True) for t in steps),
             tuple(_spec(t) for t in consts))
    trees = tuple(pytree.tree_flatten(list(range(len(g))))[1]
                  for g in specs)
    vjp = functools.partial(_vjp_step, ctx.body_id, n_x)
    vjp_id = _register(
        ("vjp", ctx.body_id, specs),
        lambda: _trace_body(vjp, f"{body.name}_vjp", specs, trees,
                            _fake_mode(carry + steps + list(consts))))
    out = torch.ops.repro_torch.scan_loop(vjp_id, carry, steps, consts,
                                          True, False)
    n_k = len(fconsts)
    dks = iter(out[n_c:n_c + n_k])
    dxs = iter(out[n_c + n_k:])
    return (None, list(out[:n_c]),
            [next(dxs) if x.is_floating_point() else None for x in xs],
            [next(dks).to(k.dtype) if k.is_floating_point() else None
             for k in consts], None, None)


_scan_loop.register_autograd(_scan_backward, setup_context=_scan_setup)


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
        carry = pytree.tree_unflatten(c_flat, c_tree)
        for leaves in zip(*(x.unbind(0) for x in x_flat)):
            carry, y = body(carry, pytree.tree_unflatten(list(leaves), x_tree),
                            consts)
            carry = pytree.tree_map(torch.Tensor.contiguous, carry)
            ys.append(y)
        stacked = pytree.tree_map(lambda *leaves: torch.stack(leaves), *ys)
        return carry, stacked
    specs = (tuple(_spec(t) for t in c_flat),
             tuple(_spec(t, step=True) for t in x_flat),
             tuple(_spec(t) for t in k_flat))
    key = (_closure_key(body), name, c_tree, x_tree, k_tree, specs)
    body_id = _register(key, lambda: _trace_body(
        body, name, specs, (c_tree, x_tree, k_tree),
        _fake_mode(c_flat + x_flat + k_flat)))
    loop_body = _BODIES[body_id]
    if torch.is_grad_enabled() and any(
            t.is_floating_point() and t.requires_grad
            for t in c_flat + x_flat + k_flat):
        if not all(t.is_floating_point() for t in c_flat):
            raise TypeError(f"scan {name!r}: a gradient through the loop "
                            f"needs a floating-point carry")
        outs = torch.ops.repro_torch.scan_loop(body_id, c_flat, x_flat,
                                               k_flat, False, True)
    else:
        outs = torch.ops.repro_torch.scan_loop(body_id, c_flat, x_flat,
                                               k_flat)
    n, n_y = loop_body.n_carry, len(loop_body.y_specs)
    return (pytree.tree_unflatten(list(outs[:n]), c_tree),
            pytree.tree_unflatten(list(outs[n:n + n_y]), loop_body.y_tree))
