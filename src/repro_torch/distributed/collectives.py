"""Collectives over a mesh axis: the port's counterpart of the
``lax.psum``, ``all_gather`` and ``ppermute`` calls the reference makes
inside ``shard_map``.

Each one is a ``torch.library`` custom op (``repro_torch::all_reduce``,
``broadcast``, ``all_gather``, ``reduce_scatter``, ``param_gather``,
``sendrecv``) with a fake, so a graph that
``sma_jit`` traces keeps each collective as one node; the dispatcher puts
the op's implementation in the node's place (:data:`IMPLS`), so the
compiled program runs the collective itself, as an eager call does (a
custom op's first call imports ``torch._dynamo``: 2.4 s on an 8-core CPU
host, ~11 s on the H100 machine's host, in every process).  Every
collective returns a new tensor that the program reads: it is never a
dead node the dispatcher could drop, and the compiled program issues them
in the order traced, the same on every rank.  (``tp_enter``'s forward
moves nothing: its dispatched node hands on its input, uncopied.)

The group of an axis is named by a string key (:meth:`repro_torch.launch.
mesh.Mesh.group_key`), registered when the mesh is made.  A key with no
process group (one rank, no ``torch.distributed`` group) makes every
collective the identity.

Routing is static, by the group's backend:

* ``nccl``: CUDA tensors go into the collective directly;
* ``gloo`` with CUDA tensors: the op copies through pinned host buffers
  in pieces, runs the collective on the host and copies back.  The pieces
  go over the line's lanes, :data:`GLOO_LANES` process groups of the same
  ranks, one piece a lane at once (one gloo group moves ~0.7 GB/s over
  loopback, four ~1.7 GB/s on an 8-core host), with at most
  :data:`BUCKET_BYTES` in flight (every op, :func:`broadcast_async`
  included, through one helper and cached buffers).  Each such call is
  counted in :data:`repro_torch.kernels.ops.ROUTED` under
  ``"collective: gloo stages through host"``, and its bytes in
  :data:`STAGED_BYTES`; it is the group's route, not a fallback;
* ``gloo`` with CPU tensors: the collective runs on them.

Every call counts in :data:`CALLS` (by op) and :data:`ROUTES` (``nccl``,
``gloo``, ``host``), its bytes in :data:`BYTES` (by span name), and, while
a :func:`repro_torch.profile` is active, is a ``comm.*`` span on the
``comm`` lane with those bytes and its axis key.

Gradients (tensor parallelism, :mod:`repro_torch.distributed.
tensor_parallel`).  ``all_reduce`` with op ``sum`` carries its gradient
through unchanged (Megatron's *g*: the sum of the ranks' partial outputs
has a gradient every rank already holds whole); :func:`tp_enter`
(``repro_torch::tp_enter``) is the identity forward and an all-reduce of
the gradient backward (Megatron's *f*: each rank's gradient of a tensor it
read whole is partial); ``all_gather``'s gradient is this rank's block of
the output's; op ``max`` carries none; ``reduce_scatter``'s is an
all-gather.  :func:`param_gather` (``repro_torch::param_gather``, FSDP's
gather of a stored parameter block, :mod:`repro_torch.distributed.fsdp`)
casts its input to the compute dtype and all-gathers it; its gradient is
cast back to the input's dtype (float32 for a master) and reduce-scattered,
so each rank receives the float32 sum over the group of every rank's
partial gradient of its block.  Eagerly these are autograd
Functions around the implementations; in a trace each op carries its
backward (``torch.library.register_autograd``), written with the same
entry points, so the joint graph holds the backward's collectives as
nodes in the order the backward issues them.
"""
from __future__ import annotations

import collections
import time
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch.obs import trace as _obs_trace

__all__ = ["BUCKET_BYTES", "BYTES", "CALLS", "ROUTES", "STAGED_BYTES",
           "STAGED_MS", "COLLECTIVE_OPS", "IMPLS", "all_gather", "all_reduce",
           "broadcast", "broadcast_async", "call_bytes", "index_of",
           "param_gather", "reduce_scatter", "register", "reset_counts",
           "sendrecv", "size_of", "tp_enter"]

#: The most a staged collective holds in pinned memory at once (all lanes).
BUCKET_BYTES = 256 << 20
#: Process groups a ``gloo`` mesh line gets (:class:`repro_torch.launch.
#: mesh.Mesh`), for staged pieces in flight together.
GLOO_LANES = 4

#: Calls by op, and by route.
CALLS: Dict[str, int] = collections.Counter()
ROUTES: Dict[str, int] = collections.Counter()
#: Bytes copied to the host by staged collectives (each tensor once), and
#: the host milliseconds those calls took (copies and collective).
STAGED_BYTES: Dict[str, int] = collections.Counter()
STAGED_MS: Dict[str, float] = collections.Counter()
#: The bytes each call's span carries (:func:`call_bytes`), by span name.
BYTES: Dict[str, int] = collections.Counter()

_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "mean": dist.ReduceOp.SUM,
               "max": dist.ReduceOp.MAX}

STAGED_REASON = "collective: gloo stages through host"

#: key -> (the line's process groups (its lanes) or None, its global
#: ranks, backend)
_GROUPS: Dict[str, Tuple[Optional[List[Any]], List[int], Optional[str]]] = {}
_PINNED: Dict[Any, torch.Tensor] = {}


def register(key: str, groups: Optional[List[Any]], ranks: List[int],
             backend: Optional[str]) -> None:
    """Name the process groups of one mesh axis line (``Mesh`` calls it):
    one a lane, each of the same ranks; None without a process group."""
    _GROUPS[key] = (list(groups) if groups else None, list(ranks), backend)


def size_of(key: str) -> int:
    """Ranks in the group under ``key``."""
    return len(_GROUPS[key][1])


def index_of(key: str) -> int:
    """This rank's index in the group under ``key``."""
    ranks = _GROUPS[key][1]
    return ranks.index(dist.get_rank()) if dist.is_initialized() else 0


def reset_counts() -> None:
    for c in (CALLS, ROUTES, STAGED_BYTES, STAGED_MS, BYTES):
        c.clear()


def call_bytes(op: str, shape, itemsize: int, ranks: int,
               peer: bool = True) -> int:
    """The bytes one call's span carries: an all-reduce's and a
    reduce-scatter's input once; a broadcast's and an all-gather's to each
    other rank (a ``param_gather``'s in the dtype it gathers, ``itemsize``
    that dtype's); a send's when it has a peer (``peer``); an identity
    (``tp_enter``) none."""
    n = itemsize
    for d in shape:
        n *= int(d)
    if op in ("all_reduce", "reduce_scatter"):
        return n
    if op in ("broadcast", "all_gather", "param_gather"):
        return n * (ranks - 1)
    if op == "sendrecv":
        return n if peer else 0
    return 0


def _lookup(key: str):
    if key not in _GROUPS:
        raise KeyError(f"no process group registered under {key!r}: build "
                       f"the Mesh (every rank, same order) before the "
                       f"program that uses it")
    return _GROUPS[key]


def _route(x: torch.Tensor, backend: Optional[str]) -> str:
    if x.device.type == "cuda" and backend != "nccl":
        return "host"
    return "nccl" if backend == "nccl" else "gloo"


def _pinned(slot, nbytes: int) -> torch.Tensor:
    """A cached pinned byte buffer of at least ``nbytes`` (one a slot)."""
    buf = _PINNED.get(slot)
    if buf is None or buf.numel() < nbytes:
        buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        _PINNED[slot] = buf
    return buf


def _host(slot, n: int, dtype: torch.dtype) -> torch.Tensor:
    """``n`` elements of ``dtype`` in slot ``slot``'s pinned buffer."""
    size = dtype.itemsize
    return _pinned(slot, n * size)[:n * size].view(dtype)


def _count(op: str, route: str) -> None:
    CALLS[op] += 1
    ROUTES[route] += 1
    if route == "host":
        from repro_torch.kernels import ops
        ops.ROUTED[STAGED_REASON] += 1


class _Staged:
    """Times a staged call on the host clock into :data:`STAGED_MS`."""

    def __init__(self, op: str, route: str) -> None:
        self.op, self.on = op, route == "host"

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        if self.on:
            STAGED_MS[self.op] += (time.perf_counter() - self.t0) * 1e3


def _span(name: str, key: str, nbytes: int):
    BYTES[name] += int(nbytes)
    tr = _obs_trace.current_tracer()
    if tr is None:
        return _obs_trace._NULL
    return tr.span(name, cat="comm", mode="comm", axis=key,
                   bytes=int(nbytes))


# --------------------------------------------------------------------------
# Implementations
# --------------------------------------------------------------------------
def _lane_pieces(numel: int, itemsize: int, lanes: int):
    """Pieces of a staged tensor: at most :data:`BUCKET_BYTES` in flight
    over all lanes, and at least one piece a lane."""
    step = max(1, min(BUCKET_BYTES // lanes // itemsize,
                      -(-numel // lanes)))
    return [(lo, min(numel, lo + step)) for lo in range(0, numel, step)]


def _staged(flat: torch.Tensor, outs, groups, issue,
            tag: Any = "sync") -> "_InFlight":
    """Move ``flat`` through pinned host memory in pieces, one piece a
    lane (a process group of the same ranks) in flight: ``issue(group,
    slot, host_in)`` starts the collective and returns ``(work,
    host_outs)``; each of ``host_outs`` is then copied into the piece's
    place in the matching flat tensor of ``outs``.  ``flat`` may be 2-D
    (one row a rank's part, a reduce-scatter's input): a piece is then the
    same columns of every row.  The first round of pieces is issued now;
    the handle's ``wait()`` completes it and runs the rest.  ``tag`` names
    the pinned buffers (one set a tag): a call left in flight while others
    run has a tag of its own."""
    return _InFlight(flat, outs, groups, issue, tag)


class _InFlight:
    """A staged collective (:func:`_staged`): at most one round of pieces,
    :data:`BUCKET_BYTES` over all lanes, in flight."""

    def __init__(self, flat, outs, groups, issue, tag) -> None:
        self.flat, self.outs, self.groups = flat, outs, groups
        self.issue, self.tag = issue, tag
        lanes = len(groups)
        rows = flat.shape[0] if flat.dim() == 2 else 1
        pieces = _lane_pieces(flat.shape[-1], flat.element_size() * rows,
                              lanes)
        self.rounds = [pieces[i:i + lanes]
                       for i in range(0, len(pieces), lanes)]
        self.pending = self._issue()

    def _issue(self) -> list:
        pending = []
        if self.rounds:
            for lane, (lo, hi) in enumerate(self.rounds.pop(0)):
                slot = (self.tag, lane)
                part = self.flat[..., lo:hi]
                host_in = _host(slot + (0,), part.numel(),
                                self.flat.dtype).view(part.shape)
                host_in.copy_(part)
                pending.append((lo, hi, *self.issue(self.groups[lane], slot,
                                                    host_in)))
        return pending

    def wait(self) -> None:
        while self.pending:
            for lo, hi, work, host_outs in self.pending:
                work.wait()
                for out, host in zip(self.outs, host_outs):
                    out[lo:hi].copy_(host)
            self.pending = self._issue()


class _Works:
    """Several works as one (a piece's send and receive)."""

    def __init__(self, works) -> None:
        self.works = works

    def wait(self) -> None:
        for w in self.works:
            w.wait()


def _all_reduce_impl(x: torch.Tensor, key: str, op: str, span: str
                     ) -> torch.Tensor:
    return _run_all_reduce(x, key, op, span)


def _run_all_reduce(x: torch.Tensor, key: str, op: str, span: str
                    ) -> torch.Tensor:
    """The all-reduce a ``repro_torch::all_reduce`` node runs (looked up
    on the module at each call, so a check can stand a planted fault in
    its place)."""
    groups, ranks, backend = _lookup(key)
    out = x.contiguous().clone()
    if groups is None:
        return out
    route = _route(x, backend)
    _count("all_reduce", route)
    red = _REDUCE_OPS[op]
    with _span(span, key, out.numel() * out.element_size()), \
            _Staged("all_reduce", route):
        if route != "host":
            dist.all_reduce(out, op=red, group=groups[0])
        else:
            def issue(group, slot, buf):
                return (dist.all_reduce(buf, op=red, group=group,
                                        async_op=True), [buf])
            _staged(out.view(-1), [out.view(-1)], groups, issue).wait()
            STAGED_BYTES["all_reduce"] += out.numel() * out.element_size()
    if op == "mean":
        out = out / len(ranks)
    return out


def _broadcast_impl(x: torch.Tensor, key: str, src: int, span: str
                    ) -> torch.Tensor:
    groups, ranks, backend = _lookup(key)
    out = x.contiguous().clone()
    if groups is None:
        return out
    route = _route(x, backend)
    _count("broadcast", route)
    with _span(span, key, out.numel() * out.element_size()
               * (len(ranks) - 1)), _Staged("broadcast", route):
        if route != "host":
            dist.broadcast(out, src=ranks[src], group=groups[0])
        else:
            def issue(group, slot, buf):
                return (dist.broadcast(buf, src=ranks[src], group=group,
                                       async_op=True), [buf])
            _staged(out.view(-1), [out.view(-1)], groups, issue).wait()
            STAGED_BYTES["broadcast"] += out.numel() * out.element_size()
    return out


def _all_gather_impl(x: torch.Tensor, key: str, dim: int, span: str,
                     op: str = "all_gather") -> torch.Tensor:
    groups, ranks, backend = _lookup(key)
    x = x.contiguous()
    if groups is None:
        return x.clone()
    n = len(ranks)
    route = _route(x, backend)
    _count(op, route)
    parts = [torch.empty_like(x) for _ in range(n)]
    with _span(span, key, x.numel() * x.element_size() * (n - 1)), \
            _Staged(op, route):
        if route != "host":
            dist.all_gather(parts, x, group=groups[0])
        else:
            def issue(group, slot, mine):
                bufs = [_host(slot + (1 + r,), mine.numel(), mine.dtype)
                        for r in range(n)]
                return dist.all_gather(bufs, mine, group=group,
                                       async_op=True), bufs
            _staged(x.view(-1), [p.view(-1) for p in parts], groups,
                    issue).wait()
            STAGED_BYTES[op] += x.numel() * x.element_size()
    return torch.cat(parts, dim=dim)


def _reduce_scatter_impl(x: torch.Tensor, key: str, dim: int, span: str
                         ) -> torch.Tensor:
    return _run_reduce_scatter(x, key, dim, span)


def _run_reduce_scatter(x: torch.Tensor, key: str, dim: int, span: str
                        ) -> torch.Tensor:
    """The sum over the group of every rank's ``x``, this rank's block of it
    along ``dim`` (the blocks in group order), as a ``repro_torch::
    reduce_scatter`` node runs it (looked up on the module at each call,
    so a check can stand a planted fault in its place)."""
    groups, ranks, backend = _lookup(key)
    if groups is None:
        return x.contiguous().clone()
    n = len(ranks)
    lead = x.movedim(dim, 0).contiguous()      # rank r's block: row r
    out = lead.new_empty((lead.shape[0] // n,) + tuple(lead.shape[1:]))
    route = _route(x, backend)
    _count("reduce_scatter", route)
    with _span(span, key, x.numel() * x.element_size()), \
            _Staged("reduce_scatter", route):
        if route != "host":
            dist.reduce_scatter_tensor(out, lead, group=groups[0])
        else:
            def issue(group, slot, rows):
                mine = _host(slot + (1,), rows.shape[1], rows.dtype)
                return (dist.reduce_scatter_tensor(
                    mine, rows.reshape(-1), group=group, async_op=True),
                    [mine])
            _staged(lead.view(n, -1), [out.view(-1)], groups, issue).wait()
            STAGED_BYTES["reduce_scatter"] += x.numel() * x.element_size()
    return out.movedim(0, dim).contiguous()


def _param_gather_impl(x: torch.Tensor, key: str, dim: int,
                       dtype: torch.dtype, summed: bool, span: str
                       ) -> torch.Tensor:
    """FSDP's gather of a stored block: ``x`` in ``dtype``, every rank's
    block concatenated along ``dim`` (``summed`` only picks the gradient
    rule)."""
    return _all_gather_impl(x.to(dtype), key, dim, span, "param_gather")


def _sendrecv_impl(x: torch.Tensor, key: str, dst: int, src: int,
                   span: str) -> torch.Tensor:
    """Send ``x`` to index ``dst`` of the group and receive a tensor like it
    from index ``src`` (-1: none; the result is then zeros)."""
    groups, ranks, backend = _lookup(key)
    x = x.contiguous()
    out = torch.zeros_like(x)
    if groups is None:
        return out
    route = _route(x, backend)
    _count("sendrecv", route)
    with _span(span, key, x.numel() * x.element_size() * (dst >= 0)), \
            _Staged("sendrecv", route):
        def issue(group, slot, send):
            recv = (_host(slot + (1,), send.numel(), send.dtype)
                    if route == "host" else torch.empty_like(send))
            reqs = []
            if dst >= 0:
                reqs.append(dist.P2POp(dist.isend, send, ranks[dst], group))
            if src >= 0:
                reqs.append(dist.P2POp(dist.irecv, recv, ranks[src], group))
            works = dist.batch_isend_irecv(reqs) if reqs else []
            return _Works(works), [recv] if src >= 0 else []

        if route != "host":
            work, recvs = issue(groups[0], None, x)
            work.wait()
            for recv in recvs:
                out.copy_(recv)
        else:
            _staged(x.view(-1), [out.view(-1)], groups, issue).wait()
            STAGED_BYTES["sendrecv"] += x.numel() * x.element_size()
    return out


def _gathered_shape(x: torch.Tensor, key: str, dim: int):
    shape = list(x.shape)
    shape[dim] *= size_of(key)
    return shape


def _scattered_shape(x: torch.Tensor, key: str, dim: int):
    shape = list(x.shape)
    shape[dim] //= size_of(key)
    return shape


def _tp_enter_impl(x: torch.Tensor, key: str, span: str) -> torch.Tensor:
    """Tensor parallelism's *f* forward, as a dispatched graph calls it:
    ``x`` itself (its backward is an all-reduce of the gradient)."""
    if _lookup(key)[0] is not None:
        CALLS["tp_enter"] += 1
    return x


def _tp_enter_op(x: torch.Tensor, key: str, span: str) -> torch.Tensor:
    """The ``tp_enter`` op's own implementation: a custom op returns a new
    tensor, so a copy (nothing calls the op on real tensors: a dispatched
    graph calls :func:`_tp_enter_impl` in its place)."""
    return _tp_enter_impl(x, key, span).clone()


def _op(name: str, impl, fake):
    op = torch.library.custom_op(f"repro_torch::{name}", impl,
                                 mutates_args=())
    op.register_fake(fake)
    return getattr(torch.ops.repro_torch, name).default


#: The collectives' custom ops (each a node of a traced graph).
COLLECTIVE_OPS = {
    "all_reduce": _op("all_reduce", _all_reduce_impl,
                      lambda x, key, op, span: torch.empty_like(
                          x, memory_format=torch.contiguous_format)),
    "broadcast": _op("broadcast", _broadcast_impl,
                     lambda x, key, src, span: torch.empty_like(
                         x, memory_format=torch.contiguous_format)),
    "all_gather": _op("all_gather", _all_gather_impl,
                      lambda x, key, dim, span: x.new_empty(
                          _gathered_shape(x, key, dim))),
    "reduce_scatter": _op("reduce_scatter", _reduce_scatter_impl,
                          lambda x, key, dim, span: x.new_empty(
                              _scattered_shape(x, key, dim))),
    "param_gather": _op("param_gather", _param_gather_impl,
                        lambda x, key, dim, dtype, summed, span: x.new_empty(
                            _gathered_shape(x, key, dim), dtype=dtype)),
    "sendrecv": _op("sendrecv", _sendrecv_impl,
                    lambda x, key, dst, src, span: torch.empty_like(
                        x, memory_format=torch.contiguous_format)),
    "tp_enter": _op("tp_enter", _tp_enter_op,
                    lambda x, key, span: torch.empty_like(
                        x, memory_format=torch.contiguous_format)),
}


#: Each op -> the implementation a dispatched graph calls in its place.
IMPLS = {COLLECTIVE_OPS["all_reduce"]: _all_reduce_impl,
         COLLECTIVE_OPS["broadcast"]: _broadcast_impl,
         COLLECTIVE_OPS["all_gather"]: _all_gather_impl,
         COLLECTIVE_OPS["reduce_scatter"]: _reduce_scatter_impl,
         COLLECTIVE_OPS["param_gather"]: _param_gather_impl,
         COLLECTIVE_OPS["sendrecv"]: _sendrecv_impl,
         COLLECTIVE_OPS["tp_enter"]: _tp_enter_impl}


# --------------------------------------------------------------------------
# Gradients: the ops' registered backward (a trace) and the autograd
# Functions of an eager call, one rule each
# --------------------------------------------------------------------------
def _reduce_grad(grad: torch.Tensor, key: str, op: str) -> torch.Tensor:
    if op == "max":
        raise RuntimeError("all_reduce op 'max' has no gradient: reduce a "
                           "detached tensor")
    return grad / size_of(key) if op == "mean" else grad


def _gather_grad(grad: torch.Tensor, key: str, dim: int) -> torch.Tensor:
    """This rank's block of the gathered output's gradient."""
    size = grad.shape[dim] // size_of(key)
    return grad.narrow(dim, index_of(key) * size, size).contiguous()


def _enter_grad(grad: torch.Tensor, key: str, span: str) -> torch.Tensor:
    return all_reduce(grad, key, span=span)


#: The span of a :func:`param_gather`'s backward reduce-scatter.
PARAM_GRAD_SPAN = "comm.fsdp_reduce_scatter"


def _param_grad(grad: torch.Tensor, key: str, dim: int,
                dtype: torch.dtype, summed: bool) -> torch.Tensor:
    """A gathered parameter's gradient, back on the stored block: cast to
    the block's ``dtype`` first, then reduce-scattered over the group
    (``summed``: the ranks' gradients are partial sums of one loss), or
    else this rank's block of it (every rank computed the same whole
    gradient)."""
    grad = grad.to(dtype)
    if summed:
        return reduce_scatter(grad, key, dim, span=PARAM_GRAD_SPAN)
    return _gather_grad(grad, key, dim)


def _save_param_args(ctx, inputs, output) -> None:
    ctx.args = inputs[1:]
    ctx.in_dtype = inputs[0].dtype


def _save_args(ctx, inputs, output) -> None:
    ctx.args = inputs[1:]


torch.library.register_autograd(
    "repro_torch::all_reduce",
    lambda ctx, grad: (_reduce_grad(grad, ctx.args[0], ctx.args[1]),
                       None, None, None),
    setup_context=_save_args)
torch.library.register_autograd(
    "repro_torch::all_gather",
    lambda ctx, grad: (_gather_grad(grad, ctx.args[0], ctx.args[1]),
                       None, None, None),
    setup_context=_save_args)
torch.library.register_autograd(
    "repro_torch::reduce_scatter",
    lambda ctx, grad: (all_gather(grad, ctx.args[0], ctx.args[1],
                                  span=ctx.args[2]), None, None, None),
    setup_context=_save_args)
torch.library.register_autograd(
    "repro_torch::param_gather",
    lambda ctx, grad: (_param_grad(grad, ctx.args[0], ctx.args[1],
                                   ctx.in_dtype, ctx.args[3]),
                       None, None, None, None, None),
    setup_context=_save_param_args)
torch.library.register_autograd(
    "repro_torch::tp_enter",
    lambda ctx, grad: (_enter_grad(grad, ctx.args[0], ctx.args[1]),
                       None, None),
    setup_context=_save_args)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, key, op, span):
        ctx.key, ctx.op = key, op
        return _all_reduce_impl(x, key, op, span)

    @staticmethod
    def backward(ctx, grad):
        return _reduce_grad(grad, ctx.key, ctx.op), None, None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, key, dim, span):
        ctx.key, ctx.dim = key, dim
        return _all_gather_impl(x, key, dim, span)

    @staticmethod
    def backward(ctx, grad):
        return _gather_grad(grad, ctx.key, ctx.dim), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, key, dim, span):
        ctx.key, ctx.dim, ctx.span = key, dim, span
        return _reduce_scatter_impl(x, key, dim, span)

    @staticmethod
    def backward(ctx, grad):
        return (all_gather(grad, ctx.key, ctx.dim, span=ctx.span),
                None, None, None)


class _ParamGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, key, dim, dtype, summed, span):
        ctx.key, ctx.dim, ctx.summed, ctx.in_dtype = key, dim, summed, x.dtype
        return _param_gather_impl(x, key, dim, dtype, summed, span)

    @staticmethod
    def backward(ctx, grad):
        return (_param_grad(grad, ctx.key, ctx.dim, ctx.in_dtype,
                            ctx.summed), None, None, None, None, None)


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, key, span):
        ctx.key, ctx.span = key, span
        if _lookup(key)[0] is not None:
            CALLS["tp_enter"] += 1
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _enter_grad(grad, ctx.key, ctx.span), None, None


# --------------------------------------------------------------------------
# Entry points: the op while a graph is traced (fake tensors), else the
# implementation (through its autograd Function when a gradient flows)
# --------------------------------------------------------------------------
def _traced(x: torch.Tensor) -> bool:
    return isinstance(x, FakeTensor)


def _grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def all_reduce(x: torch.Tensor, key: str, op: str = "sum",
               span: str = "comm.all_reduce") -> torch.Tensor:
    """The sum (``op="mean"``: the mean; ``"max"``: the largest, without
    a gradient) of ``x`` over the group, on every rank."""
    if op not in _REDUCE_OPS:
        raise ValueError(f"all_reduce op {op!r} (sum | mean | max)")
    if _traced(x):
        return torch.ops.repro_torch.all_reduce(x, key, op, span)
    if _grad(x):
        return _AllReduce.apply(x, key, op, span)
    return _all_reduce_impl(x, key, op, span)


def tp_enter(x: torch.Tensor, key: str,
             span: str = "comm.tp_enter") -> torch.Tensor:
    """``x`` unchanged; its gradient is all-reduced over the group (the
    backward's call carries ``span``).  The identity without a group."""
    if _lookup(key)[0] is None:
        return x
    if _traced(x):
        return torch.ops.repro_torch.tp_enter(x, key, span)
    if _grad(x):
        return _Enter.apply(x, key, span)
    return x


def broadcast(x: torch.Tensor, key: str, src: int,
              span: str = "comm.broadcast") -> torch.Tensor:
    """Index ``src``'s ``x`` on every rank of the group."""
    if _traced(x):
        return torch.ops.repro_torch.broadcast(x, key, src, span)
    return _broadcast_impl(x, key, src, span)


class _Pending:
    """An issued broadcast: :meth:`wait` gives the tensor (and records its
    ``comm.*`` span, from issue to completion)."""

    def __init__(self, out, work, staged, key, span, nbytes, attrs) -> None:
        self.out, self.work, self.staged = out, work, staged
        self.key, self.span, self.nbytes, self.attrs = (key, span, nbytes,
                                                        attrs)
        self.tracer = _obs_trace.current_tracer()
        self.t0 = self.tracer.now_us() if self.tracer is not None else 0.0
        self.h0 = time.perf_counter()

    def wait(self) -> torch.Tensor:
        if self.work is not None:
            self.work.wait()
            self.work = None
            if self.staged:
                STAGED_MS["broadcast"] += (time.perf_counter()
                                           - self.h0) * 1e3
            if self.tracer is not None:
                self.tracer.add_event(
                    self.span, cat="comm", mode="comm",
                    ts=self.t0, dur=self.tracer.now_us() - self.t0,
                    axis=self.key, bytes=int(self.nbytes), **self.attrs)
        return self.out


def broadcast_async(x: torch.Tensor, key: str, src: int,
                    span: str = "comm.broadcast", **attrs: Any) -> _Pending:
    """:func:`broadcast`, issued now and completed by the handle's
    ``wait()`` (the overlapped SUMMA's panels; one broadcast a ``key`` in
    flight at once).  Staged through host as :func:`broadcast` is, in its
    first round of pieces until ``wait()``.  Not an op of a traced
    graph: a compiled program calls the sharded GEMM at run time."""
    groups, ranks, backend = _lookup(key)
    out = x.contiguous().clone()
    nbytes = out.numel() * out.element_size() * (len(ranks) - 1)
    if groups is None:
        return _Pending(out, None, False, key, span, nbytes, attrs)
    route = _route(x, backend)
    _count("broadcast", route)
    BYTES[span] += int(nbytes)
    if route == "host":
        def issue(group, slot, buf):
            return (dist.broadcast(buf, src=ranks[src], group=group,
                                   async_op=True), [buf])
        work = _staged(out.view(-1), [out.view(-1)], groups, issue,
                       tag=("async", key))
        STAGED_BYTES["broadcast"] += out.numel() * out.element_size()
    else:
        work = dist.broadcast(out, src=ranks[src], group=groups[0],
                              async_op=True)
    return _Pending(out, work, route == "host", key, span, nbytes, attrs)


def all_gather(x: torch.Tensor, key: str, dim: int = 0,
               span: str = "comm.all_gather") -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in group order; the
    gradient of this rank's ``x`` is its block of the output's."""
    dim = dim % max(x.dim(), 1)
    if _traced(x):
        return torch.ops.repro_torch.all_gather(x, key, dim, span)
    if _grad(x):
        return _AllGather.apply(x, key, dim, span)
    return _all_gather_impl(x, key, dim, span)


def reduce_scatter(x: torch.Tensor, key: str, dim: int = 0,
                   span: str = "comm.reduce_scatter") -> torch.Tensor:
    """The sum of every rank's ``x`` over the group, this rank's block of
    it along ``dim`` (blocks in group order); the gradient of ``x`` is the
    all-gather of the block's."""
    dim = dim % max(x.dim(), 1)
    if _traced(x):
        return torch.ops.repro_torch.reduce_scatter(x, key, dim, span)
    if _grad(x):
        return _ReduceScatter.apply(x, key, dim, span)
    return _reduce_scatter_impl(x, key, dim, span)


def param_gather(x: torch.Tensor, key: str, dim: int, dtype: torch.dtype,
                 summed: bool = True,
                 span: str = "comm.fsdp_gather") -> torch.Tensor:
    """A stored parameter block ``x`` cast to ``dtype`` and all-gathered
    over the group along ``dim`` (the cast first: the gather moves the
    compute dtype's bytes).  The gradient of ``x`` is the gathered
    tensor's cast back to ``x``'s dtype and reduce-scattered over the
    group (span :data:`PARAM_GRAD_SPAN`): the float32 sum of the ranks'
    partial gradients of this rank's block; with ``summed`` False (the
    ranks computed one gradient, not shares of it) this rank's block of
    it, with no collective."""
    dim = dim % max(x.dim(), 1)
    if _traced(x):
        return torch.ops.repro_torch.param_gather(x, key, dim, dtype, summed,
                                                  span)
    if _grad(x):
        return _ParamGather.apply(x, key, dim, dtype, summed, span)
    return _param_gather_impl(x, key, dim, dtype, summed, span)


def sendrecv(x: torch.Tensor, key: str, dst: int, src: int,
             span: str = "comm.sendrecv") -> torch.Tensor:
    """Send ``x`` to group index ``dst`` and return what index ``src``
    sent (-1 for no peer; zeros are returned when there is no ``src``)."""
    if _traced(x):
        return torch.ops.repro_torch.sendrecv(x, key, dst, src, span)
    return _sendrecv_impl(x, key, dst, src, span)
