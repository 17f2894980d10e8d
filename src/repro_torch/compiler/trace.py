"""Stage 1 -- trace: a PyTorch function to an fx graph of aten ops
(``repro.compiler.trace``).

``trace_model(fn, *args, **kwargs)`` flattens ``(args, kwargs)`` with
``torch.utils._pytree``, makes one fake tensor per tensor leaf (shape,
stride, dtype and device of the leaf, no storage) and runs
``make_fx(..., tracing_mode="fake")`` under ``torch.enable_grad()``.
Tracing is shape-only, like ``jax.ShapeDtypeStruct`` in the reference: a
leaf may be a real tensor or a :class:`TensorSpec`, and a full-width
configuration traces without allocating device memory.  The fakes keep the
leaves' devices, so factory calls in the function (``torch.arange(...,
device=x.device)``) are recorded on the device the compiled program will
run on.

Grad mode is on while tracing, so a function that differentiates inside
itself (``torch.autograd.grad`` of a loss, as the reference's train step
holds ``jax.value_and_grad``) records its backward too: one joint graph of
forward, backward and whatever follows (the optimizer's in-place writes).
A function whose leaves do not require grad records the graph it records
under ``torch.no_grad()``.

How the kernel entries of :mod:`repro_torch.kernels.ops` meet the tracer
(:func:`kernel_entries_as_ops`, active only while tracing).  Each call is
decided as ``ops`` decides between its autograd Functions and its
wrappers: grad mode on and an input that requires grad make a **gradient
call site**; anything else traces as before:

* ``sma_gemm`` and ``rmsnorm_gemm`` trace as their plain chains
  (``kernels/ref.py``: f32 upcasts, ``mm``, bias, epilogue, the downcast;
  the norm's ``pow -> mean -> add eps -> rsqrt -> mul -> mul scale``), so
  the rewrite pass finds the fusable sites in them as it finds them in any
  other program;
* ``flash_attention``, ``decode_attention``, ``paged_decode_attention``,
  ``rglru_scan`` and ``mlstm_chunkwise`` trace as one node each, a
  ``torch.library`` custom op (``repro_torch::...``) with a fake
  implementation; the dispatcher calls the entry itself in its place, so
  what the entry decides at run time (the paged site's routing and its
  ``ops.ROUTED`` count, the kernel's launch count) happens on every call
  of the compiled program, not once while tracing;
* at a gradient call site ``sma_gemm``, ``rmsnorm_gemm`` and
  ``flash_attention`` trace as custom ops with a registered backward
  (:data:`GRADIENT_OPS`): ``repro_torch::sma_gemm`` / ``rmsnorm_gemm``
  (the whole fused call, one node) and ``repro_torch::flash_attention_fwd``
  (returning the ``lse`` it saves).  Their backward is the one of
  :mod:`repro_torch.kernels.autograd`, written in ``repro_torch::sma_gemm``
  and ``repro_torch::flash_attention_bwd`` nodes and the same elementwise
  aten ops, so each kernel launch of the direct step is one node of the
  joint graph.  The scans' nodes carry a backward too: ``rglru_scan``'s is
  one ``repro_torch::rglru_scan_bwd`` node (the reverse-scan kernel on
  the card), and ``mlstm_chunkwise`` / ``mlstm_chunkwise_state``'s one
  ``repro_torch::mlstm_chunkwise_bwd`` node (the backward kernel on the
  card, the plain version's gradient on the CPU).  A remat
  group's recomputation (``torch.utils.checkpoint``) is traced where the
  backward asks for it, its sites gradient sites of their own.  A gradient the step never reads is a node without users,
  which dispatch drops.

A :func:`repro_torch.compiler.loop.scan` records one
``repro_torch::scan_loop`` node with its own body graph (the scope holds
:func:`repro_torch.compiler.loop.tracing` open), not its unrolled steps.

The entries are swapped on the ``ops`` module for the trace only: the direct
path never goes through a custom op's dispatcher.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Callable, Iterator, List, Optional, Tuple

import torch
import torch.utils._pytree as pytree
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.fx.experimental.proxy_tensor import make_fx

from repro_torch.compiler import loop
from repro_torch.kernels import autograd as _autograd
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import norm_gemm as _norm
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rglru as _rglru
from repro_torch.kernels import sma_gemm as _gemm

__all__ = ["GEMM_SITE_OPS", "GRADIENT_OPS", "KERNEL_ENTRY_OPS",
           "TensorSpec", "TracedModel",
           "kernel_entries_as_ops", "trace_model"]


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """A shape-only argument: what a leaf looks like, with no storage."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    device: torch.device = torch.device("cuda")

    def __post_init__(self) -> None:
        device = torch.device(self.device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", 0)    # as a tensor's .device reads
        object.__setattr__(self, "shape", tuple(int(d) for d in self.shape))
        object.__setattr__(self, "device", device)

    def stride(self) -> Tuple[int, ...]:
        """Contiguous strides."""
        out, acc = [], 1
        for d in reversed(self.shape):
            out.append(acc)
            acc *= max(d, 1)
        return tuple(reversed(out))


@dataclasses.dataclass(frozen=True)
class TracedModel:
    """A function frozen into an fx graph plus its pytree contract."""

    name: str
    graph_module: torch.fx.GraphModule
    in_tree: Any     # TreeSpec of (args, kwargs)
    out_tree: Any    # TreeSpec of fn's return value
    num_nodes: int

    @property
    def graph(self) -> torch.fx.Graph:
        return self.graph_module.graph


# --------------------------------------------------------------------------
# Kernel entries as single graph nodes
# --------------------------------------------------------------------------
def _dense(*ts: torch.Tensor):
    """Contiguous outputs, as the fakes below promise the tracer (a no-op
    for the kernels, which write dense outputs)."""
    return tuple(t.contiguous() for t in ts)


def flash_entry(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                causal: bool, window: Optional[int],
                scale: Optional[float]) -> torch.Tensor:
    """``ops.flash_attention`` with the custom op's positional arguments."""
    return ops.flash_attention(q, k, v, causal=causal, window=window,
                               scale=scale).contiguous()


def decode_entry(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, cache_len: torch.Tensor,
                 scale: Optional[float]) -> torch.Tensor:
    """``ops.decode_attention`` with the custom op's positional arguments."""
    return ops.decode_attention(q, k_cache, v_cache, cache_len,
                                scale=scale).contiguous()


def paged_entry(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                block_table: torch.Tensor, q_pos: torch.Tensor,
                kv_len: torch.Tensor, window: Optional[int],
                scale: Optional[float]) -> torch.Tensor:
    """``ops.paged_decode_attention`` with the custom op's positional
    arguments (its routing and ``ops.ROUTED`` count happen here, at run
    time)."""
    return ops.paged_decode_attention(q, k_pool, v_pool, block_table, q_pos,
                                      kv_len, window=window,
                                      scale=scale).contiguous()


def rglru_entry(a: torch.Tensor, u: torch.Tensor, h0: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    return _dense(*ops.rglru_scan(a, u, h0))


def mlstm_entry(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                log_f: torch.Tensor, log_i: torch.Tensor,
                chunk: int) -> torch.Tensor:
    return ops.mlstm_chunkwise(q, k, v, log_f, log_i,
                               chunk=chunk).contiguous()


def mlstm_state_entry(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      log_f: torch.Tensor, log_i: torch.Tensor, chunk: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                 torch.Tensor]:
    """The mLSTM with its final state, flattened to (h, C, n, m)."""
    h, (c, n, m) = ops.mlstm_chunkwise(q, k, v, log_f, log_i, chunk=chunk,
                                       return_state=True)
    return _dense(h, c, n, m)


def _register(name: str, entry: Callable, fake: Callable,
              backward: Optional[Callable] = None,
              setup: Optional[Callable] = None):
    op = torch.library.custom_op(f"repro_torch::{name}", entry,
                                 mutates_args=())
    op.register_fake(fake)
    if backward is not None:
        op.register_autograd(backward, setup_context=setup)
    return getattr(torch.ops.repro_torch, name).default


def _empty(like: torch.Tensor, shape, dtype=None) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype or like.dtype, device=like.device)


def _fake_mlstm_state(q, k, v, log_f, log_i, chunk):
    b, h, _, d = q.shape
    f32 = torch.float32
    return (_empty(q, q.shape), _empty(q, (b, h, d, d), f32),
            _empty(q, (b, h, d), f32), _empty(q, (b, h), f32))


# --------------------------------------------------------------------------
# Gradient call sites: the GEMM and flash entries with their backward
# --------------------------------------------------------------------------
def gemm_entry(a: torch.Tensor, b: torch.Tensor, bias: Optional[torch.Tensor],
               epilogue: str) -> torch.Tensor:
    """One ``sma_gemm`` launch with the custom op's positional arguments."""
    return _gemm.sma_gemm(a, b, bias=bias, epilogue=epilogue).contiguous()


def norm_entry(x: torch.Tensor, scale: torch.Tensor, w: torch.Tensor,
               epilogue: str, eps: float) -> torch.Tensor:
    """One ``rmsnorm_gemm`` launch with the custom op's positional
    arguments."""
    return _norm.rmsnorm_gemm(x, scale, w, epilogue=epilogue,
                              eps=eps).contiguous()


def flash_fwd_entry(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool, window: Optional[int],
                    scale: Optional[float]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The flash forward kernel, with the ``lse`` its backward reads."""
    return _dense(*_flash.flash_attention_fwd(q, k, v, causal=causal,
                                              window=window, scale=scale))


def flash_bwd_entry(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                    causal: bool, window: Optional[int],
                    scale: Optional[float]
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The flash backward kernel: (dq, dk, dv)."""
    return _dense(*_flash.flash_attention_bwd(q, k, v, out, lse, dout,
                                              causal=causal, window=window,
                                              scale=scale))


def _gemm_node(a: torch.Tensor, b: torch.Tensor,
               bias: Optional[torch.Tensor]) -> torch.Tensor:
    """A backward product as a ``repro_torch::sma_gemm`` node."""
    return torch.ops.repro_torch.sma_gemm(a, b, bias, "none")


def _gemm_setup(ctx, inputs, output) -> None:
    a, b, bias, epilogue = inputs
    ctx.save_for_backward(a, b, bias)
    ctx.epilogue = epilogue


def _gemm_backward(ctx, dc):
    a, b, bias = ctx.saved_tensors
    return (*_autograd.sma_gemm_backward(_gemm_node, a, b, bias,
                                         ctx.epilogue, dc,
                                         ctx.needs_input_grad), None)


def _norm_setup(ctx, inputs, output) -> None:
    x, scale, w, epilogue, eps = inputs
    ctx.save_for_backward(x, scale, w)
    ctx.epilogue, ctx.eps = epilogue, eps


def _norm_backward(ctx, dy):
    x, scale, w = ctx.saved_tensors
    return (*_autograd.rmsnorm_gemm_backward(_gemm_node, x, scale, w,
                                             ctx.epilogue, ctx.eps, dy,
                                             ctx.needs_input_grad),
            None, None)


def _flash_setup(ctx, inputs, output) -> None:
    q, k, v, causal, window, scale = inputs
    ctx.save_for_backward(q, k, v, *output)
    ctx.args = dict(causal=causal, window=window, scale=scale)


def _flash_backward(ctx, dout, dlse):
    return (*_autograd.flash_attention_backward(
        torch.ops.repro_torch.flash_attention_bwd, ctx.saved_tensors, dout,
        **ctx.args), None, None, None)


def rglru_bwd_entry(a: torch.Tensor, h_seq: torch.Tensor,
                    h0: Optional[torch.Tensor], dh_seq: torch.Tensor,
                    dh_last: Optional[torch.Tensor]
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The RG-LRU backward kernel: (da, du, dh0), dh0 of shape (0,)
    without an h0."""
    da, du, dh0 = _rglru.rglru_scan_bwd(a, h_seq, dh_seq, h0=h0,
                                        dh_last=dh_last)
    return _dense(da, du, dh0 if dh0 is not None else a.new_empty((0,)))


def mlstm_bwd_entry(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    log_f: torch.Tensor, log_i: torch.Tensor, chunk: int,
                    dh: torch.Tensor, dc: Optional[torch.Tensor],
                    dn: Optional[torch.Tensor], dm: Optional[torch.Tensor]
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                               torch.Tensor, torch.Tensor]:
    """(dq, dk, dv, dlog_f, dlog_i) of the mLSTM's h (and state)."""
    return _dense(*_autograd.mlstm_chunkwise_backward(
        (q, k, v, log_f, log_i), chunk, (dh, dc, dn, dm)))


def _rglru_setup(ctx, inputs, output) -> None:
    a, u, h0 = inputs
    ctx.has_h0 = h0 is not None
    ctx.save_for_backward(a, output[0], *((h0,) if ctx.has_h0 else ()))


def _rglru_backward(ctx, dh_seq, dh_last):
    a, h_seq, *h0 = ctx.saved_tensors
    da, du, dh0 = torch.ops.repro_torch.rglru_scan_bwd(
        a, h_seq, h0[0] if h0 else None, dh_seq.contiguous(), dh_last)
    return da, du, dh0 if ctx.has_h0 else None


def _mlstm_setup(ctx, inputs, output) -> None:
    *ins, chunk = inputs
    ctx.save_for_backward(*ins)
    ctx.chunk = chunk


def _mlstm_backward(ctx, dh, *dstate):
    grads = tuple(dstate) if dstate else (None, None, None)
    return (*torch.ops.repro_torch.mlstm_chunkwise_bwd(
        *ctx.saved_tensors, ctx.chunk, dh.contiguous(), *grads), None)


def _gemm_out(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return _empty(a, tuple(a.shape[:-1]) + (w.shape[1],))


#: The gradient call sites' custom ops, and the scans' backward ops, ->
#: their entries (see the module docstring); the GEMM two are
#: :data:`GEMM_SITE_OPS`.
GRADIENT_OPS = {
    _register("sma_gemm", gemm_entry,
              lambda a, b, bias, epilogue: _gemm_out(a, b),
              _gemm_backward, _gemm_setup): gemm_entry,
    _register("rmsnorm_gemm", norm_entry,
              lambda x, scale, w, epilogue, eps: _gemm_out(x, w),
              _norm_backward, _norm_setup): norm_entry,
    _register("flash_attention_fwd", flash_fwd_entry,
              lambda q, k, v, causal, window, scale:
              (_empty(q, q.shape), _empty(q, q.shape[:3], torch.float32)),
              _flash_backward, _flash_setup): flash_fwd_entry,
    _register("flash_attention_bwd", flash_bwd_entry,
              lambda q, k, v, out, lse, dout, causal, window, scale:
              (_empty(q, q.shape), _empty(k, k.shape), _empty(v, v.shape))):
        flash_bwd_entry,
    _register("rglru_scan_bwd", rglru_bwd_entry,
              lambda a, h_seq, h0, dh_seq, dh_last:
              (_empty(a, a.shape), _empty(a, a.shape),
               _empty(a, h0.shape if h0 is not None else (0,)))):
        rglru_bwd_entry,
    _register("mlstm_chunkwise_bwd", mlstm_bwd_entry,
              lambda q, k, v, log_f, log_i, chunk, dh, dc, dn, dm:
              tuple(_empty(t, t.shape) for t in (q, k, v, log_f, log_i))):
        mlstm_bwd_entry,
}

#: The GEMM gradient sites: the rewriter makes each one GEMM site.
GEMM_SITE_OPS = frozenset({torch.ops.repro_torch.sma_gemm.default,
                           torch.ops.repro_torch.rmsnorm_gemm.default})


#: Custom op -> the kernel entry it stands for (with the op's positional
#: arguments); the dispatcher calls the entry in the op's place.  The fakes
#: give dense outputs, as the entries do.
KERNEL_ENTRY_OPS = {
    _register("flash_attention", flash_entry,
              lambda q, k, v, causal, window, scale: _empty(q, q.shape)):
        flash_entry,
    _register("decode_attention", decode_entry,
              lambda q, k_cache, v_cache, cache_len, scale:
              _empty(q, q.shape)): decode_entry,
    _register("paged_decode_attention", paged_entry,
              lambda q, k_pool, v_pool, block_table, q_pos, kv_len, window,
              scale: _empty(q, q.shape)): paged_entry,
    _register("rglru_scan", rglru_entry,
              lambda a, u, h0: (_empty(a, a.shape),
                                _empty(a, (a.shape[0], a.shape[2]))),
              _rglru_backward, _rglru_setup): rglru_entry,
    _register("mlstm_chunkwise", mlstm_entry,
              lambda q, k, v, log_f, log_i, chunk: _empty(q, q.shape),
              _mlstm_backward, _mlstm_setup): mlstm_entry,
    _register("mlstm_chunkwise_state", mlstm_state_entry,
              _fake_mlstm_state, _mlstm_backward, _mlstm_setup):
        mlstm_state_entry,
    **GRADIENT_OPS,
}


def _gradient_site(*ins: Optional[torch.Tensor]) -> bool:
    """Grad mode on and an input that requires grad (where ``ops`` takes
    its autograd Function)."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in ins)


def _trace_gemm(a, b, *, bias=None, epilogue="none", mesh=None):
    # ``mesh`` is the dispatcher's decision at run time (its GEMM sites
    # carry the engine's mesh), not the trace's.
    if _gradient_site(a, b, bias):
        return torch.ops.repro_torch.sma_gemm(a, b, bias, epilogue)
    return ref.gemm_ref(a, b, bias=bias, epilogue=epilogue)


def _trace_norm(x, scale, w, *, epilogue="none", eps=1e-6):
    if _gradient_site(x, scale, w):
        return torch.ops.repro_torch.rmsnorm_gemm(x, scale, w, epilogue, eps)
    return ref.rmsnorm_gemm_ref(x, scale, w, epilogue=epilogue, eps=eps)


def _trace_flash(q, k, v, *, causal=True, window=None, scale=None):
    if _gradient_site(q, k, v):
        return torch.ops.repro_torch.flash_attention_fwd(
            q, k, v, causal, window, scale)[0]
    return torch.ops.repro_torch.flash_attention(q, k, v, causal, window,
                                                 scale)


def _trace_decode(q, k_cache, v_cache, cache_len, *, scale=None):
    return torch.ops.repro_torch.decode_attention(q, k_cache, v_cache,
                                                  cache_len, scale)


def _trace_paged(q, k_pool, v_pool, block_table, q_pos, kv_len, *,
                 window=None, scale=None):
    return torch.ops.repro_torch.paged_decode_attention(
        q, k_pool, v_pool, block_table, q_pos, kv_len, window, scale)


def _trace_rglru(a, u, h0=None):
    return tuple(torch.ops.repro_torch.rglru_scan(a, u, h0))


def _trace_mlstm(q, k, v, log_f, log_i, *, chunk=128, return_state=False):
    if not return_state:
        return torch.ops.repro_torch.mlstm_chunkwise(q, k, v, log_f, log_i,
                                                     chunk)
    h, c, n, m = torch.ops.repro_torch.mlstm_chunkwise_state(
        q, k, v, log_f, log_i, chunk)
    return h, (c, n, m)


_TRACE_ENTRIES = {
    "sma_gemm": _trace_gemm,
    "rmsnorm_gemm": _trace_norm,
    "flash_attention": _trace_flash,
    "decode_attention": _trace_decode,
    "paged_decode_attention": _trace_paged,
    "rglru_scan": _trace_rglru,
    "mlstm_chunkwise": _trace_mlstm,
}
_LOCK = threading.Lock()


@contextlib.contextmanager
def kernel_entries_as_ops() -> Iterator[None]:
    """For the ``with`` scope, the ``ops`` entries trace as described in the
    module docstring, and a ``loop.scan`` records one node.  One trace at a
    time: the swap is process-wide."""
    with _LOCK, loop.tracing():
        saved = {name: getattr(ops, name) for name in _TRACE_ENTRIES}
        try:
            for name, fn in _TRACE_ENTRIES.items():
                setattr(ops, name, fn)
            yield
        finally:
            for name, fn in saved.items():
                setattr(ops, name, fn)


# --------------------------------------------------------------------------
# Tracing
# --------------------------------------------------------------------------
def _fake(mode: FakeTensorMode, leaf: Any) -> Any:
    """A fresh fake tensor for a tensor or TensorSpec leaf (one per leaf,
    so two leaves holding the same tensor still trace as two inputs)."""
    if leaf is None:
        return None
    if isinstance(leaf, TensorSpec):
        shape, stride = leaf.shape, leaf.stride()
    elif isinstance(leaf, torch.Tensor):
        shape, stride = tuple(leaf.shape), tuple(leaf.stride())
    else:
        raise TypeError(
            f"sma_jit argument leaf {leaf!r} is not a tensor; mark the "
            f"containing keyword argument static via "
            f"sma_jit(..., static_argnames=...)")
    with mode:
        return torch.empty_strided(shape, stride, dtype=leaf.dtype,
                                   device=leaf.device)


def trace_model(fn: Callable, *args, name: Optional[str] = None,
                **kwargs) -> TracedModel:
    """Trace ``fn(*args, **kwargs)`` to a :class:`TracedModel`.

    Leaves of ``args``/``kwargs`` are tensors, :class:`TensorSpec` or None;
    only their metadata is read.  Static configuration (a config object, a
    string) is closed over by ``fn`` (``functools.partial``) or passed as a
    static keyword of :func:`repro_torch.api.sma_jit`.
    """
    flat, in_tree = pytree.tree_flatten((args, kwargs))
    mode = FakeTensorMode()
    fakes = [_fake(mode, leaf) for leaf in flat]
    out_trees: List[Any] = []

    def flat_fn(*flat_in):
        call_args, call_kwargs = pytree.tree_unflatten(list(flat_in), in_tree)
        flat_out, out_tree = pytree.tree_flatten(fn(*call_args,
                                                    **call_kwargs))
        out_trees.append(out_tree)
        return flat_out

    with torch.enable_grad(), kernel_entries_as_ops():
        gm = make_fx(flat_fn, tracing_mode="fake")(*fakes)
    return TracedModel(
        name=name or getattr(getattr(fn, "func", fn), "__name__", None)
        or "model",
        graph_module=gm, in_tree=in_tree, out_tree=out_trees[-1],
        num_nodes=len(gm.graph.nodes))
