"""Stage 2 -- lower: fx graph nodes to the symbolic ``Op`` IR of
:mod:`repro_torch.core.modes`, with FLOP and byte costs read from the fake
tensors each node carries (``repro.compiler.lower``).

The mapping is the paper's taxonomy over aten ops, as the reference maps
JAX primitives:

* ``mm`` and ``addmm`` (a 2-D right operand: the ``(..., K) @ (K, N)``
  shape, :func:`sma_eligible`), ``convolution``, ``mv``/``dot`` ->
  ``MATMUL``; ``bmm``/``baddbmm`` -> ``ATTENTION_MATMUL`` (SYSTOLIC);
* reductions (``sum``, ``mean``, ``amax``, ``cumsum``, ...) ->
  ``REDUCTION``, tile-local only over the trailing axis; ``_softmax`` ->
  a ``REDUCTION`` (max and sum) and an ``ELEMENTWISE`` (exp and divide);
  ``native_layer_norm`` and its kin -> ``NORMALIZATION``;
* ``index``/``index_select``/``gather``/``scatter``/``index_put``/
  ``embedding`` -> ``GATHER_SCATTER`` and ``topk``/``sort`` -> ``TOPK``,
  never tile-local;
* ``_to_copy`` with a dtype change -> ``CAST``;
* everything else that computes -> ``ELEMENTWISE``, transcendentals
  FLOP-weighted heavier;
* layout ops (``view``, ``_unsafe_view``, ``transpose``, ``expand``,
  ``slice``, ``cat``, ``clone``, ``arange``, ...) are elided and counted
  in :class:`LowerStats`.

Every kernel-entry node (:data:`repro_torch.compiler.trace.
KERNEL_ENTRY_OPS`) becomes one ``Op`` of its mode: flash attention,
forward (with or without its ``lse``) and backward -> ``ATTENTION_MATMUL``
(its FLOPs counted over the (query, key) pairs the mask keeps, the
backward's at 2.5x the forward's); a gradient site's ``sma_gemm`` /
``rmsnorm_gemm`` -> ``MATMUL`` followed by its fused SIMD work (the norm
prologue as ``NORMALIZATION``, the bias and the epilogue as
``ELEMENTWISE``), which the planner attaches to the product's group as it
attaches a plain chain's; the contiguous and paged decode entries ->
``ATTENTION_MATMUL``, their FLOPs over each query against every key the
shapes let it reach (the cache's ``Smax``, or the table's ``max_blocks x
block_size``: an upper bound, the valid lengths are data) and their bytes
over those keys and values; the RG-LRU and mLSTM scans -> ``RECURRENCE``.

Python loops unroll while tracing, so a model's layer loop lowers layer
by layer.  A :func:`repro_torch.compiler.loop.scan` is one loop node
(``repro_torch::scan_loop``) with its own body graph, and lowers as the
reference lowers a ``scan`` (``repro.compiler.lower._lower_scan``): a trip
count L up to ``max_scan_unroll`` walks the body L times
(``unrolled_scans``), so mode switches are counted exactly; a longer loop
emits one ``scan_carry(len=L)`` ``RECURRENCE`` op, costed on the carry (L
x its elements in FLOPs, its bytes in and out), then the body once with
every cost x L (``coarsened_scans``): the steady state behind a marker
that breaks fusion across the loop boundary.

With a comm coster (:func:`repro_torch.distributed.summa.comm_coster_for`,
built from ``SMAOptions.mesh`` by the dispatch pipeline) every eligible
product and every GEMM gradient site carries the collective bytes the
SUMMA schedule moves for it (``Op.comm_bytes``), priced on the operands'
dtype before the plain chain's f32 upcast, as the dispatched site moves
them.
"""
from __future__ import annotations

import dataclasses
import math
import operator
from typing import Callable, Dict, List, Optional

import torch
import torch.fx

from repro_torch.compiler import loop
from repro_torch.core.modes import Op, OpKind

__all__ = ["CommCoster", "LoweredProgram", "LowerStats", "gemm_shape",
           "lower_graph", "operand_itemsize", "sma_eligible"]

#: ``(m, n, k, itemsize_a, itemsize_b) -> collective bytes`` for one GEMM
#: site on a mesh (:func:`repro_torch.distributed.summa.comm_coster_for`).
CommCoster = Callable[[int, int, int, int, int], float]

#: Pure layout ops: zero-cost at plan level.
LAYOUT_OPS = frozenset({
    "view", "_unsafe_view", "reshape", "_reshape_alias", "view_as",
    "transpose", "t", "permute", "movedim", "expand", "expand_as", "slice",
    "select", "narrow", "squeeze", "unsqueeze", "flatten", "unflatten",
    "cat", "stack", "split", "split_with_sizes", "unbind", "chunk",
    "clone", "contiguous", "alias", "detach", "lift_fresh_copy",
    "as_strided", "diagonal", "unfold", "flip", "roll", "repeat",
    "constant_pad_nd", "pad", "copy", "copy_", "arange", "empty",
    "empty_like", "empty_strided", "new_empty", "zeros", "zeros_like",
    "new_zeros", "ones", "ones_like", "new_ones", "full", "full_like",
    "new_full", "scalar_tensor", "fill", "fill_", "zero_",
})

REDUCE_OPS = frozenset({
    "sum", "mean", "amax", "amin", "max", "min", "argmax", "argmin", "prod",
    "logsumexp", "var", "var_mean", "std", "std_mean", "norm",
    "linalg_vector_norm", "any", "all",
})

CUMULATIVE_OPS = frozenset({"cumsum", "cumprod", "cummax", "cummin",
                            "logcumsumexp"})

SOFTMAX_OPS = frozenset({"_softmax", "_log_softmax"})

NORM_OPS = frozenset({"native_layer_norm", "native_group_norm",
                      "native_batch_norm", "_native_batch_norm_legit",
                      "_native_batch_norm_legit_no_training"})

GATHER_OPS = frozenset({
    "index", "index_select", "gather", "scatter", "scatter_add",
    "scatter_reduce", "index_put", "index_put_", "_index_put_impl_",
    "index_add", "index_copy", "embedding", "take", "masked_scatter",
    "slice_scatter", "select_scatter",
})

TOPK_OPS = frozenset({"topk", "sort", "argsort", "kthvalue", "msort"})

MATMUL_OPS = frozenset({"mm", "addmm", "mv", "addmv", "dot", "vdot"})
BATCHED_MATMUL_OPS = frozenset({"bmm", "baddbmm"})

TRANSCENDENTAL_OPS = frozenset({
    "exp", "exp2", "expm1", "log", "log2", "log10", "log1p", "sigmoid",
    "tanh", "sin", "cos", "tan", "asin", "acos", "atan", "atan2", "sinh",
    "cosh", "erf", "erfc", "erfinv", "pow", "rsqrt", "sqrt", "gelu", "silu",
    "softplus", "log_sigmoid_forward", "logit", "mish", "lgamma",
    "digamma",
})

_TRANSCENDENTAL_FLOPS = 4.0

#: Elementwise ops recognized by name (the rest count as unknown).
KNOWN_ELEMENTWISE = frozenset({
    "add", "sub", "rsub", "mul", "div", "neg", "abs", "sign", "floor",
    "ceil", "round", "trunc", "clamp", "clamp_min", "clamp_max", "minimum",
    "maximum", "where", "masked_fill", "relu", "eq", "ne", "lt", "le", "gt",
    "ge", "logical_and", "logical_or", "logical_not", "logical_xor",
    "bitwise_and", "bitwise_or", "bitwise_not", "bitwise_xor", "remainder",
    "fmod", "reciprocal", "lerp", "addcmul", "addcdiv", "tril", "triu",
    "threshold", "hardtanh", "isnan", "isinf",
})


@dataclasses.dataclass
class LowerStats:
    """Bookkeeping emitted alongside the lowered ops."""

    total_eqns: int = 0          # graph nodes that compute or move data
    layout_ops_elided: int = 0
    kernel_entries: int = 0      # flash / scan nodes
    unrolled_scans: int = 0      # loop nodes walked L times
    coarsened_scans: int = 0     # loop nodes costed once x L
    unknown_prims: Dict[str, int] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class LoweredProgram:
    """The symbolic program handed to :class:`repro_torch.core.sma.
    SMAPolicy`."""

    ops: List[Op]
    stats: LowerStats

    @property
    def total_comm_bytes(self) -> float:
        return sum(op.comm_bytes for op in self.ops)


# --------------------------------------------------------------------------
# Node helpers
# --------------------------------------------------------------------------
def op_name(node: torch.fx.Node) -> str:
    """The aten overload packet's name (``"mm"``), ``"getitem"`` for tuple
    indexing, or the target's own name."""
    if node.target is operator.getitem:
        return "getitem"
    packet = getattr(node.target, "_overloadpacket", None)
    if packet is not None:
        return packet.__name__
    return getattr(node.target, "__name__", str(node.target))


def val(node) -> object:
    """The fake value a node carries (None for non-nodes)."""
    return node.meta.get("val") if isinstance(node, torch.fx.Node) else None


def _nbytes(value) -> float:
    if isinstance(value, torch.Tensor):
        return float(value.numel() * value.element_size())
    if isinstance(value, (tuple, list)):
        return sum(_nbytes(v) for v in value)
    return 0.0


def _numel(value) -> float:
    if isinstance(value, torch.Tensor):
        return float(value.numel())
    if isinstance(value, (tuple, list)):
        return sum(_numel(v) for v in value)
    return 0.0


def _in_bytes(node: torch.fx.Node) -> float:
    return sum(_nbytes(val(n)) for n in node.all_input_nodes)


def sma_eligible(node: torch.fx.Node) -> bool:
    """True for the ``(M, K) @ (K, N)`` product the SMA GEMM takes: ``mm``,
    or ``addmm`` with a 1-D bias of N and unit ``beta``/``alpha``, with 2-D
    floating operands.  ``make_fx`` writes a ``(..., K) @ (K, N)`` product
    as ``view`` (leading dims collapsed) -> ``mm`` -> ``_unsafe_view``, so
    the ``mm`` is the site.  Batched products (``bmm``) keep their native
    lowering."""
    if node.op != "call_function":
        return False
    name = op_name(node)
    if name == "mm":
        a, b = node.args[:2]
    elif name == "addmm":
        bias, a, b = node.args[:3]
        if (node.kwargs.get("beta", 1) != 1 or node.kwargs.get("alpha", 1)
                != 1 or getattr(val(bias), "ndim", None) != 1
                or tuple(val(bias).shape) != (val(b).shape[1],)):
            return False
    else:
        return False
    va, vb = val(a), val(b)
    return (isinstance(va, torch.Tensor) and isinstance(vb, torch.Tensor)
            and va.ndim == 2 and vb.ndim == 2
            and va.dtype.is_floating_point and vb.dtype.is_floating_point)


def gemm_shape(node: torch.fx.Node):
    """(M, N, K) of an eligible ``mm``/``addmm`` node."""
    a, b = (node.args[:2] if op_name(node) == "mm" else node.args[1:3])
    m, k = val(a).shape
    return int(m), int(val(b).shape[1]), int(k)


def operand_itemsize(node) -> int:
    """The element size of a product operand as the program holds it: the
    source of the plain chain's f32 upcast (``_to_copy``, through views),
    else the operand's own."""
    seen = node
    while isinstance(seen, torch.fx.Node) and seen.op == "call_function" \
            and op_name(seen) in ("_to_copy", "view", "_unsafe_view",
                                  "reshape", "clone", "contiguous"):
        seen = seen.args[0]
    value = val(seen) if isinstance(seen, torch.fx.Node) else None
    if not isinstance(value, torch.Tensor):
        value = val(node)
    return value.element_size()


def _reduced_dims(node: torch.fx.Node, ndim: int):
    """The reduced axes of a reduction node, normalized; all axes when the
    node names none."""
    dims = node.args[1] if len(node.args) > 1 else node.kwargs.get("dim")
    if dims is None or (isinstance(dims, (list, tuple)) and not dims):
        return tuple(range(ndim))
    if isinstance(dims, int):
        dims = (dims,)
    if not all(isinstance(d, int) for d in dims):
        return tuple(range(ndim))
    return tuple(sorted(d % max(ndim, 1) for d in dims))


def attention_pairs(sq: int, skv: int, causal: bool, window) -> int:
    """(query, key) pairs a causal/windowed, end-aligned mask keeps."""
    if not causal and window is None:
        return sq * skv
    total = 0
    for i in range(sq):
        last = skv - sq + i                 # the query's own position
        first = 0 if window is None else max(0, last - window + 1)
        total += max(0, min(last, skv - 1) - first + 1)
    return total


# --------------------------------------------------------------------------
# The lowerer
# --------------------------------------------------------------------------
class _Lowerer:
    def __init__(self, max_scan_unroll: int,
                 comm_coster: Optional[CommCoster] = None) -> None:
        self.comm_coster = comm_coster
        self.ops: List[Op] = []
        self.stats = LowerStats()
        self.max_scan_unroll = max_scan_unroll
        self.path = ""          # "scan[i]/" or "scan(xL)/" inside a loop
        self.mult = 1.0         # cost multiplier inside a coarsened loop

    def emit(self, name: str, kind: OpKind, *, flops: float,
             bytes_in: float, bytes_out: float, tile_local: bool,
             comm_bytes: float = 0.0) -> None:
        m = self.mult
        self.ops.append(Op(f"{self.path}{name}#{len(self.ops) + 1}", kind,
                           flops=flops * m, bytes_in=bytes_in * m,
                           bytes_out=bytes_out * m, tile_local=tile_local,
                           comm_bytes=comm_bytes * m))

    def comm(self, m: int, n: int, k: int, a, b) -> float:
        """The collective bytes of a product site on the mesh (0 without
        one); ``a``, ``b`` its operand nodes."""
        if self.comm_coster is None:
            return 0.0
        return self.comm_coster(m, n, k, operand_itemsize(a),
                                operand_itemsize(b))

    def walk(self, graph: torch.fx.Graph, path: str, mult: float) -> None:
        saved = self.path, self.mult
        self.path, self.mult = path, mult
        try:
            for node in graph.nodes:
                self.lower(node)
        finally:
            self.path, self.mult = saved

    def _loop(self, node: torch.fx.Node) -> None:
        """A loop node: unrolled up to ``max_scan_unroll``, else the carry
        marker and the body once x L (module docstring)."""
        body = loop.body_of(node.args[0]).graph_module.graph
        length = int(val(node.args[2][0]).shape[0])
        if length <= self.max_scan_unroll:
            self.stats.unrolled_scans += 1
            for i in range(length):
                self.walk(body, f"{self.path}scan[{i}]/", self.mult)
            return
        self.stats.coarsened_scans += 1
        carry = [val(c) for c in node.args[1]]
        carry_bytes = sum(_nbytes(c) for c in carry)
        self.emit(f"scan_carry(len={length})", OpKind.RECURRENCE,
                  flops=_numel(carry) * length, bytes_in=carry_bytes,
                  bytes_out=carry_bytes, tile_local=False)
        self.walk(body, f"{self.path}scan(x{length})/", self.mult * length)

    def lower(self, node: torch.fx.Node) -> None:
        from repro_torch.compiler.trace import KERNEL_ENTRY_OPS
        if node.op != "call_function":
            return
        self.stats.total_eqns += 1
        if node.target is loop.LOOP_OP:
            self._loop(node)
            return
        name = op_name(node)
        out = val(node)
        bin_, bout = _in_bytes(node), _nbytes(out)

        if node.target in KERNEL_ENTRY_OPS:
            self.stats.kernel_entries += 1
            self._kernel_entry(node, name, bin_, bout)
            return
        if name in LAYOUT_OPS or name == "getitem" or (
                name == "_to_copy" and "dtype" not in node.kwargs):
            self.stats.layout_ops_elided += 1
            return

        if name in MATMUL_OPS or name in BATCHED_MATMUL_OPS:
            a = val(node.args[1] if name in ("addmm", "addmv", "baddbmm")
                    else node.args[0])
            k = a.shape[-1] if isinstance(a, torch.Tensor) else 0
            kind = (OpKind.ATTENTION_MATMUL if name in BATCHED_MATMUL_OPS
                    else OpKind.MATMUL)
            comm = 0.0
            if sma_eligible(node):
                gm, gn, gk = gemm_shape(node)
                ops_ = (node.args[:2] if name == "mm" else node.args[1:3])
                comm = self.comm(gm, gn, gk, *ops_)
            self.emit(name, kind, flops=2.0 * _numel(out) * k,
                      bytes_in=bin_, bytes_out=bout, tile_local=True,
                      comm_bytes=comm)
        elif name == "convolution":
            w = val(node.args[1])
            per_out = w.numel() / max(w.shape[0], 1)
            self.emit(name, OpKind.MATMUL, flops=2.0 * _numel(out) * per_out,
                      bytes_in=bin_, bytes_out=bout, tile_local=True)
        elif name in REDUCE_OPS or name in CUMULATIVE_OPS:
            operand = val(node.args[0])
            local = _reduced_dims(node, operand.ndim) == (operand.ndim - 1,)
            self.emit(name, OpKind.REDUCTION, flops=float(operand.numel()),
                      bytes_in=bin_, bytes_out=bout, tile_local=local)
        elif name in SOFTMAX_OPS:
            operand = val(node.args[0])
            n = float(operand.numel())
            local = node.args[1] % operand.ndim == operand.ndim - 1
            self.emit(f"{name}.reduce", OpKind.REDUCTION, flops=2.0 * n,
                      bytes_in=bin_, bytes_out=0.0, tile_local=local)
            self.emit(f"{name}.normalize", OpKind.ELEMENTWISE,
                      flops=(_TRANSCENDENTAL_FLOPS + 1.0) * n,
                      bytes_in=0.0, bytes_out=bout, tile_local=True)
        elif name in NORM_OPS:
            self.emit(name, OpKind.NORMALIZATION,
                      flops=4.0 * _numel(val(node.args[0])), bytes_in=bin_,
                      bytes_out=bout, tile_local=True)
        elif name in GATHER_OPS:
            self.emit(name, OpKind.GATHER_SCATTER, flops=0.0, bytes_in=bin_,
                      bytes_out=bout, tile_local=False)
        elif name in TOPK_OPS:
            n = max(_numel(val(node.args[0])), 2.0)
            self.emit(name, OpKind.TOPK, flops=n * math.log2(n),
                      bytes_in=bin_, bytes_out=bout, tile_local=False)
        elif name == "_to_copy":
            self.emit(name, OpKind.CAST, flops=0.0, bytes_in=bin_,
                      bytes_out=bout, tile_local=True)
        else:
            if name not in TRANSCENDENTAL_OPS and \
                    name not in KNOWN_ELEMENTWISE:
                self.stats.unknown_prims[name] = \
                    self.stats.unknown_prims.get(name, 0) + 1
            weight = _TRANSCENDENTAL_FLOPS \
                if name in TRANSCENDENTAL_OPS else 1.0
            self.emit(name, OpKind.ELEMENTWISE, flops=weight * _numel(out),
                      bytes_in=bin_, bytes_out=bout, tile_local=True)

    def _gemm_site(self, node: torch.fx.Node, name: str, bin_: float,
                   bout: float) -> None:
        """A GEMM gradient site: the product, then its fused SIMD work
        (the norm prologue, the bias, the epilogue), each costed as the
        plain chain's op and reading the f32 intermediate it keeps on
        chip."""
        prologue = name == "rmsnorm_gemm"
        a, w = val(node.args[0]), val(node.args[2 if prologue else 1])
        k, n = w.shape
        m = a.numel() // max(k, 1)
        self.emit(name, OpKind.MATMUL, flops=2.0 * m * n * k, bytes_in=bin_,
                  bytes_out=bout, tile_local=True,
                  comm_bytes=self.comm(m, n, k, node.args[0],
                                       node.args[2 if prologue else 1]))
        if prologue:
            self.emit(f"{name}.rmsnorm", OpKind.NORMALIZATION,
                      flops=4.0 * m * k,
                      bytes_in=float(m * k * a.element_size()),
                      bytes_out=0.0, tile_local=True)
        elif node.args[2] is not None:
            self.emit(f"{name}.bias", OpKind.ELEMENTWISE, flops=float(m * n),
                      bytes_in=4.0 * m * n, bytes_out=0.0, tile_local=True)
        epilogue = node.args[3]
        if epilogue != "none":
            weight = 1.0 if epilogue == "relu" else _TRANSCENDENTAL_FLOPS
            self.emit(f"{name}.{epilogue}", OpKind.ELEMENTWISE,
                      flops=weight * m * n, bytes_in=4.0 * m * n,
                      bytes_out=0.0, tile_local=True)

    def _kernel_entry(self, node: torch.fx.Node, name: str, bin_: float,
                      bout: float) -> None:
        if name in ("sma_gemm", "rmsnorm_gemm"):
            self._gemm_site(node, name, bin_, bout)
        elif name in ("flash_attention", "flash_attention_fwd",
                      "flash_attention_bwd"):
            q, k = val(node.args[0]), val(node.args[1])
            b, hq, sq, d = q.shape
            at = 6 if name == "flash_attention_bwd" else 3
            causal, window = node.args[at], node.args[at + 1]
            pairs = attention_pairs(sq, k.shape[2], causal, window)
            # The backward's five products (S and dP recomputed, dV, dK,
            # dQ) over the forward's two: 2.5x its FLOPs.
            mult = 10.0 if name == "flash_attention_bwd" else 4.0
            self.emit(name, OpKind.ATTENTION_MATMUL,
                      flops=mult * b * hq * pairs * d, bytes_in=bin_,
                      bytes_out=bout, tile_local=True)
        elif name in ("decode_attention", "paged_decode_attention"):
            q, kv = val(node.args[0]), val(node.args[1])
            if name == "paged_decode_attention":
                b, c, hq, d = q.shape
                keys = val(node.args[3]).shape[1] * kv.shape[2]
            else:
                (b, hq, d), c = q.shape, 1
                keys = kv.shape[2]
            kv_bytes = 2.0 * b * kv.shape[1] * keys * d * kv.element_size()
            lens = sum(_nbytes(val(a)) for a in node.args[3:])  # table, lens
            self.emit(name, OpKind.ATTENTION_MATMUL,
                      flops=4.0 * b * hq * c * keys * d,
                      bytes_in=_nbytes(q) + kv_bytes + lens,
                      bytes_out=bout, tile_local=True)
        elif name in ("rglru_scan", "rglru_scan_bwd"):
            # Forward: a product and a sum a step; backward: two products
            # and a sum (the carry, da) and the carried sum.
            per = 2.0 if name == "rglru_scan" else 4.0
            self.emit(name, OpKind.RECURRENCE,
                      flops=per * _numel(val(node.args[0])), bytes_in=bin_,
                      bytes_out=bout, tile_local=False)
        else:       # the mLSTM, with or without state, and its backward
            b, h, s, d = val(node.args[0]).shape
            chunk = min(node.args[5], s)
            # The backward recomputes the forward's products and makes two
            # more for each: 2x the forward's FLOPs.
            mult = 8.0 if name == "mlstm_chunkwise_bwd" else 4.0
            self.emit(name, OpKind.RECURRENCE,
                      flops=mult * b * h * s * d * (chunk + d),
                      bytes_in=bin_, bytes_out=bout, tile_local=False)


def lower_graph(graph: torch.fx.Graph, *, max_scan_unroll: int = 8,
                comm_coster: Optional[CommCoster] = None) -> LoweredProgram:
    """Lower a traced fx graph to the symbolic :class:`Op` program; loop
    nodes of trip count up to ``max_scan_unroll`` unroll; ``comm_coster``
    prices each GEMM site's collective bytes (module docstring)."""
    lw = _Lowerer(max_scan_unroll, comm_coster)
    lw.walk(graph, "", 1.0)
    return LoweredProgram(ops=lw.ops, stats=lw.stats)
