"""Stage 3.5 -- rewrite: realize the planned fusion in the traced graph
(``repro.compiler.rewrite``).

The pass walks the fx graph and turns every SMA-eligible product
(:func:`repro_torch.compiler.lower.sma_eligible`: ``mm``, or ``addmm`` with
a 1-D bias) into one GEMM site, a :class:`FusedGemm` that the dispatcher
runs as one kernel entry call.  The reference's patterns, all anchored on
the product:

* **epilogue chains** -- ``mm -> add(1-D bias)`` and/or an activation of
  the result: ``relu``, ``gelu`` (``aten.gelu`` with ``approximate=
  "tanh"``), ``silu`` (``aten.silu``, or ``x * sigmoid(x)``), ``tanh``:
  ``sma_gemm(a, w, bias=..., epilogue=...)``;
* **prologue chains** -- ``rmsnorm(x; scale) -> mm [-> activation]``, the
  ``pow 2 -> mean(-1) -> add eps -> rsqrt -> mul x -> mul scale`` chain:
  ``rmsnorm_gemm(x, scale, w, epilogue=..., eps=...)``;
* every other eligible product is a **bare** site: ``sma_gemm(a, w)``;
* a **gradient call site** (``repro_torch::sma_gemm`` /
  ``repro_torch::rmsnorm_gemm``, :data:`repro_torch.compiler.trace.
  GEMM_SITE_OPS`) is already one kernel call with its bias, epilogue or
  norm prologue in its arguments: it becomes a site as it stands (fused
  when it carries any of them, with or without ``fuse``).

A product ``make_fx`` wrote for a ``(..., K)`` operand reads ``view ->
mm -> _unsafe_view``; the views are looked through.  **Dtype round trips**
are folded (the reference's "optional dtype round-trip casts"): where both
operands are f32 upcasts of bf16/f16 tensors of one dtype and the chain
ends in the downcast to that dtype, the site runs on the bf16/f16 tensors
and the kernel's output dtype is the downcast.  That is the plain chain an
``ops.sma_gemm`` call traces to (``kernels/ref.py``), so a model's direct
calls come back as the same calls on the same operands.  Without the round
trip the site runs on the product's own operands, in their dtype.

Conservative fallbacks, each counted by reason in :class:`RewriteStats`
(the site is then bare, or native):

* ``multi_consumer`` -- the product's value has several consumers, so no
  epilogue is fused (the value is needed bare);
* ``graph_output`` -- the product's value is an output of the graph;
* ``no_fusable_consumer`` -- nothing fusable follows the product;
* ``unsupported_dtype`` -- operands outside {f16, bf16, f32}: the product
  stays a native ``mm`` (the kernels take no other dtype).

A norm chain fuses only where every intermediate, the normalized matrix
included, feeds the chain alone, and, for a bf16/f16 x, only where the
chain ends in the downcast to x's dtype (``rmsnorm_gemm`` returns x's
dtype): a product followed by an f32 bias add before its downcast keeps
the bias in its epilogue instead.

A loop node (:func:`repro_torch.compiler.loop.scan`) is rewritten
recursively, as the reference rewrites a ``scan`` body: its body graph is
rewritten once (:attr:`RewriteResult.bodies`, by body id), and each loop
node of trip count L adds the body's sites to the stats with their avoided
bytes x L (``mult`` in each site record).  No chain fuses across the loop
boundary: the body is its own graph, and a product whose value leaves the
body is a ``graph_output`` fallback.  With ``fuse=False`` (``SMAOptions(
fuse_runtime=False)``) only bare sites are made: the A/B baseline, where
each epilogue runs as its own kernels on the product's f32 output.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple, Union

import torch
import torch.fx

from repro_torch.compiler import loop
from repro_torch.compiler.lower import gemm_shape, op_name, sma_eligible, val
from repro_torch.compiler.trace import GEMM_SITE_OPS

__all__ = ["FUSABLE_DTYPES", "FusedGemm", "RewriteResult", "RewriteStats",
           "rewrite_program"]

Node = torch.fx.Node

#: dtypes the GEMM kernels take.
FUSABLE_DTYPES = frozenset({torch.float16, torch.bfloat16, torch.float32})
_LOW = (torch.float16, torch.bfloat16)
_VIEWS = ("view", "_unsafe_view", "reshape")


@dataclasses.dataclass
class FusedGemm:
    """One GEMM site standing in for a chain of graph nodes.

    ``kind`` ``"epilogue"`` or ``"bare"``: ``inputs = (a, b, bias|None)``
    runs ``sma_gemm(a, b, bias=..., epilogue=...)``; ``"prologue"``:
    ``inputs = (x, scale, w)`` runs ``rmsnorm_gemm(x, scale, w,
    epilogue=..., eps=...)``.  ``out`` is the node whose value the site
    produces, ``shape`` its shape where the kernel's output needs a view to
    it (else None).
    """

    kind: str
    inputs: Tuple[Optional[Node], ...]
    out: Node
    chain: Tuple[Node, ...]
    epilogue: str = "none"
    eps: float = 1e-6
    shape: Optional[Tuple[int, ...]] = None
    site: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def fused(self) -> bool:
        return self.kind != "bare"

    @property
    def entry(self) -> str:
        return "rmsnorm_gemm" if self.kind == "prologue" else "sma_gemm"


@dataclasses.dataclass
class RewriteStats:
    """Realized-fusion accounting."""

    realized_fused_sites: int = 0
    realized_epilogue_sites: int = 0
    realized_prologue_sites: int = 0
    realized_hbm_bytes_avoided: float = 0.0
    eqns_elided: int = 0
    fallback_reasons: Dict[str, int] = dataclasses.field(default_factory=dict)
    sites: List[Dict[str, Any]] = dataclasses.field(default_factory=list)

    def fallback(self, reason: str) -> None:
        self.fallback_reasons[reason] = \
            self.fallback_reasons.get(reason, 0) + 1

    def asdict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


RewriteItem = Union[Node, FusedGemm]


@dataclasses.dataclass
class RewriteResult:
    """The graph's node stream with every GEMM site's chain collapsed, and
    the rewritten body of every loop node, by body id."""

    items: List[RewriteItem]
    stats: RewriteStats
    bodies: Dict[int, "RewriteResult"] = dataclasses.field(
        default_factory=dict)

    @property
    def sites(self) -> List[FusedGemm]:
        return [it for it in self.items if isinstance(it, FusedGemm)]


# --------------------------------------------------------------------------
# Matching helpers
# --------------------------------------------------------------------------
def _is(node: Any, *names: str) -> bool:
    return (isinstance(node, Node) and node.op == "call_function"
            and op_name(node) in names)


def _sole_user(node: Node) -> Optional[Node]:
    """The only user of ``node``, or None if shared or a graph output."""
    users = list(node.users)
    if len(users) != 1 or users[0].op == "output":
        return None
    return users[0]


def _nbytes(node: Node) -> float:
    v = val(node)
    return float(v.numel() * v.element_size())


def _cast_to(node: Any) -> Optional[torch.dtype]:
    """The dtype a plain ``_to_copy(x, dtype=...)`` casts to, else None."""
    if not _is(node, "_to_copy") or set(node.kwargs) != {"dtype"}:
        return None
    return node.kwargs["dtype"]


def _upcast_src(node: Any) -> Optional[Node]:
    """x for ``_to_copy(x, dtype=f32)`` with x in bf16/f16, else None."""
    if _cast_to(node) is torch.float32 and val(node.args[0]).dtype in _LOW:
        return node.args[0]
    return None


def _downcast(node: Any) -> Optional[torch.dtype]:
    """D for ``_to_copy(y_f32, dtype=D)`` with D in bf16/f16, else None."""
    to = _cast_to(node)
    if to in _LOW and val(node.args[0]).dtype is torch.float32:
        return to
    return None


def _collapse_src(node: Any, k: int) -> Optional[Node]:
    """x for a view of x (..., K) as (M, K), else None."""
    if not _is(node, *_VIEWS):
        return None
    src = val(node.args[0])
    return node.args[0] if (src.ndim >= 2 and src.shape[-1] == k
                            and tuple(val(node).shape)
                            == (src.numel() // max(k, 1), k)) else None


def _match_activation(f: Node) -> Optional[Tuple[str, List[Node]]]:
    """A named activation of ``f``: (epilogue, its nodes in order)."""
    if any(u.op == "output" for u in f.users):
        return None
    users = list(f.users)
    if len(users) == 1:
        u = users[0]
        if _is(u, "relu", "tanh", "silu") and len(u.args) == 1:
            return op_name(u), [u]
        if (_is(u, "gelu") and len(u.args) == 1
                and u.kwargs.get("approximate") == "tanh"):
            return "gelu", [u]
        return None
    if len(users) == 2:                 # x * sigmoid(x)
        sig = [u for u in users if _is(u, "sigmoid")]
        mul = [u for u in users if _is(u, "mul")]
        if (len(sig) == 1 and len(mul) == 1 and _sole_user(sig[0]) is mul[0]
                and set(mul[0].args) == {f, sig[0]}):
            return "silu", [sig[0], mul[0]]
    return None


def _match_bias(y: Node, n: int) -> Optional[Tuple[Node, Node]]:
    """``add(y, bias)`` with a 1-D floating bias of N: (bias, the add)."""
    u = _sole_user(y)
    if not _is(u, "add") or len(u.args) != 2 or u.kwargs:
        return None
    others = [a for a in u.args if a is not y]
    if len(others) != 1 or not isinstance(others[0], Node):
        return None
    bias = val(others[0])
    if (bias.ndim != 1 or tuple(bias.shape) != (n,)
            or not bias.dtype.is_floating_point):
        return None
    return others[0], u


def _strip_upcast(node: Node) -> Node:
    return _upcast_src(node) or node


def _match_prologue(anchor: Node) -> Optional[Tuple[Node, Node, Node, float,
                                                    List[Node]]]:
    """The rmsnorm chain feeding an ``mm``'s left operand:
    (x, scale, w, eps, the chain's nodes), or None.

    The chain, with the casts present for a bf16/f16 x (absent for f32)::

        x32 = _to_copy(x, f32); sq = pow(x32, 2); ms = mean(sq, [-1], True)
        r = rsqrt(ms + eps); normed = x32 * r * scale
        lhs = view(_to_copy(_to_copy(normed, x.dtype), f32), (M, K))
    """
    if not _is(anchor, "mm"):
        return None
    lhs, w_node = anchor.args[:2]
    k = val(lhs).shape[1]
    chain: List[Node] = []
    node = lhs
    src = _collapse_src(node, k)
    if src is not None:
        chain.append(node)
        node = src
    rounded_to = None
    up = _upcast_src(node)
    if up is not None:
        rounded_to = _downcast(up)
        if rounded_to is None:
            return None
        chain += [node, up]
        node = up.args[0]
    if not _is(node, "mul") or len(node.args) != 2:
        return None
    scale = next((a for a in node.args if isinstance(a, Node)
                  and val(a).ndim == 1 and val(a).shape[0] == k), None)
    xr = next((a for a in node.args if a is not scale), None)
    if scale is None or not _is(xr, "mul") or len(xr.args) != 2:
        return None
    chain += [node, xr]
    r = next((a for a in xr.args if isinstance(a, Node)
              and val(a).shape[-1:] == (1,)), None)
    x32 = next((a for a in xr.args if a is not r), None)
    if not _is(r, "rsqrt"):
        return None
    ve = r.args[0]
    if not _is(ve, "add") or not isinstance(ve.args[1], (int, float)):
        return None
    eps, ms = float(ve.args[1]), ve.args[0]
    ndim = val(ms).ndim
    if (not _is(ms, "mean") or len(ms.args) < 3 or ms.args[2] is not True
            or list(ms.args[1]) not in ([-1], [ndim - 1])):
        return None
    sq = ms.args[0]
    if _is(sq, "pow") and sq.args[1] == 2:
        x32b = sq.args[0]
    elif _is(sq, "mul") and sq.args[0] is sq.args[1]:
        x32b = sq.args[0]
    else:
        return None
    chain += [r, ve, ms, sq]
    x = _strip_upcast(x32)
    if not isinstance(x32, Node) or _strip_upcast(x32b) is not x:
        return None
    xdt = val(x).dtype
    w = _upcast_src(w_node)
    if xdt in _LOW:
        if rounded_to is not xdt or w is None or val(w).dtype is not xdt:
            return None
    elif xdt is not torch.float32 or rounded_to is not None \
            or val(w_node).dtype is not torch.float32:
        return None
    else:
        w = w_node
    inside = set(chain) | {anchor}
    if any(u not in inside for n in chain for u in n.users):
        return None
    return x, scale, w, eps, chain


# --------------------------------------------------------------------------
# The rewriter
# --------------------------------------------------------------------------
def _match_epilogue(anchor: Node, n: int, fuse: bool, *, with_bias: bool):
    """The chain after a product: its collapsing view, the bias add (when
    ``with_bias`` and the product has none of its own), an activation.
    Returns (chain, the intermediates it elides, its last node, bias,
    epilogue, the dtype a downcast after it casts to)."""
    chain: List[Node] = [anchor]
    saved: List[Node] = []              # intermediates that never exist
    head = anchor
    u = _sole_user(head)
    if _is(u, *_VIEWS) and val(u).shape[-1] == n:
        chain.append(u)
        head = u
    bias = anchor.args[0] if op_name(anchor) == "addmm" else None
    if fuse and with_bias and bias is None:
        matched = _match_bias(head, n)
        if matched is not None:
            bias, add = matched
            chain.append(add)
            saved.append(head)
            head = add
    epilogue = "none"
    act = _match_activation(head) if fuse else None
    if act is not None:
        epilogue = act[0]
        chain += act[1]
        saved.append(head)
        head = act[1][-1]
    return chain, saved, head, bias, epilogue, _downcast(_sole_user(head))


def _match_site(anchor: Node, fuse: bool, stats: RewriteStats
                ) -> Optional[FusedGemm]:
    is_addmm = op_name(anchor) == "addmm"
    a_node, b_node = anchor.args[1:3] if is_addmm else anchor.args[:2]
    if (val(a_node).dtype not in FUSABLE_DTYPES
            or val(b_node).dtype not in FUSABLE_DTYPES):
        stats.fallback("unsupported_dtype")
        return None
    m, n, k = gemm_shape(anchor)

    prologue = _match_prologue(anchor) if fuse else None
    chain, saved, head, bias, epilogue, down = _match_epilogue(
        anchor, n, fuse, with_bias=prologue is None)
    if prologue is not None and val(prologue[0]).dtype in _LOW \
            and down is not val(prologue[0]).dtype:
        # rmsnorm_gemm returns x's dtype, and the chain does not: no
        # prologue, and the product's own bias may fuse after all.
        prologue = None
        chain, saved, head, bias, epilogue, down = _match_epilogue(
            anchor, n, fuse, with_bias=True)
    fused = prologue is not None or bias is not None or epilogue != "none"
    if fuse and not fused:
        y = chain[-1]
        if len(y.users) > 1:
            stats.fallback("multi_consumer")
        elif any(u.op == "output" for u in y.users):
            stats.fallback("graph_output")
        else:
            stats.fallback("no_fusable_consumer")

    if prologue is not None:
        x, scale, w, eps, pro_chain = prologue
        inputs = (x, scale, w)
        folded = val(x).dtype in _LOW
        saved.append(anchor.args[0])    # the normalized matrix
        chain = pro_chain + chain
    else:
        a_src = _collapse_src(a_node, k) or a_node
        a16, b16 = _upcast_src(a_src), _upcast_src(b_node)
        folded = (down is not None and a16 is not None and b16 is not None
                  and val(a16).dtype is down and val(b16).dtype is down)
        inputs = (a16, b16, bias) if folded else (a_src, b_node, bias)
    if folded:
        head = _sole_user(head)
        chain.append(head)

    kernel_shape = tuple(val(inputs[0]).shape[:-1]) + (n,)
    out_shape = tuple(val(head).shape)
    kind = ("prologue" if prologue is not None
            else "epilogue" if fused else "bare")
    avoided = sum(2.0 * _nbytes(v) for v in saved) if fused else 0.0
    site = {"kind": kind, "epilogue": epilogue, "bias": bias is not None,
            "m": m, "k": k, "n": n,
            "dtype": str(val(inputs[0]).dtype).replace("torch.", ""),
            "folded_casts": folded,
            "eqns_elided": len(chain) - 1 if fused else 0,
            "hbm_bytes_avoided": avoided}
    fg = FusedGemm(kind=kind, inputs=inputs, out=head, chain=tuple(chain),
                   epilogue=epilogue,
                   eps=prologue[3] if prologue is not None else 1e-6,
                   shape=None if out_shape == kernel_shape else out_shape,
                   site=site)
    _count(stats, fg)
    return fg


def _count(stats: RewriteStats, fg: FusedGemm) -> None:
    """Realized-fusion accounting of one site."""
    if not fg.fused:
        return
    stats.realized_fused_sites += 1
    if fg.kind == "prologue":
        stats.realized_prologue_sites += 1
    else:
        stats.realized_epilogue_sites += 1
    stats.realized_hbm_bytes_avoided += fg.site["hbm_bytes_avoided"]
    stats.eqns_elided += len(fg.chain) - 1
    stats.sites.append(fg.site)


def _gradient_site(node: Node, stats: RewriteStats) -> FusedGemm:
    """A gradient call site as one GEMM site.  What it keeps on chip is
    what the plain chain's fusion saves: the f32 product before its bias
    and before its epilogue, and a prologue's normalized matrix."""
    prologue = op_name(node) == "rmsnorm_gemm"
    inputs = tuple(node.args[:3])
    epilogue = node.args[3]
    a = val(inputs[0])
    k, n = val(inputs[2] if prologue else inputs[1]).shape
    m = a.numel() // max(k, 1)
    bias = not prologue and inputs[2] is not None
    kind = ("prologue" if prologue
            else "epilogue" if bias or epilogue != "none" else "bare")
    avoided = 2.0 * 4 * m * n * (int(bias) + int(epilogue != "none"))
    if prologue:
        avoided += 2.0 * m * k * a.element_size()
    site = {"kind": kind, "epilogue": epilogue, "bias": bias, "m": m,
            "k": k, "n": n, "dtype": str(a.dtype).replace("torch.", ""),
            "folded_casts": False, "eqns_elided": 0,
            "hbm_bytes_avoided": avoided if kind != "bare" else 0.0}
    fg = FusedGemm(kind=kind, inputs=inputs, out=node, chain=(node,),
                   epilogue=epilogue,
                   eps=node.args[4] if prologue else 1e-6, site=site)
    _count(stats, fg)
    return fg


def _add_body(stats: RewriteStats, body: RewriteStats,
              length: int) -> None:
    """One loop node's share of its body's sites: their avoided bytes x
    the trip count."""
    stats.realized_fused_sites += body.realized_fused_sites
    stats.realized_epilogue_sites += body.realized_epilogue_sites
    stats.realized_prologue_sites += body.realized_prologue_sites
    stats.realized_hbm_bytes_avoided += \
        body.realized_hbm_bytes_avoided * length
    stats.eqns_elided += body.eqns_elided
    for reason, n in body.fallback_reasons.items():
        stats.fallback_reasons[reason] = \
            stats.fallback_reasons.get(reason, 0) + n
    stats.sites.extend(
        dict(site, hbm_bytes_avoided=site["hbm_bytes_avoided"] * length,
             mult=site.get("mult", 1) * length)
        for site in body.sites)


def rewrite_program(graph: torch.fx.Graph, *, fuse: bool = True
                    ) -> RewriteResult:
    """Collapse every GEMM site's chain in ``graph`` (left unchanged) into a
    :class:`FusedGemm`; ``fuse=False`` makes bare sites only.  Loop bodies
    are rewritten recursively (module docstring)."""
    stats = RewriteStats()
    bodies: Dict[int, RewriteResult] = {}
    nodes: Sequence[Node] = list(graph.nodes)
    order = {node: i for i, node in enumerate(nodes)}
    consumed: Set[Node] = set()
    at: Dict[Node, FusedGemm] = {}
    for node in nodes:
        if node.op == "call_function" and node.target is loop.LOOP_OP:
            body_id = node.args[0]
            if body_id not in bodies:
                bodies[body_id] = rewrite_program(
                    loop.body_of(body_id).graph_module.graph, fuse=fuse)
            for inner_id, inner in bodies[body_id].bodies.items():
                bodies.setdefault(inner_id, inner)
            _add_body(stats, bodies[body_id].stats,
                      val(node.args[2][0]).shape[0])
            continue
        if node.op == "call_function" and node.target in GEMM_SITE_OPS:
            at[node] = _gradient_site(node, stats)
            consumed.add(node)
            continue
        if node in consumed or not sma_eligible(node):
            continue
        site = _match_site(node, fuse, stats)
        if site is None:
            continue
        if any(c in consumed for c in site.chain):
            raise AssertionError(f"GEMM sites overlap at {node}")
        consumed.update(site.chain)
        # Emit at the chain's last node: every input is live there.
        at[max(site.chain, key=order.__getitem__)] = site
    items: List[RewriteItem] = []
    for node in nodes:
        if node in at:
            items.append(at[node])
        elif node not in consumed:
            items.append(node)
    return RewriteResult(items=items, stats=stats, bodies=bodies)
