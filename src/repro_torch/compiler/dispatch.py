"""Stage 4 -- dispatch: the rewritten program as a ``torch.fx.GraphModule``
whose GEMM sites and kernel-entry nodes call the port's kernel entries
(``repro.compiler.dispatch``).

:func:`build_module` copies the traced graph node by node, with each
:class:`~repro_torch.compiler.rewrite.FusedGemm` put in its chain's place
as one call:

* a fused epilogue site and a bare site call
  :func:`repro_torch.kernels.ops.sma_gemm` (``bias=``, ``epilogue=``,
  and ``mesh=``: the engine's ``SMAOptions.mesh``, which shards the site
  by SUMMA, or ``False``);
* a fused prologue site calls :func:`repro_torch.kernels.ops.rmsnorm_gemm`,
  device-local under a mesh too;
* a gradient call site (``repro_torch::sma_gemm`` / ``rmsnorm_gemm``)
  is a site as well, fused or bare as its arguments say;
* a kernel-entry node (``repro_torch::flash_attention``, the flash
  forward and backward of a gradient site, the decode attentions, the
  scans) calls its entry
  (:data:`repro_torch.compiler.trace.KERNEL_ENTRY_OPS`), and a collective
  node (``repro_torch::all_reduce`` and its kin) its implementation
  (:data:`repro_torch.distributed.collectives.IMPLS`);
* a loop node (``repro_torch::scan_loop``) becomes a call of a
  :class:`ScanLoop` submodule, which runs the loop body's own dispatching
  module (built once per body, from the body's rewrite) L times; the
  kernel entries inside it decide their route and count their launches on
  every step, as any other site does;
* every other node runs its aten op natively.

Nodes the rewrite left without a user (the folded upcasts, the collapsing
views, a gradient the step never reads, a remat group's recomputed last
product) are dropped; in-place writes (a serving step's pool
``index_put_``, a train step's optimizer ``mul_`` / ``add_`` / ``copy_``
on its parameters and moments) are kept: their schemas mutate.
``GraphModule.recompile`` turns the graph into Python, so a call runs
generated code, not an interpreter loop over nodes.  The entries
are looked up on ``ops`` at call time.  On the card no eligible product
reaches ``aten.mm``: each is a kernel launch (or the wrapper raises).

While a :func:`repro_torch.profile` is active, and only then, a call runs
the same graph through :class:`TracedRun`, a ``torch.fx.Interpreter``
that records the reference dispatcher's spans: ``dispatch.sma_gemm`` /
``dispatch.fused_gemm`` around each GEMM site and one
``dispatch.simd_region`` (mode ``simd``) per run of other nodes between
them, and each loop node under one ``dispatch.loop`` span (its body's
name and trip count; its steps run the body's generated code, so inside
it only the kernel entries' ``kernel.{op}`` spans are recorded).  Without
a profile the generated code runs, at no cost a node.

:func:`compile_with_options` is the pipeline ``trace -> lower -> plan ->
rewrite -> dispatch`` behind :func:`repro_torch.api.sma_jit`, each of the
first four stages under a ``compile.{stage}`` span.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import time
from typing import Any, Callable, Dict, List, Optional

import torch
import torch.fx
import torch.utils._pytree as pytree

from repro_torch.api.options import SMAOptions, resolve_options
from repro_torch.backends.base import OpSite
from repro_torch.backends.registry import record_sites, select_backend
from repro_torch.compiler import loop
from repro_torch.compiler.fuse import ModelPlan, plan_program
from repro_torch.compiler.lower import (MATMUL_OPS, BATCHED_MATMUL_OPS,
                                        lower_graph, op_name, sma_eligible,
                                        val)
from repro_torch.compiler.report import (backends_section, comm_section,
                                         fusion_section, plan_report)
from repro_torch.compiler.rewrite import (FUSABLE_DTYPES, FusedGemm,
                                          RewriteResult, rewrite_program)
from repro_torch.compiler.trace import (GEMM_SITE_OPS, KERNEL_ENTRY_OPS,
                                        TracedModel, trace_model)
from repro_torch.core.sma import SMAPolicy
from repro_torch.distributed import collectives
from repro_torch.kernels import ops
from repro_torch.obs import trace as _obs_trace
from repro_torch.resilience import guard as _res_guard

__all__ = ["CompiledModel", "ScanLoop", "TracedRun", "build_module",
           "collect_collectives", "collect_comm_sites",
           "compile_with_options",
           "count_dispatch_sites"]


def sma_gemm_site(a, b, bias, *, epilogue, shape, mesh=False):
    """One ``sma_gemm`` site; ``shape`` views the output where the chain's
    value had another shape (the collapsed leading dims); ``mesh`` is the
    engine's (``False`` without one: the local path even inside an
    ambient ``options(mesh=...)``)."""
    out = ops.sma_gemm(a, b, bias=bias, epilogue=epilogue, mesh=mesh)
    return out if shape is None else out.view(shape)


def rmsnorm_gemm_site(x, scale, w, *, epilogue, eps, shape):
    out = ops.rmsnorm_gemm(x, scale, w, epilogue=epilogue, eps=eps)
    return out if shape is None else out.view(shape)


def _dispatchable(node: torch.fx.Node) -> bool:
    return sma_eligible(node) and all(
        val(a).dtype in FUSABLE_DTYPES
        for a in node.all_input_nodes)


def count_dispatch_sites(graph: torch.fx.Graph) -> Dict[str, Any]:
    """Census of the traced graph's products: ``systolic_dispatch_sites``
    (eligible products and gradient call sites, taken by
    ``sma_gemm``/``rmsnorm_gemm``) and
    ``native_dot_sites`` (batched or otherwise native), and the
    ``kernel_entry_sites`` (flash, scans).  Loop nodes are counted in
    ``loop_nodes``, and each loop body once in ``loop_bodies`` (by its
    name): its node count, its own census, the loop nodes that run it and
    their trip counts."""
    counts: Dict[str, Any] = {"systolic_dispatch_sites": 0,
                              "native_dot_sites": 0,
                              "kernel_entry_sites": 0, "loop_nodes": 0,
                              "loop_bodies": {}}
    for node in graph.nodes:
        if node.op != "call_function":
            continue
        if node.target is loop.LOOP_OP:
            counts["loop_nodes"] += 1
            _count_body(counts["loop_bodies"], node)
        elif node.target in GEMM_SITE_OPS:
            counts["systolic_dispatch_sites"] += 1
        elif node.target in KERNEL_ENTRY_OPS:
            counts["kernel_entry_sites"] += 1
        elif _dispatchable(node):
            counts["systolic_dispatch_sites"] += 1
        elif op_name(node) in MATMUL_OPS | BATCHED_MATMUL_OPS:
            counts["native_dot_sites"] += 1
    return counts


def _count_body(bodies: Dict[str, Any], node: torch.fx.Node) -> None:
    """One loop node's entry in ``count_dispatch_sites``' ``loop_bodies``."""
    body_id = node.args[0]
    body = loop.body_of(body_id)
    name = body.name
    if name in bodies and bodies[name]["body_id"] != body_id:
        name = f"{name}#{body_id}"
    entry = bodies.get(name)
    if entry is None:
        inner = count_dispatch_sites(body.graph_module.graph)
        entry = bodies[name] = {"body_id": body_id,
                                "nodes": body.num_nodes, "loops": 0,
                                "trip_counts": [], **inner}
    entry["loops"] += 1
    length = int(val(node.args[2][0]).shape[0])
    if length not in entry["trip_counts"]:
        entry["trip_counts"].append(length)


def collect_backend_sites(items: List[Any]) -> List[Dict[str, Any]]:
    """The static route of every site among ``items`` (rewrite items: GEMM
    sites and kernel-entry nodes), from the fake values alone."""
    with record_sites() as sites:
        for item in items:
            if isinstance(item, FusedGemm):
                select_backend(OpSite.from_args(
                    item.entry, tuple(val(n) for n in item.inputs)))
            elif item.op == "call_function" and \
                    item.target in KERNEL_ENTRY_OPS:
                name = op_name(item)
                extras = {}
                if name == "paged_decode_attention":   # its routing inputs
                    extras = {"c": val(item.args[0]).shape[1],
                              "window": item.args[6]}
                select_backend(OpSite.from_args(
                    name, tuple(val(a) for a in item.args
                                if isinstance(a, torch.fx.Node)),
                    **extras))
    return sites


class ScanLoop(torch.nn.Module):
    """A loop node at run time: ``module``, the body's dispatching module,
    over the leading axis of the step inputs, from the last index down
    for a backward's loop node (``reverse``), returning the stacked input
    carries too where the node saves them for its backward
    (:func:`repro_torch.compiler.loop.run_body`)."""

    def __init__(self, body: loop.LoopBody,
                 module: torch.fx.GraphModule) -> None:
        super().__init__()
        self.body = body
        self.module = module

    def forward(self, carry, xs, consts, reverse=False, save_carries=False):
        return loop.run_body(self.body, self.module, list(carry), list(xs),
                             list(consts), reverse, save_carries)


def _module_sites(module: torch.nn.Module) -> List[Any]:
    """Every GEMM site and kernel-entry node of a dispatching module, a
    loop body's once per loop node."""
    out: List[Any] = []
    for n in module.graph.nodes:
        if "site" in n.meta:
            out.append(n.meta["site"])
        elif n.op == "call_module":
            sub = module.get_submodule(n.target)
            if isinstance(sub, ScanLoop):
                out += _module_sites(sub.module)
    return out


def collect_comm_sites(rewritten: RewriteResult) -> List[Dict[str, Any]]:
    """``(m, n, k, itemsizes)`` of every GEMM site a mesh shards: the
    epilogue and bare sites (a prologue site runs device-local), each loop
    body's once, unmultiplied (``repro.compiler.dispatch.
    collect_comm_sites``)."""
    sites: List[Dict[str, Any]] = []

    def walk(rw: RewriteResult) -> None:
        for item in rw.items:
            if isinstance(item, FusedGemm) and item.kind != "prologue":
                a, b = val(item.inputs[0]), val(item.inputs[1])
                m = 1
                for d in a.shape[:-1]:
                    m *= int(d)
                sites.append({"m": m, "n": int(b.shape[1]),
                              "k": int(b.shape[0]),
                              "itemsize_a": a.element_size(),
                              "itemsize_b": b.element_size()})
        for body in rw.bodies.values():
            walk(body)

    walk(rewritten)
    return sites


def collect_collectives(module: torch.fx.GraphModule) -> Dict[str, Any]:
    """The collective nodes of a dispatching module that move bytes (a
    group of one rank moves none; ``tp_enter``'s forward is the identity),
    by span name: ``{"calls", "bytes", "bytes_total"}`` (FSDP's parameter
    gathers and their gradients' reduce-scatters among them), each call's
    bytes those its span carries (:func:`repro_torch.distributed.collectives.
    call_bytes`).  Loop bodies hold none."""
    impls = {fn: op.__name__.split("::")[-1].split(".")[0]
             for op, fn in collectives.IMPLS.items()}
    calls: Dict[str, int] = {}
    nbytes: Dict[str, int] = {}
    for n in module.graph.nodes:
        if n.op != "call_function" or n.target not in impls:
            continue
        op, key = impls[n.target], n.args[1]
        if op == "tp_enter" or collectives._lookup(key)[0] is None:
            continue
        x = val(n.args[0])
        peer = op != "sendrecv" or n.args[2] >= 0
        itemsize = (n.args[3].itemsize if op == "param_gather"
                    else x.element_size())
        span = n.args[-1]
        calls[span] = calls.get(span, 0) + 1
        nbytes[span] = nbytes.get(span, 0) + collectives.call_bytes(
            op, x.shape, itemsize, collectives.size_of(key), peer)
    return {"calls": calls, "bytes": nbytes,
            "bytes_total": sum(nbytes.values())}


def _build(root: torch.fx.GraphModule, name: str,
           rewritten: RewriteResult, mesh: Any = None
           ) -> torch.fx.GraphModule:
    """The dispatching module of one graph (``root`` holds its
    attributes); a loop node's body is built by the same function.  With a
    ``mesh``, each epilogue and bare site passes it to ``sma_gemm`` (held
    as the module's ``_mesh`` attribute)."""
    graph = torch.fx.Graph()
    env: Dict[torch.fx.Node, torch.fx.Node] = {}
    loops: Dict[str, ScanLoop] = {}
    mesh_arg: Any = False
    if mesh is not None:
        mesh_arg = graph.get_attr("_mesh")

    def arg(n):
        return None if n is None else env[n]

    for item in rewritten.items:
        if isinstance(item, torch.fx.Node) and \
                item.target is loop.LOOP_OP:
            body_id = item.args[0]
            body = loop.body_of(body_id)
            target = f"loop{body_id}"
            if target not in loops:
                loops[target] = ScanLoop(body, _build(
                    body.graph_module, f"{name}_{body.name}",
                    rewritten.bodies[body_id], mesh))
            new = graph.call_module(
                target, torch.fx.node.map_arg(item.args[1:], env.get))
            new.meta["val"] = val(item)
            new.meta["dispatch_span"] = (
                "dispatch.loop",
                {"body": body.name,
                 "len": int(val(item.args[2][0]).shape[0])})
            env[item] = new
            continue
        if isinstance(item, FusedGemm):
            if item.kind == "prologue":
                new = graph.call_function(
                    rmsnorm_gemm_site, tuple(arg(n) for n in item.inputs),
                    {"epilogue": item.epilogue, "eps": item.eps,
                     "shape": item.shape})
            else:
                new = graph.call_function(
                    sma_gemm_site, tuple(arg(n) for n in item.inputs),
                    {"epilogue": item.epilogue, "shape": item.shape,
                     "mesh": mesh_arg})
            new.meta["val"] = val(item.out)
            new.meta["site"] = item
            new.meta["dispatch_span"] = (
                ("dispatch.fused_gemm",
                 {"kind": item.kind, "epilogue": item.epilogue})
                if item.fused else
                ("dispatch.sma_gemm",
                 {"lhs": list(val(item.inputs[0]).shape),
                  "rhs": list(val(item.inputs[1]).shape)}))
            env[item.out] = new
            continue
        new = graph.node_copy(item, lambda n: env[n])
        if item.op == "call_function" and item.target in KERNEL_ENTRY_OPS:
            new.target = KERNEL_ENTRY_OPS[item.target]
            new.meta["site"] = item
        elif item.op == "call_function" and item.target in collectives.IMPLS:
            new.target = collectives.IMPLS[item.target]
        env[item] = new
    attrs: Dict[str, Any] = {
        n.target: functools.reduce(getattr, n.target.split("."), root)
        for n in graph.nodes if n.op == "get_attr" and n.target != "_mesh"}
    attrs.update(loops)
    if mesh is not None:
        attrs["_mesh"] = mesh
    module = torch.fx.GraphModule(attrs, graph, class_name=f"SMA_{name}")
    module.graph.eliminate_dead_code()
    module.recompile()
    return module


def build_module(traced: TracedModel, rewritten: RewriteResult,
                 mesh: Any = None) -> torch.fx.GraphModule:
    """The dispatching ``GraphModule`` (see the module docstring)."""
    return _build(traced.graph_module, traced.name, rewritten, mesh)


class TracedRun(torch.fx.Interpreter):
    """One run of a dispatching module that records its dispatch spans
    (reference ``repro.compiler.dispatch._Interpreter``): each GEMM site
    under ``dispatch.sma_gemm`` (a bare site, with its operand shapes) or
    ``dispatch.fused_gemm`` (with its kind and epilogue), and each run of
    other nodes between them as one ``dispatch.simd_region`` event (mode
    ``simd``, its node count).  Walls are host time: the tracer's ``sync``
    does not wait inside a region."""

    def __init__(self, module: torch.fx.GraphModule,
                 tracer: "_obs_trace.Tracer") -> None:
        super().__init__(module)
        self.tracer = tracer
        self._region_start: Optional[float] = None
        self._region_nodes = 0

    def _flush(self) -> None:
        if self._region_start is not None:
            end = self.tracer.now_us()
            if end > self._region_start:
                self.tracer.add_event(
                    "dispatch.simd_region", cat="dispatch",
                    ts=self._region_start, dur=end - self._region_start,
                    mode="simd", nodes=self._region_nodes)
        self._region_start, self._region_nodes = None, 0

    def run_node(self, n: torch.fx.Node) -> Any:
        site = n.meta.get("dispatch_span")     # set by build_module
        if site is not None:
            self._flush()
            name, args = site
            with self.tracer.span(name, cat="dispatch", **args):
                return super().run_node(n)
        if n.op == "output":
            self._flush()
        elif n.op != "placeholder":
            if self._region_start is None:
                self._region_start = self.tracer.now_us()
            self._region_nodes += 1
        return super().run_node(n)


@dataclasses.dataclass
class CompiledModel:
    """Plan + executable for ONE signature (an :class:`repro_torch.api.
    Engine` caches one per signature).  Calling it with arguments of the
    compiled structure runs the dispatching module under
    ``torch.no_grad()``: a traced backward is explicit aten and kernel
    calls, so it needs no autograd at run time.  In-place writes of the
    function to its inputs happen on the caller's tensors, and an input it
    returns is returned as that tensor."""

    traced: TracedModel
    plan: ModelPlan
    report_data: Dict[str, Any]
    module: torch.fx.GraphModule
    rewritten: RewriteResult
    options: SMAOptions
    #: Installed by the owning engine: restamps the report's ``engine``
    #: section on every read.
    report_refresh: Optional[Callable[[Dict[str, Any]], None]] = \
        dataclasses.field(default=None, repr=False, compare=False)

    @property
    def report(self) -> Dict[str, Any]:
        if self.report_refresh is not None:
            self.report_refresh(self.report_data)
        return self.report_data

    @property
    def name(self) -> str:
        return self.traced.name

    @property
    def summary(self):
        return self.plan.summary

    @property
    def fused_sites(self) -> List[FusedGemm]:
        """Every realized fusion site (bare sites excluded)."""
        return [s for s in self.rewritten.sites if s.fused]

    def __call__(self, *args, **kwargs):
        flat, in_tree = pytree.tree_flatten((args, kwargs))
        if in_tree != self.traced.in_tree:
            raise TypeError(
                f"compiled model '{self.name}' called with argument "
                f"structure {in_tree}; compiled for {self.traced.in_tree}")
        if torch.is_grad_enabled() and any(
                isinstance(t, torch.Tensor) and t.requires_grad
                for t in flat):
            raise RuntimeError(
                f"compiled '{self.name}' was called with grad enabled on "
                f"inputs that require grad, but a compiled program holds "
                f"no autograd graph to differentiate: take the gradient "
                f"inside the compiled function (torch.autograd.grad of "
                f"its loss, as repro_torch.launch.train.direct_step does) "
                f"and call it under torch.no_grad() or on inputs that do "
                f"not require grad")
        tracer = _obs_trace.current_tracer()
        with torch.no_grad():
            if tracer is None:
                outs = self.module(*flat)
            else:
                outs = TracedRun(self.module, tracer).run(*flat)
        return pytree.tree_unflatten(list(outs), self.traced.out_tree)


def compile_with_options(fn: Callable, *args, name: Optional[str] = None,
                         options: Optional[SMAOptions] = None,
                         **kwargs) -> CompiledModel:
    """Trace -> lower -> plan -> rewrite -> dispatch, configured by one
    :class:`SMAOptions` (``options`` overlaid on the ambient context).  The
    report's ``compile`` section times each stage on the host clock.  With
    ``SMAOptions.mesh``, its rules are the ambient ones while the model
    traces, the plan's GEMM ops carry their SUMMA comm bytes, the
    epilogue and bare sites run sharded, and the report's ``comm``
    section prices them (:func:`collect_comm_sites`)."""
    o = resolve_options(options)
    times: Dict[str, float] = {}
    # A mesh: its rule table is the ambient one while the model traces,
    # and its SUMMA cost model prices the plan's GEMM sites.
    comm_coster, rules_ctx = None, contextlib.nullcontext()
    if o.mesh is not None:
        from repro_torch.distributed.sharding import MeshRules, use_rules
        from repro_torch.distributed.summa import comm_coster_for
        comm_coster = comm_coster_for(o.mesh)
        rules_ctx = use_rules(o.mesh_rules or MeshRules(),
                              tuple(o.mesh.axis_names))
    t0 = time.perf_counter()
    with _obs_trace.span("compile.trace", cat="compile"), rules_ctx:
        traced = trace_model(fn, *args, name=name, **kwargs)
    t1 = time.perf_counter()
    with _obs_trace.span("compile.lower", cat="compile"):
        program = lower_graph(traced.graph,
                              max_scan_unroll=o.max_scan_unroll,
                              comm_coster=comm_coster)
    t2 = time.perf_counter()
    policy = o.policy if o.policy is not None else SMAPolicy(
        fuse_epilogues=bool(o.fuse_epilogues),
        max_epilogue_ops=o.max_epilogue_ops)
    with _obs_trace.span("compile.plan", cat="compile"):
        plan = plan_program(program, name=traced.name, policy=policy)
    t3 = time.perf_counter()
    with _obs_trace.span("compile.rewrite", cat="compile"):
        rewritten = rewrite_program(traced.graph, fuse=bool(o.fuse_runtime))
    t4 = time.perf_counter()
    module = build_module(traced, rewritten, o.mesh)
    t5 = time.perf_counter()
    times.update(trace_s=t1 - t0, lower_s=t2 - t1, plan_s=t3 - t2,
                 rewrite_s=t4 - t3, dispatch_s=t5 - t4)

    report = plan_report(plan)
    report["options"] = o.asdict()
    report["dispatch"] = {"backend": "static",
                          **count_dispatch_sites(traced.graph)}
    report["fusion"] = fusion_section(
        plan, rewritten if o.fuse_runtime else None)
    report["backends"] = backends_section(collect_backend_sites(
        _module_sites(module)))
    report["comm"] = comm_section(o.mesh, collect_comm_sites(rewritten),
                                  plan_comm_bytes=program.total_comm_bytes,
                                  collectives=collect_collectives(module))
    report["resilience"] = _res_guard.resilience_section()
    report["compile"] = times
    return CompiledModel(traced=traced, plan=plan, report_data=report,
                         module=module, rewritten=rewritten, options=o)
