"""Stage 5 -- report: machine-readable plan summaries
(``repro.compiler.report``).

``plan_report`` renders a :class:`repro_torch.compiler.fuse.ModelPlan` into
a plain-JSON dict (group counts, temporal mode switches, fused SIMD ops,
HBM bytes avoided, systolic FLOP share, per-kind FLOP histograms, the
largest fusion groups), with the reference's keys.  ``fusion_section``
reconciles what the planner *promised* with what the rewrite pass
*realized*.  ``backends_section`` records the static route of each
dispatched site (:func:`repro_torch.backends.registry.select_backend`).
The ``runtime`` section (the measured mode timeline of a
:func:`repro_torch.profile` window) is stamped by the engine
(:mod:`repro_torch.api.engine`) and rendered by :func:`render_text`, as
is the ``resilience`` section
(:func:`repro_torch.resilience.guard.resilience_section`, stamped at
compile and restamped on every report read).  Loop nodes show in the
``lowering`` section (``unrolled_scans``, ``coarsened_scans``) and in the
``dispatch`` section (``loop_nodes``, and per body its nodes, sites and
trip counts).  ``comm_section`` prices the collective bytes of a compiled
program's sharded GEMM sites on ``SMAOptions.mesh`` through
:func:`repro_torch.distributed.summa.summa_comm_stats`, the cost model the
SUMMA schedule is built from; its ``collectives`` part counts the
collective nodes of the dispatched program (train(mesh=)'s all-reduces,
all-gathers, FSDP parameter gathers and gradient reduce-scatters, forward
and backward) by span name, with the bytes each
call's span carries, so a run's :data:`repro_torch.distributed.
collectives.BYTES` and its ``comm.*`` spans read the same bytes a call.
The reference's ``diagnostics`` section
waits for ``analysis`` (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional

from repro_torch.compiler.fuse import ModelPlan
from repro_torch.core.modes import ExecMode


def plan_report(plan: ModelPlan, *, top_groups: int = 5) -> Dict[str, Any]:
    """JSON-safe report for one planned model."""
    summary = plan.summary
    hist = plan.mode_flop_histogram
    kind_flops: Dict[str, float] = {}
    kind_counts: Dict[str, int] = {}
    for op in plan.ops:
        kind_flops[op.kind.value] = kind_flops.get(op.kind.value, 0.0) \
            + op.flops
        kind_counts[op.kind.value] = kind_counts.get(op.kind.value, 0) + 1

    ranked = sorted(plan.groups,
                    key=lambda g: sum(op.flops for op in g.ops),
                    reverse=True)
    groups_out = []
    for g in ranked[:top_groups]:
        groups_out.append({
            "mode": g.mode.value,
            "anchor": g.anchor.name if g.anchor is not None else None,
            "ops": len(g.ops),
            "fused_simd_ops": g.fused_simd_ops,
            "flops": sum(op.flops for op in g.ops),
            "bytes_kept_in_vmem": g.bytes_kept_in_vmem,
        })

    return {
        "model": plan.name,
        "num_ops": len(plan.ops),
        "groups": summary.groups,
        "systolic_groups": len(plan.systolic_groups),
        "simd_groups": len(plan.simd_groups),
        "mode_switches": summary.mode_switches,
        "fused_simd_ops": summary.fused_simd_ops,
        "hbm_bytes_avoided": summary.hbm_bytes_avoided,
        "systolic_flop_share": summary.systolic_flop_share,
        "total_flops": plan.total_flops,
        "total_bytes": sum(op.bytes_in + op.bytes_out for op in plan.ops),
        "mode_flop_histogram": {m.value: hist[m] for m in ExecMode},
        "opkind_flops": kind_flops,
        "opkind_counts": kind_counts,
        "largest_groups": groups_out,
        "lowering": dataclasses.asdict(plan.stats),
    }


def fusion_section(plan: ModelPlan, rewritten: Optional[Any] = None,
                   *, max_sites: int = 20) -> Dict[str, Any]:
    """Planned-vs-realized fusion accounting for one compiled model.

    ``planned_*`` comes from the symbolic :class:`SMAPolicy` plan;
    ``realized_*`` from the rewrite pass that the dispatcher actually
    executes.  ``rewritten=None`` (``fuse_runtime=False``) reports zero
    realized sites, the honest number for bare dispatch.
    """
    summary = plan.summary
    planned_sites = sum(1 for g in plan.systolic_groups
                        if g.fused_simd_ops > 0)
    out: Dict[str, Any] = {
        "planned_fused_sites": planned_sites,
        "planned_fused_simd_ops": summary.fused_simd_ops,
        "planned_hbm_bytes_avoided": summary.hbm_bytes_avoided,
        "realized_fused_sites": 0,
        "realized_epilogue_sites": 0,
        "realized_prologue_sites": 0,
        "realized_hbm_bytes_avoided": 0.0,
        "eqns_elided": 0,
        "fallback_reasons": {},
        "sites": [],
    }
    if rewritten is not None:
        st = rewritten.stats
        out.update({
            "realized_fused_sites": st.realized_fused_sites,
            "realized_epilogue_sites": st.realized_epilogue_sites,
            "realized_prologue_sites": st.realized_prologue_sites,
            "realized_hbm_bytes_avoided": st.realized_hbm_bytes_avoided,
            "eqns_elided": st.eqns_elided,
            "fallback_reasons": dict(st.fallback_reasons),
            "sites": list(st.sites[:max_sites]),
        })
    return out


def backends_section(records: List[Dict[str, Any]], *,
                     max_sites: int = 40) -> Dict[str, Any]:
    """Chosen backend, execution mode and kernel route per dispatched site
    (the :func:`repro_torch.backends.registry.record_sites` records), with
    the sites that run a plain version counted by reason."""
    from repro_torch.backends.registry import available_backends
    from repro_torch.backends.base import BACKENDS

    chosen: Dict[str, int] = {}
    mode_hist: Dict[str, int] = {}
    routes: Dict[str, int] = {}
    reasons: Dict[str, int] = {}
    for r in records:
        chosen[r["backend"]] = chosen.get(r["backend"], 0) + 1
        mode_hist[r["mode"]] = mode_hist.get(r["mode"], 0) + 1
        if r["route"] is not None:
            key = f"{r['op']}.{r['route']}"
            routes[key] = routes.get(key, 0) + 1
        if r["fallback_reason"]:
            cat = r["fallback_reason"].split(":", 1)[0]
            reasons[cat] = reasons.get(cat, 0) + 1
    return {
        "requested": "static",
        "available": list(available_backends()),
        "backend_modes": {name: b.mode.value for name, b in BACKENDS.items()},
        "num_sites": len(records),
        "fallback_sites": sum(reasons.values()),
        "chosen": chosen,
        "mode_histogram": mode_hist,
        "routes": routes,
        "fallback_reasons": reasons,
        "sites": list(records[:max_sites]),
    }


def comm_section(mesh, sites, *, plan_comm_bytes: float = 0.0,
                 overlap: bool = True, max_sites: int = 20,
                 collectives: Optional[Dict[str, Any]] = None
                 ) -> Dict[str, Any]:
    """Predicted collective traffic for one compiled model on ``mesh``
    (``repro.compiler.report.comm_section``).

    ``sites`` are :func:`repro_torch.compiler.dispatch.collect_comm_sites`'
    dicts, each priced through :func:`repro_torch.distributed.summa.
    summa_comm_stats`, so the bytes reconcile with what the sharded GEMM
    moves.  ``plan_comm_bytes`` is the lowered plan's total: loop bodies
    times their trip count, and every eligible product, the head's
    prologue site too (the plan does not know yet which chain the rewrite
    makes a device-local prologue), so it can differ from the per-site sum
    by those.  No mesh, or a mesh of one rank: ``enabled`` False and zero
    traffic.  ``collectives``: the program's collective nodes
    (:func:`repro_torch.compiler.dispatch.collect_collectives`), reported
    whatever the mesh."""
    out: Dict[str, Any] = {
        "enabled": False,
        "grid": [1, 1],
        "axes": {},
        "devices": 1,
        "steps_per_gemm": 0,
        "num_gemm_sites": len(sites),
        "bytes_a": 0.0,
        "bytes_b": 0.0,
        "bytes_total": 0.0,
        "hidden_bytes": 0.0,
        "predicted_overlap_fraction": 0.0,
        "collectives_per_axis": {},
        "plan_comm_bytes": float(plan_comm_bytes),
        "sites": [],
        "collectives": collectives or {"calls": {}, "bytes": {},
                                       "bytes_total": 0},
    }
    if mesh is None:
        return out
    from repro_torch.distributed.summa import summa_comm_stats, summa_grid

    row, col, pr, pc = summa_grid(mesh)
    out["grid"] = [pr, pc]
    out["axes"] = {"row": row, "col": col}
    out["devices"] = int(getattr(mesh, "size", pr * pc))
    if pr * pc <= 1:
        return out
    out["enabled"] = True
    collectives: Dict[str, int] = {}
    site_stats = []
    for s in sites:
        st = summa_comm_stats(s["m"], s["n"], s["k"], pr=pr, pc=pc,
                              itemsize_a=s["itemsize_a"],
                              itemsize_b=s["itemsize_b"], overlap=overlap,
                              row_axis=row, col_axis=col)
        out["bytes_a"] += st["bytes_a"]
        out["bytes_b"] += st["bytes_b"]
        out["bytes_total"] += st["bytes_total"]
        out["hidden_bytes"] += st["hidden_bytes"]
        out["steps_per_gemm"] = st["steps"]
        for ax, cnt in st["collectives_per_axis"].items():
            collectives[ax] = collectives.get(ax, 0) + cnt
        site_stats.append({**s, "bytes_total": st["bytes_total"],
                           "steps": st["steps"]})
    out["collectives_per_axis"] = collectives
    out["predicted_overlap_fraction"] = \
        (out["hidden_bytes"] / out["bytes_total"]) if out["bytes_total"] \
        else 0.0
    out["sites"] = site_stats[:max_sites]
    return out


def render_text(report: Dict[str, Any]) -> str:
    """One-screen human rendering of a plan report."""
    lines = [
        f"model: {report['model']}",
        f"  ops {report['num_ops']} -> groups {report['groups']} "
        f"(systolic {report['systolic_groups']}, simd "
        f"{report['simd_groups']})",
        f"  temporal mode switches : {report['mode_switches']}",
        f"  fused SIMD epilogues   : {report['fused_simd_ops']}",
        f"  HBM bytes avoided      : "
        f"{report['hbm_bytes_avoided'] / 1e6:.2f} MB",
        f"  systolic FLOP share    : "
        f"{report['systolic_flop_share']:.1%}",
    ]
    low = report.get("lowering", {})
    if low.get("unrolled_scans") or low.get("coarsened_scans"):
        lines.append(
            f"  loops (lowered)        : {low['unrolled_scans']} unrolled, "
            f"{low['coarsened_scans']} coarsened (x trip count behind a "
            f"RECURRENCE marker)")
    disp = report.get("dispatch")
    if disp:
        lines.append(
            f"  dispatch               : "
            f"{disp['systolic_dispatch_sites']} GEMM sites -> sma_gemm/"
            f"rmsnorm_gemm, {disp['kernel_entry_sites']} kernel entries, "
            f"{disp['native_dot_sites']} native")
        for name, body in sorted(disp.get("loop_bodies", {}).items()):
            lines.append(
                f"  loop body {name}: {body['nodes']} nodes, "
                f"{body['systolic_dispatch_sites']} GEMM sites, "
                f"{body['loops']} loop nodes x trip counts "
                f"{body['trip_counts']}")
    fus = report.get("fusion")
    if fus:
        lines.append(
            f"  runtime fusion         : "
            f"{fus['realized_fused_sites']} sites realized "
            f"({fus['realized_epilogue_sites']} epilogue, "
            f"{fus['realized_prologue_sites']} prologue) / "
            f"{fus['planned_fused_sites']} planned; "
            f"{fus['realized_hbm_bytes_avoided'] / 1e6:.2f} MB "
            f"HBM avoided (realized)")
        if fus.get("fallback_reasons"):
            reasons = ", ".join(f"{k}={v}" for k, v in
                                sorted(fus["fallback_reasons"].items()))
            lines.append(f"  fusion fallbacks       : {reasons}")
    bks = report.get("backends")
    if bks:
        per_backend = ", ".join(f"{k}={v}" for k, v in
                                sorted(bks["chosen"].items()))
        per_route = ", ".join(f"{k}={v}" for k, v in
                              sorted(bks["routes"].items()))
        lines.append(
            f"  backends               : {per_backend or 'no op sites'}"
            f"{'; routes ' + per_route if per_route else ''}")
    comm = report.get("comm")
    if comm and comm.get("enabled"):
        per_axis = ", ".join(f"{k}x{v}" for k, v in
                             sorted(comm["collectives_per_axis"].items()))
        lines.append(
            f"  comm (mesh {comm['grid'][0]}x{comm['grid'][1]})    : "
            f"{comm['bytes_total'] / 1e6:.2f} MB over "
            f"{comm['num_gemm_sites']} GEMM sites "
            f"({comm['predicted_overlap_fraction']:.0%} predicted hidden; "
            f"collectives {per_axis or 'none'})")
    comp = report.get("compile")
    if comp:
        lines.append(
            "  compile                : " + ", ".join(
                f"{k.removesuffix('_s')} {v:.3f}s" for k, v in comp.items()))
    eng = report.get("engine")
    if eng:
        lines.append(
            f"  engine cache           : {eng['cache_hits']} hits, "
            f"compile {eng['compile_time_s']:.3f}s "
            f"(amortized {eng['amortized_compile_s'] * 1e3:.2f} ms/call)")
    rt = report.get("runtime")
    if rt and rt.get("enabled"):
        from repro_torch.obs.export import render_mode_timeline
        per_mode = ", ".join(
            f"{m}={us / 1e3:.2f}ms" for m, us in
            sorted(rt["per_mode_us"].items()))
        lines.append(
            f"  runtime (measured)     : {per_mode or 'no mode spans'}; "
            f"{rt['mode_switches']} mode switches, "
            f"{rt['switch_overhead_us'] / 1e3:.2f} ms switch overhead")
        lines.extend("    " + ln
                     for ln in render_mode_timeline(rt).splitlines())
    res = report.get("resilience")
    if res and res.get("enabled"):
        lines.append(
            f"  resilience             : "
            f"{res['numeric_events']} numeric events, "
            f"{len(res['events'])} events on record (no failover or "
            f"quarantine in the port)")
        if res.get("injected_faults"):
            injected = ", ".join(f"{k}={v}" for k, v in
                                 sorted(res["injected_faults"].items()))
            lines.append(f"  injected faults        : {injected}")
    return "\n".join(lines)


def write_report(report: Dict[str, Any], path: str) -> None:
    with open(path, "w") as f:
        json.dump(report, f, indent=2, sort_keys=True)
        f.write("\n")
