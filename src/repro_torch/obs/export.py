"""Trace export + the mode-timeline aggregator (``repro.obs.export``).

Two consumers of one event stream (:class:`repro_torch.obs.trace.Tracer`):

* :func:`chrome_trace` / :func:`write_chrome_trace` — Chrome trace-event
  JSON, loadable in Perfetto (https://ui.perfetto.dev) or
  ``chrome://tracing``.  Systolic and SIMD work render as two pseudo-thread
  lanes under one process, so the paper's temporal mode schedule is
  literally visible: one lane goes quiet while the other runs.  Host-side
  control (engine, compile stages, serve/train steps) gets its own lane.
* :func:`runtime_section` — the measured half of the plan report: per-mode
  wall time, runtime mode-switch count, and switch-boundary overhead,
  aggregated from the mode-tagged spans.  This sits next to the *static*
  ``summary.mode_switches`` in every plan report (the ``runtime`` section),
  giving the roadmap's ``predicted_vs_measured`` comparison its measured
  side.  :func:`render_mode_timeline` renders the same aggregation as a
  two-lane ASCII timeline for ``report.render_text``.

Aggregation semantics: spans nest (a kernel span sits inside the
dispatcher's SIMD region, both inside a serving tick), so the timeline is
resolved innermost-wins — at any instant the mode is that of the
latest-starting active span.  Mode switches count transitions in the
resulting segment sequence (consecutive same-mode segments collapse,
matching how the static planner counts group transitions); switch overhead
is the un-attributed gap wall time at boundaries where the mode changes.
A copy of the reference's logic: the same events give the same sections.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Sequence

__all__ = ["chrome_trace", "write_chrome_trace", "runtime_section",
           "render_mode_timeline", "LANES"]

#: Pseudo-thread lane ids in the exported trace.  ``comm`` carries the
#: collective launches of mesh-sharded GEMMs (SUMMA panel broadcasts), so a
#: sharded run shows a third lane where comm traffic either hides under the
#: systolic lane (overlap) or strictly alternates with it (reference path).
LANES = {"host": 0, "systolic": 1, "simd": 2, "comm": 3}


def chrome_trace(events: Sequence[Dict[str, Any]], *, pid: int = 1
                 ) -> Dict[str, Any]:
    """Render tracer events as a Chrome trace-event JSON object.

    Every slice carries the ``ph``/``ts``/``dur``/``pid``/``tid`` fields the
    trace-event format requires; ``args`` keeps the SMA-specific tags
    (backend, mode, block sizes, sync flag) inspectable in the UI.
    """
    trace_events: List[Dict[str, Any]] = [
        {"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
         "args": {"name": "repro SMA"}},
    ]
    for lane, tid in sorted(LANES.items(), key=lambda kv: kv[1]):
        trace_events.append(
            {"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
             "args": {"name": lane if lane == "host"
                      else f"{lane} mode"}})
        trace_events.append(
            {"ph": "M", "name": "thread_sort_index", "pid": pid, "tid": tid,
             "args": {"sort_index": tid}})
    for e in events:
        tid = LANES.get(e.get("mode") or "host", LANES["host"])
        ev = {
            "name": e["name"],
            "cat": e.get("cat", "host"),
            "ph": e.get("ph", "X"),
            "ts": e["ts"],
            "dur": e.get("dur", 0.0),
            "pid": pid,
            "tid": tid,
            "args": dict(e.get("args", {})),
        }
        if ev["ph"] == "i":
            ev.pop("dur")
            ev["s"] = "t"
        trace_events.append(ev)
    return {"traceEvents": trace_events, "displayTimeUnit": "ms"}


def write_chrome_trace(events: Sequence[Dict[str, Any]], path: str) -> None:
    with open(path, "w") as f:
        json.dump(chrome_trace(events), f, indent=1)
        f.write("\n")


# --------------------------------------------------------------------------
# Mode-timeline aggregation
# --------------------------------------------------------------------------
def _mode_segments(events: Sequence[Dict[str, Any]]
                   ) -> List[Dict[str, Any]]:
    """Flatten mode-tagged (possibly nested/overlapping) spans into a
    non-overlapping segment sequence, innermost span winning."""
    spans = [(e["ts"], e["ts"] + e["dur"], e["mode"], i, e["name"])
             for i, e in enumerate(events)
             if e.get("mode") in ("systolic", "simd", "comm")
             and e.get("dur", 0.0) > 0.0]
    if not spans:
        return []
    bounds = sorted({t for s, e, *_ in spans for t in (s, e)})
    segments: List[Dict[str, Any]] = []
    for a, b in zip(bounds, bounds[1:]):
        active = [sp for sp in spans if sp[0] <= a and sp[1] >= b]
        if not active:
            continue
        start, _, mode, _, name = max(active, key=lambda sp: (sp[0], sp[3]))
        prev = segments[-1] if segments else None
        if prev is not None and prev["mode"] == mode \
                and abs(prev["ts"] + prev["dur"] - a) < 1e-6:
            prev["dur"] = b - prev["ts"]
        else:
            segments.append({"mode": mode, "ts": a, "dur": b - a,
                             "name": name})
    return segments


def runtime_section(events: Sequence[Dict[str, Any]], *, sync: bool = False,
                    total_us: Optional[float] = None,
                    max_segments: int = 200) -> Dict[str, Any]:
    """Measured per-mode accounting for one profiled window.

    The returned dict is the plan report's ``runtime`` section — the
    runtime counterpart of the static ``mode_switches``/``mode_flop_
    histogram`` numbers.  ``sync=False`` means walls are async-dispatch
    enqueue times (labeled so); profile with ``sync=True`` for
    device-honest durations (the card drained at span boundaries).
    """
    segments = _mode_segments(events)
    per_mode = {"systolic": 0.0, "simd": 0.0, "comm": 0.0}
    switches = 0
    switch_overhead = 0.0
    prev = None
    for seg in segments:
        per_mode[seg["mode"]] += seg["dur"]
        if prev is not None and seg["mode"] != prev["mode"]:
            switches += 1
            switch_overhead += max(
                0.0, seg["ts"] - (prev["ts"] + prev["dur"]))
        prev = seg
    if total_us is None:
        total_us = (max(s["ts"] + s["dur"] for s in segments)
                    - min(s["ts"] for s in segments)) if segments else 0.0
    kernel_spans = sum(1 for e in events if e.get("cat") == "kernel")
    compile_us = sum(e["dur"] for e in events
                     if e.get("cat") == "engine"
                     and e["name"] == "engine.compile")
    return {
        "enabled": True,
        "sync": bool(sync),
        "wall_basis": "device (torch.cuda.synchronize at span boundaries)"
        if sync else "async dispatch (enqueue walls)",
        "total_us": total_us,
        "per_mode_us": per_mode,
        "mode_switches": switches,
        "switch_overhead_us": switch_overhead,
        "kernel_spans": kernel_spans,
        "compile_us": compile_us,
        "segments": segments[:max_segments],
        "segments_truncated": max(0, len(segments) - max_segments),
    }


def render_mode_timeline(section: Dict[str, Any], *, width: int = 64
                         ) -> str:
    """Two-lane ASCII rendering of a ``runtime`` section — systolic above,
    SIMD below, one column per time slice of the profiled window."""
    total = section.get("total_us") or 0.0
    segments = section.get("segments") or []
    lanes = {"systolic": [" "] * width, "simd": [" "] * width,
             "comm": [" "] * width}
    if total > 0:
        t0 = min((s["ts"] for s in segments), default=0.0)
        for seg in segments:
            lo = int((seg["ts"] - t0) / total * width)
            hi = int((seg["ts"] + seg["dur"] - t0) / total * width)
            for col in range(max(lo, 0), min(max(hi, lo + 1), width)):
                lanes[seg["mode"]][col] = "#"
    per_mode = section.get("per_mode_us", {})
    basis = section.get("wall_basis", "")
    lines = [f"runtime mode timeline ({total / 1e3:.2f} ms window; "
             f"{basis})"]
    modes = ("systolic", "simd", "comm") if per_mode.get("comm") \
        else ("systolic", "simd")
    for mode in modes:
        us = per_mode.get(mode, 0.0)
        share = us / total if total else 0.0
        lines.append(f"  {mode:<8} |{''.join(lanes[mode])}| "
                     f"{us / 1e3:8.2f} ms ({share:5.1%})")
    lines.append(f"  mode switches (runtime): "
                 f"{section.get('mode_switches', 0)} "
                 f"(boundary overhead "
                 f"{section.get('switch_overhead_us', 0.0) / 1e3:.2f} ms)")
    return "\n".join(lines)
