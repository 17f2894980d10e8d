"""Process-wide counters/histograms registry (``repro.obs.metrics``).

The tracer (:mod:`repro_torch.obs.trace`) answers "what happened, when"
for one profiled window; this module answers "how much, overall" for the
life of the process: engine cache hits/misses, compile seconds, serving
ticks, tokens and latencies.  Counters are plain dict
increments — cheap enough to stay always-on (no enable knob), with
:func:`snapshot` / :func:`reset` semantics for tests and serving loops.

Producers across the port feed it:

* :class:`repro_torch.api.engine.Engine` — ``engine.cache_hits`` /
  ``engine.cache_misses`` / ``engine.cache_evictions`` counters and the
  ``engine.compile_s`` histogram;
* :class:`repro_torch.serving.ServeEngine` — ``serving.admitted`` /
  ``serving.ticks`` / ``serving.mode_switches`` / ``serving.tokens``, the
  ``serving.queue_wait_s`` / ``serving.ttft_s`` / ``serving.itl_s``
  histograms, and the ``serve.*`` failure-path counters.
"""
from __future__ import annotations

import collections
import threading
from typing import Any, Deque, Dict

__all__ = ["MetricsRegistry", "METRICS", "inc", "get", "observe", "snapshot",
           "reset"]

#: Bounded reservoir per histogram for percentile estimates: serving wants
#: p50/p99 latencies without unbounded memory, so each histogram keeps the
#: most recent SAMPLE_CAP observations (a sliding window, which for latency
#: monitoring is usually *more* useful than all-of-history).
SAMPLE_CAP = 2048


def _percentile(sorted_vals, q: float) -> float:
    """Nearest-rank percentile over an already-sorted sample list."""
    if not sorted_vals:
        return 0.0
    k = min(len(sorted_vals) - 1, max(0, int(q * len(sorted_vals))))
    return sorted_vals[k]


class MetricsRegistry:
    """Named counters (monotonic ints) + histograms (count/total/min/max,
    plus sliding-window p50/p99 in :meth:`snapshot`)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {}
        self._hists: Dict[str, Dict[str, float]] = {}
        self._samples: Dict[str, Deque[float]] = {}

    def inc(self, name: str, n: float = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def get(self, name: str) -> float:
        """Current value of a counter (0 if it never incremented) — the
        delta-assertion accessor the resilience tests lean on."""
        with self._lock:
            return self._counters.get(name, 0)

    def observe(self, name: str, value: float) -> None:
        value = float(value)
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                self._hists[name] = {"count": 1, "total": value,
                                     "min": value, "max": value}
                self._samples[name] = collections.deque(maxlen=SAMPLE_CAP)
            else:
                h["count"] += 1
                h["total"] += value
                h["min"] = min(h["min"], value)
                h["max"] = max(h["max"], value)
            self._samples[name].append(value)

    def snapshot(self) -> Dict[str, Any]:
        """A JSON-safe point-in-time copy: ``{"counters": {...},
        "histograms": {name: {count, total, mean, min, max, p50, p99}}}``
        (percentiles over the last :data:`SAMPLE_CAP` observations)."""
        with self._lock:
            counters = dict(self._counters)
            hists = {}
            for name, h in self._hists.items():
                vals = sorted(self._samples.get(name, ()))
                hists[name] = {**h, "mean": h["total"] / h["count"],
                               "p50": _percentile(vals, 0.50),
                               "p99": _percentile(vals, 0.99)}
        return {"counters": counters, "histograms": hists}

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._hists.clear()
            self._samples.clear()


#: The process-wide registry every producer in the stack feeds.
METRICS = MetricsRegistry()

# Module-level conveniences bound to the global registry.
inc = METRICS.inc
get = METRICS.get
observe = METRICS.observe
snapshot = METRICS.snapshot
reset = METRICS.reset
