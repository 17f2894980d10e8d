"""``repro_torch.obs``: runtime tracing, metrics and the mode-switch
timeline (counterpart of ``repro.obs``; the logic is copied, the port
imports nothing of ``repro``).

* :mod:`repro_torch.obs.trace` -- a contextvar-scoped span tracer.
  ``repro_torch.profile(path=..., sync=...)`` turns it on for a scope; it
  is strictly off by default and never part of an engine's compile-cache
  key.
* :mod:`repro_torch.obs.metrics` -- a process-wide counters/histograms
  registry (engine cache hits/misses, compile seconds, serving ticks,
  tokens and latencies) with ``snapshot()`` / ``reset()``.
* :mod:`repro_torch.obs.export` -- Chrome-trace JSON for Perfetto /
  ``chrome://tracing`` (systolic and SIMD as two pseudo-thread lanes), the
  ``runtime`` plan-report section (measured per-mode time, runtime
  mode-switch count, switch-boundary overhead), and a plain-text timeline.

:mod:`repro_torch.obs.timing` is the shared warmup-aware timer.
"""
from repro_torch.obs.export import (LANES, chrome_trace, render_mode_timeline,
                                    runtime_section, write_chrome_trace)
from repro_torch.obs.metrics import (METRICS, MetricsRegistry, inc, observe,
                                     reset, snapshot)
from repro_torch.obs.timing import timeit, timeit_us
from repro_torch.obs.trace import (Span, Tracer, current_tracer, last_tracer,
                                   profile, span)

__all__ = [
    "profile", "span", "Span", "Tracer", "current_tracer", "last_tracer",
    "METRICS", "MetricsRegistry", "inc", "observe", "snapshot", "reset",
    "chrome_trace", "write_chrome_trace", "runtime_section",
    "render_mode_timeline", "LANES",
    "timeit", "timeit_us",
]
