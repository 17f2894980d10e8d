"""Contextvar-scoped span/event tracer (``repro.obs.trace``): the runtime
half of the SMA story.

The compiler's plan reports describe what the stack *intends* to do; this
module records what it actually *did*: engine calls and compiles, each
compile stage, the dispatcher's GEMM sites and SIMD regions, kernel
launches (with their execution mode and the route the wrapper took), and
the serving engine's ticks.  The contract:

* **Strictly off by default.**  No tracer is installed unless the program is
  inside a :func:`profile` scope; every instrumentation site reduces to one
  ``ContextVar.get()`` returning ``None`` plus a no-op context manager, so
  disabled tracing records nothing.
* **Never part of the compile-cache key.**  Tracing state lives in a
  contextvar here, NOT in :class:`repro_torch.api.options.SMAOptions`, so
  enabling a profile never fragments an engine's cache.
* **Honest about async launches.**  A CUDA kernel launch returns before the
  card has run it: a span around it measures the host's enqueue time, not
  device time.  ``profile(sync=True)`` calls ``torch.cuda.synchronize()``
  at span boundaries (where the value is a real CUDA tensor) so walls are
  device-honest; every event carries a ``synced`` flag so the export layer
  can label enqueue walls as such.

Usage::

    with repro_torch.profile(path="trace.json", sync=True) as prof:
        engine(x)                       # spans recorded
    prof.runtime_section()              # measured per-mode time + switches
    print(prof.timeline_text())         # two-lane ASCII mode timeline
    # trace.json is Chrome-trace JSON: open in Perfetto / chrome://tracing
"""
from __future__ import annotations

import contextlib
import contextvars
import time
from typing import Any, Dict, Iterator, List, Optional

__all__ = ["Span", "Tracer", "profile", "span", "current_tracer",
           "last_tracer"]


def synchronize(value: Any) -> None:
    """Wait for the card to finish the work behind ``value`` (any pytree):
    ``torch.cuda.synchronize()`` when a leaf is a CUDA tensor; CPU tensors
    are already computed.  Raises for a fake tensor (inside a trace), which
    has no value to wait for."""
    import torch
    import torch.utils._pytree as pytree
    from torch._subclasses.fake_tensor import FakeTensor
    tensors = [t for t in pytree.tree_leaves(value)
               if isinstance(t, torch.Tensor)]
    if any(isinstance(t, FakeTensor) for t in tensors):
        raise TypeError("a fake tensor has no value to wait for")
    if any(t.device.type == "cuda" for t in tensors):
        torch.cuda.synchronize()


class Span:
    """One open span.  Created by :meth:`Tracer.span`; appended to the
    tracer's event list (as a Chrome-trace-shaped dict) when the ``with``
    scope exits."""

    __slots__ = ("tracer", "name", "cat", "mode", "args", "_start")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 mode: Optional[str], args: Dict[str, Any]) -> None:
        self.tracer = tracer
        self.name = name
        self.cat = cat
        self.mode = mode
        self.args = args
        self._start = 0.0

    @property
    def sync(self) -> bool:
        return self.tracer.sync

    def annotate(self, **attrs: Any) -> None:
        """Attach attributes discovered mid-span (e.g. cache hit/miss)."""
        self.args.update(attrs)

    def block(self, value: Any) -> Any:
        """Synchronize on ``value`` at the span boundary when the tracer is
        in ``sync`` mode, so the recorded wall is device time rather than
        enqueue time.  Fake tensors (inside a trace) cannot be waited on:
        those spans keep their enqueue walls and are marked unsynced."""
        if not self.tracer.sync:
            return value
        try:
            synchronize(value)
            self.args.setdefault("synced", True)
        except Exception:
            self.args["synced"] = False
        return value


class Tracer:
    """An in-memory event buffer with a monotonic clock.

    Events are plain dicts already shaped like Chrome-trace ``"X"`` slices
    (``name``/``cat``/``ts``/``dur`` in microseconds, plus the SMA-specific
    ``mode`` used for lane assignment and the mode-timeline aggregation).
    """

    def __init__(self, path: Optional[str] = None, sync: bool = False
                 ) -> None:
        self.path = path
        self.sync = sync
        self.events: List[Dict[str, Any]] = []
        self._t0 = time.perf_counter()
        self.total_us: Optional[float] = None

    # ------------------------------------------------------------- clock
    def now_us(self) -> float:
        """Microseconds since the tracer was created."""
        return (time.perf_counter() - self._t0) * 1e6

    # ----------------------------------------------------------- writing
    def add_event(self, name: str, *, cat: str = "host", ts: float,
                  dur: float, mode: Optional[str] = None,
                  **args: Any) -> None:
        """Append one completed slice (used by aggregating instrumentation
        like the dispatcher's SIMD-region tracking, which cannot use a
        ``with`` scope)."""
        self.events.append({"name": name, "cat": cat, "ts": ts, "dur": dur,
                            "mode": mode, "args": args})

    @contextlib.contextmanager
    def span(self, name: str, *, cat: str = "host",
             mode: Optional[str] = None, **args: Any) -> Iterator[Span]:
        sp = Span(self, name, cat, mode, dict(args))
        sp._start = self.now_us()
        try:
            yield sp
        finally:
            end = self.now_us()
            if not self.sync:
                sp.args.setdefault("synced", False)
            self.events.append({"name": sp.name, "cat": sp.cat,
                                "ts": sp._start, "dur": end - sp._start,
                                "mode": sp.mode, "args": sp.args})

    def instant(self, name: str, *, cat: str = "host", **args: Any) -> None:
        """A zero-duration marker event."""
        self.events.append({"name": name, "cat": cat, "ts": self.now_us(),
                            "dur": 0.0, "mode": None, "ph": "i",
                            "args": args})

    # ----------------------------------------------------------- reading
    def chrome_trace(self) -> Dict[str, Any]:
        from repro_torch.obs.export import chrome_trace
        return chrome_trace(self.events)

    def save(self, path: Optional[str] = None) -> str:
        from repro_torch.obs.export import write_chrome_trace
        target = path or self.path
        if target is None:
            raise ValueError("no path given to Tracer.save and the tracer "
                             "was created without one")
        write_chrome_trace(self.events, target)
        return target

    def runtime_section(self) -> Dict[str, Any]:
        from repro_torch.obs.export import runtime_section
        return runtime_section(self.events, sync=self.sync,
                               total_us=self.total_us)

    def timeline_text(self, width: int = 64) -> str:
        from repro_torch.obs.export import render_mode_timeline
        return render_mode_timeline(self.runtime_section(), width=width)

    def __repr__(self) -> str:
        return (f"Tracer(events={len(self.events)}, sync={self.sync}, "
                f"path={self.path!r})")


_ACTIVE: contextvars.ContextVar[Optional[Tracer]] = contextvars.ContextVar(
    "repro_torch_obs_tracer", default=None)

#: The most recent tracer (active or already closed): lets plan reports
#: stamp their ``runtime`` section after the ``profile`` scope has exited.
_LAST: Optional[Tracer] = None


def current_tracer() -> Optional[Tracer]:
    """The tracer installed by an enclosing :func:`profile`, else ``None``.
    This is THE fast path every instrumentation site starts with."""
    return _ACTIVE.get()


def last_tracer() -> Optional[Tracer]:
    """The active tracer if any, else the most recently closed one."""
    return _ACTIVE.get() or _LAST


@contextlib.contextmanager
def profile(path: Optional[str] = None, *, sync: bool = False
            ) -> Iterator[Tracer]:
    """Record spans for everything inside the scope.

    ``path`` (optional) writes a Chrome-trace JSON on exit: load it in
    Perfetto (https://ui.perfetto.dev) or ``chrome://tracing``, where
    systolic and SIMD work render as two pseudo-thread lanes.
    ``sync=True`` synchronizes the card at span boundaries for
    device-honest walls (adds that synchronization; off by default).

    Tracing state never touches :class:`~repro_torch.api.options.
    SMAOptions`, so profiling cannot fragment any engine's compile cache.
    """
    global _LAST
    tracer = Tracer(path=path, sync=sync)
    token = _ACTIVE.set(tracer)
    _LAST = tracer
    try:
        yield tracer
    finally:
        tracer.total_us = tracer.now_us()
        _ACTIVE.reset(token)
        if path is not None:
            tracer.save(path)


#: Reusable no-op context manager for disabled-tracing call sites
#: (``contextlib.nullcontext`` is stateless, hence shareable).
_NULL = contextlib.nullcontext()


def span(name: str, *, cat: str = "host", mode: Optional[str] = None,
         **args: Any):
    """``with obs.span(...) as sp``: records iff a profile is active.

    Disabled cost is one contextvar read plus a shared ``nullcontext``;
    ``sp`` is ``None`` when disabled, so conditional annotations read
    ``if sp is not None: sp.annotate(...)``.
    """
    tracer = _ACTIVE.get()
    if tracer is None:
        return _NULL
    return tracer.span(name, cat=cat, mode=mode, **args)
