"""The one warmup-aware wall-clock timing helper (``repro.obs.timing``).

Two semantics:

* ``sync_each=False`` (throughput): warm up, launch ``iters`` calls
  back-to-back, wait once at the end: the card may run one call while the
  host enqueues the next, which is the steady-state serving number.
* ``sync_each=True`` (latency): wait on every call, so no call overlaps the
  next and per-call overhead is exactly what is measured.

Waiting is :func:`repro_torch.obs.trace.synchronize` on the returned value
(``torch.cuda.synchronize()`` when it holds a CUDA tensor).
"""
from __future__ import annotations

import time
from typing import Any, Callable

from repro_torch.obs.trace import synchronize

__all__ = ["timeit", "timeit_us"]


def _block(value: Any) -> Any:
    synchronize(value)
    return value


def timeit(fn: Callable, *args: Any, iters: int = 5, warmup: int = 1,
           sync_each: bool = False, **kwargs: Any) -> float:
    """Seconds per call of ``fn(*args, **kwargs)`` over ``iters`` timed
    iterations, after ``warmup`` untimed (waited-on) calls.

    ``warmup=0`` with ``iters=1`` times a cold first call (an engine's
    compile included).
    """
    if iters < 1:
        raise ValueError("iters must be >= 1")
    for _ in range(warmup):
        _block(fn(*args, **kwargs))
    t0 = time.perf_counter()
    if sync_each:
        for _ in range(iters):
            _block(fn(*args, **kwargs))
    else:
        out = None
        for _ in range(iters):
            out = fn(*args, **kwargs)
        _block(out)
    return (time.perf_counter() - t0) / iters


def timeit_us(fn: Callable, *args: Any, iters: int = 5, warmup: int = 1,
              sync_each: bool = False, **kwargs: Any) -> float:
    """:func:`timeit`, in microseconds per call (the benchmark row unit)."""
    return timeit(fn, *args, iters=iters, warmup=warmup,
                  sync_each=sync_each, **kwargs) * 1e6
