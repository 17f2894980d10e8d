"""Failure classification, numeric guards, the event ledger and the plan
report's ``resilience`` section (counterpart of
``repro.resilience.guard``).

* :func:`is_runtime_failure` -- which exceptions a serving tick retries.
  **A deliberate divergence from the reference**, which retries any
  ``RuntimeError`` whose message holds "out of memory", "OOM" or
  "INTERNAL:", and any ``NotImplementedError``.  In the port a failed
  kernel launch raises ``RuntimeError("...: CUDA error N at launch
  (...)")`` (``repro_torch.kernels._build.check``): its text can read "out
  of memory", but a CUDA launch error is sticky, so a retry cannot succeed
  and would only evict the request as failed and hide the fault.  A
  ``NotImplementedError`` is a site with no route, which by the port's
  static routing must propagate.  Retryable here: :class:`~repro_torch.
  resilience.faults.InjectedFault`, ``torch.cuda.OutOfMemoryError`` (the
  caching allocator's, which frees and recovers) and ``MemoryError``.
  Everything else propagates.
* :func:`check_numerics_value` -- the ``SMAOptions.check_numerics`` policy
  (``"off" | "log" | "raise"``) applied to one output.  The reference's
  ``"fallback"`` recomputes on its plain path; in the port that would be a
  fallback that hides the kernel, so :class:`~repro_torch.api.SMAOptions`
  refuses it, and a non-finite value under any policy but ``"log"``
  raises.
* :func:`resilience_section` -- the ledger stamped into plan reports, with
  the reference's keys.
* :class:`RetryPolicy` -- bounded retry, backoff and the watchdog bound of
  failure-isolated serving (:class:`repro_torch.serving.ServeEngine`).

The reference's quarantine, failover ladder (``next_rung``,
``note_runtime_fallback``) and ``"fallback"`` policy are not ported: no
kernel fails over to its plain version on the card.

Counters are mirrored into :mod:`repro_torch.obs.metrics` and kept locally
for the report section (surviving ``metrics.reset()``).
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import warnings
from typing import Any, Callable, Dict, List, Optional

import torch
import torch.utils._pytree as pytree

from repro_torch.obs import metrics as _metrics
from repro_torch.resilience.faults import InjectedFault

__all__ = ["is_runtime_failure", "check_numerics_value",
           "resilience_section", "record_event", "warn_once", "RetryPolicy",
           "reset", "EVENTS", "NUMERIC_POLICIES"]

#: The ``check_numerics`` policies the port takes.
NUMERIC_POLICIES = ("off", "log", "raise")


def is_runtime_failure(exc: BaseException) -> bool:
    """True when ``exc`` is a failure a whole-tick retry may outlive (the
    module docstring says why the port's set is narrower than the
    reference's)."""
    return isinstance(exc, (InjectedFault, torch.cuda.OutOfMemoryError,
                            MemoryError))


# --------------------------------------------------------------------------
# Event ledger (feeds the report's ``resilience`` section)
# --------------------------------------------------------------------------
EVENTS: "collections.deque[Dict[str, Any]]" = collections.deque(maxlen=256)
_COUNTS: Dict[str, float] = {}
_WARNED: set = set()
_LOCK = threading.Lock()


def _count(name: str, n: float = 1) -> None:
    with _LOCK:
        _COUNTS[name] = _COUNTS.get(name, 0) + n
    _metrics.inc(f"resilience.{name}", n)


def record_event(kind: str, **fields: Any) -> None:
    EVENTS.append({"kind": kind, **fields})


def warn_once(key: str, message: str) -> None:
    """Warn the first time ``key`` is seen: a serving loop under chaos would
    otherwise flood the log."""
    with _LOCK:
        if key in _WARNED:
            return
        _WARNED.add(key)
    warnings.warn(message, RuntimeWarning, stacklevel=3)


# --------------------------------------------------------------------------
# Numeric guards
# --------------------------------------------------------------------------
def _nonfinite_leaves(value: Any) -> List[str]:
    """Paths of the floating-point tensors of ``value`` that hold a NaN or
    an Inf (a host sync per tensor)."""
    bad: List[str] = []
    for path, leaf in pytree.tree_flatten_with_path(value)[0]:
        if isinstance(leaf, torch.Tensor) and leaf.is_floating_point() \
                and not bool(torch.isfinite(leaf).all()):
            bad.append(pytree.keystr(path) or "<out>")
    return bad


def check_numerics_value(op: str, backend: str, value: Any,
                         recompute: Optional[Callable[[], Any]],
                         policy: Optional[str]) -> Any:
    """Apply the ``check_numerics`` policy to one output.

    ``recompute`` is the reference's signature; the port passes None
    (it has no plain path to recompute on), so a non-finite value raises
    ``FloatingPointError`` under ``"raise"`` and is warned about, once per
    (op, backend), under ``"log"``.
    """
    if policy in (None, "off"):
        return value
    if policy not in NUMERIC_POLICIES:
        raise ValueError(f"check_numerics={policy!r} "
                         f"(one of {NUMERIC_POLICIES})")
    bad = _nonfinite_leaves(value)
    if not bad:
        return value
    _count("numeric_events")
    record_event("numeric_guard", op=op, backend=backend, leaves=bad,
                 policy=policy)
    msg = (f"{op} produced non-finite output on backend '{backend}' "
           f"(leaves {bad})")
    if policy == "log":
        warn_once(f"numeric:{op}:{backend}", msg + " [check_numerics=log]")
        return value
    raise FloatingPointError(msg)


# --------------------------------------------------------------------------
# Serving policy + report section
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry + backoff for failure-isolated serving.

    ``max_retries`` is per request: a poisoned request is evicted (marked
    failed) once its budget is spent, while other rows keep decoding.
    ``backoff_s`` is slept after a whole tick fails.  ``deadline_s`` is the
    watchdog bound on one admit or tick (soft: a launch cannot be
    preempted, so an overrun is counted and warned, not interrupted).
    """

    max_retries: int = 1
    backoff_s: float = 0.0
    deadline_s: Optional[float] = None


def resilience_section(*, max_events: int = 20) -> Dict[str, Any]:
    """The runtime resilience ledger for plan reports, with the
    reference's keys.  ``runtime_fallbacks``, ``failover_attempts``,
    ``numeric_fallbacks`` and ``quarantine_skips`` are always 0 and
    ``quarantine`` always empty: the port has no failover ladder and no
    quarantine.  Process-scoped: one section shows every event since the
    last :func:`reset`."""
    with _LOCK:
        counts = dict(_COUNTS)
    events = list(EVENTS)
    injected: Dict[str, int] = {}
    for name, n in _metrics.snapshot()["counters"].items():
        if name.startswith("resilience.injected."):
            injected[name.rsplit(".", 1)[1]] = int(n)
    return {
        "enabled": bool(counts or events or injected),
        "runtime_fallbacks": 0,
        "failover_attempts": 0,
        "numeric_events": int(counts.get("numeric_events", 0)),
        "numeric_fallbacks": 0,
        "quarantine_skips": 0,
        "quarantine": [],
        "injected_faults": injected,
        "events": events[-max_events:],
    }


def reset() -> None:
    """Clear the event ledger, counters and warn-once state."""
    EVENTS.clear()
    with _LOCK:
        _COUNTS.clear()
        _WARNED.clear()
