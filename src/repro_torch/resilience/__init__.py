"""``repro_torch.resilience``: fault injection, numeric guards and
failure-isolated serving (counterpart of ``repro.resilience``).

* :mod:`repro_torch.resilience.faults` -- seeded, scoped fault injectors
  (``with repro_torch.inject_faults("sma_gemm@cuda:runtime_error"):
  ...``; the ``REPRO_FAULTS`` environment hook).  The probes sit at the
  kernel entries (:mod:`repro_torch.kernels.ops`, backend ``cuda`` or
  ``plain``), the engine's compile (``engine.compile``) and the serving
  engine's ``serve.admit`` / ``serve.tick``.
* :mod:`repro_torch.resilience.guard` -- failure classification, the
  ``check_numerics`` policy, the event ledger and the report's
  ``resilience`` section, and :class:`RetryPolicy` for the serving
  engine's whole-tick retry and per-request eviction.

Not ported, by the port's rule that routing is static: the reference's
quarantine and failover ladder, and ``check_numerics="fallback"``.  A
kernel that fails on the card raises; it never reruns on its plain
version.

``repro_torch.resilience.reset()`` clears the ledger (test isolation).
"""
from repro_torch.resilience.faults import (FaultSpec, InjectedFault,
                                           inject_faults, parse_faults,
                                           reinstall_env_faults)
from repro_torch.resilience.guard import (EVENTS, RetryPolicy,
                                          check_numerics_value,
                                          is_runtime_failure,
                                          resilience_section, warn_once)
from repro_torch.resilience.guard import reset as _reset_guard

__all__ = [
    "FaultSpec", "InjectedFault", "inject_faults", "parse_faults",
    "reinstall_env_faults",
    "RetryPolicy", "check_numerics_value", "is_runtime_failure",
    "resilience_section", "warn_once", "EVENTS", "reset",
]


def reset() -> None:
    """Clear the event ledger, its counters and the warn-once state."""
    _reset_guard()
