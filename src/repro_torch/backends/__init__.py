"""Static per-site routing record (``repro.backends``): :mod:`base` holds
the site, reason and backend records, :mod:`registry` the pure selection
and the site recorder."""
from repro_torch.backends.base import (BACKENDS, Backend, FallbackReason,
                                       OpSite)
from repro_torch.backends.registry import (available_backends, record_sites,
                                           select_backend)

__all__ = ["BACKENDS", "Backend", "FallbackReason", "OpSite",
           "available_backends", "record_sites", "select_backend"]
