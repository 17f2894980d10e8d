"""``repro_torch.api``: the public front door (``repro.api``).

* :func:`sma_jit` / :class:`Engine` -- compile a PyTorch forward function
  lazily and cache the executable per abstract signature;
* :class:`SMAOptions` / :func:`options` / :func:`current_options` /
  :func:`resolve_options` -- the one configuration path, with a context
  manager for scoped overrides.

Re-exported from the top-level ``repro_torch`` package.
"""
from repro_torch.api.engine import (Engine, EngineStats, abstract_signature,
                                    sma_jit)
from repro_torch.api.options import (DEFAULTS, SMAOptions, current_options,
                                     options, resolve_options)

__all__ = ["Engine", "EngineStats", "abstract_signature", "sma_jit",
           "SMAOptions", "options", "current_options", "resolve_options",
           "DEFAULTS"]
