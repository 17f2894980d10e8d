"""The port's backends as a static per-site routing record
(``repro.backends.base``).

The reference makes the substrate a registry of pluggable executors with
capability checks and a preference ladder.  The port routes statically
(ROADMAP.md, rules of the port), so what is kept is the record:

* :class:`OpSite` -- one kernel call site as shapes, dtypes and a device
  type, read from tensors or fake tensors alike, so a site resolves the
  same at compile time and at run time;
* :class:`FallbackReason` -- why a site runs the plain version
  (``"category:detail"``; falsy, as in the reference);
* :class:`Backend` -- a name and its execution mode.  Two exist:
  :data:`CUDA`, the hand-written kernels, and :data:`PLAIN`, the plain
  PyTorch versions (CPU tensors, and the sites ``kernels.ops`` routes by
  design, counted in ``ops.ROUTED``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

from repro_torch.core.modes import ExecMode

__all__ = ["Backend", "BACKENDS", "CUDA", "FallbackReason", "OpSite",
           "PLAIN"]


@dataclasses.dataclass(frozen=True)
class FallbackReason:
    """Why a site runs the plain version.  Falsy, so a check reads
    ``if not verdict: ...``; ``reason`` is ``"category:detail"``."""

    reason: str

    def __bool__(self) -> bool:
        return False

    def __str__(self) -> str:
        return self.reason

    @property
    def category(self) -> str:
        return self.reason.split(":", 1)[0]


def _dtype_name(dtype: Any) -> str:
    return str(dtype).replace("torch.", "")


@dataclasses.dataclass(frozen=True)
class OpSite:
    """One kernel call site: op name, operand shapes and dtypes, the device
    type of its tensors, and op-specific parameters (``extras``)."""

    op: str
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[str, ...]
    device: str
    extras: Tuple[Tuple[str, Any], ...] = ()

    @classmethod
    def from_args(cls, op: str, args: Tuple[Any, ...],
                  **extras: Any) -> "OpSite":
        """A site from tensors (real or fake); ``None`` args are skipped."""
        ts = [a for a in args if a is not None]
        if not ts:
            raise ValueError(f"{op} site has no tensor operand")
        return cls(op=op, shapes=tuple(tuple(t.shape) for t in ts),
                   dtypes=tuple(_dtype_name(t.dtype) for t in ts),
                   device=ts[0].device.type,
                   extras=tuple(sorted(extras.items())))

    def extra(self, name: str, default: Any = None) -> Any:
        for k, v in self.extras:
            if k == name:
                return v
        return default


@dataclasses.dataclass(frozen=True)
class Backend:
    """A named executor and its execution mode."""

    name: str
    mode: ExecMode
    description: str = ""


CUDA = Backend("cuda", ExecMode.SYSTOLIC,
               "hand-written sm_90a kernels (kernels/csrc)")
PLAIN = Backend("plain", ExecMode.SIMD,
                "plain PyTorch versions (kernels/ref.py)")
BACKENDS = {b.name: b for b in (CUDA, PLAIN)}
