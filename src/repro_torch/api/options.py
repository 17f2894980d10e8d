"""``SMAOptions``: the one configuration surface of the front door
(``repro.api.options``).

:class:`SMAOptions` is a frozen, hashable dataclass; a field left ``None``
inherits from the enclosing :func:`options` context, else from
:data:`DEFAULTS`, so partial options overlay field by field::

    with repro_torch.options(fuse_runtime=False):
        y = engine(params, batch)        # compiles its own, unfused entry

:func:`current_options` is the defaults overlaid by every active context;
:func:`resolve_options` overlays explicit options on that, which is what an
engine bakes into each cached executable and into its cache key.

The port keeps only the fields that mean something in it today.  The
reference's ``backend``, ``interpret``, ``autotune``, ``block_*``,
``precision``, ``jit``, ``donate_argnums`` and ``verify`` wait for the
modules that give them a meaning (ROADMAP.md §1): routing is static and by
device.  ``mesh`` (a :class:`repro_torch.launch.mesh.Mesh`) routes the
GEMM sites of a compiled program through the SUMMA sharded GEMM, prices
their collective bytes in the plan and fills the report's ``comm``
section; ``mesh_rules`` (a :class:`repro_torch.distributed.MeshRules`,
the stock table when ``mesh`` is set without one) is the ambient rule
context while the model traces.  Both are part of the cache key: a new
mesh recompiles, an equal one hits.  ``max_scan_unroll`` bounds the trip
count up to which the lowering unrolls a loop node
(:func:`repro_torch.compiler.loop.scan`), as the reference's bounds a
``scan``.  ``check_numerics`` takes ``"off"``,
``"log"`` and ``"raise"``; the reference's ``"fallback"`` (recompute on
the plain path) is refused, since routing in the port never falls back.

An :func:`options` context that turns ``check_numerics`` on holds
:func:`repro_torch.resilience.faults.probing` open, so a kernel entry
reads the one flag ``faults.QUIET`` to know whether it must probe or
check its output.

This module imports nothing of the port but that module, so every layer
can import it.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Iterator, Optional, Tuple

from repro_torch.resilience import faults as _faults

__all__ = ["SMAOptions", "options", "current_options", "resolve_options",
           "ambient_mesh", "DEFAULTS"]


@dataclasses.dataclass(frozen=True)
class SMAOptions:
    """Every knob of the trace -> plan -> rewrite -> dispatch pipeline.

    lower
      * ``max_scan_unroll`` -- loop nodes of trip count up to this unroll
        in the plan; longer ones are costed once x the trip count behind
        a ``RECURRENCE`` marker.

    plan / rewrite
      * ``fuse_runtime`` -- run the fusion patterns of the rewrite pass
        (``False`` is the spatially decoupled A/B baseline: every GEMM
        dispatched bare, its epilogue run as separate kernels).
      * ``fuse_epilogues`` / ``max_epilogue_ops`` -- the
        :class:`~repro_torch.core.sma.SMAPolicy` knobs of the plan.
      * ``policy`` -- a pre-built ``SMAPolicy`` (wins over the two above).

    engine
      * ``max_cache_entries`` -- beyond this many cached executables the
        least recently used is evicted; ``0`` means unbounded.

    resilience
      * ``check_numerics`` -- ``"off"`` | ``"log"`` | ``"raise"``: check
        each kernel entry's output and each engine call's outputs for
        NaN/Inf (:func:`repro_torch.resilience.guard.check_numerics_value`).

    distributed
      * ``mesh`` -- a :class:`repro_torch.launch.mesh.Mesh`: the GEMM
        sites of the compiled program run as SUMMA sharded GEMMs
        (:func:`repro_torch.distributed.summa.sma_gemm_sharded`), the
        plan costs their collective bytes, and the report gains its
        ``comm`` section.  The mesh is hashable, so the options stay so.
      * ``mesh_rules`` -- a :class:`repro_torch.distributed.MeshRules`
        installed as the ambient rule context while the model traces
        (the stock table when ``mesh`` is set without one).
    """

    fuse_runtime: Optional[bool] = None
    fuse_epilogues: Optional[bool] = None
    max_epilogue_ops: Optional[int] = None
    max_cache_entries: Optional[int] = None
    check_numerics: Optional[str] = None
    max_scan_unroll: Optional[int] = None
    policy: Any = None
    mesh: Any = None
    mesh_rules: Any = None

    _FIELDS = ("fuse_runtime", "fuse_epilogues", "max_epilogue_ops",
               "max_cache_entries", "check_numerics", "max_scan_unroll",
               "policy", "mesh", "mesh_rules")

    def __post_init__(self) -> None:
        if self.check_numerics == "fallback":
            raise ValueError(
                "check_numerics='fallback' recomputes a non-finite output on "
                "the plain path, a runtime fallback that would hide the "
                "kernel; the port routes statically and never falls back "
                "(use 'off' | 'log' | 'raise')")
        if self.check_numerics not in (None, "off", "log", "raise"):
            raise ValueError(
                f"check_numerics={self.check_numerics!r} (one of "
                f"'off' | 'log' | 'raise')")

    def overlay(self, other: Optional["SMAOptions"]) -> "SMAOptions":
        """``other``'s explicitly set (non-``None``) fields override ours."""
        if other is None:
            return self
        updates = {f: getattr(other, f) for f in self._FIELDS
                   if getattr(other, f) is not None}
        return dataclasses.replace(self, **updates) if updates else self

    def cache_key(self) -> Tuple[Any, ...]:
        """Hashable identity for the compile cache.  A ``policy`` hashes by
        identity; holding the object itself (not its ``id()``) keeps it
        alive as long as the key, so a recycled id never aliases two."""
        return tuple(getattr(self, f) for f in self._FIELDS)

    def asdict(self) -> dict:
        """JSON-friendly view (for plan reports)."""
        out = {f: getattr(self, f) for f in self._FIELDS}
        if self.policy is not None:
            out["policy"] = type(self.policy).__name__
        if self.mesh is not None:
            out["mesh"] = {"axes": {str(k): int(s) for k, s in
                                    dict(self.mesh.shape).items()},
                           "devices": int(self.mesh.size)}
        if self.mesh_rules is not None:
            out["mesh_rules"] = type(self.mesh_rules).__name__
        return out


#: The resolved defaults.
DEFAULTS = SMAOptions(fuse_runtime=True, fuse_epilogues=True,
                      max_epilogue_ops=4, max_cache_entries=0,
                      check_numerics="off", max_scan_unroll=8, policy=None,
                      mesh=None, mesh_rules=None)

_STACK: contextvars.ContextVar[Tuple[SMAOptions, ...]] = \
    contextvars.ContextVar("repro_torch_sma_options_stack", default=())


def current_options() -> SMAOptions:
    """Defaults overlaid by every active :func:`options` context, inner
    last."""
    merged = DEFAULTS
    for layer in _STACK.get():
        merged = merged.overlay(layer)
    return merged


def ambient_mesh() -> Any:
    """The ``mesh`` :func:`current_options` would give, without building
    the merged options (a kernel entry asks on every call)."""
    for layer in reversed(_STACK.get()):
        if layer.mesh is not None:
            return layer.mesh
    return DEFAULTS.mesh


def resolve_options(*overlays: Optional[SMAOptions]) -> SMAOptions:
    """:func:`current_options` overlaid by explicit options, in order (an
    engine's options beat the context)."""
    merged = current_options()
    for layer in overlays:
        merged = merged.overlay(layer)
    return merged


@contextlib.contextmanager
def options(opts: Optional[SMAOptions] = None, /,
            **fields: Any) -> Iterator[SMAOptions]:
    """Push a partial :class:`SMAOptions` overlay for the ``with`` scope:
    an ``SMAOptions`` or keyword fields, not both.  Nested contexts overlay
    field by field.  Yields the resolved options."""
    if opts is not None and fields:
        raise TypeError("pass an SMAOptions object OR keyword fields, "
                        "not both")
    layer = opts if opts is not None else SMAOptions(**fields)
    checks = layer.check_numerics not in (None, "off")
    with _faults.probing() if checks else contextlib.nullcontext():
        token = _STACK.set(_STACK.get() + (layer,))
        try:
            yield current_options()
        finally:
            _STACK.reset(token)
