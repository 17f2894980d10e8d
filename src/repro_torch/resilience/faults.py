"""Deterministic, scoped fault injection (counterpart of
``repro.resilience.faults``).

* :class:`FaultSpec` -- one named fault: a *site* (a kernel entry point such
  as ``"sma_gemm"``, or an engine site such as ``"serve.tick"`` /
  ``"engine.compile"``), an optional backend qualifier (the port's route
  names, ``cuda`` or ``plain``), a *kind*, and firing controls
  (``times``/``after``/``p``).
* :func:`inject_faults` -- a context manager pushing an injector for the
  ``with`` scope (``with repro_torch.inject_faults("sma_gemm@cuda:"
  "runtime_error:times=1"): ...``).  Nested scopes stack; every probe
  consults all active injectors.
* ``REPRO_FAULTS`` -- the environment hook: a process-wide base schedule
  parsed once at the first probe.  :func:`reinstall_env_faults` re-reads
  it.

Kinds: ``runtime_error`` raises :class:`InjectedFault` at the probe;
``compile_error`` the same, but only inside a :func:`compile_scope` (the
engine wraps its compile in one); ``nan`` / ``inf`` make every float
tensor of a launch's output NaN / Inf (integer tensors are left alone);
``latency`` sleeps ``latency_s`` at the probe.

Determinism: probabilistic specs (``p < 1``) draw from a
``random.Random`` seeded per injector, and ``times``/``after`` counters
are per spec, so a schedule fires on the same calls as in the JAX package.

The probes are on the hot path of every kernel entry
(:mod:`repro_torch.kernels.ops`), so the module keeps :data:`QUIET`: True
while no :func:`probing` scope is open anywhere (every ``inject_faults``
scope is one, and so is an ``options(check_numerics=...)`` context that
turns the check on) and ``REPRO_FAULTS`` was read and is empty.  A caller
that sees it True skips the probes and the numeric check with one
attribute read.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import os
import random
import threading
import time
from typing import Any, Iterator, List, Optional, Sequence, Tuple, Union

import torch
import torch.utils._pytree as pytree

from repro_torch.obs import metrics as _metrics

__all__ = ["FaultSpec", "InjectedFault", "inject_faults", "parse_faults",
           "maybe_raise", "corrupt", "compile_scope", "in_compile_scope",
           "reinstall_env_faults", "active_specs", "probing", "QUIET"]

KINDS = ("runtime_error", "compile_error", "nan", "inf", "latency")

#: Kinds checked before the launch (may raise / sleep) and after it
#: (corrupt the output).
_PRE_KINDS = ("runtime_error", "compile_error", "latency")
_POST_KINDS = ("nan", "inf")


class InjectedFault(RuntimeError):
    """Raised by an armed ``runtime_error`` / ``compile_error`` spec: a
    runtime-class failure by definition
    (:func:`repro_torch.resilience.guard.is_runtime_failure`)."""

    def __init__(self, site: str, backend: Optional[str], kind: str) -> None:
        super().__init__(f"injected {kind} at {site}"
                         + (f"@{backend}" if backend else ""))
        self.site = site
        self.backend = backend
        self.kind = kind


@dataclasses.dataclass
class FaultSpec:
    """One injectable fault.

    ``site`` matches the probe's site name exactly (``"*"`` matches any);
    ``backend`` of ``None`` matches any backend.  ``times`` bounds how many
    probes the spec fires on (``None`` = unlimited), ``after`` skips that
    many matching probes first, and ``p`` fires probabilistically from the
    injector's seeded RNG.
    """

    site: str
    kind: str
    backend: Optional[str] = None
    times: Optional[int] = 1
    after: int = 0
    p: float = 1.0
    latency_s: float = 0.001

    def __post_init__(self) -> None:
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(one of {KINDS})")
        self._seen = 0
        self._fired = 0

    def matches(self, site: str, backend: Optional[str]) -> bool:
        if self.site != "*" and self.site != site:
            return False
        return self.backend is None or self.backend == backend

    def arm(self, rng: random.Random) -> bool:
        """Consume one matching probe; True when the fault fires."""
        self._seen += 1
        if self._seen <= self.after:
            return False
        if self.times is not None and self._fired >= self.times:
            return False
        if self.p < 1.0 and rng.random() >= self.p:
            return False
        self._fired += 1
        return True


def parse_faults(text: str) -> List[FaultSpec]:
    """Parse the ``REPRO_FAULTS`` mini-language into specs.

    Format (semicolon-separated)::

        site[@backend]:kind[:key=value,key=value...]

    e.g. ``"sma_gemm@cuda:runtime_error:times=1;serve.tick:latency:"
    "times=10,latency_s=0.002"``.
    """
    specs: List[FaultSpec] = []
    for chunk in text.split(";"):
        chunk = chunk.strip()
        if not chunk:
            continue
        parts = chunk.split(":")
        if len(parts) < 2:
            raise ValueError(f"fault spec {chunk!r} needs site:kind")
        target, kind = parts[0], parts[1]
        backend = None
        if "@" in target:
            target, backend = target.split("@", 1)
        kwargs: dict = {}
        if len(parts) > 2:
            for kv in parts[2].split(","):
                k, _, v = kv.partition("=")
                k = k.strip()
                if k in ("times", "after"):
                    kwargs[k] = None if v == "none" else int(v)
                elif k in ("p", "latency_s"):
                    kwargs[k] = float(v)
                else:
                    raise ValueError(f"unknown fault param {k!r} in {chunk!r}")
        specs.append(FaultSpec(site=target, kind=kind, backend=backend,
                               **kwargs))
    return specs


class _Injector:
    def __init__(self, specs: Sequence[FaultSpec], seed: int) -> None:
        self.specs = list(specs)
        self.rng = random.Random(seed)


# Active injectors: a process-wide base (from REPRO_FAULTS, parsed lazily)
# plus a contextvar stack pushed by ``inject_faults`` scopes.
_ENV: Optional[Tuple[_Injector, ...]] = None
_STACK: contextvars.ContextVar[Tuple[_Injector, ...]] = \
    contextvars.ContextVar("repro_torch_fault_injectors", default=())
_OPEN = 0                       # probing scopes open, in any context
_LOCK = threading.Lock()

#: True when no probe can fire (module docstring).
QUIET = False


def _settle() -> None:
    global QUIET
    QUIET = _OPEN == 0 and _ENV is not None and not _ENV


def _env_injectors() -> Tuple[_Injector, ...]:
    global _ENV
    if _ENV is None:
        raw = os.environ.get("REPRO_FAULTS", "").strip()
        _ENV = (_Injector(parse_faults(raw), seed=0),) if raw else ()
        with _LOCK:
            _settle()
    return _ENV


def reinstall_env_faults() -> None:
    """Re-read ``REPRO_FAULTS`` at the next probe."""
    global _ENV, QUIET
    _ENV = None
    QUIET = False


def _active() -> Tuple[_Injector, ...]:
    return _env_injectors() + _STACK.get()


def active_specs() -> List[FaultSpec]:
    """Every spec currently in scope (env base + ``inject_faults`` stack)."""
    return [s for inj in _active() for s in inj.specs]


@contextlib.contextmanager
def inject_faults(specs: Union[str, FaultSpec, Sequence[FaultSpec]],
                  *, seed: int = 0) -> Iterator[List[FaultSpec]]:
    """Scope a deterministic fault schedule.

    ``specs`` is a spec string (see :func:`parse_faults`), one
    :class:`FaultSpec`, or a sequence of them.  Firing counters live on the
    spec objects, so a schedule is consumed once per ``with`` entry.
    """
    if isinstance(specs, str):
        specs = parse_faults(specs)
    elif isinstance(specs, FaultSpec):
        specs = [specs]
    inj = _Injector(specs, seed)
    with probing():
        token = _STACK.set(_STACK.get() + (inj,))
        try:
            yield inj.specs
        finally:
            _STACK.reset(token)


@contextlib.contextmanager
def probing() -> Iterator[None]:
    """Hold :data:`QUIET` False for the scope, in every context: the kernel
    entries then run their probes and their numeric check."""
    global _OPEN, QUIET
    with _LOCK:
        _OPEN += 1
        QUIET = False
    try:
        yield
    finally:
        with _LOCK:
            _OPEN -= 1
            _settle()


# --------------------------------------------------------------------------
# Compile scope (gates ``compile_error`` kinds)
# --------------------------------------------------------------------------
_COMPILING: contextvars.ContextVar[bool] = \
    contextvars.ContextVar("repro_torch_fault_compile_scope", default=False)


@contextlib.contextmanager
def compile_scope() -> Iterator[None]:
    """Mark the scope as compile-time: ``compile_error`` specs fire only
    inside it (the engine wraps its compile pipeline in this)."""
    token = _COMPILING.set(True)
    try:
        yield
    finally:
        _COMPILING.reset(token)


def in_compile_scope() -> bool:
    return _COMPILING.get()


# --------------------------------------------------------------------------
# Probes
# --------------------------------------------------------------------------
def maybe_raise(site: str, backend: Optional[str] = None) -> None:
    """Pre-launch probe: fire any armed raise/latency spec for this site."""
    injectors = _active()
    if not injectors:
        return
    for inj in injectors:
        for spec in inj.specs:
            if spec.kind not in _PRE_KINDS or not spec.matches(site, backend):
                continue
            if spec.kind == "compile_error" and not in_compile_scope():
                continue
            if not spec.arm(inj.rng):
                continue
            _metrics.inc(f"resilience.injected.{spec.kind}")
            if spec.kind == "latency":
                time.sleep(spec.latency_s)
                continue
            raise InjectedFault(site, backend, spec.kind)


def corrupt(site: str, backend: Optional[str], value: Any) -> Any:
    """Post-launch probe: every floating-point tensor of ``value`` (a
    tensor or a pytree of them) becomes NaN/Inf when a spec fires; other
    leaves pass through."""
    injectors = _active()
    if not injectors:
        return value
    fill = None
    for inj in injectors:
        for spec in inj.specs:
            if spec.kind not in _POST_KINDS or not spec.matches(site, backend):
                continue
            if not spec.arm(inj.rng):
                continue
            _metrics.inc(f"resilience.injected.{spec.kind}")
            fill = float("nan") if spec.kind == "nan" else float("inf")
    if fill is None:
        return value

    def poison(leaf):
        if isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
            return torch.full_like(leaf, fill)
        return leaf

    return pytree.tree_map(poison, value)
