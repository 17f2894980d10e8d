"""``sma_jit`` / :class:`Engine`: the front door (``repro.api.engine``).

``sma_jit(fn, options=...)`` returns an :class:`Engine`, a callable that
compiles lazily on first call (:func:`repro_torch.compiler.dispatch.
compile_with_options`) and caches the executable under the **abstract
signature**: the pytree structure of ``(args, kwargs)``, each leaf's
(shape, dtype, device, stride), the static keyword values and the resolved
options.  A call whose signature was seen skips trace, plan and rewrite and
runs the cached module; a new batch or sequence length compiles once.
Strides are in the key because the trace specializes on them (a
``.contiguous()`` of a contiguous input records no copy); JAX's
``weak_type`` has no counterpart.

Example::

    import functools, torch
    from repro_torch import sma_jit
    from repro_torch.models import lm

    eng = sma_jit(functools.partial(lm.forward, cfg=cfg))
    with torch.no_grad():
        logits = eng(params, batch={"tokens": tokens})   # compiles (miss)
        logits = eng(params, batch={"tokens": tokens})   # cache hit
    eng.stats                     # EngineStats(hits=1, misses=1, ...)
    eng.compile(params, batch=...).report                # the plan report

A function that differentiates inside itself compiles its backward too
(the reference's ``sma_jit`` around ``jax.value_and_grad``): the trace
records forward, backward and the in-place updates as one program, each
kernel call of the direct step one node.  The trainer's step
(``repro_torch.launch.train.make_step``) is such a function::

    def step(params, opt_state, batch):
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss, _ = lm.loss_fn(live, cfg, batch, remat=True)
        grads = torch.autograd.grad(loss, leaves(live))
        return adamw.update(grads, opt_state, params, ocfg)  # in place

    train_step = sma_jit(step, name="train_step")
    params, opt_state, metrics = train_step(params, opt_state, batch)
    params, opt_state, metrics = train_step(params, opt_state, batch)  # hit

The optimizer state's leaves are tensors, so step 2..N hit the cache.
The compiled program holds no autograd graph: a call with grad enabled on
inputs that require grad raises; differentiate inside the function.

``static_argnames`` marks keyword arguments as compile-time constants
(hashable, baked into the trace), as with ``jax.jit``.

Observability (:mod:`repro_torch.obs`), as in the reference: every lookup
feeds ``engine.cache_hits`` / ``engine.cache_misses`` /
``engine.cache_evictions`` and each compile the ``engine.compile_s``
histogram; under a :func:`repro_torch.profile` a call runs in an
``engine.call`` span annotated ``cache=hit|miss`` and a compile in an
``engine.compile`` span, and a plan report read after a profile carries
its ``runtime`` section (the measured mode timeline of the most recent
profile window).

Resilience (:mod:`repro_torch.resilience`), as in the reference: a
compile runs inside :func:`~repro_torch.resilience.faults.compile_scope`
behind the ``engine.compile`` fault probe (a failed compile caches
nothing, so the next call compiles again); with ``check_numerics`` on,
the call runs under that option, so its kernel entries check their
outputs, and its outputs are checked at the engine boundary
(``engine.{name}``).  There is no recompute on a plain path: a non-finite
output raises under ``"raise"`` and is warned about under ``"log"``.  A
report read carries the ``resilience`` section.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.utils._pytree as pytree

from repro_torch.api.options import SMAOptions, options, resolve_options
from repro_torch.compiler.trace import TensorSpec
from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _obs_trace
from repro_torch.resilience import faults as _faults
from repro_torch.resilience import guard as _res_guard

__all__ = ["Engine", "EngineStats", "abstract_signature", "sma_jit"]


def abstract_signature(flat_leaves) -> Tuple[Any, ...]:
    """Per-leaf ``(shape, dtype, device, stride)``: the shape-polymorphic
    half of the cache key.  A leaf is a tensor, a
    :class:`~repro_torch.compiler.trace.TensorSpec` or None."""
    sig = []
    for leaf in flat_leaves:
        if leaf is None:
            sig.append(None)
        elif isinstance(leaf, (torch.Tensor, TensorSpec)):
            sig.append((tuple(leaf.shape), str(leaf.dtype), str(leaf.device),
                        tuple(leaf.stride())))
        else:
            raise TypeError(
                f"sma_jit argument leaf {leaf!r} is not a tensor; mark "
                f"the containing keyword argument static via "
                f"sma_jit(..., static_argnames=...)")
    return tuple(sig)


@dataclasses.dataclass
class EngineStats:
    """Cache and compile accounting for one engine."""

    hits: int = 0
    misses: int = 0
    evictions: int = 0
    compile_time_s: float = 0.0

    @property
    def calls(self) -> int:
        return self.hits + self.misses

    @property
    def hit_rate(self) -> float:
        return self.hits / self.calls if self.calls else 0.0

    @property
    def amortized_compile_s(self) -> float:
        """Compile seconds over every call so far (trends to 0 in steady
        state)."""
        return self.compile_time_s / self.calls if self.calls else 0.0

    def asdict(self) -> Dict[str, Any]:
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions, "calls": self.calls,
                "hit_rate": self.hit_rate,
                "compile_time_s": self.compile_time_s,
                "amortized_compile_s": self.amortized_compile_s}


@dataclasses.dataclass
class _CacheEntry:
    compiled: Any                  # compiler.dispatch.CompiledModel
    hits: int = 0
    compile_time_s: float = 0.0


class Engine:
    """Shape-keyed LRU compile cache around the compiler pipeline.
    Construct with :func:`sma_jit`."""

    def __init__(self, fn: Callable, *, options: Optional[SMAOptions] = None,
                 static_argnames: Tuple[str, ...] = (),
                 name: Optional[str] = None) -> None:
        self.fn = fn
        self.options = options
        self.static_argnames = tuple(static_argnames)
        self.name = name or getattr(getattr(fn, "func", fn), "__name__",
                                    None) or "model"
        self.stats = EngineStats()
        # Use-ordered: eviction pops the front, a hit moves to the end.
        self._cache: "collections.OrderedDict[Any, _CacheEntry]" = \
            collections.OrderedDict()

    def _key(self, args, kwargs, opts: SMAOptions):
        static = {k: kwargs[k] for k in self.static_argnames if k in kwargs}
        dynamic = {k: v for k, v in kwargs.items() if k not in static}
        flat, in_tree = pytree.tree_flatten((args, dynamic))
        static_key = tuple(sorted(static.items()))
        try:
            hash(static_key)
        except TypeError as exc:
            raise TypeError(f"static argument values must be hashable, got "
                            f"{static!r}") from exc
        return ((in_tree, abstract_signature(flat), static_key,
                 opts.cache_key()), static, dynamic)

    def _lookup(self, args, kwargs
                ) -> Tuple[_CacheEntry, Dict[str, Any], bool, SMAOptions]:
        """``(entry, dynamic kwargs, hit, options)``, compiling on a
        miss."""
        opts = resolve_options(self.options)
        key, static, dynamic = self._key(args, kwargs, opts)
        entry = self._cache.get(key)
        if entry is not None:
            self._cache.move_to_end(key)
            self.stats.hits += 1
            entry.hits += 1
            _metrics.inc("engine.cache_hits")
            return entry, dynamic, True, opts

        from repro_torch.compiler.dispatch import compile_with_options
        fn = functools.partial(self.fn, **static) if static else self.fn
        t0 = time.perf_counter()
        with _obs_trace.span("engine.compile", cat="engine",
                             engine=self.name), _faults.compile_scope():
            # A signature whose kernels fail to build: ``engine.compile``
            # specs (compile_error through the scope, or runtime_error /
            # latency).
            _faults.maybe_raise("engine.compile", self.name)
            compiled = compile_with_options(fn, *args, name=self.name,
                                            options=opts, **dynamic)
        dt = time.perf_counter() - t0
        entry = _CacheEntry(compiled=compiled, compile_time_s=dt)
        compiled.report_refresh = functools.partial(self._refresh_report,
                                                    entry)
        self._cache[key] = entry
        self.stats.misses += 1
        self.stats.compile_time_s += dt
        _metrics.inc("engine.cache_misses")
        _metrics.observe("engine.compile_s", dt)
        limit = opts.max_cache_entries or 0
        while limit > 0 and len(self._cache) > limit:
            self._cache.popitem(last=False)
            self.stats.evictions += 1
            _metrics.inc("engine.cache_evictions")
        return entry, dynamic, False, opts

    def _refresh_report(self, entry: _CacheEntry,
                        rep: Dict[str, Any]) -> None:
        calls = entry.hits + 1
        rep["engine"] = {
            "cache_hits": entry.hits,
            "compile_time_s": entry.compile_time_s,
            "amortized_compile_s": entry.compile_time_s / calls,
            "engine_stats": self.stats.asdict(),
        }
        # The measured half of the plan: the active (or most recent)
        # profile window's mode timeline; runs of other engines inside the
        # same window count in the same timeline.
        tracer = _obs_trace.last_tracer()
        if tracer is not None and tracer.events:
            rep["runtime"] = tracer.runtime_section()
        rep["resilience"] = _res_guard.resilience_section()

    def _run(self, args, kwargs) -> Tuple[Any, bool]:
        """Lookup, run, and the engine-boundary numeric guard."""
        entry, dynamic, hit, opts = self._lookup(args, kwargs)
        policy = opts.check_numerics
        if policy in (None, "off"):
            return entry.compiled(*args, **dynamic), hit
        with options(check_numerics=policy):
            out = entry.compiled(*args, **dynamic)
        return _res_guard.check_numerics_value(
            f"engine.{self.name}", "engine", out, None, policy), hit

    def __call__(self, *args, **kwargs):
        tracer = _obs_trace.current_tracer()
        if tracer is None:
            return self._run(args, kwargs)[0]
        with tracer.span("engine.call", cat="engine",
                         engine=self.name) as sp:
            out, hit = self._run(args, kwargs)
            sp.annotate(cache="hit" if hit else "miss")
            return sp.block(out)

    def compile(self, *args, **kwargs):
        """Compile (or fetch) the executable for this signature without
        running it; leaves may be :class:`~repro_torch.compiler.trace.
        TensorSpec`.  Returns the cached ``CompiledModel``."""
        return self._lookup(args, kwargs)[0].compiled

    @property
    def cache_size(self) -> int:
        return len(self._cache)

    @property
    def report(self) -> Dict[str, Any]:
        """Cache stats and one summary per cached signature."""
        entries = []
        for (in_tree, sig, static_key, _), entry in self._cache.items():
            entries.append({
                "signature": [list(s) if s is not None else None
                              for s in sig],
                "static": [list(kv) for kv in static_key],
                "cache_hits": entry.hits,
                "compile_time_s": entry.compile_time_s,
                "fused_sites": len(entry.compiled.fused_sites),
                "mode_switches": entry.compiled.summary.mode_switches,
            })
        return {"engine": self.name, "cache": self.stats.asdict(),
                "entries": entries}

    def __repr__(self) -> str:
        return (f"Engine({self.name}, entries={len(self._cache)}, "
                f"hits={self.stats.hits}, misses={self.stats.misses})")


def sma_jit(fn: Optional[Callable] = None, *,
            options: Optional[SMAOptions] = None,
            static_argnames=(), name: Optional[str] = None):
    """Wrap ``fn`` in an :class:`Engine`: bare (``@sma_jit``), with
    arguments (``@sma_jit(options=...)``) or as a call (``sma_jit(fn,
    options=...)``).  ``options`` overlays the ambient
    :func:`repro_torch.api.options.options` context at each call."""
    if isinstance(static_argnames, str):
        static_argnames = (static_argnames,)

    def wrap(f: Callable) -> Engine:
        return Engine(f, options=options,
                      static_argnames=tuple(static_argnames), name=name)

    return wrap if fn is None else wrap(fn)
