"""The serving entry point, and the deprecated slot ``Server``
(counterpart of ``repro.launch.serve``).

``python -m repro_torch.launch.serve --arch mistral-nemo-12b`` serves a
few random prompts through :class:`repro_torch.serving.ServeEngine`
(random weights from seed 0) and prints what the engine did: requests
done and failed, ticks, mode switches, and each phase's compiles.  It runs
on ``cuda`` and raises without a card, unless ``--device cpu`` asks for
the plain versions.

``Server`` keeps the old slot surface working over a ``ServeEngine``
configured for slot-equivalent behaviour:

* ``slots`` rows, each provisioned with a full ``cache_size`` budget in
  blocks of 16, so admission succeeds exactly when a slot is free;
* ``admit`` prefills the whole prompt before returning and emits no token
  (:meth:`ServeEngine.admit_sync`); ``tick`` decodes one token for every
  active request (:meth:`ServeEngine.decode_tick`) and re-feeds the last
  prompt token first, at position ``len(prompt)``, so the cache holds that
  token twice: the legacy semantics, reproduced exactly;
* the same fault sites (``serve.admit`` / ``serve.tick``), ``serve.*``
  counters and retry / evict / watchdog behaviour.

Each ``Server`` construction warns once (``DeprecationWarning``, pointed
at the caller).  Migrate to::

    from repro_torch.serving import Request, ServeEngine
    eng = ServeEngine(cfg, params, ...)
    eng.submit(Request(rid=0, prompt=..., max_new_tokens=8))
    eng.run()
"""
from __future__ import annotations

import argparse
import contextlib
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch._deprecation import warn_deprecated
from repro_torch._device import DeviceLike
from repro_torch.api import SMAOptions
from repro_torch.configs.base import ModelConfig, get_config, reduced
from repro_torch.models import lm
from repro_torch.obs import trace as _obs_trace
from repro_torch.resilience.guard import RetryPolicy
from repro_torch.serving import CacheConfig, Request, ServeEngine

__all__ = ["Request", "Server", "main"]

#: Block size the shim provisions its slot-equivalent pools with.
_BLOCK = 16


class Server:
    """Deprecated slot-based facade over :class:`ServeEngine`."""

    def __init__(self, cfg: ModelConfig, params: dict, *, slots: int = 4,
                 cache_size: int = 256,
                 options: Optional[SMAOptions] = None,
                 temperature: float = 0.0, seed: int = 0,
                 retry: Optional[RetryPolicy] = None,
                 device: DeviceLike = None) -> None:
        warn_deprecated(
            "repro_torch.launch.serve.Server is deprecated; use "
            "repro_torch.serving.ServeEngine (continuous batching over a "
            "paged KV cache) instead")
        self.cfg = cfg
        self.slots = slots
        self.cache_size = cache_size
        blocks_per_slot = -(-cache_size // _BLOCK)
        cache = CacheConfig(block_size=_BLOCK,
                            num_blocks=slots * blocks_per_slot,
                            max_seq_len=cache_size)
        self.core = ServeEngine(cfg, params, cache=cache, max_batch=slots,
                                options=options, temperature=temperature,
                                seed=seed, retry=retry, device=device)

    @property
    def params(self) -> dict:
        return self.core.params

    @property
    def active(self) -> Dict[int, Request]:
        return self.core.active

    @property
    def done(self) -> Dict[int, Request]:
        return self.core.done

    @property
    def failed(self) -> Dict[int, Request]:
        return self.core.failed

    @property
    def retry(self) -> RetryPolicy:
        return self.core.retry

    @property
    def temperature(self) -> float:
        return self.core.temperature

    @property
    def cache_len(self) -> np.ndarray:
        return self.core.cache_len

    @property
    def engine(self):
        """The decode-phase ``sma_jit`` engine (stats and cache)."""
        return self.core.engines["decode"]

    def free_slots(self) -> List[int]:
        return self.core.free_rows()

    def admit(self, req: Request) -> bool:
        """True when the request was consumed (admitted with its prompt
        prefilled, trivially completed, or rejected as ``failed``); False
        only when no slot is free."""
        return self.core.admit_sync(req)

    def tick(self) -> Dict[int, int]:
        """Decode one token for every active request."""
        if not self.core.active:
            return {}
        with _obs_trace.span("serve.tick", cat="serve",
                             active=len(self.core.active)):
            return self.core.decode_tick()


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="record a runtime trace of the serve loop and "
                         "write Chrome-trace JSON (Perfetto-loadable) here")
    ap.add_argument("--device", default=None,
                    help="default cuda; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    params = lm.init(cfg, seed=0, device=args.device)
    engine = ServeEngine(cfg, params, max_batch=args.slots,
                         temperature=args.temperature, device=args.device)

    rng = np.random.RandomState(0)
    for i in range(args.requests):
        req = Request(rid=i,
                      prompt=rng.randint(0, cfg.vocab_size, size=(6,))
                      .astype(np.int32),
                      max_new_tokens=args.max_new)
        status = engine.submit(req)
        if status == "failed":
            print(f"[serve] rejected request {req.rid}: {req.error}")
    t0 = time.time()
    with _obs_trace.profile(path=args.trace_out) if args.trace_out \
            else contextlib.nullcontext() as prof:
        ticks = engine.run()
    dt = time.time() - t0
    print(f"[serve] {len(engine.done)} done / {len(engine.failed)} failed "
          f"of {args.requests} requests, {ticks} engine ticks, "
          f"{dt:.2f}s ({ticks / max(dt, 1e-9):.1f} ticks/s)")
    sched = engine.sched.stats()
    print(f"[serve] scheduler({sched['policy']}): {sched['ticks']} ticks, "
          f"{sched['mode_switches']} mode switches")
    for name, eng in engine.engines.items():
        st = eng.stats
        print(f"[serve] {name} engine cache: {st.hits} hits / "
              f"{st.misses} compiles, compile {st.compile_time_s:.2f}s")
    if args.trace_out:
        print(f"[serve] wrote trace -> {args.trace_out}")
        print(prof.timeline_text())


if __name__ == "__main__":
    main()
