"""ServeEngine: continuous batching over a paged KV cache
(counterpart of ``repro.serving.engine``).

The same request flow as the JAX engine: ``submit`` queues a request,
every ``step`` first admits from the queue into free rows (reserving each
request's whole KV-block budget), then the mode scheduler picks one
same-phase batch -- a prefill chunk for every row still prefilling, or one
decode token for every decoding row -- and the engine runs it.

**One compile per (phase, bucket).**  Both phases run through
:func:`repro_torch.sma_jit` engines (``self.engines``), named
``{cfg.name}.paged_decode`` and ``{cfg.name}.paged_prefill`` as the
reference names them.  Batches are padded to power-of-two row buckets
with rows whose block tables are all-sentinel (their pool writes land in
the spare block and their attention reads nothing, see
``serving.model``) and prefill chunks to ``prefill_chunk``, so each phase
compiles once per bucket and every later tick is a cache hit.
:meth:`reset` keeps the compiled signatures.  There is no eager fallback:
a step that fails to trace or compile raises.  The direct path is
:func:`repro_torch.serving.model.paged_decode_step` /
``paged_prefill_step`` called by hand.  Ticks run under
``torch.inference_mode()``, so no autograd bookkeeping reaches the kernel
entry points.

**Observability** (:mod:`repro_torch.obs`), at the reference's sites:
each tick runs under a ``serving.tick.{phase}`` span tagged with its mode
(prefill systolic, decode SIMD) and rows, so ``obs.runtime_section`` of
the tick spans measures the realized mode switches; the counters
``serving.admitted`` / ``serving.ticks`` / ``serving.mode_switches`` /
``serving.tokens`` and the histograms ``serving.queue_wait_s`` /
``serving.ttft_s`` / ``serving.itl_s``, and on the failure paths
``serve.retries`` / ``serve.evictions`` / ``serve.requests_failed`` /
``serve.watchdog_exceeded``.  Each executed tick is also recorded in
``tick_log`` as (phase, rows, seconds).

**Failure isolation** (:mod:`repro_torch.resilience`), as in the
reference: per-row containment of non-finite logits (only healthy rows
advance; a poisoned request is charged a retry under
:class:`~repro_torch.resilience.guard.RetryPolicy` and evicted, its blocks
zeroed and freed, once the budget is spent); the whole-tick retry (a tick
that raises a runtime-class failure,
:func:`~repro_torch.resilience.guard.is_runtime_failure`, charges every
row one retry, counts ``serve.tick_failures``, backs off and leaves the
next tick to try again; any other exception propagates); the fault sites
``serve.admit`` and ``serve.tick``; and the soft watchdog
(``serve.watchdog_exceeded``, warned once per site).

**Recurrent rows** (RG-LRU, mLSTM, sLSTM) keep a dense per-row state
beside the pools (:mod:`repro_torch.serving.model`), handled per tick as
the reference handles it: :meth:`_gather` copies the tick's rows out
(padding rows repeat the first row; pools pass through whole), the step
consumes that copy and returns new recurrent tensors, and
:meth:`_scatter` writes back only the rows whose logits are finite, so a
poisoned row keeps its pre-tick state.  :meth:`_zero_row` zeroes a row's
recurrent state on admit and on eviction.

**The retry after a mid-step fault is exact.**  The compiled steps write
the paged pools in place, so unlike the reference the pools after a
failed tick are not the pre-tick pools: a fault at ``serve.tick`` fires
before the step and nothing is written, but a fault at a kernel entry
fires mid-step, after some layers have written their keys and values at
positions >= ``cache_len``.  ``cache_len`` has not advanced, nothing
reads past it, and the retry rewrites the same slots with the same
values.  The recurrent entries of ``self.state`` are untouched by a
failed tick, since the step only read their gathered copy.  So the
retried tick's tokens are the unfaulted ones.

**The slot API** of the deprecated :class:`repro_torch.launch.serve.
Server`: :meth:`admit_sync` (admit and prefill the whole prompt, emitting
no token) and :meth:`decode_tick` (decode only, the last prompt token
re-fed on the first tick).

Inputs: an ``embeds``-mode model (musicgen) is fed
:func:`~repro_torch.serving.model.token_embeds` of its token ids; a
``tokens+vision`` model serves as a ``tokens`` one (no vision prefix, as
in the reference).  Greedy sampling is ``argmax``; with ``temperature >
0`` tokens are drawn with the engine's own ``torch.Generator`` (not JAX's
bits).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.api import SMAOptions, sma_jit
from repro_torch.configs.base import ModelConfig
from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _obs_trace
from repro_torch.resilience import faults as _faults
from repro_torch.resilience.guard import (RetryPolicy, is_runtime_failure,
                                          record_event, warn_once)
from repro_torch.serving import model as smodel
from repro_torch.serving.kv_cache import CacheConfig, PagedKVCache
from repro_torch.serving.scheduler import (ModeScheduler, SchedulerConfig,
                                           TickPlan)

__all__ = ["Request", "RetryPolicy", "ServeEngine"]


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray           # (S,) int32
    max_new_tokens: int = 16
    out_tokens: Optional[List[int]] = None
    slot: int = -1               # engine row while active
    #: ``pending`` -> ``active`` -> ``done`` | ``failed``.
    status: str = "pending"
    error: Optional[str] = None
    retries: int = 0
    prefilled: int = 0           # prompt tokens already prefilled
    #: emit the first token from the prefill logits (continuous path); the
    #: slot API instead re-feeds the last prompt token on the first decode
    #: tick.
    emit_first: bool = True
    t_submit: Optional[float] = None
    t_admit: Optional[float] = None
    t_first: Optional[float] = None
    t_last: Optional[float] = None


class ServeEngine:
    """Continuous-batching engine: paged KV + SMA mode-batching scheduler.

    ``params`` must already be on ``device`` (``cuda`` unless the caller
    passes ``device="cpu"``).  ``options`` configure both phases'
    ``sma_jit`` engines.
    """

    def __init__(self, cfg: ModelConfig, params: dict, *,
                 cache: Optional[CacheConfig] = None,
                 max_batch: int = 8,
                 sched: Optional[SchedulerConfig] = None,
                 options: Optional[SMAOptions] = None,
                 temperature: float = 0.0, seed: int = 0,
                 retry: Optional[RetryPolicy] = None,
                 device: DeviceLike = None) -> None:
        self.device = resolve_device(device)
        if params["head"]["w"].device.type != self.device.type:
            raise ValueError(f"params are on {params['head']['w'].device}, "
                             f"the engine on {self.device}")
        self.cfg = cfg
        self.params = params
        self.cache = cache or CacheConfig()
        self.max_batch = max_batch
        self.sched = ModeScheduler(sched)
        self.temperature = temperature
        self.seed = seed
        self.gen = torch.Generator().manual_seed(seed)
        self.retry = retry or RetryPolicy()

        self.kv = PagedKVCache(self.cache, max_batch)
        self.state = smodel.init_state(cfg, max_batch, self.cache,
                                       device=self.device)
        self.cache_len = np.zeros((max_batch,), np.int32)  # host-side truth
        self._pooled = frozenset(smodel.pooled_positions(cfg))

        self.queue: List[Request] = []
        self.active: Dict[int, Request] = {}
        self.done: Dict[int, Request] = {}
        self.failed: Dict[int, Request] = {}
        self.tick_log: List[Tuple[str, int, float]] = []

        # One engine per phase, one compile per row bucket.
        self.engines = {
            "decode": sma_jit(
                lambda p, s, bt, cl, b: smodel.paged_decode_step(
                    p, s, bt, cl, cfg, b),
                options=options, name=f"{cfg.name}.paged_decode"),
            "prefill": sma_jit(
                lambda p, s, bt, cl, nt, b: smodel.paged_prefill_step(
                    p, s, bt, cl, nt, cfg, b),
                options=options, name=f"{cfg.name}.paged_prefill"),
        }

    # ------------------------------------------------------------------ rows
    def free_rows(self) -> List[int]:
        used = {r.slot for r in self.active.values()}
        return [i for i in range(self.max_batch) if i not in used]

    def _by_row(self) -> Dict[int, Request]:
        return {r.slot: r for r in self.active.values()}

    def _prefill_reqs(self) -> List[Request]:
        return [r for r in self.active.values()
                if r.prefilled < len(r.prompt)]

    def _decode_reqs(self) -> List[Request]:
        return [r for r in self.active.values()
                if r.prefilled >= len(r.prompt)]

    # ------------------------------------------------------------- admission
    def _validate(self, req: Request) -> bool:
        """Terminal validation; True when the request was consumed (failed
        or trivially done) without taking capacity."""
        if len(req.prompt) == 0:
            self._fail(req, "empty prompt (nothing to decode from)")
            return True
        why = self.kv.admission_error(len(req.prompt), req.max_new_tokens)
        if why is not None:
            self._fail(req, why)
            return True
        if req.max_new_tokens <= 0:
            req.out_tokens = []
            req.status = "done"
            self.done[req.rid] = req
            return True
        return False

    def submit(self, req: Request) -> str:
        """Validate and enqueue; admission happens on the next
        :meth:`step`.  Returns the request's status."""
        if req.t_submit is None:
            req.t_submit = time.perf_counter()
        if self._validate(req):
            return req.status
        self.queue.append(req)
        return req.status

    def try_admit(self, req: Request, *, emit_first: bool = True) -> bool:
        """Place a validated request into a free row, reserving its whole
        KV-block budget.  False = no row or no blocks right now.
        ``emit_first=False`` suppresses the token of the prefill's last
        logits (the slot API's)."""
        free = self.free_rows()
        if not free:
            return False
        row = free[0]
        if not self.kv.admit(row, len(req.prompt), req.max_new_tokens):
            return False
        now = time.perf_counter()
        req.slot = row
        req.out_tokens = []
        req.status = "active"
        req.prefilled = 0
        req.emit_first = emit_first
        req.t_admit = now
        if req.t_submit is not None:
            _metrics.observe("serving.queue_wait_s", now - req.t_submit)
        self._zero_row(row)
        self.active[req.rid] = req
        _metrics.inc("serving.admitted")
        return True

    def _admit_from_queue(self) -> None:
        """Drain the FIFO head into free rows, every tick."""
        while self.queue:
            head = self.queue[0]
            if self._validate(head):
                self.queue.pop(0)
                continue
            if not self.try_admit(head):
                return
            self.queue.pop(0)

    def admit_sync(self, req: Request) -> bool:
        """Slot-API admission (the deprecated ``Server.admit``): validate,
        take a row, and prefill the whole prompt before returning.  No
        first token is emitted: the first decode tick re-feeds the last
        prompt token.

        Returns True when the request was consumed (admitted, trivially
        done, or rejected as failed) and False only when no capacity is
        free.  A runtime-class failure during the prefill evicts the
        request."""
        if req.t_submit is None:
            req.t_submit = time.perf_counter()
        if self._validate(req):
            return True
        t0 = time.perf_counter()
        if not self.try_admit(req, emit_first=False):
            return False
        with _obs_trace.span("serve.admit", cat="serve", rid=req.rid,
                             slot=req.slot, prompt_len=len(req.prompt)):
            try:
                _faults.maybe_raise("serve.admit")
                with _obs_trace.span("serve.warmup", cat="serve",
                                     rid=req.rid, slot=req.slot,
                                     tokens=len(req.prompt)):
                    while (req.status == "active"
                           and req.prefilled < len(req.prompt)):
                        self._run_plan(self.sched.plan([req.slot], []))
            except Exception as exc:
                if not is_runtime_failure(exc):
                    raise
                self._evict(req, f"warmup failed: "
                                 f"{type(exc).__name__}: {exc}")
        self._watchdog("serve.admit", time.perf_counter() - t0)
        return True

    # ----------------------------------------------------------------- ticks
    def step(self) -> Dict[int, int]:
        """One scheduler tick: admit, plan one same-mode batch, run it.
        Returns ``{rid: token}`` for tokens emitted this tick."""
        self._admit_from_queue()
        prefill_rows = [r.slot for r in self._prefill_reqs()]
        decode_rows = sorted(r.slot for r in self._decode_reqs())
        plan = self.sched.plan(prefill_rows, decode_rows)
        if plan.phase == "idle":
            return {}
        return self._guarded_tick(plan)

    def decode_tick(self) -> Dict[int, int]:
        """Slot-API tick (the deprecated ``Server.tick``): one token for
        every decode-ready request, no prefill interleaved."""
        decode_rows = sorted(r.slot for r in self._decode_reqs())
        if not decode_rows:
            return {}
        return self._guarded_tick(self.sched.plan([], decode_rows))

    def _guarded_tick(self, plan: TickPlan) -> Dict[int, int]:
        """Run one planned tick behind the ``serve.tick`` fault probe; a
        runtime-class failure becomes a whole-tick retry
        (:meth:`_tick_failed`), anything else propagates.  A completed
        tick is logged in ``tick_log``."""
        t0 = time.perf_counter()
        out: Dict[int, int] = {}
        try:
            _faults.maybe_raise("serve.tick")
            out = self._run_plan(plan)
            self.tick_log.append((plan.phase, len(plan.rows),
                                  time.perf_counter() - t0))
        except Exception as exc:
            if not is_runtime_failure(exc):
                raise
            self._tick_failed(exc, plan.rows)
        self._watchdog("serve.tick", time.perf_counter() - t0)
        return out

    def run(self, *, max_ticks: int = 100_000) -> int:
        """Drive :meth:`step` until all submitted work drains.  Returns the
        number of ticks."""
        ticks = 0
        while (self.queue or self.active) and ticks < max_ticks:
            self.step()
            ticks += 1
        return ticks

    @torch.inference_mode()
    def _run_plan(self, plan: TickPlan) -> Dict[int, int]:
        """Run one planned tick under its mode-tagged span: the span's
        ``mode`` is what ``obs.runtime_section`` collapses into systolic /
        SIMD segments, the measured mode-switch count of the serve loop."""
        if plan.switched:
            _metrics.inc("serving.mode_switches")
        _metrics.inc("serving.ticks")
        with _obs_trace.span(f"serving.tick.{plan.phase}", cat="serve",
                             mode=plan.mode, rows=len(plan.rows)):
            if plan.phase == "prefill":
                return self._prefill_tick(list(plan.rows))
            return self._decode_tick(list(plan.rows))

    # ------------------------------------------------------------- internals
    @staticmethod
    def _bucket(n: int) -> int:
        return 1 << max(0, n - 1).bit_length() if n > 1 else 1

    def _padded_rows(self, rows: List[int]) -> Tuple[List[int], int]:
        """The tick's rows filled up to their power-of-two bucket by
        repeating the first (the rows a recurrent entry gathers), and the
        number of padding rows."""
        pad = min(self.max_batch, self._bucket(len(rows))) - len(rows)
        return rows + [rows[0]] * pad, pad

    def _gather(self, rows_padded: List[int]) -> smodel.State:
        """The state a tick's step takes: pools pass through whole (no
        batch axis); each recurrent entry is a copy of the tick's rows."""
        if len(self._pooled) == len(self.state):
            return self.state
        idx = torch.tensor(rows_padded, dtype=torch.long, device=self.device)
        return tuple(entry if p in self._pooled
                     else {k: v[:, idx] for k, v in entry.items()}
                     for p, entry in enumerate(self.state))

    def _scatter(self, new_state: smodel.State, rows: List[int],
                 good: List[int]) -> None:
        """Write a tick's recurrent rows back, for the healthy rows
        ``good`` (indices into ``rows``) only: a poisoned row keeps its
        pre-tick state.  The pools were written in place by the step."""
        if not good or len(self._pooled) == len(self.state):
            return
        src = torch.tensor(good, dtype=torch.long, device=self.device)
        dst = torch.tensor([rows[i] for i in good], dtype=torch.long,
                           device=self.device)
        for p, entry in enumerate(new_state):
            if p not in self._pooled:
                for k, v in entry.items():
                    self.state[p][k][:, dst] = v[:, src]

    def _zero_row(self, row: int) -> None:
        """Reset one row's recurrent state and length (pool blocks need no
        reset on admit: every position below kv_len is freshly written)."""
        self.cache_len[row] = 0
        for p, entry in enumerate(self.state):
            if p not in self._pooled:
                for v in entry.values():
                    v[:, row] = 0

    def _tensor(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def _batch_of(self, toks: np.ndarray) -> Dict[str, torch.Tensor]:
        """A step's batch: token ids, or their embeddings for an
        ``embeds``-mode model."""
        toks_t = self._tensor(toks)
        if self.cfg.input_mode == "embeds":
            return {"embeds": smodel.token_embeds(self.params, self.cfg,
                                                  toks_t)}
        return {"tokens": toks_t}

    def _sample(self, row: np.ndarray) -> int:
        if self.temperature > 0:
            probs = torch.softmax(torch.from_numpy(row) / self.temperature,
                                  dim=-1)
            return int(torch.multinomial(probs, 1, generator=self.gen))
        return int(np.argmax(row))

    def _emit(self, req: Request, tok: int) -> None:
        now = time.perf_counter()
        req.out_tokens.append(tok)
        if req.t_first is None:
            if req.t_submit is not None:
                _metrics.observe("serving.ttft_s", now - req.t_submit)
            req.t_first = now
        else:
            _metrics.observe("serving.itl_s", now - req.t_last)
        req.t_last = now
        _metrics.inc("serving.tokens")
        if len(req.out_tokens) >= req.max_new_tokens:
            self._finish(req)

    def _finish(self, req: Request) -> None:
        req.status = "done"
        self.done[req.rid] = req
        self.active.pop(req.rid, None)
        self.kv.release(req.slot)

    def _tables(self, rows: List[int], pad: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        bt = np.vstack([self.kv.table_rows(rows),
                        self.kv.sentinel_rows(pad)])
        cl = np.concatenate([self.cache_len[rows], np.zeros((pad,), np.int32)])
        return self._tensor(bt), self._tensor(cl)

    def _healthy(self, logits: torch.Tensor, n: int
                 ) -> Tuple[np.ndarray, List[int]]:
        np_logits = logits[:n].float().cpu().numpy()
        good = [i for i in range(n) if np.isfinite(np_logits[i]).all()]
        return np_logits, good

    def _prefill_tick(self, rows: List[int]) -> Dict[int, int]:
        by_row = self._by_row()
        reqs = [by_row[r] for r in rows]
        c = self.sched.config.prefill_chunk
        rows_padded, pad = self._padded_rows(rows)
        bucket = len(rows) + pad
        toks = np.zeros((bucket, c), np.int32)
        n_tok = np.zeros((bucket,), np.int32)
        for i, req in enumerate(reqs):
            m = min(c, len(req.prompt) - req.prefilled)
            toks[i, :m] = req.prompt[req.prefilled:req.prefilled + m]
            n_tok[i] = m
        bt, cl = self._tables(rows, pad)
        logits, new_state, _ = self.engines["prefill"](
            self.params, self._gather(rows_padded), bt, cl,
            self._tensor(n_tok), self._batch_of(toks))
        np_logits, good = self._healthy(logits, len(rows))
        self._scatter(new_state, rows, good)
        out: Dict[int, int] = {}
        for i in good:
            req = reqs[i]
            self.cache_len[req.slot] += n_tok[i]
            req.prefilled += int(n_tok[i])
            if req.prefilled >= len(req.prompt) and req.emit_first:
                tok = self._sample(np_logits[i])
                self._emit(req, tok)
                out[req.rid] = tok
        for i in range(len(rows)):
            if i not in good:
                self._charge_retry(reqs[i], "non-finite logits")
        return out

    def _decode_tick(self, rows: List[int]) -> Dict[int, int]:
        by_row = self._by_row()
        # Defense in depth behind the admit-time budget reservation.
        for r in list(rows):
            if int(self.cache_len[r]) >= self.kv.capacity_of(r):
                self._evict(by_row[r],
                            f"KV cache exhausted mid-decode "
                            f"(cache_size={self.cache.max_seq_len})")
                rows.remove(r)
        if not rows:
            return {}
        reqs = [by_row[r] for r in rows]
        rows_padded, pad = self._padded_rows(rows)
        toks = np.zeros((len(rows) + pad, 1), np.int32)
        for i, req in enumerate(reqs):
            toks[i, 0] = (req.out_tokens[-1] if req.out_tokens
                          else int(req.prompt[-1]))
        bt, cl = self._tables(rows, pad)
        logits, new_state, _ = self.engines["decode"](
            self.params, self._gather(rows_padded), bt, cl,
            self._batch_of(toks))
        # Containment: only healthy rows advance (their recurrent state
        # and cache_len); poisoned requests are charged a bounded retry.
        np_logits, good = self._healthy(logits, len(rows))
        self._scatter(new_state, rows, good)
        out: Dict[int, int] = {}
        for i in good:
            req = reqs[i]
            self.cache_len[req.slot] += 1
            tok = self._sample(np_logits[i])
            self._emit(req, tok)
            out[req.rid] = tok
        for i in range(len(rows)):
            if i not in good:
                self._charge_retry(reqs[i], "non-finite logits")
        return out

    # -------------------------------------------------------- failure paths
    def _tick_failed(self, exc: BaseException, rows: Tuple[int, ...]
                     ) -> None:
        """The whole batched step failed (a runtime-class failure or an
        injected fault): charge every participating request one retry,
        back off, and let the next tick try again (exact: module
        docstring)."""
        _metrics.inc("serve.tick_failures")
        record_event("serve_tick_failed", error=str(exc),
                     active=len(self.active))
        warn_once(f"serve_tick:{type(exc).__name__}",
                  f"serve tick failed ({type(exc).__name__}: {exc}); "
                  f"retrying active requests (bounded by RetryPolicy)")
        by_row = self._by_row()
        for r in rows:
            req = by_row.get(r)
            if req is not None:
                self._charge_retry(req, f"tick failed: "
                                        f"{type(exc).__name__}: {exc}")
        if self.retry.backoff_s > 0:
            time.sleep(self.retry.backoff_s)

    def _charge_retry(self, req: Request, why: str) -> None:
        req.retries += 1
        _metrics.inc("serve.retries")
        if req.retries > self.retry.max_retries:
            self._evict(req, f"{why} (after {req.retries - 1} retries)")

    def _scrub_blocks(self, blocks: List[int]) -> None:
        """Zero an evicted request's pool blocks: attention masks positions
        past kv_len, but a NaN value row would still poison the weighted
        sum (0 * NaN = NaN)."""
        if not blocks:
            return
        idx = torch.as_tensor(blocks, dtype=torch.long, device=self.device)
        for p, entry in enumerate(self.state):
            if p in self._pooled:
                for pool in entry.values():
                    pool[:, idx] = 0

    def _evict(self, req: Request, error: str) -> None:
        """Remove a poisoned request mid-flight: scrub and free its blocks,
        reset its row, mark it failed.  Neighbours keep decoding."""
        self.active.pop(req.rid, None)
        if req.slot >= 0:
            self._scrub_blocks(self.kv.blocks_of(req.slot))
            self.kv.release(req.slot)
            self._zero_row(req.slot)
        _metrics.inc("serve.evictions")
        record_event("serve_evicted", rid=req.rid, slot=req.slot,
                     error=error)
        self._fail(req, error)

    def _fail(self, req: Request, error: str) -> None:
        req.status = "failed"
        req.error = error
        self.failed[req.rid] = req
        _metrics.inc("serve.requests_failed")

    def _watchdog(self, what: str, elapsed_s: float) -> None:
        """Soft deadline: a launch cannot be preempted, so an overrun is
        counted and warned (once per site), not interrupted."""
        deadline = self.retry.deadline_s
        if deadline is None or elapsed_s <= deadline:
            return
        _metrics.inc("serve.watchdog_exceeded")
        warn_once(f"serve_watchdog:{what}",
                  f"{what} took {elapsed_s:.3f}s "
                  f"(RetryPolicy.deadline_s={deadline}); the launch cannot "
                  f"be preempted -- counted as serve.watchdog_exceeded")

    # ------------------------------------------------------------- lifecycle
    def reset(self) -> None:
        """Return to an empty engine (pools zeroed, scheduler reset),
        keeping the compiled signatures: a second identical workload
        compiles nothing."""
        self.kv = PagedKVCache(self.cache, self.max_batch)
        self.state = smodel.init_state(self.cfg, self.max_batch, self.cache,
                                       device=self.device)
        self.cache_len = np.zeros((self.max_batch,), np.int32)
        self.queue.clear()
        self.active.clear()
        self.done.clear()
        self.failed.clear()
        self.tick_log.clear()
        self.sched.reset()
        self.gen = torch.Generator().manual_seed(self.seed)

    def stats(self) -> dict:
        eng = {name: {"hits": e.stats.hits, "misses": e.stats.misses,
                      "compile_time_s": e.stats.compile_time_s}
               for name, e in self.engines.items()}
        return {"kv": self.kv.stats(), "scheduler": self.sched.stats(),
                "engines": eng,
                "requests": {"queued": len(self.queue),
                             "active": len(self.active),
                             "done": len(self.done),
                             "failed": len(self.failed)}}
