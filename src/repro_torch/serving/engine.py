"""ServeEngine: continuous batching over a paged KV cache
(counterpart of ``repro.serving.engine``).

The same request flow as the JAX engine: ``submit`` queues a request,
every ``step`` first admits from the queue into free rows (reserving each
request's whole KV-block budget), then the mode scheduler picks one
same-phase batch -- a prefill chunk for every row still prefilling, or one
decode token for every decoding row -- and the engine runs it.  Batches
are padded to power-of-two row buckets with rows whose block tables are
all-sentinel: their pool writes are masked out and their attention reads
nothing (see ``serving.model``).

Steps run eagerly (no ``sma_jit``) under ``torch.inference_mode()``, so
no autograd bookkeeping reaches the kernel entry points.  Per-row
containment of non-finite logits is kept: only healthy rows advance, a
poisoned request is charged a retry under :class:`RetryPolicy` and evicted
(its blocks zeroed and freed) once the budget is spent.  Greedy sampling is ``argmax``; with
``temperature > 0`` tokens are drawn with the engine's own
``torch.Generator`` (not JAX's bits).  Fault injection, tracing spans and
``obs`` metrics are not ported; each executed tick is recorded in
``tick_log`` as (phase, rows, seconds) instead.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.serving import model as smodel
from repro_torch.serving.kv_cache import CacheConfig, PagedKVCache
from repro_torch.serving.scheduler import (ModeScheduler, SchedulerConfig,
                                           TickPlan)

__all__ = ["Request", "RetryPolicy", "ServeEngine"]


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry for failure-isolated serving (the fields of
    ``repro.resilience.guard.RetryPolicy`` that per-row containment reads;
    its ``backoff_s`` waits for a whole-tick retry, which is not ported).

    ``max_retries`` is per request: a poisoned request is evicted once its
    budget is spent while other rows keep decoding.  ``deadline_s`` is the
    soft watchdog bound on one tick (an overrun is counted and warned, not
    interrupted).
    """

    max_retries: int = 1
    deadline_s: Optional[float] = None


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
    t_submit: Optional[float] = None
    t_admit: Optional[float] = None
    t_first: Optional[float] = None
    t_last: Optional[float] = None


class ServeEngine:
    """Continuous-batching engine: paged KV + SMA mode-batching scheduler.

    ``params`` must already be on ``device`` (``cuda`` unless the caller
    passes ``device="cpu"``).
    """

    def __init__(self, cfg: ModelConfig, params: dict, *,
                 cache: Optional[CacheConfig] = None,
                 max_batch: int = 8,
                 sched: Optional[SchedulerConfig] = None,
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
        self.watchdog_exceeded = 0

        self.kv = PagedKVCache(self.cache, max_batch)
        self.state = smodel.init_state(cfg, self.cache, device=self.device)
        self.cache_len = np.zeros((max_batch,), np.int32)  # host-side truth
        self._pooled = frozenset(smodel.pooled_positions(cfg))

        self.queue: List[Request] = []
        self.active: Dict[int, Request] = {}
        self.done: Dict[int, Request] = {}
        self.failed: Dict[int, Request] = {}
        self.tick_log: List[Tuple[str, int, float]] = []

        # One step function per phase (the JAX engine's sma_jit engines).
        self.steps = {
            "decode": lambda p, s, bt, cl, b: smodel.paged_decode_step(
                p, s, bt, cl, cfg, b),
            "prefill": lambda p, s, bt, cl, nt, b: smodel.paged_prefill_step(
                p, s, bt, cl, nt, cfg, b),
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

    def try_admit(self, req: Request) -> bool:
        """Place a validated request into a free row, reserving its whole
        KV-block budget.  False = no row or no blocks right now."""
        free = self.free_rows()
        if not free:
            return False
        row = free[0]
        if not self.kv.admit(row, len(req.prompt), req.max_new_tokens):
            return False
        req.slot = row
        req.out_tokens = []
        req.status = "active"
        req.prefilled = 0
        req.t_admit = time.perf_counter()
        self.cache_len[row] = 0
        self.active[req.rid] = req
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
        t0 = time.perf_counter()
        out = self._run_plan(plan)
        elapsed = time.perf_counter() - t0
        self.tick_log.append((plan.phase, len(plan.rows), elapsed))
        self._watchdog(elapsed)
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
        if plan.phase == "prefill":
            return self._prefill_tick(list(plan.rows))
        return self._decode_tick(list(plan.rows))

    # ------------------------------------------------------------- internals
    @staticmethod
    def _bucket(n: int) -> int:
        return 1 << max(0, n - 1).bit_length() if n > 1 else 1

    def _pad(self, rows: List[int]) -> int:
        """Padding rows that fill ``rows`` up to its power-of-two bucket."""
        return min(self.max_batch, self._bucket(len(rows))) - len(rows)

    def _tensor(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

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
            req.t_first = now
        req.t_last = now
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
        pad = self._pad(rows)
        bucket = len(rows) + pad
        toks = np.zeros((bucket, c), np.int32)
        n_tok = np.zeros((bucket,), np.int32)
        for i, req in enumerate(reqs):
            m = min(c, len(req.prompt) - req.prefilled)
            toks[i, :m] = req.prompt[req.prefilled:req.prefilled + m]
            n_tok[i] = m
        bt, cl = self._tables(rows, pad)
        logits, _, _ = self.steps["prefill"](
            self.params, self.state, bt, cl, self._tensor(n_tok),
            {"tokens": self._tensor(toks)})
        np_logits, good = self._healthy(logits, len(rows))
        out: Dict[int, int] = {}
        for i in good:
            req = reqs[i]
            self.cache_len[req.slot] += n_tok[i]
            req.prefilled += int(n_tok[i])
            if req.prefilled >= len(req.prompt):
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
        pad = self._pad(rows)
        toks = np.zeros((len(rows) + pad, 1), np.int32)
        for i, req in enumerate(reqs):
            toks[i, 0] = (req.out_tokens[-1] if req.out_tokens
                          else int(req.prompt[-1]))
        bt, cl = self._tables(rows, pad)
        logits, _, _ = self.steps["decode"](
            self.params, self.state, bt, cl, {"tokens": self._tensor(toks)})
        # Containment: only healthy rows advance; poisoned requests are
        # charged a bounded retry.
        np_logits, good = self._healthy(logits, len(rows))
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
    def _charge_retry(self, req: Request, why: str) -> None:
        req.retries += 1
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
            self.cache_len[req.slot] = 0
        self._fail(req, error)

    def _fail(self, req: Request, error: str) -> None:
        req.status = "failed"
        req.error = error
        self.failed[req.rid] = req

    def _watchdog(self, elapsed_s: float) -> None:
        deadline = self.retry.deadline_s
        if deadline is None or elapsed_s <= deadline:
            return
        self.watchdog_exceeded += 1
        if self.watchdog_exceeded == 1:
            warnings.warn(f"serve tick took {elapsed_s:.3f}s "
                          f"(RetryPolicy.deadline_s={deadline}); counted in "
                          f"ServeEngine.watchdog_exceeded", RuntimeWarning)

    # ------------------------------------------------------------- lifecycle
    def reset(self) -> None:
        """Return to an empty engine (pools zeroed, scheduler reset)."""
        self.kv = PagedKVCache(self.cache, self.max_batch)
        self.state = smodel.init_state(self.cfg, self.cache,
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
        return {"kv": self.kv.stats(), "scheduler": self.sched.stats(),
                "requests": {"queued": len(self.queue),
                             "active": len(self.active),
                             "done": len(self.done),
                             "failed": len(self.failed)}}
