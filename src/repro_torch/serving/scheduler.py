"""Mode-batching continuous scheduler: which phase runs this tick.

A copy of ``repro.serving.scheduler`` (pure Python; the port imports
nothing of ``repro``).

Serving alternates between two kinds of work that land on *opposite ends*
of the SMA substrate (paper Sec. III): prefill chunks are GEMM-shaped and
run in systolic mode; decode steps are memory-bound cache sweeps and run in
SIMD mode.  On a temporal architecture every phase flip is a mode switch —
drain the pipeline, reconfigure the PE array — so the scheduler's job is
not just fairness but *mode hygiene*: group same-mode work into consecutive
ticks and pay the switch as rarely as latency targets allow.

Two policies, same admission semantics (every tick admits, prefill is
chunked, nothing blocks behind a long prompt):

* ``fcfs`` — the naive baseline: any pending prefill work preempts decode,
  one request's chunk per tick.  Under mixed load this ping-pongs
  systolic/SIMD nearly every tick.
* ``sma`` — mode-batched: (a) prefill chunks of *all* waiting requests (up
  to ``max_prefill_batch``) share one systolic tick, and (b) hysteresis —
  once in a phase, stay for at least ``mode_min_run`` ticks while both
  phases have work, so switches amortize over runs of same-mode ticks.

The scheduler is pure host-side bookkeeping: it sees row ids, never
tensors.  It counts the realized switches itself (``switches``).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

__all__ = ["SchedulerConfig", "TickPlan", "ModeScheduler"]

_POLICIES = ("sma", "fcfs")

#: phase -> SMA execution mode.
PHASE_MODE = {"prefill": "systolic", "decode": "simd"}


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Knobs for the mode-batching scheduler.

    policy:
        ``"sma"`` (mode-batched, the default) or ``"fcfs"`` (naive
        prefill-first baseline).
    prefill_chunk:
        Tokens per prefill chunk per request.  Also the padded chunk width
        of the compiled prefill step, so it bounds the number of compile
        signatures (one per batch bucket) regardless of prompt lengths.
    max_prefill_batch:
        Max requests sharing one systolic prefill tick (``sma`` only;
        ``fcfs`` always takes one).
    mode_min_run:
        Minimum consecutive ticks to stay in the current phase while both
        phases have work (``sma`` hysteresis).  1 disables hysteresis.
    """

    policy: str = "sma"
    prefill_chunk: int = 32
    max_prefill_batch: int = 8
    mode_min_run: int = 4

    def __post_init__(self) -> None:
        if self.policy not in _POLICIES:
            raise ValueError(
                f"unknown scheduler policy {self.policy!r} "
                f"(expected one of {_POLICIES})")
        if self.prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        if self.max_prefill_batch < 1:
            raise ValueError("max_prefill_batch must be >= 1")
        if self.mode_min_run < 1:
            raise ValueError("mode_min_run must be >= 1")


@dataclasses.dataclass(frozen=True)
class TickPlan:
    """One tick's worth of same-mode work.

    phase: ``"prefill"`` | ``"decode"`` | ``"idle"``.
    rows: engine rows participating this tick (prefill: the rows whose
    next chunk runs; decode: all rows with decode budget left).
    switched: True when this tick's phase differs from the previously
    *executed* phase (idle ticks don't reset the run).
    """

    phase: str
    rows: Tuple[int, ...]
    switched: bool

    @property
    def mode(self) -> Optional[str]:
        return PHASE_MODE.get(self.phase)


class ModeScheduler:
    """Decide each tick's phase and participants; count realized switches."""

    def __init__(self, config: Optional[SchedulerConfig] = None) -> None:
        self.config = config or SchedulerConfig()
        self.switches = 0          # phase flips between executed ticks
        self.ticks = 0             # executed (non-idle) ticks
        self._phase: Optional[str] = None
        self._run = 0              # consecutive ticks in current phase

    def reset(self) -> None:
        self.switches = 0
        self.ticks = 0
        self._phase = None
        self._run = 0

    # ------------------------------------------------------------- planning
    def plan(self, prefill_rows: Sequence[int],
             decode_rows: Sequence[int]) -> TickPlan:
        """Pick this tick's phase given the rows with pending work.

        ``prefill_rows``: rows with un-prefilled prompt tokens remaining
        (FIFO order — callers pass them oldest-first).  ``decode_rows``:
        rows that are past prefill and still have token budget.
        """
        cfg = self.config
        if not prefill_rows and not decode_rows:
            return TickPlan("idle", (), False)
        if not decode_rows:
            phase = "prefill"
        elif not prefill_rows:
            phase = "decode"
        elif cfg.policy == "fcfs":
            # Naive: prompt work always preempts decode.
            phase = "prefill"
        else:
            # sma: hysteresis — hold the current phase for mode_min_run
            # ticks when both phases have work, then yield to the other.
            if self._phase in ("prefill", "decode") \
                    and self._run < cfg.mode_min_run:
                phase = self._phase
            else:
                phase = "decode" if self._phase == "prefill" else "prefill"

        if phase == "prefill":
            width = 1 if cfg.policy == "fcfs" else cfg.max_prefill_batch
            rows = tuple(prefill_rows[:width])
        else:
            rows = tuple(decode_rows)
        return self._commit(phase, rows)

    def _commit(self, phase: str, rows: Tuple[int, ...]) -> TickPlan:
        switched = self._phase is not None and phase != self._phase
        if switched:
            self.switches += 1
            self._run = 1
        else:
            self._run += 1
        self._phase = phase
        self.ticks += 1
        return TickPlan(phase, rows, switched)

    # ------------------------------------------------------------ reporting
    def stats(self) -> dict:
        return {
            "policy": self.config.policy,
            "ticks": self.ticks,
            "mode_switches": self.switches,
            "current_phase": self._phase,
            "current_run": self._run,
        }


def chunk_spans(prompt_len: int, chunk: int) -> List[Tuple[int, int]]:
    """Split a prompt into (start, n_tokens) chunk spans of width ``chunk``
    (last one ragged).  Pure helper shared by engine and tests."""
    if prompt_len <= 0:
        return []
    return [(s, min(chunk, prompt_len - s))
            for s in range(0, prompt_len, chunk)]
