"""Paged KV cache: fixed-size blocks, free-list allocator, block tables.

A copy of ``repro.serving.kv_cache`` (numpy only; the port imports nothing
of ``repro``).

The serving engine's KV memory is one global pool of ``num_blocks`` blocks
of ``block_size`` token positions each (per attention layer, per KV head —
the device arrays live in the engine's state pytree; this module owns the
*bookkeeping*: which request holds which blocks).  vLLM-style paging:

* Admission allocates a request's whole budget up front
  (``ceil((prompt + max_new) / block_size)`` blocks), so a request that
  enters the batch can never OOM mid-decode — admission is the only
  failure point, and it reuses the resilience rejection path (a clear
  ``failed`` status, never a silent overflow).
* Appending a token is copy-free: the engine scatters the new K/V row into
  ``pool[block_table[row, pos // bs], :, pos % bs]`` — no per-step
  reshuffle of earlier positions, regardless of how ragged the batch is.
* Release (completion or eviction) returns the blocks to the free list;
  a freed block is safe to reuse immediately because readers mask on
  ``k_pos < kv_len`` and every position below a request's ``kv_len`` has
  been freshly written by that request.

Block tables are host-side ``np.int32`` arrays of shape
``(max_batch, max_blocks_per_req)``; unallocated slots hold the sentinel
``num_blocks`` (one past the real blocks): the serving model sends writes
through them to the pool's spare block at that id
(:func:`repro_torch.serving.model.write_index`), gathers clamp into
real-but-masked blocks, and the decode kernel never reads them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["CacheConfig", "BlockAllocator", "PagedKVCache"]


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    """Sizing of the paged pool.

    ``max_seq_len`` is the per-request position bound (prompt + generated
    tokens) — the paged analogue of the old slot server's ``cache_size``;
    ``num_blocks`` bounds the *total* memory across all requests, which is
    what continuous batching actually shares.
    """

    block_size: int = 16
    num_blocks: int = 64
    max_seq_len: int = 256

    def __post_init__(self) -> None:
        if self.block_size <= 0:
            raise ValueError(f"block_size must be > 0, got {self.block_size}")
        if self.num_blocks <= 0:
            raise ValueError(f"num_blocks must be > 0, got {self.num_blocks}")

    @property
    def max_blocks_per_req(self) -> int:
        """Table width: blocks a full-budget request can hold."""
        return -(-self.max_seq_len // self.block_size)

    def blocks_for(self, num_positions: int) -> int:
        """Blocks needed to hold ``num_positions`` token positions."""
        return max(1, -(-num_positions // self.block_size))


class BlockAllocator:
    """LIFO free-list over ``num_blocks`` block ids.

    LIFO keeps recently-freed (cache-warm, and in tests: *identifiable*)
    blocks hot; allocation is all-or-nothing so admission can never
    half-succeed.
    """

    def __init__(self, num_blocks: int) -> None:
        self.num_blocks = num_blocks
        # Stack: pop from the end.  Initialized so the first allocations
        # hand out low block ids (0, 1, ...) in order.
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_used(self) -> int:
        return self.num_blocks - len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """Take ``n`` blocks, or ``None`` (and take nothing) if fewer than
        ``n`` are free."""
        if n < 0:
            raise ValueError(f"cannot allocate {n} blocks")
        if n > len(self._free):
            return None
        taken = [self._free.pop() for _ in range(n)]
        return taken

    def free(self, blocks: List[int]) -> None:
        for b in blocks:
            if not 0 <= b < self.num_blocks:
                raise ValueError(f"block id {b} out of range "
                                 f"[0, {self.num_blocks})")
            if b in self._free:
                raise ValueError(f"double free of block {b}")
        # Reverse so a free-then-alloc of the same count returns the same
        # ids in the same order (exercised by the reuse tests).
        self._free.extend(reversed(blocks))


class PagedKVCache:
    """Per-request block-table bookkeeping over one :class:`BlockAllocator`.

    Rows are engine batch-row ids (0..max_batch-1); the device-side pools
    live in the serving model state, this class only tracks *which* blocks
    each row owns and renders the int32 block tables the paged attention
    op consumes.
    """

    def __init__(self, config: CacheConfig, max_batch: int) -> None:
        self.config = config
        self.max_batch = max_batch
        self.allocator = BlockAllocator(config.num_blocks)
        #: Sentinel = num_blocks: one past the real blocks; writes through
        #: it land in the pools' spare block, which nothing reads.
        self.sentinel = config.num_blocks
        self._tables = np.full(
            (max_batch, config.max_blocks_per_req), self.sentinel, np.int32)
        self._blocks: Dict[int, List[int]] = {}

    # -------------------------------------------------------------- admission
    def admission_error(self, prompt_len: int,
                        max_new_tokens: int) -> Optional[str]:
        """Permanent (won't-ever-fit) rejection reason, or None.

        Transient pressure (blocks currently held by other requests) is NOT
        an error — the scheduler queues those requests instead.
        """
        budget = prompt_len + max(max_new_tokens, 0)
        if budget > self.config.max_seq_len:
            return (f"request needs {budget} KV-cache positions "
                    f"(prompt {prompt_len} + max_new_tokens "
                    f"{max_new_tokens}) but cache_size is "
                    f"{self.config.max_seq_len}")
        if self.config.blocks_for(budget) > self.config.num_blocks:
            return (f"request needs {self.config.blocks_for(budget)} KV "
                    f"blocks but the paged pool has only "
                    f"{self.config.num_blocks}")
        return None

    def can_admit(self, prompt_len: int, max_new_tokens: int) -> bool:
        """True when the request's whole budget is allocatable right now."""
        budget = prompt_len + max(max_new_tokens, 0)
        return (self.admission_error(prompt_len, max_new_tokens) is None
                and self.config.blocks_for(budget) <= self.allocator.num_free)

    def admit(self, row: int, prompt_len: int, max_new_tokens: int) -> bool:
        """Allocate ``row``'s full budget.  False when blocks are short
        (nothing allocated); raises on a permanent sizing error (callers
        must check :meth:`admission_error` first) or an occupied row."""
        why = self.admission_error(prompt_len, max_new_tokens)
        if why is not None:
            raise ValueError(why)
        if row in self._blocks:
            raise ValueError(f"row {row} already holds blocks")
        budget = prompt_len + max(max_new_tokens, 0)
        blocks = self.allocator.alloc(self.config.blocks_for(budget))
        if blocks is None:
            return False
        self._blocks[row] = blocks
        self._tables[row, :] = self.sentinel
        self._tables[row, :len(blocks)] = blocks
        return True

    # ---------------------------------------------------------------- release
    def release(self, row: int) -> int:
        """Free ``row``'s blocks (no-op for an empty row); returns how many
        blocks were returned to the pool."""
        blocks = self._blocks.pop(row, None)
        self._tables[row, :] = self.sentinel
        if not blocks:
            return 0
        self.allocator.free(blocks)
        return len(blocks)

    # ---------------------------------------------------------------- reading
    def blocks_of(self, row: int) -> List[int]:
        return list(self._blocks.get(row, ()))

    def capacity_of(self, row: int) -> int:
        """Token positions ``row``'s allocated blocks can hold."""
        return len(self._blocks.get(row, ())) * self.config.block_size

    def table_rows(self, rows: List[int]) -> np.ndarray:
        """Block-table slice for an engine call: (len(rows), MB) int32."""
        return self._tables[np.asarray(rows, np.int64)]

    def sentinel_rows(self, n: int) -> np.ndarray:
        """All-sentinel table rows for batch padding: writes are masked, reads
        clamp into masked-out positions."""
        return np.full((n, self.config.max_blocks_per_req), self.sentinel,
                       np.int32)

    def stats(self) -> Dict[str, float]:
        """Occupancy/fragmentation counters (``ServeEngine.stats``, the
        allocator tests): internal fragmentation is the tail waste of
        partially-resident budgets — allocated positions that can never be
        used because budgets are not block-multiples."""
        used = self.allocator.num_used
        cfg = self.config
        waste = sum(len(b) * cfg.block_size for b in self._blocks.values())
        # subtract each row's actual budgeted positions lazily: callers that
        # need exact per-row waste pass budgets; here we report pool-level
        # occupancy only.
        return {
            "num_blocks": float(cfg.num_blocks),
            "blocks_used": float(used),
            "blocks_free": float(self.allocator.num_free),
            "utilization": used / cfg.num_blocks,
            "resident_requests": float(len(self._blocks)),
            "resident_positions": float(waste),
        }
