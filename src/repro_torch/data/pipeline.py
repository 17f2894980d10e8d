"""Deterministic synthetic token pipeline (counterpart of
``repro.data.pipeline``, token mode).

``make_batch`` is a copy, numpy only, of the JAX package's: batch ``i`` is
a pure function of ``(seed, i)``, tokens follow a noisy affine bigram over
a Zipf-ish start, and the arrays are bit-identical to the reference's.
:class:`DataPipeline` yields them as int32 tensors on the device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    noise: float = 0.1          # fraction of uniformly random tokens


def _bigram_params(seed: int, vocab: int) -> tuple[int, int]:
    rng = np.random.RandomState(seed)
    a = int(rng.randint(1, vocab - 1)) | 1  # odd => full-period-ish
    c = int(rng.randint(0, vocab - 1))
    return a, c


def make_batch(cfg: DataConfig, step: int) -> Dict[str, np.ndarray]:
    """Batch ``step`` as host numpy: ``tokens`` and ``labels`` (B, S)
    int32, labels the tokens shifted by one."""
    rng = np.random.RandomState((cfg.seed * 1_000_003 + step) % (2 ** 31))
    b, s, v = cfg.global_batch, cfg.seq_len, cfg.vocab_size
    a, c = _bigram_params(cfg.seed, v)

    start = rng.zipf(1.3, size=(b, 1)).astype(np.int64) % v
    toks = np.empty((b, s + 1), np.int64)
    toks[:, :1] = start
    noise_mask = rng.rand(b, s) < cfg.noise
    noise_tok = rng.randint(0, v, size=(b, s))
    for t in range(s):
        nxt = (a * toks[:, t] + c) % v
        toks[:, t + 1] = np.where(noise_mask[:, t], noise_tok[:, t], nxt)
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}


@dataclasses.dataclass
class PipelineState:
    """The cursor: the step of the next batch (checkpointing it comes with
    the trainer's checkpoint/resume)."""
    next_step: int = 0


class DataPipeline:
    """Iterator over batches 0, 1, 2, ... of ``cfg``, with the cursor in
    ``state``; batches land on ``device`` (``cuda`` unless the caller says
    otherwise)."""

    def __init__(self, cfg: DataConfig, *, device: DeviceLike = None) -> None:
        self.cfg = cfg
        self.device = resolve_device(device)
        self.state = PipelineState()

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        batch = make_batch(self.cfg, self.state.next_step)
        self.state.next_step += 1
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in batch.items()}
