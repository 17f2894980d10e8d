"""Deterministic synthetic data pipeline (counterpart of
``repro.data.pipeline``).

``make_batch`` is a copy, numpy only, of the JAX package's: batch ``i`` is
a pure function of ``(seed, i)``, tokens follow a noisy affine bigram over
a Zipf-ish start, and the arrays are bit-identical to the reference's in
all three input modes: ``tokens``; ``embeds`` (the audio stub: sinusoidal
frame embeddings of the tokens, no ``tokens`` key); ``tokens+vision``
(random vision embeddings ahead of the first S - Sv tokens, labels -1 on
the vision positions).  :class:`DataPipeline` yields them as tensors on
the device: tokens and labels int32, embeddings float32.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

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
    input_mode: str = "tokens"  # tokens | embeds | tokens+vision
    d_model: int = 0            # for the embeds modes
    num_vision_tokens: int = 0


def _bigram_params(seed: int, vocab: int) -> tuple[int, int]:
    rng = np.random.RandomState(seed)
    a = int(rng.randint(1, vocab - 1)) | 1  # odd => full-period-ish
    c = int(rng.randint(0, vocab - 1))
    return a, c


def make_batch(cfg: DataConfig, step: int) -> Dict[str, np.ndarray]:
    """Batch ``step`` as host numpy: ``labels`` (B, S) int32, the tokens
    shifted by one, and by ``cfg.input_mode``: ``tokens`` (B, S) int32;
    ``embeds`` (B, S, d_model) float32; or ``tokens`` (B, S - Sv) with
    ``vision_embeds`` (B, Sv, d_model) float32 and labels -1 on the Sv
    vision positions."""
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

    tokens = toks[:, :-1].astype(np.int32)
    labels = toks[:, 1:].astype(np.int32)
    if cfg.input_mode == "embeds":
        # Frame embeddings derived from the tokens (a fixed sinusoidal
        # codebook), so the label structure stays learnable.
        phase = tokens[..., None].astype(np.float32)
        embeds = np.sin(
            phase * (np.arange(cfg.d_model, dtype=np.float32) + 1.0)
            * (2 * np.pi / cfg.vocab_size)).astype(np.float32)
        return {"embeds": embeds, "labels": labels}
    if cfg.input_mode == "tokens+vision":
        nv = cfg.num_vision_tokens
        vision = rng.randn(b, nv, cfg.d_model).astype(np.float32) * 0.02
        labels = labels.copy()
        labels[:, :nv] = -1  # no loss on the vision positions
        return {"tokens": tokens[:, : s - nv], "vision_embeds": vision,
                "labels": labels}
    return {"tokens": tokens, "labels": labels}


@dataclasses.dataclass
class PipelineState:
    """The cursor: the step of the next batch.  It rides in every
    checkpoint of the trainer as ``to_dict()``."""
    next_step: int = 0

    def to_dict(self) -> Dict[str, int]:
        return {"next_step": self.next_step}

    @classmethod
    def from_dict(cls, d: Dict[str, int]) -> "PipelineState":
        return cls(next_step=int(d["next_step"]))


class DataPipeline:
    """Iterator over batches ``state.next_step``, ``+ 1``, ... of ``cfg``
    (from 0 unless a saved ``state`` is given); batches land on ``device``
    (``cuda`` unless the caller says otherwise)."""

    def __init__(self, cfg: DataConfig, *, device: DeviceLike = None,
                 state: Optional[PipelineState] = None) -> None:
        self.cfg = cfg
        self.device = resolve_device(device)
        self.state = state or PipelineState()

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        batch = make_batch(self.cfg, self.state.next_step)
        self.state.next_step += 1
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in batch.items()}
