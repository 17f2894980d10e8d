"""Paged-state model steps: decode and chunked prefill over block tables
(counterpart of ``repro.serving.model``, ``attn`` blocks).

State is a tuple with one entry per pattern position; an ``attn`` entry is
``{"k", "v"}: (num_groups, num_blocks, Hkv, block_size, head_dim)`` with no
batch axis.  Which blocks belong to which request is carried by the
``block_table`` argument.

Two entry points, one per serving phase:

* :func:`paged_decode_step` -- one token per row.
* :func:`paged_prefill_step` -- a C-token chunk per row with per-row valid
  counts ``n_tokens``; logits are taken at each row's last valid position.

**The pools are updated in place.**  Position ``p`` of a row lands at
``pool[table[row, p // bs], :, p % bs]``.  The JAX package drops writes to
the sentinel block id (``== num_blocks``) with ``mode="drop"``; PyTorch has
no such mode and an out-of-range index on CUDA is a device-side assert, so
:func:`write_index` selects the writes to keep once per step (masking
sentinel, out-of-table and padding positions) and every layer writes
through that selection.  The selection is one host sync per step.

Weights are used as they are stored (the activation dtype); every
projection is an :func:`repro_torch.kernels.ops.sma_gemm`, the head is
:func:`repro_torch.kernels.ops.rmsnorm_gemm`, and attention is
:func:`repro_torch.kernels.ops.paged_decode_attention`.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import attention
from repro_torch.models.layers import embed_apply, rmsnorm_apply
from repro_torch.models.lm import (State, check_pattern, head, mlp_residual,
                                   unstack)
from repro_torch.serving.kv_cache import CacheConfig

__all__ = ["init_state", "paged_decode_step", "paged_prefill_step",
           "pooled_positions", "write_index"]

def init_state(cfg: ModelConfig, cache: CacheConfig,
               dtype: Optional[torch.dtype] = None,
               device: DeviceLike = None) -> State:
    """Zeroed paged pools, one ``{"k", "v"}`` entry per pattern position.
    Paged pools have no batch axis, so unlike the JAX function this takes
    no ``max_batch``.  The paged steps run ``attn`` blocks only."""
    check_pattern(cfg, ("attn",))
    dev = resolve_device(device)
    dtype = dtype or cfg.activation_dtype
    shape = (cfg.num_groups, cache.num_blocks, cfg.num_kv_heads,
             cache.block_size, cfg.resolved_head_dim)
    return tuple({"k": torch.zeros(shape, dtype=dtype, device=dev),
                  "v": torch.zeros(shape, dtype=dtype, device=dev)}
                 for _ in cfg.block_pattern)


def pooled_positions(cfg: ModelConfig) -> Tuple[int, ...]:
    """Pattern positions whose state entry is a paged pool."""
    return tuple(p for p, bt in enumerate(cfg.block_pattern)
                 if bt in ("attn", "local"))


class WriteIndex(NamedTuple):
    """The pool writes one step keeps: ``keep`` (B, C) marks them,
    ``rows`` index them in the flattened (B*C) positions, and
    ``blocks``/``offsets`` say where each lands."""

    keep: torch.Tensor
    rows: torch.Tensor
    blocks: torch.Tensor
    offsets: torch.Tensor


def write_index(block_table: torch.Tensor, pos: torch.Tensor,
                num_blocks: int, block_size: int,
                valid: Optional[torch.Tensor] = None) -> WriteIndex:
    """Select the writes of positions ``pos`` (B, C) that land in a real
    block: positions past the table, sentinel entries (>= num_blocks) and
    positions masked by ``valid`` (B, C) write nowhere, as the JAX scatter
    with ``mode="drop"`` does."""
    mb = block_table.shape[1]
    pos = pos.long()
    idx = pos // block_size
    blk = torch.gather(block_table.long(), 1, idx.clamp(0, mb - 1))
    keep = (idx < mb) & (blk >= 0) & (blk < num_blocks)
    if valid is not None:
        keep &= valid
    rows = keep.reshape(-1).nonzero().squeeze(1)
    return WriteIndex(keep, rows, blk.reshape(-1)[rows],
                      (pos % block_size).reshape(-1)[rows])


def _pool_write(pool: torch.Tensor, widx: WriteIndex,
                val: torch.Tensor) -> None:
    """Write val (B, C, Hkv, D) into pool (NB, Hkv, BS, D), in place."""
    flat = val.reshape(-1, *val.shape[-2:])[widx.rows]
    pool[widx.blocks, :, widx.offsets] = flat.to(pool.dtype)


def _paged_attn(bparams: dict, x: torch.Tensor, pools: dict,
                block_table: torch.Tensor, q_pos: torch.Tensor,
                kv_len: torch.Tensor, widx: WriteIndex,
                cfg: ModelConfig) -> torch.Tensor:
    """Attention over the paged pool for a (B, C, D) chunk (C=1: decode):
    write the chunk's K/V into the pool, attend, project out.  Returns the
    residual branch (B, C, D)."""
    b, c, _ = x.shape
    h = rmsnorm_apply(bparams["norm1"], x)
    q, k, v = attention._project_qkv(bparams["mixer"], h, cfg, q_pos)
    _pool_write(pools["k"], widx, k)
    _pool_write(pools["v"], widx, v)
    out = ops.paged_decode_attention(q, pools["k"], pools["v"], block_table,
                                     q_pos, kv_len)
    return ops.sma_gemm(out.reshape(b, c, -1), bparams["mixer"]["wo"])


def _layers(params: dict, state: State, x: torch.Tensor,
            block_table: torch.Tensor, q_pos: torch.Tensor,
            kv_len: torch.Tensor, widx: WriteIndex,
            cfg: ModelConfig) -> torch.Tensor:
    """Every group, every pattern position, in order."""
    groups = [unstack(p, cfg.num_groups) for p in params["blocks"]]
    for g in range(cfg.num_groups):
        for p in range(len(cfg.block_pattern)):
            bparams = groups[p][g]
            pools = {"k": state[p]["k"][g], "v": state[p]["v"][g]}
            x = x + _paged_attn(bparams, x, pools, block_table, q_pos,
                                kv_len, widx, cfg)
            x = mlp_residual(bparams, x)
    return x


def _start(state: State, block_table: torch.Tensor, q_pos: torch.Tensor,
           valid: Optional[torch.Tensor]) -> WriteIndex:
    _, nb, _, bs, _ = state[0]["k"].shape
    return write_index(block_table, q_pos, nb, bs, valid)


def paged_decode_step(params: dict, state: State,
                      block_table: torch.Tensor, cache_len: torch.Tensor,
                      cfg: ModelConfig, batch: Dict[str, torch.Tensor]
                      ) -> Tuple[torch.Tensor, State, torch.Tensor]:
    """One token per row against the paged pool.

    block_table (B, MB) int32; cache_len (B,) -- the position this step
    writes; batch ``tokens`` (B, 1).  Returns (logits (B, Vpad), state
    (updated in place), cache_len + 1).

    A row whose new position has no block (a batch-padding row with an
    all-sentinel table) attends over nothing and gets a zero attention
    output, so no kernel reads a sentinel entry; the JAX step reads a
    clamped block there instead.  Such rows' logits are never used.
    """
    cache_len = cache_len.long()
    q_pos = cache_len[:, None]
    widx = _start(state, block_table, q_pos, None)
    kv_len = torch.where(widx.keep[:, 0], cache_len + 1, 0)
    x = embed_apply(params["embed"], batch["tokens"])          # (B, 1, D)
    x = _layers(params, state, x, block_table, q_pos, kv_len, widx, cfg)
    return head(params, x)[:, 0], state, cache_len + 1


def paged_prefill_step(params: dict, state: State,
                       block_table: torch.Tensor, cache_len: torch.Tensor,
                       n_tokens: torch.Tensor, cfg: ModelConfig,
                       batch: Dict[str, torch.Tensor]
                       ) -> Tuple[torch.Tensor, State, torch.Tensor]:
    """One prefill chunk per row: C prompt tokens, ``n_tokens`` (B,) valid.

    Pool writes of padding positions are masked.  Returns (logits at each
    row's last valid position (B, Vpad), state (updated in place),
    cache_len + n_tokens).
    """
    cache_len, n_tokens = cache_len.long(), n_tokens.long()
    x = embed_apply(params["embed"], batch["tokens"])          # (B, C, D)
    b, c, _ = x.shape
    steps = torch.arange(c, device=x.device)
    q_pos = cache_len[:, None] + steps[None, :]
    valid = steps[None, :] < n_tokens[:, None]
    kv_len = cache_len + n_tokens
    widx = _start(state, block_table, q_pos, valid)
    x = _layers(params, state, x, block_table, q_pos, kv_len, widx, cfg)
    last = (n_tokens - 1).clamp(0, c - 1)
    x_last = x[torch.arange(b, device=x.device), last][:, None]
    return head(params, x_last)[:, 0], state, kv_len
