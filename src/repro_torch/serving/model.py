"""Paged-state model steps: decode and chunked prefill over block tables
(counterpart of ``repro.serving.model``; block types ``attn``, ``local``,
``rglru``, ``mlstm`` and ``slstm``, dense or MoE).

State is a tuple with one entry per pattern position.  An ``attn`` or
``local`` entry is ``{"k", "v"}: (num_groups, num_blocks + 1, Hkv,
block_size, head_dim)`` with no batch axis (the last block is a spare,
below); which blocks belong to which request is carried by the
``block_table`` argument.  A recurrent entry (RG-LRU, mLSTM, sLSTM) is the
block's dense per-row state stacked over groups, ``(num_groups, B, ...)``,
as :func:`repro_torch.models.lm.init_state` holds it.

Two entry points, one per serving phase:

* :func:`paged_decode_step` -- one token per row.
* :func:`paged_prefill_step` -- a C-token chunk per row with per-row valid
  counts ``n_tokens``; logits are taken at each row's last valid position.
  A recurrent mixer runs the chunk token by token through its decode step
  (:func:`_chunk_mixer_scan`, one :func:`repro_torch.compiler.loop.scan`
  a layer, so a compiled step holds one loop node a recurrent layer),
  merging each row's state only while ``t < n_tokens``.

**The pools are updated in place; recurrent state is not.**  Position
``p`` of a row lands at ``pool[table[row, p // bs], :, p % bs]``.  The JAX
package drops writes to the sentinel block id (``== num_blocks``) with
``mode="drop"``; PyTorch has no such mode and an out-of-range index on
CUDA is a device-side assert, so every pool holds one spare block past the
last real one, at the sentinel id ``num_blocks`` (:func:`init_state`).  No
table hands it out.  :func:`write_index` sends every write that would be
dropped (a sentinel entry, a position past the table, a padding position)
to that block, so each layer writes all B*C positions with one
``index_put_`` whose shapes do not depend on the data: the steps trace
(:func:`repro_torch.sma_jit`) and need no host sync.  Attention reads
``pool[:num_blocks]``, a contiguous view, so the first ``num_blocks``
blocks are the JAX pools, bit for bit, and nothing reads the spare block.
A ``local`` layer writes the pool by absolute position, as ``attn`` does,
and attends over the last ``cfg.window`` keys.  A step returns the
recurrent entries as new tensors and leaves the ones it was given as they
were, so the engine can keep a row's pre-tick state.

Inputs: ``batch["tokens"]``, or ``batch["embeds"]`` (B, C, D) for an
``embeds``-mode model (:func:`token_embeds` makes them from token ids, as
the engine does).  As in the reference, serving takes no vision prefix: a
``tokens+vision`` model serves as a ``tokens`` one.

An MoE model's FFN (:func:`repro_torch.models.moe.moe_ffn`) routes each
row of a step on its own, as the reference's does: a prefill chunk's
capacity comes from the chunk length C, so the served tokens depend on
the chunking, and a row's padding positions follow its real ones in every
expert's queue, so they never take a real token's slot.

Weights are used as they are stored (the activation dtype); every
projection is an :func:`repro_torch.kernels.ops.sma_gemm` (an MoE's
router too; its expert products are ``bmm`` over experts), the head is
:func:`repro_torch.kernels.ops.rmsnorm_gemm` (so is a decode step's
mLSTM norm1 -> w_up, :func:`_decode_mixer`), and attention is
:func:`repro_torch.kernels.ops.paged_decode_attention` (a chunk, C > 1, or
a window routes to its plain version, counted in ``ops.ROUTED``, by the
reference's rule).
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.compiler import loop
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import attention
from repro_torch.models.layers import rmsnorm_apply
from repro_torch.models.lm import (_RECURRENT, State, _window, ffn_residual,
                                   head, step_inputs, unstack)
from repro_torch.serving.kv_cache import CacheConfig

__all__ = ["init_state", "paged_decode_step", "paged_prefill_step",
           "pooled_positions", "token_embeds", "write_index"]


def init_state(cfg: ModelConfig, max_batch: int, cache: CacheConfig,
               dtype: Optional[torch.dtype] = None,
               device: DeviceLike = None) -> State:
    """Zeroed serving state (module docstring): for an ``attn``/``local``
    position the pools ``{"k", "v"}`` (num_groups, num_blocks + 1, Hkv,
    block_size, head_dim), the last block the spare that dropped writes
    land in; for a recurrent position its block's ``*_init_state`` for
    ``max_batch`` rows, stacked over groups.  An unknown block type raises
    ``ValueError``, as the reference's does."""
    dev = resolve_device(device)
    dtype = dtype or cfg.activation_dtype
    shape = (cfg.num_groups, cache.num_blocks + 1, cfg.num_kv_heads,
             cache.block_size, cfg.resolved_head_dim)
    state = []
    for btype in cfg.block_pattern:
        if btype in ("attn", "local"):
            state.append({"k": torch.zeros(shape, dtype=dtype, device=dev),
                          "v": torch.zeros(shape, dtype=dtype, device=dev)})
        elif btype in _RECURRENT:
            one = _RECURRENT[btype].init_state(cfg, max_batch, dtype, dev)
            state.append({k: v.expand((cfg.num_groups,) + v.shape)
                          .contiguous() for k, v in one.items()})
        else:
            raise ValueError(f"unknown block type {btype}")
    return tuple(state)


def pooled_positions(cfg: ModelConfig) -> Tuple[int, ...]:
    """Pattern positions whose state entry is a paged pool."""
    return tuple(p for p, bt in enumerate(cfg.block_pattern)
                 if bt in ("attn", "local"))


def token_embeds(params: dict, cfg: ModelConfig,
                 toks: torch.Tensor) -> torch.Tensor:
    """Decoder-input embeddings of token ids for an ``embeds``-mode model:
    the model's own table when ``params`` has one, else a one-hot of the id
    modulo d_model, in the activation dtype (``repro.serving.model.
    token_embeds``).  The one-hot is a scatter, which needs no host sync
    (``F.one_hot`` checks its ids on the host)."""
    table = params.get("embed")
    dt = cfg.activation_dtype
    if table is not None:
        return table["table"].to(dt)[toks.long()]
    ids = (toks.long() % cfg.d_model)[..., None]
    out = torch.zeros(*toks.shape, cfg.d_model, dtype=dt, device=toks.device)
    return out.scatter_(-1, ids, 1.0)


class WriteIndex(NamedTuple):
    """Where one step's B*C pool writes land: ``keep`` (B, C) marks those
    that land in a real block; ``blocks``/``offsets`` (B*C,) give every
    write's block and offset, the spare block ``num_blocks`` for the
    others."""

    keep: torch.Tensor
    blocks: torch.Tensor
    offsets: torch.Tensor


def write_index(block_table: torch.Tensor, pos: torch.Tensor,
                num_blocks: int, block_size: int,
                valid: Optional[torch.Tensor] = None) -> WriteIndex:
    """Place the writes of positions ``pos`` (B, C): positions past the
    table, sentinel entries (outside [0, num_blocks)) and positions masked
    by ``valid`` (B, C) go to the spare block ``num_blocks``, so the real
    blocks see exactly the JAX scatter with ``mode="drop"``."""
    mb = block_table.shape[1]
    pos = pos.long()
    idx = pos // block_size
    blk = torch.gather(block_table.long(), 1, idx.clamp(0, mb - 1))
    keep = (idx < mb) & (blk >= 0) & (blk < num_blocks)
    if valid is not None:
        keep &= valid
    blocks = torch.where(keep, blk, num_blocks)
    return WriteIndex(keep, blocks.reshape(-1),
                      (pos % block_size).reshape(-1))


def _pool_write(pool: torch.Tensor, widx: WriteIndex,
                val: torch.Tensor) -> None:
    """Write val (B, C, Hkv, D) into pool (NB + 1, Hkv, BS, D), in place:
    one ``index_put_`` over every position (several dropped writes may
    meet in the spare block; which one lands there is unspecified)."""
    flat = val.reshape(-1, *val.shape[-2:])
    pool[widx.blocks, :, widx.offsets] = flat.to(pool.dtype)


def _paged_attn(bparams: dict, x: torch.Tensor, pools: dict,
                block_table: torch.Tensor, q_pos: torch.Tensor,
                kv_len: torch.Tensor, widx: WriteIndex,
                cfg: ModelConfig, window: Optional[int]) -> torch.Tensor:
    """Attention over the paged pool for a (B, C, D) chunk (C=1: decode):
    write the chunk's K/V into the pool, attend (over the last ``window``
    keys for a ``local`` layer), project out.  Returns the residual branch
    (B, C, D)."""
    b, c, _ = x.shape
    h = rmsnorm_apply(bparams["norm1"], x)
    q, k, v = attention._project_qkv(bparams["mixer"], h, cfg, q_pos)
    _pool_write(pools["k"], widx, k)
    _pool_write(pools["v"], widx, v)
    nb = pools["k"].shape[0] - 1                # the real blocks
    out = ops.paged_decode_attention(q, pools["k"][:nb], pools["v"][:nb],
                                     block_table, q_pos, kv_len,
                                     window=window)
    return ops.sma_gemm(out.reshape(b, c, -1), bparams["mixer"]["wo"])


def _token_step(decode_fn: Callable, cfg: ModelConfig, state: dict,
                x: Tuple[torch.Tensor, torch.Tensor],
                consts: Tuple[dict, torch.Tensor]
                ) -> Tuple[dict, torch.Tensor]:
    """One token of a chunk through a recurrent mixer's decode step: rows
    whose token is valid (``t < n_tokens``) take the new state, the others
    keep theirs.  x = (x_t (B, D), t); consts = (mixer params,
    n_tokens)."""
    x_t, t = x
    mixer, n_tokens = consts
    y, new = decode_fn(mixer, x_t[:, None], state, cfg)
    keep = t < n_tokens                                         # (B,)
    merged = {k: torch.where(keep.reshape((-1,) + (1,) * (v.ndim - 1)),
                             v, state[k]) for k, v in new.items()}
    return merged, y[:, 0]


def _chunk_mixer_scan(decode_fn: Callable, mixer: dict, h: torch.Tensor,
                      state: dict, n_tokens: torch.Tensor,
                      cfg: ModelConfig) -> Tuple[torch.Tensor, dict]:
    """A single-token recurrent mixer over a (B, C, D) chunk, token by
    token, with the per-row masked merge (``repro.serving.model.
    _chunk_mixer_scan``).  One :func:`repro_torch.compiler.loop.scan`: a
    compiled step holds one loop node, whose body is traced once per block
    type and shape.  Outputs at invalid positions are discarded by the
    caller's last-valid gather."""
    steps = torch.arange(h.shape[1], device=h.device)
    new_state, ys = loop.scan(functools.partial(_token_step, decode_fn, cfg),
                              state, (h.transpose(0, 1), steps),
                              (mixer, n_tokens), name=decode_fn.__name__)
    return ys.transpose(0, 1), new_state


def _decode_mixer(btype: str, bparams: dict, x: torch.Tensor, state: dict,
                  cfg: ModelConfig) -> Tuple[torch.Tensor, dict]:
    """A recurrent block's decode step on its input x (B, 1, D), norm1
    included.  An mLSTM block's norm1 feeds only its w_up, so it runs as
    one ``rmsnorm_gemm``: the site the compiler's prologue rule makes of
    that chain (as :func:`repro_torch.models.lm.head` runs final_norm ->
    head), so a compiled decode tick launches what this step launches."""
    if btype == "mlstm":
        return _RECURRENT[btype].decode(bparams["mixer"], x, state, cfg,
                                        norm_scale=bparams["norm1"]["scale"])
    h = rmsnorm_apply(bparams["norm1"], x)
    return _RECURRENT[btype].decode(bparams["mixer"], h, state, cfg)


def _layers(params: dict, state: State, x: torch.Tensor,
            attend: Callable, mix: Callable,
            cfg: ModelConfig) -> Tuple[torch.Tensor, State]:
    """Every group, every pattern position, in order.  ``attend(bparams,
    x, pools, window)`` is an attention layer's residual branch (it writes
    the pools in place); ``mix(btype, bparams, x, state)`` a recurrent
    block's mixer on its input x, norm1 included: (y, new state).  Returns
    x and the new state: the pools as they were given, each recurrent
    entry stacked anew over groups."""
    groups = [unstack(p, cfg.num_groups) for p in params["blocks"]]
    new: Dict[int, List[dict]] = {}
    for g in range(cfg.num_groups):
        for p, btype in enumerate(cfg.block_pattern):
            bparams, entry = groups[p][g], state[p]
            if btype in ("attn", "local"):
                pools = {"k": entry["k"][g], "v": entry["v"][g]}
                x = x + attend(bparams, x, pools, _window(btype, cfg))
                x = ffn_residual(bparams, btype, x, cfg)
                continue
            if btype not in _RECURRENT:
                raise ValueError(f"unknown block type {btype}")
            y, ns = mix(btype, bparams, x,
                        {k: v[g] for k, v in entry.items()})
            x = ffn_residual(bparams, btype, x + y, cfg)
            new.setdefault(p, []).append(ns)
    out = tuple({k: torch.stack([ns[k] for ns in new[p]]) for k in entry}
                if p in new else entry for p, entry in enumerate(state))
    return x, out


def _start(state: State, block_table: torch.Tensor, q_pos: torch.Tensor,
           valid: Optional[torch.Tensor]) -> Optional[WriteIndex]:
    """The step's pool writes, shared by every attention layer; None for a
    model with no pooled position."""
    pooled = [e for e in state if "k" in e]
    if not pooled:
        return None
    _, nb_spare, _, bs, _ = pooled[0]["k"].shape
    return write_index(block_table, q_pos, nb_spare - 1, bs, valid)


def paged_decode_step(params: dict, state: State,
                      block_table: torch.Tensor, cache_len: torch.Tensor,
                      cfg: ModelConfig, batch: Dict[str, torch.Tensor]
                      ) -> Tuple[torch.Tensor, State, torch.Tensor]:
    """One token per row against the paged pool.

    block_table (B, MB) int32; cache_len (B,) -- the position this step
    writes; batch ``tokens`` (B, 1) or ``embeds`` (B, 1, D).  Returns
    (logits (B, Vpad), the new state (the pools updated in place, each
    recurrent entry a new tensor), cache_len + 1).

    A row whose new position has no block (a batch-padding row with an
    all-sentinel table) attends over nothing and gets a zero attention
    output, so no kernel reads a sentinel entry; the JAX step reads a
    clamped block there instead.  Such rows' logits are never used.
    """
    cache_len = cache_len.long()
    q_pos = cache_len[:, None]
    widx = _start(state, block_table, q_pos, None)
    kv_len = (None if widx is None
              else torch.where(widx.keep[:, 0], cache_len + 1, 0))
    x = step_inputs(params, cfg, batch)                         # (B, 1, D)

    def attend(bparams, x, pools, window):
        return _paged_attn(bparams, x, pools, block_table, q_pos, kv_len,
                           widx, cfg, window)

    x, new_state = _layers(params, state, x, attend,
                           functools.partial(_decode_mixer, cfg=cfg), cfg)
    return head(params, x)[:, 0], new_state, cache_len + 1


def paged_prefill_step(params: dict, state: State,
                       block_table: torch.Tensor, cache_len: torch.Tensor,
                       n_tokens: torch.Tensor, cfg: ModelConfig,
                       batch: Dict[str, torch.Tensor]
                       ) -> Tuple[torch.Tensor, State, torch.Tensor]:
    """One prefill chunk per row: C prompt tokens, ``n_tokens`` (B,) valid.

    Pool writes of padding positions are masked, and a recurrent row's
    state merges only its valid tokens.  Returns (logits at each row's
    last valid position (B, Vpad), the new state (the pools updated in
    place, each recurrent entry a new tensor), cache_len + n_tokens).
    """
    cache_len, n_tokens = cache_len.long(), n_tokens.long()
    x = step_inputs(params, cfg, batch)                         # (B, C, D)
    b, c, _ = x.shape
    steps = torch.arange(c, device=x.device)
    q_pos = cache_len[:, None] + steps[None, :]
    valid = steps[None, :] < n_tokens[:, None]
    kv_len = cache_len + n_tokens
    widx = _start(state, block_table, q_pos, valid)

    def attend(bparams, x, pools, window):
        return _paged_attn(bparams, x, pools, block_table, q_pos, kv_len,
                           widx, cfg, window)

    def mix(btype, bparams, x, st):
        h = rmsnorm_apply(bparams["norm1"], x)
        return _chunk_mixer_scan(_RECURRENT[btype].decode, bparams["mixer"],
                                 h, st, n_tokens, cfg)

    x, new_state = _layers(params, state, x, attend, mix, cfg)
    last = (n_tokens - 1).clamp(0, c - 1)
    x_last = x[torch.arange(b, device=x.device), last][:, None]
    return head(params, x_last)[:, 0], new_state, kv_len
