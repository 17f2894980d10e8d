"""GQA attention block: parameters, projections, the dense forward and the
contiguous-cache serving steps (counterpart of ``repro.models.attention``).

``_project_qkv`` serves every path: the paged serving steps
(:mod:`repro_torch.serving.model`); :func:`attn_apply`, the train forward,
and :func:`attn_prefill`, both of which reach the flash kernel; and
:func:`attn_decode`, which reaches the contiguous decode kernel.  A
windowed (``local``) layer keeps a cache of ``window`` slots as a ring.

Under tensor parallelism (:mod:`repro_torch.distributed.tensor_parallel`)
:func:`attn_apply` runs on the rank's heads: ``wq`` (and ``wk`` / ``wv``
where the KV heads split too) are column blocks by heads behind *f*, the
flash kernel runs on the local heads, ``wo`` is a row block before *g*.
Where the KV heads stay whole (MQA, or a KV count the axis does not
divide), ``wk`` / ``wv`` are whole on every rank and each rank projects
the KV heads its query heads read: its query head h is global head
``index * Hq/m + h``, whose KV head is ``global // (Hq / Hkv)``.  Where the
query heads stay whole too, attention is computed whole on every rank.

The serving steps run on the rank's heads the same way.
:func:`attn_prefill`'s cache holds the rank's KV heads where they split,
and every KV head where they do not (the prefill rules keep ``kv_seq``
whole).  :func:`attn_decode` under the decode rules, where the KV heads
stay whole, is decode context parallelism
(:mod:`repro_torch.distributed.context_parallel`): the cache is the
rank's slice of the slots, each rank attends its slice with every query
head (gathered over the line where the query heads split), the ranks'
partial results are merged, and each rank keeps its heads' rows for
``wo``.  A cache whose slots the line does not divide stays whole on
every rank (``spec_tree_to_shardings`` leaves it), and the step then
writes and attends the whole cache on every rank, counted in
``ops.ROUTED`` under :data:`WHOLE_CACHE_REASON`.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import context_parallel as cp
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.kernels import ops
from repro_torch.models.layers import (apply_rope, compute_cast,
                                       variance_scaling_init)

#: The ``ops.ROUTED`` reason of a decode step whose cache the rules put
#: over the ``model`` line by its slots but whose slot count the line does
#: not divide: the cache is whole on every rank.
WHOLE_CACHE_REASON = ("context parallel: the model axis does not divide "
                      "the cache's slots; the cache whole on each rank")


def attn_init(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
              lead: Tuple[int, ...] = ()) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    return {
        "wq": variance_scaling_init(gen, lead + (d, nq * hd), dtype),
        "wk": variance_scaling_init(gen, lead + (d, nkv * hd), dtype),
        "wv": variance_scaling_init(gen, lead + (d, nkv * hd), dtype),
        "wo": variance_scaling_init(gen, lead + (nq * hd, d), dtype),
    }


def _project_qkv(params: dict, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor,
                 ax: Optional[tp.ModelAxis] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (..., S, D) -> roped q (..., S, Hq, hd), roped k and v
    (..., S, Hkv, hd); one SMA GEMM per projection.  With ``ax`` (tensor
    parallelism) x passes *f*, q holds this rank's query heads and k, v
    the KV heads they read (module docstring)."""
    hd = cfg.resolved_head_dim
    lead = x.shape[:-1]
    if ax is not None:
        x = ax.enter(x)

    def proj(w: torch.Tensor) -> torch.Tensor:
        return ops.sma_gemm(x, compute_cast(w, x.dtype)).reshape(
            *lead, -1, hd)

    q = apply_rope(proj(params["wq"]), positions, theta=cfg.rope_theta)
    wk, wv, idx = params["wk"], params["wv"], None
    if ax is not None and not tp.split_of(wk.shape[-1],
                                          cfg.num_kv_heads * hd):
        wk, wv, idx = _kv_of_heads(ax, params, q.shape[-2], cfg, x)
    k = apply_rope(proj(wk), positions, theta=cfg.rope_theta)
    v = proj(wv)
    if idx is not None:
        k, v = k.index_select(-2, idx), v.index_select(-2, idx)
    return q, k, v


def _kv_of_heads(ax: tp.ModelAxis, params: dict, nq: int, cfg: ModelConfig,
                 x: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor,
                            Optional[torch.Tensor]]:
    """Where ``wk`` / ``wv`` are whole: their columns of the KV heads this
    rank's ``nq`` query heads read, behind *f* in x's dtype, and the index
    that gives each query head its own KV head where flash's grouping
    cannot (else None)."""
    hd = cfg.resolved_head_dim
    lo, n, want = _kv_pick(ax, nq, cfg)
    wk, wv = (compute_cast(ax.enter(params[w]).narrow(-1, lo * hd, n * hd),
                           x.dtype).contiguous() for w in ("wk", "wv"))
    idx = None if want is None else torch.tensor(want, device=x.device)
    return wk, wv, idx


def _kv_pick(ax: tp.ModelAxis, nq: int, cfg: ModelConfig
             ) -> Tuple[int, int, Optional[List[int]]]:
    """The KV heads this rank's ``nq`` query heads read: the first, their
    count, and each query head's index among them where flash's grouping
    cannot give it (else None)."""
    group = cfg.num_heads // cfg.num_kv_heads
    want = [(ax.index * nq + h) // group for h in range(nq)]
    lo, n = want[0], want[-1] - want[0] + 1
    if nq % n or want != [lo + h // (nq // n) for h in range(nq)]:
        return lo, n, [w - lo for w in want]
    return lo, n, None


def _heads_split(params: dict, cfg: ModelConfig
                 ) -> Tuple[Optional[tp.ModelAxis], bool]:
    """(the model axis when ``wq`` is this rank's heads, whether ``wk`` /
    ``wv`` are this rank's KV heads)."""
    hd = cfg.resolved_head_dim
    ax = tp.split_of(params["wq"].shape[-1], cfg.num_heads * hd)
    kv = tp.split_of(params["wk"].shape[-1], cfg.num_kv_heads * hd)
    return ax, kv is not None


def attn_apply(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
               window: Optional[int] = None,
               positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Training / prefill forward.  x (B, S, D) -> (B, S, D).

    Project and rope at ``positions`` ((1 or B, S) integers; default
    ``arange(S)``), then causal (optionally windowed) flash attention in
    the kernel's (B, H, S, hd) layout -- the transposes are copies -- and
    the output projection; on the rank's heads under tensor parallelism
    (module docstring)."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    ax = tp.split_of(params["wq"].shape[-1],
                     cfg.num_heads * cfg.resolved_head_dim)
    if ax is None and tp.model_axis() is not None:
        ops.ROUTED[tp.WHOLE_ATTENTION_REASON] += 1
    q, k, v = _project_qkv(params, x, cfg, positions, ax)   # (B, S, H, hd)
    out = ops.flash_attention(q.transpose(1, 2).contiguous(),
                              k.transpose(1, 2).contiguous(),
                              v.transpose(1, 2).contiguous(),
                              causal=True, window=window)
    out = out.transpose(1, 2).reshape(b, s, -1)
    y = ops.sma_gemm(out, compute_cast(params["wo"], x.dtype))
    return y if ax is None else ax.exit(y)


def attn_prefill(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
                 window: Optional[int] = None, cache_size: int
                 ) -> Tuple[torch.Tensor, dict]:
    """:func:`attn_apply` that also returns the populated cache ``{"k",
    "v"}`` (B, Hkv, cache_size, hd): the prompt's keys and values, padded
    with zeros to ``cache_size`` or, when longer, cut to their last
    ``cache_size`` positions (as the JAX function does; a windowed layer's
    decode then writes position p at slot p % cache_size, which matches
    this layout only when the prompt length is a multiple of the window:
    ROADMAP.md, faults of the reference).  Under tensor parallelism on
    the rank's heads (module docstring): the cache holds the rank's KV
    heads where ``wk`` / ``wv`` are split, else every KV head, projected
    whole, of which flash reads those the rank's query heads read."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :]
    ax, kv_split = _heads_split(params, cfg)
    if ax is None and tp.model_axis() is not None:
        ops.ROUTED[tp.WHOLE_ATTENTION_REASON] += 1
    kv_whole = ax is not None and not kv_split
    q, k, v = _project_qkv(params, x, cfg, positions,
                           None if kv_whole else ax)
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    kf, vf = kh, vh
    if kv_whole:
        lo, n, want = _kv_pick(ax, qh.shape[1], cfg)
        kf, vf = kh.narrow(1, lo, n), vh.narrow(1, lo, n)
        if want is not None:
            idx = torch.tensor(want, device=x.device)
            kf, vf = kf.index_select(1, idx), vf.index_select(1, idx)
        kf, vf = kf.contiguous(), vf.contiguous()
    out = ops.flash_attention(qh, kf, vf, causal=True, window=window)
    y = ops.sma_gemm(out.transpose(1, 2).reshape(b, s, -1),
                     compute_cast(params["wo"], x.dtype))
    if ax is not None:
        y = ax.exit(y)
    pad = cache_size - s
    if pad > 0:
        kh = torch.nn.functional.pad(kh, (0, 0, 0, pad))
        vh = torch.nn.functional.pad(vh, (0, 0, 0, pad))
    elif pad < 0:
        kh = kh[:, :, -cache_size:].contiguous()
        vh = vh[:, :, -cache_size:].contiguous()
    return y, {"k": kh, "v": vh}


def _slot_and_valid(pos: torch.Tensor, smax: int, window: Optional[int]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the slot a step at ``pos`` writes, the slots valid after it) of a
    cache of ``smax`` slots: a ring for a windowed layer, else the last
    slot holds every position past it."""
    if window is not None:
        return pos % smax, (pos + 1).clamp(max=smax)
    return pos.clamp(max=smax - 1), pos + 1


def _write_slot(cache: dict, slot: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor, keep: Optional[torch.Tensor] = None
                ) -> None:
    """Each row's new key and value (B, Hkv, hd) to its ``slot``, in
    place; with ``keep`` (B,) bool, only the rows it marks (the others'
    slots keep what they hold)."""
    rows = torch.arange(slot.shape[0], device=slot.device)
    for name, new in (("k", k), ("v", v)):
        c = cache[name]
        new = new.to(c.dtype)
        if keep is not None:
            new = torch.where(keep[:, None, None], new, c[rows, :, slot])
        c[rows, :, slot] = new


def attn_decode(params: dict, x: torch.Tensor, cache: dict,
                cache_len: torch.Tensor, cfg: ModelConfig, *,
                window: Optional[int] = None,
                slots: Optional[int] = None) -> Tuple[torch.Tensor, dict]:
    """One decode step.  x (B, 1, D); cache k/v (B, Hkv, Smax, hd), written
    **in place** (the JAX function returns new arrays); cache_len (B,), the
    position this step writes.

    The new key and value go to slot ``cache_len % Smax`` in a windowed
    layer (a ring of Smax = window slots) and ``min(cache_len, Smax - 1)``
    otherwise; attention then reads ``min(cache_len + 1, Smax)`` slots
    (windowed) or ``cache_len + 1``.  Returns (y (B, 1, D), cache).

    Under tensor parallelism on the rank's heads (module docstring):
    where ``wk`` / ``wv`` are split the cache holds the rank's KV heads;
    where they are whole the cache is over the line by its slots, ``cache``
    the rank's slice of a cache of ``slots`` (the whole cache's slot count;
    default: the cache's own, i.e. whole)."""
    ax, kv_split = _heads_split(params, cfg)
    line = tp.model_axis()
    if line is not None and not kv_split:
        return _decode_over_line(params, x, cache, cache_len, cfg, window,
                                 slots, ax)
    b = x.shape[0]
    pos = cache_len.long()
    q, k, v = _project_qkv(params, x, cfg, pos[:, None], ax)  # (B,1,H,hd)
    slot, valid = _slot_and_valid(pos, cache["k"].shape[2], window)
    _write_slot(cache, slot, k[:, 0], v[:, 0])
    out = ops.decode_attention(q[:, 0], cache["k"], cache["v"],
                               valid.to(torch.int32))
    y = ops.sma_gemm(out.reshape(b, -1), compute_cast(params["wo"], x.dtype))
    if ax is not None:
        y = ax.exit(y)
    return y[:, None, :], cache


def _decode_over_line(params: dict, x: torch.Tensor, cache: dict,
                      cache_len: torch.Tensor, cfg: ModelConfig,
                      window: Optional[int], slots: Optional[int],
                      ax: Optional[tp.ModelAxis]
                      ) -> Tuple[torch.Tensor, dict]:
    """:func:`attn_decode` where the KV heads are whole over the ``model``
    line: the cache split by its slots (context parallelism), or whole
    where the line does not divide them (module docstring).  k and v are
    projected whole on every rank; q, this rank's heads where ``wq`` is
    split, is gathered over the line into every head; after attention each
    rank keeps its heads' rows for its ``wo`` block."""
    b = x.shape[0]
    pos = cache_len.long()
    local = cache["k"].shape[2]
    smax = slots or local
    split = tp.split_of(local, smax)
    q, k, v = _project_qkv(params, x, cfg, pos[:, None])     # (B,1,H,hd)
    nq = q.shape[2]
    q = q[:, 0]
    if ax is not None:
        q = ax.gather(q, dim=1, span="comm.cp_gather_q")
    slot, valid = _slot_and_valid(pos, smax, window)
    if split is None:
        ops.ROUTED[WHOLE_CACHE_REASON] += 1
        _write_slot(cache, slot, k[:, 0], v[:, 0])
        out = ops.decode_attention(q, cache["k"], cache["v"],
                                   valid.to(torch.int32))
    else:
        owner, at = cp.slot_owner(slot, local)
        _write_slot(cache, at, k[:, 0], v[:, 0], keep=owner == split.index)
        lens = cp.local_lengths(pos, smax, window, split.size)[split.index]
        out, lse = ops.decode_attention(q, cache["k"], cache["v"],
                                        lens.to(torch.int32),
                                        return_lse=True)
        out = cp.merge(out, lse, split).to(x.dtype)
    if ax is not None:
        out = out[:, ax.block(nq)]
    y = ops.sma_gemm(out.reshape(b, -1), compute_cast(params["wo"], x.dtype))
    if ax is not None:
        y = ax.exit(y)
    return y[:, None, :], cache
