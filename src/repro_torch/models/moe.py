"""Mixture-of-Experts FFN: top-k router, capacity dispatch, expert SwiGLU
(counterpart of ``repro.models.moe``).

The SMA framing of the reference: routing (softmax, top-k, the queue
positions' cumsum, the dispatch scatter and gather, the weighted combine)
is GEMM-incompatible work that runs in SIMD mode; the expert FFNs are
products that run in systolic mode; the two alternate within every block.

Dispatch is per batch row, as in the reference: each row routes its own S
tokens, and an expert takes at most C = :func:`capacity` of them, in
token-major order (token t's k choices before token t + 1's).  A choice
past its expert's C is dropped.  Every shape follows from the input's
shape, so nothing here syncs with the host and a compiled serving tick
traces it: the dispatch table is (B, E, C + 1), dropped choices land in
the spill column C, which is sliced off, and an empty slot holds the
sentinel token S, which reads a zero row.

Three points where PyTorch differs from JAX:

* Top-k ties: ``jax.lax.top_k`` gives the lower expert index first;
  ``torch.topk`` promises no order among equal values, and bf16 router
  logits tie often among 128 experts.  :func:`route` takes the first k of
  a stable descending ``torch.sort``, which keeps equal values in index
  order.
* The combine: the reference scatter-adds each slot's gate-weighted f32
  output into its token's row, which its CPU backend does in ascending
  expert order, starting from 0.0.  A float ``index_add_`` on CUDA adds
  with atomics in no fixed order, so here each token gathers its k kept
  slots and adds them in ascending expert order from 0.0: the same sums
  as the reference's, and the same bits run after run.
* The expert products are ``bmm`` over E on (E, B·C, d) operands, as the
  reference's ``einsum``s are batched products outside any Pallas kernel;
  a broadcasting ``matmul`` would copy every expert's weights over B.

The router product (…, d) @ (d, E) is an :func:`repro_torch.kernels.ops.
sma_gemm` site, in the direct step as in a compiled one.

Expert parallelism (tensor parallelism by the rules, ``expert -> model``;
:mod:`repro_torch.distributed.tensor_parallel`): each rank holds E/m
experts of ``wi`` / ``wg`` / ``wo`` and computes only their slots.  The
router is whole on every rank, so every rank routes all of its rows the
same way, and the auxiliary losses, read from the whole routing, have the
same gradient on every rank.  The gate-weighted combine over the local
experts is a partial sum, completed by *g*.  The tokens the experts read
pass *f*, and so do the gate values the combine reads: each rank's
gradient of them covers only its experts, so it is summed over the line
before it meets the router's (whole) gradient from the auxiliary losses.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.kernels import ops
from repro_torch.models.layers import compute_cast, variance_scaling_init


def moe_init(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
             lead: Tuple[int, ...] = ()) -> dict:
    """``router`` (d, E), ``wi`` / ``wg`` (E, d, f) and ``wo`` (E, f, d),
    stacked on ``lead``, with fan-in d, d, d and f."""
    moe = cfg.moe
    d, f, e = cfg.d_model, moe.d_ff_expert, moe.num_experts
    return {
        "router": variance_scaling_init(gen, lead + (d, e), dtype, fan_in=d),
        "wi": variance_scaling_init(gen, lead + (e, d, f), dtype, fan_in=d),
        "wg": variance_scaling_init(gen, lead + (e, d, f), dtype, fan_in=d),
        "wo": variance_scaling_init(gen, lead + (e, f, d), dtype, fan_in=f),
    }


def capacity(s: int, moe: MoEConfig) -> int:
    """Slots an expert has in a row of ``s`` tokens: ceil(s·k / E) times
    the capacity factor, at least 1 and at most ``s``."""
    cap = int(max(1, -(-s * moe.top_k // moe.num_experts)
                  * moe.capacity_factor))
    return min(cap, s)


def route(logits32: torch.Tensor, moe: MoEConfig
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Router logits (…, E) float32 -> (probs (…, E), gate values (…, k),
    expert ids (…, k)): softmax, the k largest with ties to the lower
    expert id (``jax.lax.top_k``'s order), renormalized to sum to 1 when
    ``norm_topk_prob``."""
    probs = torch.softmax(logits32, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, expert = vals[..., :moe.top_k], idx[..., :moe.top_k]
    if moe.norm_topk_prob:
        gate = gate / gate.sum(-1, keepdim=True)
    return probs, gate, expert


class Routing(NamedTuple):
    """What :func:`moe_aux` reads of one call: the router logits (B, S,
    E) float32, the probabilities, the choices as a one-hot (B, S, k, E)
    int32, and ``keep`` (B, S, k), the choices within capacity."""

    logits32: torch.Tensor
    probs: torch.Tensor
    onehot: torch.Tensor
    keep: torch.Tensor


def moe_ffn(params: dict, x: torch.Tensor, cfg: ModelConfig
            ) -> Tuple[torch.Tensor, Routing]:
    """x (B, S, D) -> (y (B, S, D) in x's dtype, the routing); on the
    rank's experts under expert parallelism (module docstring)."""
    moe = cfg.moe
    b, s, d = x.shape
    e, k = moe.num_experts, moe.top_k
    cap = capacity(s, moe)
    dev = x.device
    el = params["wi"].shape[0]                  # the experts held here
    ax = tp.split_of(el, e)
    e0 = 0 if ax is None else ax.index * el

    # ---- SIMD mode: routing ------------------------------------------------
    logits32 = ops.sma_gemm(x, compute_cast(params["router"],
                                            x.dtype)).float()
    probs, gate, expert = route(logits32, moe)                # (B, S, k)
    # Each choice's place in its expert's queue, token-major within a row.
    onehot = (expert[..., None] == torch.arange(e, device=dev)) \
        .to(torch.int32)                                      # (B,S,k,E)
    queue = torch.cumsum(onehot.reshape(b, s * k, e), 1,
                         dtype=torch.int32)
    e_flat = expert.reshape(b, s * k)
    pos = torch.gather(queue, 2, e_flat[..., None]).reshape(b, s, k) - 1
    keep = pos < cap

    # Token ids into the (E, C + 1) table of each row: sentinel s in empty
    # slots, dropped choices in the spill column C (sliced off).
    p_flat = torch.where(keep, pos, cap).reshape(b, s * k).long()
    tok = torch.arange(s, device=dev)[:, None].expand(s, k).reshape(1, -1)
    table = torch.full((b, e * (cap + 1)), s, dtype=torch.long, device=dev)
    table = table.scatter(1, e_flat * (cap + 1) + p_flat,
                          tok.expand(b, -1)).reshape(b, e, cap + 1)
    # Rows of x_pad below, expert-major (E, B, C): a contiguous index, so
    # the gather's output is contiguous in a compiled step as it is here.
    if ax is not None:
        table = table[:, e0:e0 + el]
    rows = (table[:, :, :cap] + (s + 1) * torch.arange(
        b, device=dev)[:, None, None]).transpose(0, 1).contiguous()

    # ---- gather + systolic mode: the expert FFNs, bmm over E ---------------
    xin = x if ax is None else ax.enter(x)
    x_pad = torch.cat([xin, xin.new_zeros(b, 1, d)], 1).reshape(-1, d)
    xe = x_pad[rows].reshape(el, b * cap, d)                  # (E, B·C, D)
    h = torch.bmm(xe, compute_cast(params["wi"], x.dtype))
    g = torch.bmm(xe, compute_cast(params["wg"], x.dtype))
    ye = torch.bmm(F.silu(g) * h, compute_cast(params["wo"], x.dtype))

    # ---- SIMD mode: the gate-weighted combine, in ascending expert order ---
    e_sorted, order = torch.sort(expert, dim=-1)
    kept = torch.gather(keep, -1, order)
    if ax is not None:
        kept = kept & (e_sorted >= e0) & (e_sorted < e0 + el)
        gate = ax.enter(gate)
        e_sorted = (e_sorted - e0).clamp(0, el - 1)
    slot = (e_sorted * (b * cap)
            + cap * torch.arange(b, device=dev)[:, None, None]
            + torch.gather(pos, -1, order).clamp(0, cap - 1))
    part = ye.reshape(-1, d)[slot].float() \
        * torch.gather(gate, -1, order)[..., None]            # (B,S,k,D)
    part = torch.where(kept[..., None], part, 0.0)
    y = torch.zeros(b, s, d, dtype=torch.float32, device=dev)
    for j in range(k):
        y = y + part[:, :, j]
    if ax is not None:
        y = ax.exit(y)
    return y.to(x.dtype), Routing(logits32, probs, onehot, keep)


def moe_aux(r: Routing, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """The load-balance and router z losses, each times its coefficient,
    and the fraction of choices dropped."""
    moe = cfg.moe
    frac_tokens = r.onehot.float().mean(dim=(1, 2))           # (B, E)
    mean_probs = r.probs.mean(1)                              # (B, E)
    lb = moe.num_experts * (frac_tokens * mean_probs).sum(-1).mean()
    z = torch.logsumexp(r.logits32, dim=-1).square().mean()
    return {"moe_lb_loss": lb * moe.lb_loss_coef,
            "moe_z_loss": z * moe.z_loss_coef,
            "moe_drop_frac": 1.0 - r.keep.float().mean()}


def moe_apply(params: dict, x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x (B, S, D) -> (y (B, S, D), aux): :func:`moe_ffn` and
    :func:`moe_aux`."""
    y, r = moe_ffn(params, x, cfg)
    return y, moe_aux(r, cfg)
