"""Griffin recurrent block: causal conv1d + RG-LRU (recurrentgemma)
(counterpart of ``repro.models.recurrent``, the RG-LRU half; mLSTM and
sLSTM are not ported).

Every projection is an :func:`repro_torch.kernels.ops.sma_gemm`: the gate
takes the fused ``"gelu"`` epilogue (tanh-approximate, as ``jax.nn.gelu``'s
default), ``w_a`` and ``w_x`` their biases, with the sigmoid applied
outside.  The scan over time is :func:`repro_torch.kernels.ops.rglru_scan`;
a decode step runs the one-step recurrence as plain tensor ops, as the JAX
package does.  The lru width is d_model (recurrentgemma-2b).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import compute_cast, variance_scaling_init

CONV_WIDTH = 4
_RGLRU_C = 8.0


def rglru_block_init(gen: torch.Generator, cfg: ModelConfig,
                     dtype: torch.dtype, lead: Tuple[int, ...] = ()) -> dict:
    """The JAX block's shapes and draws: variance-scaled matrices (the conv
    over its 4 taps), zero biases, and ``lambda_raw`` uniform in
    [0.744, 0.999), held in float32 since the gates read it so."""
    d = lru = cfg.d_model
    dev = gen.device

    def zeros(n: int) -> torch.Tensor:
        return torch.zeros(lead + (n,), dtype=dtype, device=dev)

    lam = torch.rand(lead + (lru,), generator=gen, device=dev,
                     dtype=torch.float32) * (0.999 - 0.744) + 0.744
    return {
        "w_in": variance_scaling_init(gen, lead + (d, lru), dtype),
        "w_gate": variance_scaling_init(gen, lead + (d, lru), dtype),
        "conv_w": variance_scaling_init(gen, lead + (CONV_WIDTH, lru), dtype,
                                        fan_in=CONV_WIDTH),
        "conv_b": zeros(lru),
        "w_a": variance_scaling_init(gen, lead + (lru, lru), dtype),
        "b_a": zeros(lru),
        "w_x": variance_scaling_init(gen, lead + (lru, lru), dtype),
        "b_x": zeros(lru),
        "lambda_raw": lam,
        "w_out": variance_scaling_init(gen, lead + (lru, d), dtype,
                                       fan_in=lru),
    }


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  tail: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv of width 4 in x's dtype.  x (B, S, C); w (4,
    C); b (C,); tail (B, 3, C), the inputs before x, or None (zeros).  The
    taps are summed in the JAX package's order."""
    if tail is None:
        tail = x.new_zeros((x.shape[0], CONV_WIDTH - 1, x.shape[2]))
    xp = torch.cat([tail.to(x.dtype), x], dim=1)
    s = x.shape[1]
    out = 0
    for i in range(CONV_WIDTH):
        out = out + xp[:, i:i + s] * w[i].to(x.dtype)
    return out + b.to(x.dtype)


def rglru_gates(params: dict, xc: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-step decay a_t and gated input u_t from the conv output, both in
    xc's dtype: ``log a = -8 softplus(lambda) r`` in f32, ``u = sqrt(max(1
    - a^2, 1e-12)) (i * xc)``."""
    dtype = xc.dtype
    r = torch.sigmoid(ops.sma_gemm(xc, compute_cast(params["w_a"], dtype),
                                   bias=params["b_a"].to(dtype)))
    i = torch.sigmoid(ops.sma_gemm(xc, compute_cast(params["w_x"], dtype),
                                   bias=params["b_x"].to(dtype)))
    log_lam = -8.0 * F.softplus(params["lambda_raw"].float())
    log_a = log_lam * r.float() * (_RGLRU_C / 8.0)
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    u = (mult * (i * xc).float()).to(dtype)
    return a.to(dtype), u


def _in_proj(params: dict, x: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The recurrence input ``x @ w_in`` and ``gelu(x @ w_gate)``."""
    xr = ops.sma_gemm(x, compute_cast(params["w_in"], x.dtype))
    gate = ops.sma_gemm(x, compute_cast(params["w_gate"], x.dtype),
                        epilogue="gelu")
    return xr, gate


def rglru_block_scan(params: dict, x: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The block over a whole sequence.  x (B, S, D) -> (y (B, S, D), the
    scan's h_last (B, lru) in x's dtype, the recurrence input xr (B, S,
    lru)).  Prefill keeps the last two for decode."""
    xr, gate = _in_proj(params, x)
    xc = causal_conv1d(xr, params["conv_w"], params["conv_b"])
    a, u = rglru_gates(params, xc)
    h_seq, h_last = ops.rglru_scan(a, u, None)
    y = ops.sma_gemm(h_seq * gate, compute_cast(params["w_out"], x.dtype))
    return y, h_last, xr


def rglru_block_apply(params: dict, x: torch.Tensor,
                      cfg: ModelConfig) -> torch.Tensor:
    """Training / prefill forward.  x (B, S, D) -> (B, S, D)."""
    return rglru_block_scan(params, x)[0]


def rglru_block_init_state(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                           device: torch.device) -> dict:
    """A zero carry ``h`` (B, lru) in float32 and a zero ``conv_tail``
    (B, 3, lru) in ``dtype``."""
    lru = cfg.d_model
    return {"h": torch.zeros((batch, lru), dtype=torch.float32,
                             device=device),
            "conv_tail": torch.zeros((batch, CONV_WIDTH - 1, lru),
                                     dtype=dtype, device=device)}


def rglru_block_decode(params: dict, x: torch.Tensor, state: dict,
                       cfg: ModelConfig) -> Tuple[torch.Tensor, dict]:
    """One decode step.  x (B, 1, D) -> (y (B, 1, D), new state); ``state``
    is not modified."""
    dtype = x.dtype
    xr, gate = _in_proj(params, x)
    xc = causal_conv1d(xr, params["conv_w"], params["conv_b"],
                       tail=state["conv_tail"])
    tail = torch.cat([state["conv_tail"][:, 1:],
                      xr.to(state["conv_tail"].dtype)], dim=1)
    a, u = rglru_gates(params, xc)
    h = a[:, 0].float() * state["h"] + u[:, 0].float()
    y = h.to(dtype)[:, None, :] * gate
    out = ops.sma_gemm(y, compute_cast(params["w_out"], dtype))
    return out, {"h": h, "conv_tail": tail}
