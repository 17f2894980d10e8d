"""Recurrent blocks: Griffin RG-LRU (recurrentgemma) and xLSTM's mLSTM and
sLSTM (counterpart of ``repro.models.recurrent``).

Every projection is an :func:`repro_torch.kernels.ops.sma_gemm`.  RG-LRU:
the gate takes the fused ``"gelu"`` epilogue (tanh-approximate, as
``jax.nn.gelu``'s default), ``w_a`` and ``w_x`` their biases, with the
sigmoid applied outside; the scan over time is
:func:`repro_torch.kernels.ops.rglru_scan`.  mLSTM: six products a layer
(``w_up``, ``w_q``, ``w_k``, ``w_v``, ``w_if``, ``w_down``); the gates keep
the reference's rounding (``w_if``'s product rounded to the activation
dtype, then its bias and ``log_sigmoid`` in float32, since they go through
``exp``); the sweep over the sequence is
:func:`repro_torch.kernels.ops.mlstm_chunkwise`, whose final state is the
prefill's decode state.  sLSTM: ``w_gates`` takes its bias in the epilogue,
``w_ff1`` the ``"gelu"`` epilogue; the time loop is a Python loop over
steps with the recurrent product ``r_gates`` in float32, as the reference's
``lax.scan`` (no kernel).  A decode step runs each block's one-step
recurrence as plain float32 tensor ops, as the JAX package does.  The lru
width is d_model (recurrentgemma-2b).

Tensor parallelism (the training forward under ``train(mesh=)`` with a
``model`` axis; :mod:`repro_torch.distributed.tensor_parallel`):

* RG-LRU: ``w_in`` / ``w_gate`` are column blocks of the rank's channels
  behind *f*; the conv, ``lambda_raw`` and the scan (kernel and backward)
  run on those channels; ``w_a`` / ``w_x`` are column blocks whose rows
  are whole, so they read the conv output gathered whole (the reference's
  ``xc``, sharded by ``mlp``); ``w_out`` is a row block before *g*.
* mLSTM: ``w_up`` is grouped (the rank's columns of the cell input and of
  the output gate, whole heads of each), ``w_q`` / ``w_k`` / ``w_v``
  column blocks by heads reading the gathered conv output and cell input,
  the chunkwise kernel on the local heads, ``gn_scale`` a block, ``w_down``
  a row block before *g*.  ``w_if`` / ``b_if`` are whole: every rank
  computes every head's gates and keeps its own, their gradient summed
  over the line (*f* on the weights).
* sLSTM: ``w_gates``' columns are head-major, so its column block is whole
  heads; ``r_gates`` is a block by heads and the step loop runs on the
  local heads; ``gn_scale`` is whole and each rank reads its heads' slice
  (behind *f*); the post-FF reads the hidden states gathered whole, ``w_ff1``
  a column block, ``w_ff2`` a row block before *g*.

The serving steps (``*_block_prefill``, ``*_block_decode``) split the same
way, and their states follow ``lm.state_specs``: the RG-LRU's ``h`` and
``conv_tail`` and the mLSTM's ``conv_tail`` are the rank's channels (the
``mlp`` block); the mLSTM's ``c``, ``n``, ``m`` and the sLSTM's ``c``,
``n``, ``m``, ``h`` are whole on every rank, so a step computes its
heads' part from its heads' slice and gathers the new state over the line
(:func:`_whole_heads`).
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.compiler import loop
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.kernels import ops
from repro_torch.models.layers import (compute_cast, uniform_init,
                                       variance_scaling_init)

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

    lam = uniform_init(gen, lead + (lru,), 0.744, 0.999)
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


def rglru_gates(params: dict, xc: torch.Tensor,
                xc_whole: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-step decay a_t and gated input u_t from the conv output, both in
    xc's dtype: ``log a = -8 softplus(lambda) r`` in f32, ``u = sqrt(max(1
    - a^2, 1e-12)) (i * xc)``.  ``xc_whole``: the products' input, every
    channel, where ``xc`` is this rank's (tensor parallelism)."""
    dtype = xc.dtype
    xin = xc if xc_whole is None else xc_whole
    r = torch.sigmoid(ops.sma_gemm(xin, compute_cast(params["w_a"], dtype),
                                   bias=params["b_a"].to(dtype)))
    i = torch.sigmoid(ops.sma_gemm(xin, compute_cast(params["w_x"], dtype),
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


def rglru_block_scan(params: dict, x: torch.Tensor, cfg: ModelConfig
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The block over a whole sequence.  x (B, S, D) -> (y (B, S, D), the
    scan's h_last (B, lru) in x's dtype, the recurrence input xr (B, S,
    lru)).  :func:`rglru_block_prefill` keeps the last two for decode.
    Under tensor parallelism the weights hold a block of the lru width
    (module docstring); h_last and xr are then the rank's channels."""
    ax = tp.split_of(params["w_out"].shape[-2], cfg.d_model)
    if ax is not None:
        x = ax.enter(x)
    xr, gate = _in_proj(params, x)
    xc = causal_conv1d(xr, params["conv_w"], params["conv_b"])
    a, u = rglru_gates(params, xc, None if ax is None else ax.gather(xc))
    h_seq, h_last = ops.rglru_scan(a, u, None)
    y = ops.sma_gemm(h_seq * gate, compute_cast(params["w_out"], x.dtype))
    return y if ax is None else ax.exit(y), h_last, xr


def rglru_block_apply(params: dict, x: torch.Tensor,
                      cfg: ModelConfig) -> torch.Tensor:
    """Training / prefill forward.  x (B, S, D) -> (B, S, D)."""
    return rglru_block_scan(params, x, cfg)[0]


def rglru_block_prefill(params: dict, x: torch.Tensor, cfg: ModelConfig
                        ) -> Tuple[torch.Tensor, dict]:
    """The block over a prompt, with its decode state: the scan's h_last
    (rounded to the activation dtype by the kernel, held in float32) and
    the last 3 recurrence inputs."""
    y, h_last, xr = rglru_block_scan(params, x, cfg)
    return y, {"h": h_last.float(),
               "conv_tail": xr[:, -(CONV_WIDTH - 1):]
               .to(cfg.activation_dtype).contiguous()}


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
    is not modified.  Under tensor parallelism on the rank's channels, as
    :func:`rglru_block_scan` (``state`` the rank's block)."""
    dtype = x.dtype
    ax = tp.split_of(params["w_out"].shape[-2], cfg.d_model)
    if ax is not None:
        x = ax.enter(x)
    xr, gate = _in_proj(params, x)
    xc = causal_conv1d(xr, params["conv_w"], params["conv_b"],
                       tail=state["conv_tail"])
    tail = torch.cat([state["conv_tail"][:, 1:],
                      xr.to(state["conv_tail"].dtype)], dim=1)
    a, u = rglru_gates(params, xc, None if ax is None else ax.gather(xc))
    h = a[:, 0].float() * state["h"] + u[:, 0].float()
    y = h.to(dtype)[:, None, :] * gate
    out = ops.sma_gemm(y, compute_cast(params["w_out"], dtype))
    return out if ax is None else ax.exit(out), {"h": h, "conv_tail": tail}


def _own_heads(state: dict, ax: Optional[tp.ModelAxis], heads: int,
               keys: Tuple[str, ...]) -> dict:
    """This rank's ``heads`` of the whole per-head leaves ``keys`` (dim 1)
    of a state (module docstring)."""
    if ax is None:
        return state
    return {k: v[:, ax.block(heads)] if k in keys else v
            for k, v in state.items()}


def _whole_heads(state: dict, ax: Optional[tp.ModelAxis],
                 keys: Tuple[str, ...]) -> dict:
    """The per-head leaves ``keys`` of this rank's new state gathered over
    the line into every head (dim 1; span ``comm.tp_state``)."""
    if ax is None:
        return state
    return {k: ax.gather(v.contiguous(), dim=1, span="comm.tp_state")
            if k in keys else v for k, v in state.items()}


# ===========================================================================
# xLSTM mLSTM block (matrix memory, chunkwise-parallel over a sequence)
# ===========================================================================
def _mlstm_dims(cfg: ModelConfig) -> Tuple[int, int]:
    inner = int(cfg.d_model * cfg.mlstm_proj_factor)
    return inner, inner // cfg.num_heads


def mlstm_block_init(gen: torch.Generator, cfg: ModelConfig,
                     dtype: torch.dtype, lead: Tuple[int, ...] = ()) -> dict:
    """The JAX block's shapes and draws: variance-scaled matrices (the conv
    over its 4 taps, ``w_down`` over the inner width), a zero conv bias,
    ``b_if`` = (0 for the input gates, linspace(3, 6) for the forget
    gates) and ``gn_scale`` = 1, the last two float32 as the gates and the
    norm read them."""
    d, h = cfg.d_model, cfg.num_heads
    inner, _ = _mlstm_dims(cfg)
    dev = gen.device
    b_if = torch.cat([torch.zeros(h), torch.linspace(3.0, 6.0, h)])
    return {
        "w_up": variance_scaling_init(gen, lead + (d, 2 * inner), dtype),
        "conv_w": variance_scaling_init(gen, lead + (CONV_WIDTH, inner),
                                        dtype, fan_in=CONV_WIDTH),
        "conv_b": torch.zeros(lead + (inner,), dtype=dtype, device=dev),
        "w_q": variance_scaling_init(gen, lead + (inner, inner), dtype),
        "w_k": variance_scaling_init(gen, lead + (inner, inner), dtype),
        "w_v": variance_scaling_init(gen, lead + (inner, inner), dtype),
        "w_if": variance_scaling_init(gen, lead + (inner, 2 * h), dtype),
        "b_if": b_if.to(dev).expand(lead + (2 * h,)).contiguous(),
        "gn_scale": torch.ones(lead + (inner,), dtype=torch.float32,
                               device=dev),
        "w_down": variance_scaling_init(gen, lead + (inner, d), dtype,
                                        fan_in=inner),
    }


def _headwise_rms(x: torch.Tensor, scale: torch.Tensor,
                  h: int) -> torch.Tensor:
    """Per-head RMS norm over (..., H * dh) in float32, scaled, returned in
    x's dtype."""
    lead, inner = x.shape[:-1], x.shape[-1]
    xh = x.reshape(*lead, h, inner // h).float()
    xh = xh * torch.rsqrt(xh.square().mean(-1, keepdim=True) + 1e-6)
    return (xh.reshape(*lead, inner) * scale.float()).to(x.dtype)


def _mlstm_split(params: dict, cfg: ModelConfig
                 ) -> Optional[tp.ModelAxis]:
    """The model axis when this rank holds a block of the mLSTM's heads
    (module docstring), else None."""
    return tp.split_of(params["w_down"].shape[-2], _mlstm_dims(cfg)[0])


def _mlstm_qkv_gates(params: dict, x: torch.Tensor, cfg: ModelConfig,
                     conv_tail: Optional[torch.Tensor] = None,
                     norm_scale: Optional[torch.Tensor] = None):
    """q, k, v (B, S, inner) in x's dtype, log_i and log_f (B, S, H) in
    float32, the output gate's input z and the conv's input x_m.  With
    ``norm_scale``, x is the block's input before its norm1 and the up
    projection is ``rmsnorm_gemm(x, norm_scale, w_up)``.  Under tensor
    parallelism, each of them is the rank's heads' (module docstring)."""
    dtype = x.dtype
    ax = _mlstm_split(params, cfg)
    inner = params["w_down"].shape[-2]          # the heads held here
    h = cfg.num_heads if ax is None else cfg.num_heads // ax.size
    if ax is not None:
        x = ax.enter(x)
    w_up = compute_cast(params["w_up"], dtype)
    up = (ops.sma_gemm(x, w_up) if norm_scale is None
          else ops.rmsnorm_gemm(x, norm_scale, w_up))
    x_m, z = up[..., :inner], up[..., inner:]
    xc = F.silu(causal_conv1d(x_m, params["conv_w"], params["conv_b"],
                              tail=conv_tail))
    xc_in, xm_in = ((xc, x_m) if ax is None
                    else (ax.gather(xc), ax.gather(x_m.contiguous())))
    q = ops.sma_gemm(xc_in, compute_cast(params["w_q"], dtype))
    k = ops.sma_gemm(xc_in, compute_cast(params["w_k"], dtype))
    v = ops.sma_gemm(xm_in, compute_cast(params["w_v"], dtype))
    w_if, b_if = params["w_if"], params["b_if"]
    if ax is not None:
        w_if, b_if = ax.enter(w_if), ax.enter(b_if)
    if_gates = (ops.sma_gemm(xc_in, compute_cast(w_if, dtype)).float()
                + b_if.float())
    if ax is None:
        log_i, log_f = if_gates[..., :h], F.logsigmoid(if_gates[..., h:])
    else:                       # every head's gates; this rank's heads
        heads = ax.block(h)
        whole = cfg.num_heads
        log_i = if_gates[..., :whole][..., heads]
        log_f = F.logsigmoid(if_gates[..., whole:][..., heads])
    return q, k, v, log_i, log_f, z, x_m


def _mlstm_out(params: dict, out: torch.Tensor, z: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    """Headwise norm, the silu(z) output gate, then ``w_down`` (a row
    block before *g* under tensor parallelism)."""
    ax = _mlstm_split(params, cfg)
    h = cfg.num_heads if ax is None else cfg.num_heads // ax.size
    out = _headwise_rms(out, params["gn_scale"], h) * F.silu(z)
    y = ops.sma_gemm(out, compute_cast(params["w_down"], out.dtype))
    return y if ax is None else ax.exit(y)


def _mlstm_sequence(params: dict, x: torch.Tensor, cfg: ModelConfig,
                    return_state: bool):
    """The block over a whole sequence through the chunkwise kernel.
    Returns y (B, S, D), and with ``return_state`` also the decode state."""
    b, s, _ = x.shape
    _, dh = _mlstm_dims(cfg)
    inner = params["w_down"].shape[-2]          # the heads held here
    h = inner // dh
    q, k, v, log_i, log_f, z, x_m = _mlstm_qkv_gates(params, x, cfg)

    def heads(t: torch.Tensor) -> torch.Tensor:
        return t.reshape(b, s, h, dh).transpose(1, 2)

    res = ops.mlstm_chunkwise(heads(q), heads(k), heads(v),
                              log_f.transpose(1, 2), log_i.transpose(1, 2),
                              chunk=cfg.mlstm_chunk,
                              return_state=return_state)
    out = res[0] if return_state else res
    y = _mlstm_out(params, out.transpose(1, 2).reshape(b, s, inner), z, cfg)
    if not return_state:
        return y
    c, n, m = res[1]
    return y, {"c": c, "n": n, "m": m,
               "conv_tail": x_m[:, -(CONV_WIDTH - 1):]
               .to(cfg.activation_dtype).contiguous()}


def mlstm_block_apply(params: dict, x: torch.Tensor,
                      cfg: ModelConfig) -> torch.Tensor:
    """Training / forward path.  x (B, S, D) -> (B, S, D)."""
    return _mlstm_sequence(params, x, cfg, return_state=False)


_MLSTM_HEADS = ("c", "n", "m")
_SLSTM_HEADS = ("c", "n", "m", "h")


def mlstm_block_prefill(params: dict, x: torch.Tensor, cfg: ModelConfig
                        ) -> Tuple[torch.Tensor, dict]:
    """The forward that also returns the decode state: the kernel's final
    (C, n, m) in float32 (every head's: gathered over the line under
    tensor parallelism) and the last 3 conv inputs."""
    y, state = _mlstm_sequence(params, x, cfg, return_state=True)
    return y, _whole_heads(state, _mlstm_split(params, cfg), _MLSTM_HEADS)


def mlstm_block_init_state(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                           device: torch.device) -> dict:
    """Zero C (B, H, dh, dh), n (B, H, dh) and m (B, H) in float32, and a
    zero ``conv_tail`` (B, 3, inner) in ``dtype``."""
    inner, dh = _mlstm_dims(cfg)
    h = cfg.num_heads

    def zeros(*shape, dt=torch.float32):
        return torch.zeros(shape, dtype=dt, device=device)

    return {"c": zeros(batch, h, dh, dh), "n": zeros(batch, h, dh),
            "m": zeros(batch, h),
            "conv_tail": zeros(batch, CONV_WIDTH - 1, inner, dt=dtype)}


def mlstm_block_decode(params: dict, x: torch.Tensor, state: dict,
                       cfg: ModelConfig,
                       norm_scale: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, dict]:
    """One decode step, the sequential mLSTM update in float32.  x (B, 1,
    D) -> (y (B, 1, D), new state); ``state`` is not modified.  With
    ``norm_scale`` (the block's norm1 scale), x is the block's input and
    norm1 -> w_up runs as one ``rmsnorm_gemm``: the site the compiler's
    prologue rule makes of that chain, so the paged decode step
    (:mod:`repro_torch.serving.model`) launches what its compiled tick
    launches.  Under tensor parallelism on the rank's heads (module
    docstring)."""
    b = x.shape[0]
    _, dh = _mlstm_dims(cfg)
    ax = _mlstm_split(params, cfg)
    inner = params["w_down"].shape[-2]          # the heads held here
    h = inner // dh
    state = _own_heads(state, ax, h, _MLSTM_HEADS)
    q, k, v, log_i, log_f, z, x_m = _mlstm_qkv_gates(
        params, x, cfg, conv_tail=state["conv_tail"], norm_scale=norm_scale)
    tail = torch.cat([state["conv_tail"][:, 1:],
                      x_m.to(state["conv_tail"].dtype)], dim=1)

    def heads(t: torch.Tensor) -> torch.Tensor:
        return t[:, 0].reshape(b, h, dh).float()

    q1, k1, v1 = heads(q) * dh ** -0.5, heads(k), heads(v)
    lf, li = log_f[:, 0], log_i[:, 0]                       # (B, H)
    m_new = torch.maximum(lf + state["m"], li)
    f_t = torch.exp(lf + state["m"] - m_new)
    i_t = torch.exp(li - m_new)
    c = (f_t[..., None, None] * state["c"]
         + i_t[..., None, None] * (k1[..., :, None] * v1[..., None, :]))
    n = f_t[..., None] * state["n"] + i_t[..., None] * k1
    num = torch.einsum("bhde,bhd->bhe", c, q1)
    den = torch.maximum(torch.einsum("bhd,bhd->bh", n, q1).abs(),
                        torch.exp(-m_new))[..., None]
    out = (num / den).reshape(b, 1, inner).to(x.dtype)
    new = _whole_heads({"c": c, "n": n, "m": m_new}, ax, _MLSTM_HEADS)
    return _mlstm_out(params, out, z, cfg), {**new, "conv_tail": tail}


# ===========================================================================
# xLSTM sLSTM block (scalar memory; sequential)
# ===========================================================================
def slstm_block_init(gen: torch.Generator, cfg: ModelConfig,
                     dtype: torch.dtype, lead: Tuple[int, ...] = ()) -> dict:
    """The JAX block's shapes and draws: the post-FF width is 4/3 d rounded
    up to a multiple of 128 (2816 at d 2048); ``r_gates`` (H, dh, 4 dh)
    over dh and ``gn_scale`` are float32, as the step and the norm read
    them; the gate bias is zero."""
    d, h = cfg.d_model, cfg.num_heads
    dh = d // h
    ff = -(-int(math.ceil(4.0 * d / 3.0)) // 128) * 128
    dev = gen.device
    return {
        "w_gates": variance_scaling_init(gen, lead + (d, 4 * d), dtype),
        "r_gates": variance_scaling_init(gen, lead + (h, dh, 4 * dh),
                                         torch.float32, fan_in=dh),
        "b_gates": torch.zeros(lead + (4 * d,), dtype=dtype, device=dev),
        "gn_scale": torch.ones(lead + (d,), dtype=torch.float32,
                               device=dev),
        "w_ff1": variance_scaling_init(gen, lead + (d, ff), dtype),
        "w_ff2": variance_scaling_init(gen, lead + (ff, d), dtype,
                                       fan_in=ff),
    }


def _slstm_gates(params: dict, x: torch.Tensor) -> torch.Tensor:
    """W x + b for every step, (B, S, 4D) in x's dtype."""
    return ops.sma_gemm(x, compute_cast(params["w_gates"], x.dtype),
                        bias=params["b_gates"].to(x.dtype))


def _slstm_step(r_gates: torch.Tensor, wx_t: torch.Tensor, state: dict,
                h_heads: int) -> dict:
    """One sLSTM step in float32.  wx_t (B, 4D), W x_t + b; r_gates (H,
    dh, 4 dh) float32.  Returns the new state {c, n, m, h}, each (B, H,
    dh)."""
    b = wx_t.shape[0]
    rec = torch.einsum("bhd,hdf->bhf", state["h"], r_gates)
    gates = wx_t.float().reshape(b, h_heads, -1) + rec
    li, lf, z_raw, o_raw = gates.chunk(4, dim=-1)
    lf = F.logsigmoid(lf)
    m_new = torch.maximum(lf + state["m"], li)
    i_t = torch.exp(li - m_new)
    f_t = torch.exp(lf + state["m"] - m_new)
    c = f_t * state["c"] + i_t * torch.tanh(z_raw)
    n = torch.clamp(f_t * state["n"] + i_t, min=1e-6)
    h_new = torch.sigmoid(o_raw) * (c / n)
    return {"c": c, "n": n, "m": m_new, "h": h_new}


def _slstm_out(params: dict, hs: torch.Tensor, h_heads: int,
               ax: Optional[tp.ModelAxis] = None) -> torch.Tensor:
    """Headwise norm of the hidden states (B, S, D), then the post-FF:
    ``gelu(hs @ w_ff1) @ w_ff2``.  With ``ax`` (tensor parallelism) hs
    holds this rank's ``h_heads`` heads: they read their slice of the whole
    ``gn_scale`` behind *f*, the normed states are gathered whole for
    ``w_ff1`` (a column block), and ``w_ff2`` is a row block before
    *g*."""
    scale = params["gn_scale"]
    if ax is not None:
        scale = ax.enter(scale)[ax.block(hs.shape[-1])]
    hs = _headwise_rms(hs, scale, h_heads)
    if ax is not None:
        hs = ax.gather(hs)
    ff = ops.sma_gemm(hs, compute_cast(params["w_ff1"], hs.dtype),
                      epilogue="gelu")
    y = ops.sma_gemm(ff, compute_cast(params["w_ff2"], hs.dtype))
    return y if ax is None else ax.exit(y)


def _slstm_body(h_heads: int, state: dict, wx_t: torch.Tensor,
                r_gates: torch.Tensor) -> Tuple[dict, torch.Tensor]:
    """:func:`_slstm_step` as a scan body: (new state, its h)."""
    new = _slstm_step(r_gates, wx_t, state, h_heads)
    return new, new["h"]


def slstm_block_prefill(params: dict, x: torch.Tensor, cfg: ModelConfig
                        ) -> Tuple[torch.Tensor, dict]:
    """The block over a whole sequence, one step at a time from the zero
    state, as one :func:`repro_torch.compiler.loop.scan` (the reference's
    ``lax.scan``): eagerly a Python loop, in a compiled step one loop node
    (and one reverse loop node in its backward).  x (B, S, D) -> (y (B, S,
    D), the final state, every head's: gathered over the line under tensor
    parallelism)."""
    y, state = _slstm_sequence(params, x, cfg)
    ax = tp.split_of(params["r_gates"].shape[-3], cfg.num_heads)
    return y, _whole_heads(state, ax, _SLSTM_HEADS)


def _slstm_sequence(params: dict, x: torch.Tensor, cfg: ModelConfig
                    ) -> Tuple[torch.Tensor, dict]:
    """:func:`slstm_block_prefill` with the final state of the heads held
    here (the training forward's)."""
    b, s, d = x.shape
    heads = params["r_gates"].shape[-3]          # the heads held here
    ax = tp.split_of(heads, cfg.num_heads)
    if ax is not None:
        x = ax.enter(x)
    wx = _slstm_gates(params, x).float()   # read in f32 by every step
    state = slstm_block_init_state(cfg, b, x.dtype, x.device, heads)
    state, hs = loop.scan(functools.partial(_slstm_body, heads),
                          state, wx.transpose(0, 1),
                          params["r_gates"].float(), name="slstm_step")
    hs = hs.transpose(0, 1).reshape(b, s, -1).to(x.dtype)
    return _slstm_out(params, hs, heads, ax), state


def slstm_block_apply(params: dict, x: torch.Tensor,
                      cfg: ModelConfig) -> torch.Tensor:
    """Training / forward path.  x (B, S, D) -> (B, S, D)."""
    return _slstm_sequence(params, x, cfg)[0]


def slstm_block_init_state(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                           device: torch.device,
                           heads: Optional[int] = None) -> dict:
    """c, n, m, h (B, H, dh), all float32 whatever ``dtype``: zeros, with
    n at 1e-6 (``heads``: the rank's H under tensor parallelism)."""
    dh = cfg.d_model // cfg.num_heads
    z = torch.zeros((batch, heads or cfg.num_heads, dh), dtype=torch.float32,
                    device=device)
    return {"c": z, "n": z + 1e-6, "m": z.clone(), "h": z.clone()}


def slstm_block_decode(params: dict, x: torch.Tensor, state: dict,
                       cfg: ModelConfig) -> Tuple[torch.Tensor, dict]:
    """One decode step.  x (B, 1, D) -> (y (B, 1, D), new state); ``state``
    is not modified.  Under tensor parallelism on the rank's heads (module
    docstring)."""
    b = x.shape[0]
    heads = params["r_gates"].shape[-3]          # the heads held here
    ax = tp.split_of(heads, cfg.num_heads)
    if ax is not None:
        x = ax.enter(x)
    new = _slstm_step(params["r_gates"].float(), _slstm_gates(params, x)[:, 0],
                      _own_heads(state, ax, heads, _SLSTM_HEADS), heads)
    hs = new["h"].reshape(b, 1, -1).to(x.dtype)
    return (_slstm_out(params, hs, heads, ax),
            _whole_heads(new, ax, _SLSTM_HEADS))
