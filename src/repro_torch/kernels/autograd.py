"""Gradients through the kernels: one ``torch.autograd.Function`` each.

A wrapper that writes its output through ctypes cuts the autograd graph,
so the trainer reaches the kernels only through these Functions.  Each
Function's forward and backward call the device-dispatching wrappers
(looked up on their modules at call time): on the card every product of
the backward is a kernel launch, on the CPU the same formulas run on the
plain versions, which is what the CPU tests hold against ``jax.grad``.

* :class:`SmaGemm` -- ``C = epilogue(A @ B + bias)``.  With
  ``dZ = dC * epilogue'(Z)``: ``dA = dZ @ B^T`` and ``dB = A^T @ dZ``, each
  one ``sma_gemm`` launch on contiguous transposes (copies: the kernel
  takes row-major operands only), and ``dbias = sum(dZ)``.  For an
  epilogue other than ``none`` the pre-activation Z is recomputed by one
  more ``sma_gemm`` launch (``epilogue="none"``) instead of being saved.
* :class:`RmsnormGemm` -- ``Y = epilogue(rmsnorm(x; scale) @ W)``.  The
  normalized rows are recomputed elementwise; ``dW = normed^T @ dZ`` and
  ``dnormed = dZ @ W^T`` are ``sma_gemm`` launches; the rmsnorm backward
  to ``dx`` and ``dscale`` is elementwise torch in f32.
* :class:`FlashAttention` -- the forward kernel saves ``lse``; the
  backward kernel recomputes P from it.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import norm_gemm as _norm
from repro_torch.kernels import sma_gemm as _gemm
from repro_torch.kernels.ref import rms_inverse

_GELU_C = math.sqrt(2.0 / math.pi)


def epilogue_grad(z: torch.Tensor, epilogue: str) -> torch.Tensor:
    """d epilogue / dz at the f32 pre-activation ``z``
    (:data:`repro_torch.core.sma.EPILOGUES`; gelu is the tanh form)."""
    if epilogue == "relu":
        return (z > 0).to(z.dtype)
    if epilogue == "gelu":
        u = _GELU_C * (z + 0.044715 * z ** 3)
        th = torch.tanh(u)
        du = _GELU_C * (1.0 + 3 * 0.044715 * z * z)
        return 0.5 * (1.0 + th) + 0.5 * z * (1.0 - th * th) * du
    if epilogue == "silu":
        sig = torch.sigmoid(z)
        return sig * (1.0 + z * (1.0 - sig))
    if epilogue == "tanh":
        return 1.0 - torch.tanh(z) ** 2
    raise ValueError(f"no gradient rule for epilogue {epilogue!r}")


def _dz(dc: torch.Tensor, z_fn, epilogue: str, dtype: torch.dtype
        ) -> torch.Tensor:
    """dZ = dC * epilogue'(Z) in ``dtype``; ``z_fn()`` recomputes Z."""
    if epilogue == "none":
        return dc.to(dtype)
    return (dc.float() * epilogue_grad(z_fn().float(), epilogue)).to(dtype)


def _t(x: torch.Tensor) -> torch.Tensor:
    """Row-major transpose of a matrix (a copy)."""
    return x.t().contiguous()


class SmaGemm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a: torch.Tensor, b: torch.Tensor,
                bias: Optional[torch.Tensor], epilogue: str) -> torch.Tensor:
        ctx.save_for_backward(a, b, bias)
        ctx.epilogue = epilogue
        return _gemm.sma_gemm(a, b, bias=bias, epilogue=epilogue)

    @staticmethod
    def backward(ctx, dc: torch.Tensor):
        a, b, bias = ctx.saved_tensors
        k, n = b.shape
        a2 = a.reshape(-1, k)
        dz = _dz(dc.reshape(-1, n),
                 lambda: _gemm.sma_gemm(a2, b, bias=bias), ctx.epilogue,
                 a.dtype)
        da = db = dbias = None
        if ctx.needs_input_grad[0]:
            da = _gemm.sma_gemm(dz, _t(b)).reshape(a.shape)
        if ctx.needs_input_grad[1]:
            db = _gemm.sma_gemm(_t(a2), dz)
        if bias is not None and ctx.needs_input_grad[2]:
            dbias = dz.float().sum(0).to(bias.dtype)
        return da, db, dbias, None


class RmsnormGemm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, scale: torch.Tensor, w: torch.Tensor,
                epilogue: str, eps: float) -> torch.Tensor:
        ctx.save_for_backward(x, scale, w)
        ctx.epilogue, ctx.eps = epilogue, eps
        return _norm.rmsnorm_gemm(x, scale, w, epilogue=epilogue, eps=eps)

    @staticmethod
    def backward(ctx, dy: torch.Tensor):
        x, scale, w = ctx.saved_tensors
        k, n = w.shape
        x2 = x.reshape(-1, k)
        r = rms_inverse(x2, ctx.eps)                  # (M, 1) f32
        xr = x2.float() * r
        normed = (xr * scale.float()).to(x.dtype)
        dz = _dz(dy.reshape(-1, n), lambda: _gemm.sma_gemm(normed, w),
                 ctx.epilogue, x.dtype)
        dx = dscale = dw = None
        if ctx.needs_input_grad[2]:
            dw = _gemm.sma_gemm(_t(normed), dz)
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            dn = _gemm.sma_gemm(dz, _t(w)).float()   # d normed, (M, K)
            if ctx.needs_input_grad[1]:
                dscale = (dn * xr).sum(0).to(scale.dtype)
            if ctx.needs_input_grad[0]:
                gs = dn * scale.float()
                dx = r * (gs - xr * (gs * xr).mean(-1, keepdim=True))
                dx = dx.to(x.dtype).reshape(x.shape)
        return dx, dscale, dw, None, None


class FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                causal: bool, window: Optional[int],
                scale: Optional[float]) -> torch.Tensor:
        out, lse = _flash.flash_attention_fwd(q, k, v, causal=causal,
                                              window=window, scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = dict(causal=causal, window=window, scale=scale)
        return out

    @staticmethod
    def backward(ctx, dout: torch.Tensor):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash.flash_attention_bwd(q, k, v, out, lse,
                                                dout.contiguous(), **ctx.args)
        return dq, dk, dv, None, None, None
