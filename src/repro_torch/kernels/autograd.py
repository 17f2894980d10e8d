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
* :class:`RgluScan` -- the RG-LRU scan; the forward saves a and h_seq,
  the backward is one ``rglru_scan_bwd`` launch (the reverse recurrence),
  which gives (da, du, dh0), dh0 None without h0.
* :class:`MlstmChunkwise` -- the chunkwise mLSTM, with or without its
  final state; the forward saves its inputs, the backward
  (:func:`mlstm_chunkwise_backward`) is one ``mlstm_chunkwise_bwd`` call:
  the kernel on the card (which recomputes the chunk states), the gradient
  of the plain forward by autograd on the CPU.

The GEMM backward formulas are :func:`sma_gemm_backward` and
:func:`rmsnorm_gemm_backward`, written over the ``gemm`` that makes each
product: the Functions pass the wrapper, and the compiler's gradient call
sites (:mod:`repro_torch.compiler.trace`) pass the ``repro_torch::sma_gemm``
custom op, so a traced backward records one node per launch of this one.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch

from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import mlstm as _mlstm
from repro_torch.kernels import norm_gemm as _norm
from repro_torch.kernels import rglru as _rglru
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


#: ``gemm(a, b, bias)``: one ``epilogue="none"`` product, the launch the
#: backward formulas below make for each of theirs.
Gemm = Callable[[torch.Tensor, torch.Tensor, Optional[torch.Tensor]],
                torch.Tensor]


def sma_gemm_backward(gemm: Gemm, a: torch.Tensor, b: torch.Tensor,
                      bias: Optional[torch.Tensor], epilogue: str,
                      dc: torch.Tensor, needs: Sequence[bool]):
    """(dA, dB, dbias) of ``C = epilogue(A @ B + bias)``, each None where
    ``needs`` (the inputs' ``needs_input_grad``) says no."""
    k, n = b.shape
    a2 = a.reshape(-1, k)
    dz = _dz(dc.reshape(-1, n), lambda: gemm(a2, b, bias), epilogue,
             a.dtype)
    da = db = dbias = None
    if needs[0]:
        da = gemm(dz, _t(b), None).reshape(a.shape)
    if needs[1]:
        db = gemm(_t(a2), dz, None)
    if bias is not None and needs[2]:
        dbias = dz.float().sum(0).to(bias.dtype)
    return da, db, dbias


def rmsnorm_gemm_backward(gemm: Gemm, x: torch.Tensor, scale: torch.Tensor,
                          w: torch.Tensor, epilogue: str, eps: float,
                          dy: torch.Tensor, needs: Sequence[bool]):
    """(dx, dscale, dW) of ``Y = epilogue(rmsnorm(x; scale) @ W)``, each
    None where ``needs`` says no."""
    k, n = w.shape
    x2 = x.reshape(-1, k)
    r = rms_inverse(x2, eps)                      # (M, 1) f32
    xr = x2.float() * r
    normed = (xr * scale.float()).to(x.dtype)
    dz = _dz(dy.reshape(-1, n), lambda: gemm(normed, w, None), epilogue,
             x.dtype)
    dx = dscale = dw = None
    if needs[2]:
        dw = gemm(_t(normed), dz, None)
    if needs[0] or needs[1]:
        dn = gemm(dz, _t(w), None).float()        # d normed, (M, K)
        if needs[1]:
            dscale = (dn * xr).sum(0).to(scale.dtype)
        if needs[0]:
            gs = dn * scale.float()
            dx = r * (gs - xr * (gs * xr).mean(-1, keepdim=True))
            dx = dx.to(x.dtype).reshape(x.shape)
    return dx, dscale, dw


def flash_attention_backward(bwd: Callable, saved: Sequence[torch.Tensor],
                             dout: torch.Tensor, *, causal: bool,
                             window: Optional[int], scale: Optional[float]):
    """(dq, dk, dv) of the flash forward from its saved (q, k, v, out,
    lse), by one ``bwd(q, k, v, out, lse, dout, causal, window, scale)``
    call (the backward kernel recomputes P from ``lse``)."""
    q, k, v, out, lse = saved
    return bwd(q, k, v, out, lse, dout.contiguous(), causal, window, scale)


def mlstm_chunkwise_backward(ins: Sequence[torch.Tensor], chunk: int,
                             grads: Sequence[Optional[torch.Tensor]]):
    """(dq, dk, dv, dlog_f, dlog_i) of the chunkwise mLSTM's (h, C, n, m)
    (``ins`` = q, k, v, log_f, log_i; ``grads`` the gradients of h and of
    the state, None where the output is not read): one
    ``mlstm_chunkwise_bwd`` call (the kernel for CUDA tensors, which takes
    no gradient of m; for CPU tensors the gradient of the plain version
    :func:`repro_torch.kernels.ref.mlstm_chunkwise_ref` by autograd)."""
    dh, dc, dn, dm = (tuple(grads) + (None,) * 4)[:4]
    return _mlstm.mlstm_chunkwise_bwd(
        *ins, dh.contiguous() if dh is not None else None, dc, dn, dm,
        chunk=chunk)


def _launch_flash_bwd(q, k, v, out, lse, dout, causal, window, scale):
    return _flash.flash_attention_bwd(q, k, v, out, lse, dout, causal=causal,
                                      window=window, scale=scale)


def _launch_gemm(a: torch.Tensor, b: torch.Tensor,
                 bias: Optional[torch.Tensor]) -> torch.Tensor:
    return _gemm.sma_gemm(a, b, bias=bias)


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
        return (*sma_gemm_backward(_launch_gemm, a, b, bias, ctx.epilogue,
                                   dc, ctx.needs_input_grad), None)


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
        return (*rmsnorm_gemm_backward(_launch_gemm, x, scale, w,
                                       ctx.epilogue, ctx.eps, dy,
                                       ctx.needs_input_grad), None, None)


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
        return (*flash_attention_backward(_launch_flash_bwd, ctx.saved_tensors,
                                          dout, **ctx.args), None, None, None)


class RgluScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a: torch.Tensor, u: torch.Tensor,
                h0: Optional[torch.Tensor]):
        h_seq, h_last = _rglru.rglru_scan(a, u, h0)
        ctx.save_for_backward(a, h_seq, h0)
        return h_seq, h_last

    @staticmethod
    def backward(ctx, dh_seq: torch.Tensor, dh_last: torch.Tensor):
        a, h_seq, h0 = ctx.saved_tensors
        return _rglru.rglru_scan_bwd(a, h_seq, dh_seq.contiguous(), h0=h0,
                                     dh_last=dh_last)


class MlstmChunkwise(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                log_f: torch.Tensor, log_i: torch.Tensor, chunk: int,
                return_state: bool):
        ctx.save_for_backward(q, k, v, log_f, log_i)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        out = _mlstm.mlstm_chunkwise(q, k, v, log_f, log_i, chunk=chunk,
                                     return_state=return_state)
        return (out[0], *out[1]) if return_state else out

    @staticmethod
    def backward(ctx, dh: Optional[torch.Tensor], *dstate):
        return (*mlstm_chunkwise_backward(ctx.saved_tensors, ctx.chunk,
                                          (dh, *dstate)), None, None)
