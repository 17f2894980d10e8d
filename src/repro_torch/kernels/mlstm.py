"""Chunkwise mLSTM for Hopper (xLSTM's matrix memory), with its state.

Replaces the Pallas kernel ``repro/kernels/mlstm.py:108``
(``mlstm_chunkwise``).  The CUDA kernel (``csrc/mlstm_chunkwise.cu``)
gives one block 128 value columns of one (batch, head) and walks the chunks
in order inside the block: the block's columns of the matrix memory C live
in the float32 state tensor this wrapper allocates (at head dim 1024 a
(batch, head)'s C is 4 MB, far past a block's shared memory), and what
every column block needs over the full head dim (S = q k^T, its decayed row
sums, q . n) each block computes itself.  All arithmetic is float32 on the
CUDA cores.  A ragged tail (S not a multiple of the chunk) is masked in the
kernel as the reference pads it (log f 0, log i -1e30), so the state
written is the state after S steps.

Unlike the TPU kernel, which streams h only (the JAX package sends a site
that needs the state down its XLA path), this kernel also writes the final
(C, n, m): the serving prefill takes its decode state from it.

Bound on an H100: operations (141.8 GFLOP at the xLSTM prefill shape B 4,
H 4, S 2048, D 1024, chunk 128, counting the causal (query, key) pairs only
and no q C0 on the first chunk: 0.143 ms at 989 TFLOP/s).

The wrapper runs the plain version :func:`repro_torch.kernels.ref.
mlstm_chunkwise_ref` only for CPU tensors; for CUDA tensors it launches the
kernel or raises, and counts its launches in ``mlstm_chunkwise.launches``.
There is no backward kernel (the TPU kernel has none either);
:func:`repro_torch.kernels.ops.mlstm_chunkwise` refuses a gradient on the
card.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import mlstm_chunkwise_ref
from repro_torch.kernels.sma_gemm import DTYPE_CODES

#: The longest chunk the kernel holds.
MAX_CHUNK = 128

#: q, k, v, log_f, log_i, out, C, n, m; B*H, S, D, L, dtype; stream.
_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def _lib() -> ctypes.CDLL:
    return _build.load("mlstm_chunkwise",
                       {"mlstm_chunkwise_launch": _ARGTYPES})


def mlstm_chunkwise(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    log_f: torch.Tensor, log_i: torch.Tensor, *,
                    chunk: int = 128, return_state: bool = False):
    """Stabilized chunkwise mLSTM.

    q/k/v (B, H, S, D) of one dtype (f32/bf16/f16); log_f/log_i (B, H, S),
    read as float32.  Chunks of L = min(chunk, S) steps, L <= 128 on the
    card.  Returns h (B, H, S, D) in q's dtype and, with ``return_state``,
    also (C (B, H, D, D), n (B, H, D), m (B, H)) in float32.
    """
    if not _build.on_card("mlstm_chunkwise", q):
        return mlstm_chunkwise_ref(q, k, v, log_f, log_i, chunk=chunk,
                                   return_state=return_state)
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k and v must share one (B, H, S, D) shape, "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, s, d = q.shape
    if log_f.shape != (b, h, s) or log_i.shape != (b, h, s):
        raise ValueError(f"log_f and log_i must be {(b, h, s)}, got "
                         f"{tuple(log_f.shape)} and {tuple(log_i.shape)}")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"q, k and v must share one of f32/bf16/f16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if any(t.device != q.device for t in (k, v, log_f, log_i)):
        raise ValueError(f"all inputs must be on {q.device}")
    if s < 1 or d < 1:
        raise ValueError(f"S and D must be positive, got {(s, d)}")
    L = min(chunk, s)
    if not 1 <= L <= MAX_CHUNK:
        raise ValueError(f"the kernel takes chunks of 1..{MAX_CHUNK} steps, "
                         f"got {chunk}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    lf = log_f.float().contiguous()
    li = log_i.float().contiguous()
    out = torch.empty_like(q)
    c = torch.empty((b, h, d, d), dtype=torch.float32, device=q.device)
    n = torch.empty((b, h, d), dtype=torch.float32, device=q.device)
    m = torch.empty((b, h), dtype=torch.float32, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        err = lib.mlstm_chunkwise_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lf.data_ptr(),
            li.data_ptr(), out.data_ptr(), c.data_ptr(), n.data_ptr(),
            m.data_ptr(), b * h, s, d, L, DTYPE_CODES[q.dtype],
            _build.stream_of(q))
    _build.check(lib, err, "mlstm_chunkwise")
    mlstm_chunkwise.launches += 1
    return (out, (c, n, m)) if return_state else out


mlstm_chunkwise.launches = 0
