"""Public kernel entry points (counterpart of ``repro.kernels.ops``).

Models call these, never the kernel modules directly.  ``sma_gemm``,
``rmsnorm_gemm`` and ``decode_attention`` are the kernel wrappers
themselves; ``paged_decode_attention`` adds the routing below.  Each entry
point:

* dispatches by device: the kernel wrapper launches its CUDA kernel for a
  CUDA tensor (or raises) and runs its plain version for a CPU tensor.
  There is no runtime failover from a kernel to a plain version;
* routes statically, mirroring the JAX package: a paged-attention site with
  more than one query token per row (a chunked-prefill tile) or a window
  goes to the plain :func:`repro_torch.kernels.ref.paged_attention_ref`, as
  ``repro.kernels.decode_attention.paged_constraints`` routes it.  Each such
  call is counted in :data:`ROUTED` under its reason string;
* counts kernel launches on the wrappers (:func:`launch_counts`).

The JAX package's backend registry and ladder are not ported.
"""
from __future__ import annotations

import collections
from typing import Dict, Optional

import torch

from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.norm_gemm import rmsnorm_gemm
from repro_torch.kernels.ref import paged_attention_ref
from repro_torch.kernels.sma_gemm import sma_gemm

__all__ = ["ROUTED", "decode_attention", "launch_counts",
           "paged_decode_attention", "paged_route", "reset_counts",
           "rmsnorm_gemm", "sma_gemm"]

#: Calls routed to a plain version by design, keyed by reason.
ROUTED: Dict[str, int] = collections.Counter()

#: The kernel wrappers whose ``.launches`` the counters read.
WRAPPERS = {
    "sma_gemm": sma_gemm,
    "rmsnorm_gemm": rmsnorm_gemm,
    "paged_decode_attention": _decode.paged_decode_attention,
    "decode_attention": decode_attention,
}


def launch_counts() -> Dict[str, int]:
    """Kernel launches per wrapper since the last :func:`reset_counts`."""
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
    ROUTED.clear()


def paged_route(c: int, window: Optional[int]) -> Optional[str]:
    """Why a paged site goes to the plain version, or None for the kernel
    (the reasons of ``repro.kernels.decode_attention.paged_constraints``)."""
    if c != 1:
        return (f"shape:chunked prefill tile (C={c}) needs per-query "
                f"masking (single-token decode kernel only)")
    if window is not None:
        return "param:sliding-window masking runs on the SIMD paged path"
    return None


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_table: torch.Tensor,
                           q_pos: torch.Tensor, kv_len: torch.Tensor, *,
                           window: Optional[int] = None,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Block-table GQA attention over a paged pool (serving).

    q (B, C, Hq, D); k/v_pool (NB, Hkv, BS, D); block_table (B, MB) int32
    (entries >= NB unallocated); q_pos (B, C); kv_len (B,) valid lengths
    including this chunk.  Returns (B, C, Hq, D).  Single-token sites
    without a window go to the paged decode kernel (which, like the JAX
    kernel path, takes q_pos as kv_len - 1); the others are routed to
    :func:`paged_attention_ref`.
    """
    why = paged_route(q.shape[1], window)
    if why is not None:
        ROUTED[why] += 1
        return paged_attention_ref(q, k_pool, v_pool, block_table, q_pos,
                                   kv_len, window=window, scale=scale)
    out = _decode.paged_decode_attention(q[:, 0], k_pool, v_pool,
                                         block_table, kv_len, scale=scale)
    return out[:, None]
