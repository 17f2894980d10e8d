"""Flash attention for Hopper, forward and backward (train/prefill path).

Replaces the Pallas kernel ``repro/kernels/flash_attention.py:101``
(``flash_attention``).  The CUDA kernels (``csrc/flash_attention.cu``) run
on ``wgmma`` + TMA with warp specialisation: a block of three warpgroups,
one producer that keeps TMA loads in flight and two consumers of 64 rows
each.  The forward gives a block 128 query rows of one (batch, head) and
loops over the visible KV tiles inside the block, with the online softmax
in f32 registers; the backward (FlashAttention-2) gives a block 128 keys
of one (batch, KV head), recomputes ``P`` from the forward's ``lse``,
sums dK/dV over the group in registers, and (head_dim 64 and 128) adds dQ
into an f32 buffer with TMA reduce-adds, in no fixed order.  At head_dim
256 the backward runs in two passes with no unordered add, so its
gradients are the same bits from run to run: pass 1 gives a block 64 keys
of one (batch, KV head), a producer warpgroup and two consumers split by
role (one computes S and P and sums dV, the other dP and dS and sums dK:
each score product once), and stores each rounded dS tile to a banded
scratch (one 64 x 64 tile a visible (query tile, key tile) pair; the
library's ``flash_attention_bwd256_slots`` counts them); pass 2 gives a
block 64 query rows of one (batch, query head) and sums dS K over the key
tiles they see in ascending order.
KV tiles wholly in the future or before the window are skipped, keys past
``Skv`` are masked in the kernel, and query head ``h`` reads KV head
``h // group``.

Bound on an H100: operations (``4 * D`` flops per visible (query, key)
pair forward, 2.5x that backward).

Two wrappers, each with its own launch counter and its launches by route
(``.routes``, zeroed by ``ops.reset_counts``; :func:`_route` picks the
route statically):

* :func:`flash_attention_fwd` -- ``(out, lse)``; plain version
  :func:`repro_torch.kernels.ref.flash_attention_ref`.
* :func:`flash_attention_bwd` -- ``(dq, dk, dv)``; plain version
  :func:`repro_torch.kernels.ref.flash_attention_bwd_ref`.  One call
  launches two kernels (``D = rowsum(dO * O)``, then the main pass; at
  head_dim 256 three: the delta pass, pass 1 and pass 2) and counts once.
  The D 256 passes' algorithm in plain PyTorch is
  :func:`repro_torch.kernels.ref.flash_attention_bwd256_split_ref`.

Each runs its plain version only for CPU tensors; for CUDA tensors it
launches the kernel or raises.  The kernels take bf16/f16 and head_dim
64, 128 or 256.  Anything else on the card raises.  The D 256 backward's
dS scratch is B * Hq * 8 KB a visible (query tile, key tile) pair
(0.26 GB at RecurrentGemma's training call), allocated per call.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (flash_attention_bwd_ref,
                                     flash_attention_ref)
from repro_torch.kernels.sma_gemm import DTYPE_CODES

#: head_dims each kernel takes.
FWD_HEAD_DIMS = (64, 128, 256)
BWD_HEAD_DIMS = (64, 128, 256)
#: Shared memory a block can use on an H100 (227 KB).
SMEM_LIMIT = 232_448
#: Rows and columns of a dS tile of the D 256 backward's scratch
#: (``Bwd256::TILE``).
BWD256_TILE = 64

#: q, k, v, out, lse; B, Hq, Hkv, Sq, Skv, D; scale; causal, window,
#: dtype; stream.
_FWD_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                 + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
#: q, k, v, out, dout, lse, delta, dq, dk, dv, the D 256 dS scratch; then
#: as the forward, with the scratch's slots a (batch, query head) and the
#: planted faults' mask after the dtype.
_BWD_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 6
                 + [ctypes.c_float] + [ctypes.c_int] * 5 + [ctypes.c_void_p])


def _lib() -> ctypes.CDLL:
    return _build.load("flash_attention",
                       {"flash_attention_fwd_launch": _FWD_ARGTYPES,
                        "flash_attention_bwd_launch": _BWD_ARGTYPES,
                        "flash_attention_smem": [ctypes.c_int] * 2,
                        "flash_attention_bwd256_slots": [ctypes.c_int] * 4})


def _route(d: int, dtype: torch.dtype, backward: bool = False) -> str:
    """The kernel for head_dim ``d``: ``"wgmma"`` (the TMA + wgmma
    kernels) for every (dtype, head_dim) the wrappers take."""
    dims = BWD_HEAD_DIMS if backward else FWD_HEAD_DIMS
    if dtype not in (torch.bfloat16, torch.float16) or d not in dims:
        raise ValueError(f"no flash route for {dtype}, head_dim {d}")
    return "wgmma"


def smem_bytes(d: int, backward: bool = False, dq_pass: bool = False
               ) -> int:
    """Dynamic shared memory of the kernel for head_dim ``d``, as
    ``csrc/flash_attention.cu`` sizes it (``Fwd<D>::SMEM``,
    ``Bwd<D>::SMEM``; at D 256 the backward's pass 1 ``Bwd256::SMEM``, or
    with ``dq_pass`` its pass 2 ``Bwd256::DQ_SMEM``): 64-column boxes of
    128-byte rows, 1 KB to align the swizzled tiles, 8 bytes an mbarrier.
    Asserts that it fits the 227 KB a block may use."""
    boxes = d // 64
    tile = boxes * 64 * 128  # a 64-row tile of K, V, Q or dO
    if backward and d == 256 and dq_pass:  # 4 x (K, 2 x dS 64 x 64);
        #                                    2 x 4 mbarriers
        size = 4 * (tile + 2 * 64 * 64 * 2) + 1024 + 8 * 8
    elif backward and d == 256:  # K, V; 2 x (Q, dO); 2 P^T parts (64 x 16
        #                          f32); dS^T 64 x 64; 2 x (lse, delta, 4
        #                          words of metadata); 1 + 2 x 2 + 4
        #                          mbarriers
        size = (2 * tile + 2 * 2 * tile + 2 * 64 * 16 * 4 + 64 * 64 * 2
                + 2 * (2 * 64 + 4) * 4 + 1024 + 8 * 9)
    elif backward:  # K, V (128 keys); a ring of (Q, dO of 64 rows, dS^T,
        #             lse / delta); 2 dQ tiles (64 x d f32); 1 + 3 x stages
        #             mbarriers
        stages = 3 if d == 64 else 2
        size = (2 * boxes * 128 * 128
                + stages * (2 * boxes * 64 * 128 + 128 * 64 * 2 + 2 * 64 * 4)
                + 2 * 64 * d * 4 + 1024 + 8 * (1 + 3 * stages))
    else:  # Q (128 rows); a ring of (K, V of tk keys); 1 + 2 x stages
        #    mbarriers
        tk, stages = (64, 2) if d > 128 else (128, 3)
        size = (boxes * 128 * 128 + stages * 2 * boxes * tk * 128 + 1024
                + 8 * (1 + 2 * stages))
    assert size <= SMEM_LIMIT, f"{size} bytes of shared memory"
    return size


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, with a 16-byte aligned start (TMA's rule for a tensor
    map's base)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check(head_dims: Tuple[int, ...], q: torch.Tensor, k: torch.Tensor,
           v: torch.Tensor, *more: torch.Tensor
           ) -> Tuple[int, int, int, int, int, int]:
    b, hq, sq, d = q.shape
    b2, hkv, skv, d2 = k.shape
    if b2 != b or d2 != d or v.shape != k.shape or hkv == 0 or hq % hkv:
        raise ValueError(f"shapes do not match: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    for t in (k, v, *more):
        if t.device != q.device:
            raise ValueError(f"all inputs must be on {q.device}")
    if q.dtype not in (torch.bfloat16, torch.float16) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"the flash kernels take bf16/f16 q, k, v of one "
                         f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if d not in head_dims:
        which = "forward" if head_dims == FWD_HEAD_DIMS else "backward"
        raise ValueError(f"the flash {which} kernel takes head_dim in "
                         f"{head_dims}, got {d}")
    return b, hq, hkv, sq, skv, d


def _window(window: Optional[int]) -> int:
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    return 0 if window is None else int(window)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: Optional[int] = None,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Online-softmax attention.  q (B, Hq, Sq, D); k/v (B, Hkv, Skv, D).

    Returns ``out`` (B, Hq, Sq, D) in q's dtype and ``lse`` (B, Hq, Sq)
    float32, the log-sum-exp of each row's scaled scores (+inf for a row
    that sees no key).
    """
    if not _build.on_card("flash_attention", q):
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   scale=scale)
    b, hq, hkv, sq, skv, d = _check(FWD_HEAD_DIMS, q, k, v)
    win = _window(window)
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    if out.numel():
        route = _route(d, q.dtype)
        scale = float(scale) if scale is not None else d ** -0.5
        lib = _lib()
        with torch.cuda.device(q.device):
            err = lib.flash_attention_fwd_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr(), b, hq, hkv, sq, skv, d, scale, int(causal),
                win, DTYPE_CODES[q.dtype], _build.stream_of(q))
        _build.check(lib, err, f"flash_attention_fwd ({route})")
        flash_attention_fwd.launches += 1
        FWD_ROUTES[route] += 1
    return out, lse


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, *, causal: bool = True,
                        window: Optional[int] = None,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients of :func:`flash_attention_fwd`'s ``out`` with respect to
    q, k and v, given ``out``, ``lse`` and ``dout`` (B, Hq, Sq, D).
    Returns (dq, dk, dv) in the inputs' dtype; dk and dv are summed over
    the query heads of each KV head."""
    if not _build.on_card("flash_attention_bwd", q):
        return flash_attention_bwd_ref(q, k, v, out, lse, dout,
                                       causal=causal, window=window,
                                       scale=scale)
    b, hq, hkv, sq, skv, d = _check(BWD_HEAD_DIMS, q, k, v, out, lse,
                                    dout)
    if out.shape != q.shape or dout.shape != q.shape \
            or lse.shape != (b, hq, sq):
        raise ValueError(f"out {tuple(out.shape)}, dout "
                         f"{tuple(dout.shape)} and lse {tuple(lse.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if out.dtype != q.dtype or dout.dtype != q.dtype \
            or lse.dtype != torch.float32:
        raise ValueError(f"out/dout must be {q.dtype} and lse float32, got "
                         f"{out.dtype}, {dout.dtype}, {lse.dtype}")
    out = _run_bwd(q, k, v, out, lse, dout, causal, window, scale)
    if q.numel() and k.numel():
        flash_attention_bwd.launches += 1
        BWD_ROUTES[_route(d, q.dtype, backward=True)] += 1
    return out


def _run_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
             causal: bool, window: Optional[int], scale: Optional[float],
             plant: int = 0
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One launch of the backward kernels on checked CUDA inputs; counts
    nothing.  ``plant`` feeds the D 256 kernels their planted faults (a
    mask of ``ref.FLASH_PLANT_*``; ``chip_smoke.py``), 0 on every real
    call; a planted call zeroes the dS scratch first, so that a slot pass 1
    skipped reads as zeros.  Records the D 256 scratch's bytes on
    ``flash_attention_bwd.scratch_bytes``."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    win = _window(window)
    q, k, v, out, dout = (_aligned(t) for t in (q, k, v, out, dout))
    lse = lse.contiguous()
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if not (q.numel() and k.numel()):
        dk.zero_()
        dv.zero_()
        return torch.zeros_like(q), dk, dv
    lib = _lib()
    slots, ds = 0, None
    if d == 256:  # dQ written once in q's dtype; dS through the scratch
        slots = lib.flash_attention_bwd256_slots(sq, skv, int(causal), win)
        dq = torch.empty_like(q)
        ds = (torch.zeros if plant else torch.empty)(
            (max(b * hq * slots, 1) * BWD256_TILE, BWD256_TILE),
            dtype=q.dtype, device=q.device)
        flash_attention_bwd.scratch_bytes = ds.nbytes
    else:         # dQ summed into a zeroed f32 buffer
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    delta = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    route = _route(d, q.dtype, backward=True)
    scale = float(scale) if scale is not None else d ** -0.5
    with torch.cuda.device(q.device):
        err = lib.flash_attention_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), ds.data_ptr() if ds is not None
            else None, b, hq, hkv, sq, skv, d, scale, int(causal), win,
            DTYPE_CODES[q.dtype], slots, int(plant), _build.stream_of(q))
    _build.check(lib, err, f"flash_attention_bwd ({route})")
    return (dq if d == 256 else dq.to(q.dtype)), dk, dv


#: Launches per route (:func:`_route`), read as ``.routes`` on each
#: wrapper; ``ops.reset_counts`` clears them.  Module dicts, so a stand-in
#: that takes a wrapper's name (a planted fault) still counts into them.
FWD_ROUTES = {"wgmma": 0}
BWD_ROUTES = {"wgmma": 0}
flash_attention_fwd.launches = 0
flash_attention_fwd.routes = FWD_ROUTES
flash_attention_bwd.launches = 0
flash_attention_bwd.routes = BWD_ROUTES
#: Bytes of the dS scratch of the last D 256 backward on the card.
flash_attention_bwd.scratch_bytes = 0
