#!/usr/bin/env python3
"""Build and drive the PyTorch/CUDA port on one NVIDIA card, and check it.

    python3 chip_smoke.py

1. Prints the card's name and power limit (``nvidia-smi``).  Without a card
   it exits non-zero and prints no result.
2. Builds every kernel from ``src/repro_torch/kernels/csrc/`` with ``nvcc``
   for ``sm_90a`` into ``build/kernels/`` (one ``nvcc`` per source, all at
   once).
3. Holds each kernel entry against its plain PyTorch version in bf16 at the
   main paths' own shapes, and times kernel, plain version, the one
   PyTorch call that computes the same function where there is one
   (``library_ms``, a yardstick the port never calls), and the bound.  The
   flash kernels (forward and backward) are also fed planted faults (a
   skipped KV tile, the diagonal key dropped, the backward's D term
   dropped), which their checks must catch.
4. Serving path: full-width StableLM-2-1.6B (random weights from a seed)
   through ``repro_torch.serving.ServeEngine``, 8 requests with prompts of
   64-512 tokens and 32 new tokens each, greedy.  Checks that every request
   finishes with 32 tokens, that every kernel of the path was launched in
   that run as many times as predicted, and that one decode step's logits
   through the kernels agree with the same step through the plain versions.
   Times a decode step with the GEMM entries through their autograd
   Functions and through the bare wrappers.
5. Training path: one step of a 4-layer full-width model through the
   kernels against the same step through the plain versions (loss, grad
   norm, every weight's gradient a layer at a time), and the same step with
   planted backward faults, which the limits must catch; then
   ``repro_torch.launch.train.train`` on full-width, full-depth
   StableLM-2-1.6B, sequence 2048, batch 4, remat, 5 steps: finite losses
   that fall, launch counts as predicted, nothing routed, step time,
   tokens/s, MFU and peak memory; a profile of one more step.
6. Prints the kernel table as one JSON line, then the result line
   ``{"ok": true, "device": {...}}`` last.

Imports nothing of JAX or of the JAX package.  Any failed check raises and
the script exits non-zero before the result line.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, DataPipeline  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import autograd as kautograd  # noqa: E402
from repro_torch.kernels import decode_attention as kdecode  # noqa: E402
from repro_torch.kernels import flash_attention as kflash  # noqa: E402
from repro_torch.kernels import norm_gemm as knorm  # noqa: E402
from repro_torch.kernels import sma_gemm as kgemm  # noqa: E402
from repro_torch.launch.train import (TrainLoopConfig, make_step,  # noqa: E402
                                      train)
from repro_torch.models import lm  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402
from repro_torch.serving import (CacheConfig, Request,  # noqa: E402
                                 SchedulerConfig, ServeEngine)
from repro_torch.serving import model as smodel  # noqa: E402

ARCH = "stablelm-1.6b"
# H100 SXM data sheet, dense: bf16 tensor cores, f32 CUDA cores, HBM3.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
              torch.float32: 67e12}
PEAK_BYTES = 3.35e12
# GEMM kernels vs plain versions, bf16 outputs: the reference's own tol_for
# (tests/test_kernels.py), |err| <= ATOL + RTOL * |plain| elementwise.  It
# covers one bf16 rounding flip of an output computed in another order.
RTOL = ATOL = 3e-2
# Decode attention vs its plain version, |err| <= ATTN_ATOL + ATTN_RTOL *
# |plain|.  Rows of 256-1024 keys average that many unit normals, so their
# outputs are only 0.03-0.08: RTOL passes one bf16 rounding flip (2^-7
# relative) and ATOL one flip of an output near 0.25.  The planted faults
# of attn_controls (a 64-token tile skipped, a page misindexed) must fail
# it on every such row.
ATTN_ATOL, ATTN_RTOL = 2e-3, 1e-2
# Decode-step logits after 24 bf16 layers, kernels vs plain versions: every
# GEMM output is rounded to bf16 on both sides from sums taken in another
# order, and the flips compound through the layers.  On an H100 that noise
# reads 0.078 and the smallest planted fault of check_decode_logits 0.172
# (PERF.md); the limit lies between them.
LOGIT_ATOL = 0.12
COLD_BYTES = 160 << 20        # > 50 MB L2: rotate inputs so reads are cold
# Flash forward vs its plain version, bf16 outputs, per element
# |err| <= FLASH_ATOL + FLASH_RTOL * |plain|: twice the decode attention's
# limit, since the kernel rounds P to bf16 before the PV product (the
# plain version keeps it f32).  Rows of few keys average values up to ~4,
# so P's rounding moves them by up to 2 bf16 ulps; at the decode limit
# the first run read 1.19 limits (PERF.md).
FLASH_ATOL, FLASH_RTOL = 4e-3, 2e-2
# Flash backward vs its plain version (fed the same out and lse): max |err|
# over a gradient tensor, relative to that tensor's max |plain|.  dq is
# summed with atomics in no fixed order, so its low bits vary by run.
FLASH_GRAD_LIMIT = 2e-2
# A planted fault must fail the check on every row it moves by more than
# this many limits (measured on the plain version of the faulty inputs).
FAULT_MARGIN = 3.0
# One training step, 4 full-width layers, kernels vs plain versions (both
# bf16 compute, f32 masters): relative error of the loss, of the global
# grad norm, and of every weight's gradient a layer at a time (Frobenius).
# Every product's output is rounded to bf16 on both sides from sums taken
# in another order, and the flips compound through the layers and the
# backward.  On an H100 the loss and grad norm read 7e-6 and 8.7e-5, and
# wq of layer 0, the last MLP's wo and the head 0.007-0.013; the planted
# faults of STEP_FAULTS must read above these limits (PERF.md).
STEP_LIMITS = {"loss": 1e-4, "grad_norm": 1e-3, "grad": 3e-2}
TRAIN_STEPS, TRAIN_SEQ, TRAIN_BATCH = 5, 2048, 4
# The trainer's peak rate (1 warmup step, cosine to 0 at step 5).  At the
# reference's default 3e-3 the full-width loss rises again after step 2,
# and by 0.4 nats more or less from dQ's summation order alone (PERF.md);
# at this rate it must fall from step 1 to step 5.
TRAIN_LR = 1e-3
H100_BF16 = 989e12            # dense bf16 tensor-core peak, for the MFU

KERNEL_SOURCES = {
    "sma_gemm": ("src/repro_torch/kernels/csrc/sma_gemm.cu",
                 "src/repro/kernels/sma_gemm.py:83"),
    "rmsnorm_gemm": ("src/repro_torch/kernels/csrc/norm_gemm.cu",
                     "src/repro/kernels/norm_gemm.py:62"),
    "paged_decode_attention": (
        "src/repro_torch/kernels/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention.py:78"),
    "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:78"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:101"),
    # The TPU kernel has no backward (no transpose rule for pallas_call);
    # this kernel is the gradient of the one it replaces.
    "flash_attention_bwd": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:101"),
}


def fail(msg: str) -> None:
    raise RuntimeError(f"chip_smoke: {msg}")


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, args_list, iters: int = 20) -> float:
    """Mean device time of ``fn(*args)`` in ms over ``iters`` launches,
    cycling through ``args_list`` (copies that together exceed L2)."""
    for args in args_list[:3]:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*args_list[i % len(args_list)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def copies(nbytes: int) -> int:
    return max(1, min(16, math.ceil(COLD_BYTES / max(nbytes, 1))))


def limit_multiples(got: torch.Tensor, want: torch.Tensor, atol: float,
                    rtol: float) -> torch.Tensor:
    """Per leading-axis row, the largest |err| / (atol + rtol * |want|):
    above 1 where the row fails the tolerance."""
    got, want = got.float(), want.float()
    ratio = (got - want).abs() / (atol + rtol * want.abs())
    return ratio.reshape(ratio.shape[0], -1).amax(1)


def compare(got: torch.Tensor, want: torch.Tensor, what: str,
            atol: float = ATOL, rtol: float = RTOL) -> float:
    if got.shape != want.shape or not torch.isfinite(got.float()).all():
        fail(f"{what}: shape {tuple(got.shape)} vs {tuple(want.shape)} or "
             f"non-finite output")
    err = (got.float() - want.float()).abs().max().item()
    if limit_multiples(got, want, atol, rtol).max().item() > 1:
        fail(f"{what}: kernel disagrees with its plain version "
             f"(max |err| {err:.4g})")
    return err


def bound(nbytes: float, flops: float, dtype: torch.dtype):
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def entry(name, shape, err, ms, plain_ms, bound_pair, library_ms):
    source, replaces = KERNEL_SOURCES[name]
    return {"name": name, "shape": shape, "route": "cuda", "source": source,
            "replaces": replaces, "launches": None, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_pair[0],
            "bound_by": bound_pair[1], "library_ms": library_ms}


# ---------------------------------------------------------------------------
# Kernel checks at the serving path's shapes
# ---------------------------------------------------------------------------
# (M, K, N, epilogue).  Serving: decode (M 1, 8) and prefill ticks (M
# 1024, 2048).  Training, B*S = 8192 tokens: forward and dA products (M
# 8192), the dB products (K 8192; the head's dW and the MLP wo's dB are the
# largest) and the head's dnormed (K 100352).
SERVE_GEMMS = [(m, k, n, ep) for m in (1, 8, 1024, 2048)
               for k, n, ep in ((2048, 2048, "none"), (2048, 5632, "none"),
                                (2048, 5632, "silu"), (5632, 2048, "none"))]
TRAIN_GEMMS = [(8192, 2048, 2048, "none"), (8192, 2048, 5632, "none"),
               (8192, 2048, 5632, "silu"), (8192, 5632, 2048, "none"),
               (2048, 8192, 5632, "none"), (5632, 8192, 2048, "none"),
               (2048, 8192, 100352, "none"), (8192, 100352, 2048, "none")]


def check_sma_gemm(gen, dev, shapes, tag=""):
    out = []
    dt = torch.bfloat16
    for m, k, n, ep in shapes:
        a = torch.randn((m, k), generator=gen, device=dev).to(dt)
        ws = [(torch.randn((k, n), generator=gen, device=dev)
               * k ** -0.5).to(dt)
              for _ in range(copies(k * n * 2))]
        got = kgemm.sma_gemm(a, ws[0], epilogue=ep)
        err = compare(got, ref.gemm_ref(a, ws[0], epilogue=ep),
                      f"sma_gemm M={m} {k}->{n} {ep}")
        args = [(a, w) for w in ws]
        big = 2 * m * n * k > 1e11
        ms = time_ms(lambda a_, w_: kgemm.sma_gemm(a_, w_, epilogue=ep),
                     args, 5 if big else 20)
        plain_ms = time_ms(
            lambda a_, w_: ref.gemm_ref(a_, w_, epilogue=ep), args,
            3 if big else 20)
        lib_ms = (time_ms(torch.matmul, args, 5 if big else 20)
                  if ep == "none" else None)
        b = bound(2 * (m * k + k * n + m * n), 2 * m * n * k, dt)
        out.append(entry("sma_gemm", f"M={m} K={k} N={n} {ep} bf16{tag}",
                         err, ms, plain_ms, b, lib_ms))
        del a, ws, got, args
    return out


def check_rmsnorm_gemm(gen, dev):
    out = []
    dt = torch.bfloat16
    k, n = 2048, lm.padded_vocab(get_config(ARCH))
    w = (torch.randn((k, n), generator=gen, device=dev) * k ** -0.5).to(dt)
    scale = torch.rand((k,), generator=gen, device=dev) + 0.5
    for m in (1, 8, TRAIN_SEQ * TRAIN_BATCH):
        x = (torch.randn((m, k), generator=gen, device=dev) * 3).to(dt)
        got = knorm.rmsnorm_gemm(x, scale, w)
        err = compare(got, ref.rmsnorm_gemm_ref(x, scale, w),
                      f"rmsnorm_gemm M={m} {k}->{n}")
        args = [(x, scale, w)]
        iters = 20 if m <= 8 else 3
        ms = time_ms(knorm.rmsnorm_gemm, args, iters)
        plain_ms = time_ms(ref.rmsnorm_gemm_ref, args, iters)
        b = bound(2 * (m * k + k * n + m * n) + 4 * k, 2 * m * n * k, dt)
        out.append(entry("rmsnorm_gemm", f"M={m} K={k} N={n} none bf16",
                         err, ms, plain_ms, b, None))
    return out


KV_LENS = (0, 1, 17, 100, 256, 511, 777, 1024)


def by_len(multiples: torch.Tensor) -> dict:
    return {n: round(x, 4) for n, x in zip(KV_LENS, multiples.tolist())}


def attn_controls(q, k_pool, v_pool, table, lens, want, bs):
    """Planted faults fed to the paged kernel, each held against the plain
    version of the right inputs: a skipped last 64-token tile and one
    misindexed full page must fail the attention tolerance on every row of
    256 keys or more, and the newest key dropped on every non-empty row."""
    long = [r for r, n in enumerate(KV_LENS) if n >= 256]
    skipped = lens.clone()
    skipped[long] -= 64
    misindexed = table.clone()
    for r in long:
        misindexed[r, KV_LENS[r] // bs - 2] = table[(r + 1) % len(KV_LENS), 0]
    faults = {"last 64-token tile skipped": (table, skipped, long),
              "one full page misindexed": (misindexed, lens, long),
              "newest key dropped": (table, (lens - 1).clamp(min=0),
                                     [r for r, n in enumerate(KV_LENS) if n])}
    for name, (tbl, lns, rows) in faults.items():
        bad = kdecode.paged_decode_attention(q, k_pool, v_pool, tbl, lns)
        mult = limit_multiples(bad, want, ATTN_ATOL, ATTN_RTOL)
        print(f"paged decode control, {name}: limit multiple by kv_len "
              f"{by_len(mult)}")
        if (mult[rows] <= 1).any():
            fail(f"paged decode control '{name}' passes the attention "
                 f"tolerance on a row it changes")


def check_decode(gen, dev):
    """Paged entry at the engine's pool geometry, then the contiguous
    entry: B=8, Hq=Hkv=32, D=64, BS=16, ragged kv_len including 0."""
    dt = torch.bfloat16
    b, h, d, bs, nb, smax = 8, 32, 64, 16, 512, 1024
    mb = smax // bs
    lens = torch.tensor(KV_LENS, dtype=torch.int32, device=dev)
    rng = np.random.default_rng(0)
    perm = rng.permutation(nb)
    table = np.full((b, mb), nb, np.int32)
    used = 0
    for r, n in enumerate(KV_LENS):
        pages = max(1, -(-n // bs))
        table[r, :pages] = perm[used:used + pages]
        used += pages
    table = torch.from_numpy(table).to(dev)
    q = torch.randn((b, h, d), generator=gen, device=dev).to(dt)
    pools = [tuple(torch.randn((nb, h, bs, d), generator=gen,
                               device=dev).to(dt) for _ in range(2))
             for _ in range(2)]
    total = sum(KV_LENS)
    nbytes = 2 * 2 * b * h * d + 2 * 2 * total * h * d + 4 * (b * mb + b)
    flops = 4 * total * h * d
    out = []

    got = kdecode.paged_decode_attention(q, *pools[0], table, lens)
    want = ref.paged_decode_attention_ref(q, *pools[0], table, lens)
    if got[0].abs().max().item() != 0.0:
        fail("paged decode: kv_len 0 row is not 0")
    err = compare(got, want, "paged_decode_attention", ATTN_ATOL, ATTN_RTOL)
    print(f"paged decode, kernel vs plain: limit multiple by kv_len "
          f"{by_len(limit_multiples(got, want, ATTN_ATOL, ATTN_RTOL))}")
    attn_controls(q, *pools[0], table, lens, want, bs)
    args = [(q, kp, vp, table, lens) for kp, vp in pools]
    out.append(entry(
        "paged_decode_attention",
        f"B={b} Hq=Hkv={h} D={d} BS={bs} NB={nb} kv_len={list(KV_LENS)} bf16",
        err, time_ms(kdecode.paged_decode_attention, args),
        time_ms(ref.paged_decode_attention_ref, args),
        bound(nbytes, flops, dt), None))

    caches = [tuple(torch.randn((b, h, smax, d), generator=gen,
                                device=dev).to(dt) for _ in range(2))
              for _ in range(2)]
    got = kdecode.decode_attention(q, *caches[0], lens)
    err = compare(got, ref.decode_attention_ref(q, *caches[0], lens),
                  "decode_attention", ATTN_ATOL, ATTN_RTOL)
    args = [(q, kc, vc, lens) for kc, vc in caches]
    mask = (torch.arange(smax, device=dev)[None, :]
            < lens[:, None])[:, None, None, :]

    def sdpa(q_, k_, v_, _lens):
        return F.scaled_dot_product_attention(q_[:, :, None], k_, v_,
                                              attn_mask=mask)

    out.append(entry(
        "decode_attention",
        f"B={b} Hq=Hkv={h} D={d} Smax={smax} kv_len={list(KV_LENS)} bf16",
        err, time_ms(kdecode.decode_attention, args),
        time_ms(ref.decode_attention_ref, args),
        bound(nbytes - 4 * b * mb, flops, dt), time_ms(sdpa, args)))
    return out


# ---------------------------------------------------------------------------
# Flash attention, forward and backward, at the trainer's shapes
# ---------------------------------------------------------------------------
FLASH_CASES = {   # B 4, S 2048, D 64, bf16, causal; Hq/Hkv and window vary
    "causal": (32, 32, None),
    "GQA 32/8": (32, 8, None),
    "window 512": (32, 32, 512),
}


def flash_inputs(gen, dev, hq, hkv, seq=TRAIN_SEQ, b=TRAIN_BATCH, d=64):
    def rn(h):
        return torch.randn((b, h, seq, d), generator=gen,
                           device=dev).to(torch.bfloat16)
    return rn(hq), rn(hkv), rn(hkv), rn(hq)


def visible_pairs(sq, skv, window, dev) -> int:
    """(query, key) pairs the kernel must score, per (batch, head)."""
    return int(ref.flash_mask(sq, skv, causal=True, window=window,
                              device=dev).sum())


def row_multiples(got, want, atol=FLASH_ATOL, rtol=FLASH_RTOL):
    """Per (batch, head, query row), the largest |err| / (atol + rtol *
    |want|) over the row's head_dim: above 1 where the row fails."""
    ratio = (got.float() - want.float()).abs() / (atol + rtol
                                                  * want.float().abs())
    return ratio.amax(-1)


def grad_error(got, want) -> float:
    """max |err| of a gradient relative to its max |plain|."""
    if not torch.isfinite(got.float()).all():
        return math.inf
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


def flash_controls(q, k, v, dout, out, lse):
    """Planted faults fed to the kernels, each held against the plain
    version of the right inputs.  Forward: the 64 newest keys of every
    query dropped (a skipped KV tile: row i + 64 run with keys 0..i) and
    the diagonal key dropped (row i + 1 run with keys 0..i).  Each must
    fail the forward check on every row it moves by more than
    FAULT_MARGIN limits.  Backward: the D = rowsum(dO * O) term dropped
    (O fed as zeros) must fail the dq and dk checks."""
    want = ref.flash_attention_ref(q, k, v)[0]
    for name, drop in (("KV tile skipped (64 newest keys)", 64),
                       ("diagonal key dropped", 1)):
        args = (q[:, :, drop:], k[:, :, :-drop], v[:, :, :-drop])
        effect = row_multiples(ref.flash_attention_ref(*args)[0],
                               want[:, :, drop:])
        bad = row_multiples(kflash.flash_attention_fwd(*args)[0],
                            want[:, :, drop:])
        must = effect > FAULT_MARGIN
        caught = (bad[must] > 1).float().mean().item() if must.any() else 0
        print(f"flash control, {name}: moves {must.float().mean():.3f} of "
              f"the rows by > {FAULT_MARGIN} limits; the check fails "
              f"{caught:.4f} of them (min multiple "
              f"{bad[must].min().item() if must.any() else 0:.3g}) and "
              f"{(bad > 1).float().mean():.3f} of all rows")
        if not must.any() or caught < 1:
            fail(f"flash control '{name}' passes the check on a row it "
                 f"changes")
    bad = kflash.flash_attention_bwd(q, k, v, torch.zeros_like(out), lse,
                                     dout)
    wants = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout)
    errs = [grad_error(g, w) for g, w in zip(bad, wants)]
    print(f"flash control, backward D term dropped: dq {errs[0]:.4g}, dk "
          f"{errs[1]:.4g}, dv {errs[2]:.4g} (limit {FLASH_GRAD_LIMIT})")
    if min(errs[:2]) <= FLASH_GRAD_LIMIT:
        fail("flash control 'D term dropped' passes the dq or dk check")


def check_flash(gen, dev):
    """Each case: forward (out, lse) and backward (dq, dk, dv, fed the
    kernel's out and lse) against the plain versions; the causal case also
    feeds the planted faults and is timed."""
    dt = torch.bfloat16
    rows = []
    for case, (hq, hkv, window) in FLASH_CASES.items():
        q, k, v, dout = flash_inputs(gen, dev, hq, hkv)
        out, lse = kflash.flash_attention_fwd(q, k, v, window=window)
        want, want_lse = ref.flash_attention_ref(q, k, v, window=window)
        mult = row_multiples(out, want)
        err = (out.float() - want.float()).abs().max().item()
        lse_err = (lse - want_lse).abs().max().item()
        grads = kflash.flash_attention_bwd(q, k, v, out, lse, dout,
                                           window=window)
        wants = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout,
                                            window=window)
        gerr = {n: grad_error(g, w)
                for n, g, w in zip(("dq", "dk", "dv"), grads, wants)}
        gabs = {n: (g.float() - w.float()).abs().max().item()
                for n, g, w in zip(("dq", "dk", "dv"), grads, wants)}
        print(f"flash {case}: out max |err| {err:.4g} (max limit multiple "
              f"{mult.max().item():.3g} of {FLASH_ATOL} + {FLASH_RTOL}"
              f"|plain|), lse {lse_err:.3g}; grads max |err| "
              f"{json.dumps({n: round(x, 5) for n, x in gabs.items()})}, "
              f"relative to max |plain| "
              f"{json.dumps({n: round(x, 5) for n, x in gerr.items()})} "
              f"(limit {FLASH_GRAD_LIMIT})")
        if not torch.isfinite(out.float()).all() or mult.max() > 1:
            fail(f"flash forward {case}: kernel disagrees with its plain "
                 f"version")
        if lse_err > 1e-2:
            fail(f"flash forward {case}: lse off by {lse_err:.3g}")
        if max(gerr.values()) > FLASH_GRAD_LIMIT:
            fail(f"flash backward {case}: {gerr} over {FLASH_GRAD_LIMIT}")
        if case != "causal":
            continue
        flash_controls(q, k, v, dout, out, lse)
        b, _, s, d = q.shape
        pairs = visible_pairs(s, s, window, dev) * b * hq
        sets = [(q, k, v, dout)] + [flash_inputs(gen, dev, hq, hkv)]
        fwd_args = [x[:3] for x in sets]
        outs = [kflash.flash_attention_fwd(*a) for a in fwd_args]
        bwd_args = [(*a[:3], o, l, a[3]) for a, (o, l) in zip(sets, outs)]
        io = 2 * q.numel()                      # bytes of one (B,H,S,D)
        shape = f"B={b} Hq={hq} Hkv={hkv} S={s} D={d} causal bf16"

        def sdpa(q_, k_, v_):
            return F.scaled_dot_product_attention(q_, k_, v_, is_causal=True)

        lib_sets = []
        for q_, k_, v_, do_ in sets:
            leaves_ = [t.detach().clone().requires_grad_() for t in
                       (q_, k_, v_)]
            lib_sets.append((sdpa(*leaves_), leaves_, do_))

        def sdpa_bwd(o_, leaves_, do_):
            return torch.autograd.grad(o_, leaves_, do_, retain_graph=True)

        rows.append(entry(
            "flash_attention", shape, err,
            time_ms(lambda *a: kflash.flash_attention_fwd(*a), fwd_args),
            time_ms(ref.flash_attention_ref, fwd_args, 3),
            bound(4 * io + 4 * b * hq * s, 4 * d * pairs, dt),
            time_ms(sdpa, fwd_args)))
        rows.append(entry(
            "flash_attention_bwd", shape, max(gabs.values()),
            time_ms(lambda *a: kflash.flash_attention_bwd(*a), bwd_args),
            time_ms(ref.flash_attention_bwd_ref, bwd_args, 3),
            bound(8 * io + 4 * b * hq * s, 10 * d * pairs, dt),
            time_ms(sdpa_bwd, lib_sets)))
        del lib_sets, outs, sets
    return rows


# ---------------------------------------------------------------------------
# The main path: ServeEngine at full width
# ---------------------------------------------------------------------------
def serve(cfg, params, dev):
    cache = CacheConfig(block_size=16, num_blocks=512, max_seq_len=1024)
    sched = SchedulerConfig(policy="sma", prefill_chunk=256)
    eng = ServeEngine(cfg, params, cache=cache, max_batch=8, sched=sched,
                      device=dev)
    rng = np.random.default_rng(0)
    lens = rng.integers(64, 513, size=8)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, size=n)
                    .astype(np.int32), max_new_tokens=32)
            for i, n in enumerate(lens)]
    # Warm-up request (first launches, allocator), then a clean engine.
    eng.submit(Request(rid=-1, prompt=reqs[0].prompt[:64], max_new_tokens=2))
    eng.run()
    eng.reset()

    ops.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, routed = ops.launch_counts(), dict(ops.ROUTED)

    for r in reqs:
        if r.status != "done" or len(r.out_tokens) != 32:
            fail(f"request {r.rid}: {r.status} with "
                 f"{len(r.out_tokens or [])} tokens ({r.error})")
        if not all(0 <= t < lm.padded_vocab(cfg) for t in r.out_tokens):
            fail(f"request {r.rid}: token out of range")
    for name in ("sma_gemm", "rmsnorm_gemm", "paged_decode_attention"):
        if counts[name] == 0:
            fail(f"kernel {name} was not launched on the main path")
    ticks = {p: [s for ph, _, s in eng.tick_log if ph == p]
             for p in ("prefill", "decode")}
    n_ticks = len(eng.tick_log)
    per_layer = 7 * cfg.num_layers
    expect = {"sma_gemm": per_layer * n_ticks, "rmsnorm_gemm": n_ticks,
              "paged_decode_attention": cfg.num_layers * len(ticks["decode"])}
    for name, n in expect.items():
        if counts[name] != n:
            fail(f"{name}: {counts[name]} launches, expected {n}")
    ttft = [r.t_first - r.t_submit for r in reqs]
    tokens = sum(len(r.out_tokens) for r in reqs)
    print(f"serve: {len(reqs)} requests, prompts {lens.tolist()}, "
          f"{tokens} tokens in {wall:.3f} s: {tokens / wall:.1f} tokens/s "
          f"(wall clock, bf16, {ARCH} full width, random weights)")
    print(f"serve: TTFT mean {1e3 * np.mean(ttft):.1f} ms, max "
          f"{1e3 * max(ttft):.1f} ms; decode step mean "
          f"{1e3 * np.mean(ticks['decode']):.2f} ms over "
          f"{len(ticks['decode'])} ticks; prefill tick mean "
          f"{1e3 * np.mean(ticks['prefill']):.2f} ms over "
          f"{len(ticks['prefill'])} ticks; switches {eng.sched.switches}")
    print(f"serve: launches {json.dumps(counts)}; per decode tick "
          f"{per_layer} sma_gemm, 1 rmsnorm_gemm, {cfg.num_layers} paged "
          f"decode; routed to plain by design {json.dumps(routed)}")
    del eng
    torch.cuda.empty_cache()
    return counts


@contextlib.contextmanager
def plain_kernels():
    """Swap every kernel wrapper for its plain version, where the entry
    points and the autograd Functions look them up, to run the same step
    (forward and backward) without the kernels."""
    swaps = {(kgemm, "sma_gemm"): ref.gemm_ref,
             (knorm, "rmsnorm_gemm"): ref.rmsnorm_gemm_ref,
             (kdecode, "paged_decode_attention"):
                 ref.paged_decode_attention_ref,
             (kflash, "flash_attention_fwd"): ref.flash_attention_ref,
             (kflash, "flash_attention_bwd"): ref.flash_attention_bwd_ref}
    saved = {key: getattr(*key) for key in swaps}
    for (mod, name), fn in swaps.items():
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)


def prefilled(cfg, params, dev):
    """Pools after a ragged 64-token prefill of 8 rows, and the next
    decode step's inputs (table, cache_len, tokens)."""
    cache = CacheConfig(block_size=16, num_blocks=512, max_seq_len=1024)
    b, c = 8, 64
    state = smodel.init_state(cfg, cache, device=dev)
    mb = cache.max_blocks_per_req
    table = torch.arange(b * mb, dtype=torch.int32,
                         device=dev).reshape(b, mb) % cache.num_blocks
    gen = torch.Generator(device=dev).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (b, c), generator=gen,
                         device=dev)
    n_tok = torch.tensor([64, 1, 17, 33, 64, 50, 8, 40], device=dev)
    zero = torch.zeros(b, dtype=torch.int32, device=dev)
    _, state, cl = smodel.paged_prefill_step(params, state, table, zero,
                                             n_tok, cfg, {"tokens": toks})
    nxt = torch.randint(0, cfg.vocab_size, (b, 1), generator=gen, device=dev)
    return state, table, cl, nxt


@contextlib.contextmanager
def planted(fault: str, layer: int):
    """One wrong launch in ``layer`` of a decode step, made by feeding a
    kernel wrong inputs: the attention out projection with its last
    64-wide K tile skipped, or the attention with the newest key dropped."""
    gemm, attn = ops.sma_gemm, ops.paged_decode_attention
    calls = {"gemm": 0, "attn": 0}

    def wrong_gemm(a, w, **kw):
        calls["gemm"] += 1
        if fault == "wo K tile skipped" and calls["gemm"] == 7 * layer + 4:
            k = w.shape[0] - 64
            return gemm(a[..., :k].contiguous(), w[:k], **kw)
        return gemm(a, w, **kw)

    def wrong_attn(q, k_pool, v_pool, table, q_pos, kv_len, **kw):
        calls["attn"] += 1
        if fault == "newest key dropped" and calls["attn"] == layer + 1:
            kv_len = (kv_len - 1).clamp(min=0)
        return attn(q, k_pool, v_pool, table, q_pos, kv_len, **kw)

    ops.sma_gemm, ops.paged_decode_attention = wrong_gemm, wrong_attn
    try:
        yield
    finally:
        ops.sma_gemm, ops.paged_decode_attention = gemm, attn


def check_decode_logits(cfg, params, dev):
    """One decode step after a ragged prefill, through the kernels and
    through the plain versions, on the same pools; then the same step with
    one planted fault in one layer, which the limit must catch."""
    state, table, cl, nxt = prefilled(cfg, params, dev)
    b = nxt.shape[0]
    saved = [{k: v.clone() for k, v in e.items()} for e in state]

    def step():
        for e, s in zip(state, saved):
            for k in e:
                e[k].copy_(s[k])
        return smodel.paged_decode_step(params, state, table, cl, cfg,
                                        {"tokens": nxt})[0].float()

    got = step()
    with plain_kernels():
        want = step()
    if not torch.isfinite(got).all() or got.shape != (b, cfg.vocab_size):
        fail(f"decode logits: shape {tuple(got.shape)} or non-finite")

    def reading(x):
        d = x - want
        return d.abs().max().item(), (d.norm() / want.norm()).item()

    err, rel = reading(got)
    top_k, top_p = got.argmax(-1), want.argmax(-1)
    print(f"decode logits, kernels vs plain versions: max |err| {err:.4g}, "
          f"relative RMS {rel:.4g} (|logit| max "
          f"{want.abs().max().item():.3g}), top-1 agree on "
          f"{int((top_k == top_p).sum())}/{b} rows")
    controls = []
    for fault in ("wo K tile skipped", "newest key dropped"):
        for layer in (0, cfg.num_layers // 2, cfg.num_layers - 1):
            with planted(fault, layer):
                c_err, c_rel = reading(step())
            controls.append(c_err)
            print(f"decode logits control, {fault} in layer {layer}: "
                  f"max |err| {c_err:.4g}, relative RMS {c_rel:.4g}")
    for r in (top_k != top_p).nonzero()[:, 0].tolist():
        gap = (want[r, top_p[r]] - want[r, top_k[r]]).item()
        print(f"decode logits row {r}: top-1 {top_k[r].item()} vs "
              f"{top_p[r].item()}, {gap:.4g} apart in the plain logits")
        if gap > LOGIT_ATOL:
            fail(f"decode logits row {r}: top-1 {top_k[r].item()} vs "
                 f"{top_p[r].item()}, {gap:.4g} apart in the plain logits")
    if err > LOGIT_ATOL:
        fail(f"decode logits: max |err| {err:.4g} > {LOGIT_ATOL}")
    if min(controls) <= LOGIT_ATOL:
        fail(f"decode logits: a planted fault reads {min(controls):.4g}, "
             f"within the limit {LOGIT_ATOL}")


def profile_decode(cfg, params, dev, steps: int = 5):
    """torch.profiler over a few decode steps (batch 8, kv_len up to 65):
    device busy share of the window and device time by kernel.  The window
    is host time under the profiler, which slows the host side."""
    from torch.profiler import ProfilerActivity, profile
    state, table, cl, nxt = prefilled(cfg, params, dev)
    tokens = {"tokens": nxt}
    smodel.paged_decode_step(params, state, table, cl, cfg, tokens)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            smodel.paged_decode_step(params, state, table, cl, cfg, tokens)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    report_profile(prof, wall, steps, "decode step")


@contextlib.contextmanager
def gemm_entries(how: str):
    """The GEMM entry points calling the kernel wrappers directly
    (``"wrapper"``, what ``ops`` does with grad mode off) or through their
    autograd Functions whatever the grad mode (``"Function.apply"``)."""
    saved = ops.sma_gemm, ops.rmsnorm_gemm
    if how == "wrapper":
        ops.sma_gemm, ops.rmsnorm_gemm = kgemm.sma_gemm, knorm.rmsnorm_gemm
    else:
        def sma_gemm(a, b, *, bias=None, epilogue="none"):
            return kautograd.SmaGemm.apply(a, b, bias, epilogue)

        def rmsnorm_gemm(x, scale, w, *, epilogue="none", eps=1e-6):
            return kautograd.RmsnormGemm.apply(x, scale, w, epilogue, eps)
        ops.sma_gemm, ops.rmsnorm_gemm = sma_gemm, rmsnorm_gemm
    try:
        yield
    finally:
        ops.sma_gemm, ops.rmsnorm_gemm = saved


def entry_overhead(cfg, params, dev, rounds: int = 4, steps: int = 5):
    """Host wall of one decode step (batch 8, synchronized at its end, under
    the caller's inference_mode) with the 169 GEMM entry calls a step going
    through their autograd Functions against calling the wrappers
    directly; the two alternate (A B B A) ``rounds`` times, ``steps`` steps
    each.  Medians in ms."""
    state, table, cl, nxt = prefilled(cfg, params, dev)
    tokens = {"tokens": nxt}
    walls = {"Function.apply": [], "wrapper": []}

    def run(how, keep=True):
        with gemm_entries(how):
            for _ in range(steps):
                t = time.perf_counter()
                smodel.paged_decode_step(params, state, table, cl, cfg,
                                         tokens)
                torch.cuda.synchronize()
                if keep:
                    walls[how].append(time.perf_counter() - t)

    run("Function.apply", keep=False)
    run("wrapper", keep=False)
    for _ in range(rounds):
        for how in ("Function.apply", "wrapper", "wrapper", "Function.apply"):
            run(how)
    med = {how: 1e3 * float(np.median(w)) for how, w in walls.items()}
    extra = med["Function.apply"] - med["wrapper"]
    print(f"decode step host wall, median of {len(walls['wrapper'])}: GEMM "
          f"entries through Function.apply {med['Function.apply']:.3f} ms, "
          f"wrappers called directly {med['wrapper']:.3f} ms; difference "
          f"{extra:.3f} ms ({100 * extra / med['wrapper']:.2f} %, "
          f"{1e3 * extra / (7 * cfg.num_layers + 1):.2f} us a call)")
    return med


# ---------------------------------------------------------------------------
# The training path
# ---------------------------------------------------------------------------
def step_launches(cfg) -> dict:
    """Kernel launches of one training step with remat (PERF.md): per
    layer, 7 projections forward, 7 again in the recomputation and 15 in
    the backward (dA and dB of each, and the gate's Z once more); 2 for
    the head's dW and dnormed; the flash forward twice and its backward
    once."""
    n = cfg.num_layers
    return {"sma_gemm": 29 * n + 2, "rmsnorm_gemm": 1,
            "flash_attention": 2 * n, "flash_attention_bwd": n}


def matmul_params(cfg) -> int:
    """Parameters that enter a matrix product (the embedding gather does
    not): the MFU's N."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    attn = d * hd * (2 * cfg.num_heads + 2 * cfg.num_kv_heads)
    return cfg.num_layers * (attn + 3 * d * cfg.d_ff) \
        + d * lm.padded_vocab(cfg)


def train_batch(cfg, dev):
    return next(DataPipeline(DataConfig(cfg.vocab_size, TRAIN_SEQ,
                                        TRAIN_BATCH, seed=0), device=dev))


def named_leaves(tree, prefix: str = "") -> list:
    """(name, leaf) pairs in :func:`repro_torch.tree.leaves` order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in named_leaves(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (tuple, list)):
        return [x for i, node in enumerate(tree)
                for x in named_leaves(node, f"{prefix}{i}.")]
    return [(prefix[:-1], tree)]


def grad_pieces(names, grads) -> dict:
    """Each gradient by name, the block leaves (stacked over layers) split
    into one piece a layer: ``blocks.0.mixer.wq[2]`` is layer 2's wq."""
    out = {}
    for name, g in zip(names, grads):
        if name.startswith("blocks."):
            out.update({f"{name}[{i}]": x for i, x in enumerate(g)})
        else:
            out[name] = g
    return out


# Planted faults in the backward of one training step: each is one wrong
# launch in one layer, made by feeding a kernel wrong inputs.  The first
# two must fail STEP_LIMITS; the third, 64 of the 8,192 tokens left out of
# one weight gradient, is the smallest we plant, and its reading says what
# the limits resolve.
STEP_FAULTS = {"flash backward, D term dropped": True,
               "dB, last 64-column N tile skipped": True,
               "dB, last 64-token K tile skipped": False}


@contextlib.contextmanager
def planted_backward(fault: str, layer: int, layers: int, tokens: int):
    """One wrong backward launch in ``layer``: the flash backward fed O as
    zeros (its D = rowsum(dO * O) term dropped), or one weight gradient
    dB = A^T dZ (the one product with K = tokens) computed without its last
    64 columns or without its last 64 tokens.  The backward runs the layers
    last to first; the head's dW is the first dB product, then 7 a layer.
    Yields the call counts, to show the fault found its launch."""
    bwd, gemm = kflash.flash_attention_bwd, kgemm.sma_gemm
    calls = {"flash": 0, "dB": 0}
    flash_at = layers - 1 - layer
    db_at = 1 + 7 * (layers - 1 - layer) + 3

    def wrong_bwd(q, k, v, out, lse, dout, **kw):
        if fault.startswith("flash") and calls["flash"] == flash_at:
            out = torch.zeros_like(out)
        calls["flash"] += 1
        return bwd(q, k, v, out, lse, dout, **kw)

    def wrong_gemm(a, b, **kw):
        if a.shape[-1] != tokens:
            return gemm(a, b, **kw)
        hit = fault.startswith("dB") and calls["dB"] == db_at
        calls["dB"] += 1
        if hit and "K tile" in fault:
            return gemm(a[:, :tokens - 64].contiguous(), b[:tokens - 64], **kw)
        if hit:
            n = b.shape[1] - 64
            part = gemm(a, b[:, :n].contiguous(), **kw)
            return torch.cat([part, part.new_zeros(a.shape[0], 64)], 1)
        return gemm(a, b, **kw)

    # The wrappers count their launches on their module-level names, which
    # now hold the stand-ins: give those a counter (the step's counts are
    # not read in these runs).
    wrong_bwd.launches = wrong_gemm.launches = 0
    kflash.flash_attention_bwd, kgemm.sma_gemm = wrong_bwd, wrong_gemm
    try:
        yield calls
    finally:
        kflash.flash_attention_bwd, kgemm.sma_gemm = bwd, gemm


def check_train_step(cfg, dev, layers: int = 4):
    """One step's loss and gradients, 4 full-width layers, through the
    kernels and through the plain versions, on the same f32 masters and
    batch (remat on in both, so the plain attention's S x S scores live
    for one layer at a time): the loss, the global grad norm and every
    weight's gradient, a layer at a time, within STEP_LIMITS.  Then the
    same step with each of STEP_FAULTS planted in layer 2."""
    cfg_n = dataclasses.replace(cfg, num_groups=layers)
    params = lm.init(cfg_n, seed=0, device=dev, dtype=cfg_n.parameter_dtype)
    names, flat = zip(*named_leaves(params))
    for p in flat:
        p.requires_grad_(True)
    batch = train_batch(cfg_n, dev)
    tokens = batch["tokens"].numel()

    def run():
        loss, _ = lm.loss_fn(params, cfg_n, batch, remat=True)
        grads = torch.autograd.grad(loss, flat)
        return (loss.item(), adamw.global_norm(grads).item(),
                grad_pieces(names, grads))

    with plain_kernels():
        want = run()

    def errors(got) -> dict:
        rel = {"loss": abs(got[0] - want[0]) / abs(want[0]),
               "grad_norm": abs(got[1] - want[1]) / want[1]}
        for name, w in want[2].items():
            d = got[2][name].float() - w.float()
            rel[name] = (d.norm() / w.float().norm().clamp_min(1e-30)).item()
        return rel

    ops.reset_counts()
    got = run()
    counts = ops.launch_counts()
    rel = errors(got)
    limits = {k: STEP_LIMITS.get(k, STEP_LIMITS["grad"]) for k in rel}
    picks = ("blocks.0.mixer.wq[0]", f"blocks.0.ffn.wo[{layers - 1}]",
             "head.w")
    grads_rel = {k: x for k, x in rel.items() if k not in STEP_LIMITS}
    worst = max(grads_rel, key=grads_rel.get)
    shown = {k: float(f"{rel[k]:.4g}")
             for k in ("loss", "grad_norm") + picks}
    print(f"train step, {layers} layers, kernels vs plain: loss "
          f"{got[0]:.6f} vs {want[0]:.6f}, grad norm {got[1]:.5f} vs "
          f"{want[1]:.5f}; relative errors {json.dumps(shown)}; over all "
          f"{len(grads_rel)} gradient pieces max {rel[worst]:.4g} "
          f"({worst}), median {np.median(list(grads_rel.values())):.4g}")
    del got
    expect = step_launches(cfg_n)
    if {k: counts[k] for k in expect} != expect:
        fail(f"train step launches {counts}, expected {expect}")
    over = {k: x for k, x in rel.items() if not x <= limits[k]}
    if over:
        fail(f"train step, kernels vs plain: {over} over {limits}")

    layer = layers // 2
    for fault, must in STEP_FAULTS.items():
        with planted_backward(fault, layer, layers, tokens) as calls:
            frel = errors(run())
        if calls != {"flash": layers, "dB": 1 + 7 * layers}:
            fail(f"train step control '{fault}': the backward made {calls} "
                 f"launches, so the fault may have missed its target")
        mult = {k: x / limits[k] for k, x in frel.items()}
        top = sorted(mult, key=mult.get, reverse=True)
        largest = {k: round(mult[k], 3) for k in top[:3]}
        print(f"train step control, {fault} in layer {layer}: largest limit "
              f"multiples {json.dumps(largest)}, loss {mult['loss']:.3g}, "
              f"grad norm {mult['grad_norm']:.3g}; "
              f"{sum(x > 1 for x in mult.values())} of {len(mult)} readings "
              f"over their limits")
        if must and mult[top[0]] <= 1:
            fail(f"train step control '{fault}' passes every limit")


def run_trainer(cfg, dev):
    """train() at full width and depth, at TRAIN_LR; returns the launch
    counts of the run (5 steps) and the trained parameters."""
    loop = TrainLoopConfig(steps=TRAIN_STEPS, seq_len=TRAIN_SEQ,
                           global_batch=TRAIN_BATCH, log_every=1, seed=0,
                           peak_lr=TRAIN_LR, remat=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    torch.cuda.synchronize()
    result = train(cfg, loop, device=dev)
    torch.cuda.synchronize()
    counts, routed = ops.launch_counts(), dict(ops.ROUTED)
    peak = torch.cuda.max_memory_allocated()
    hist = result["history"]
    for h in hist:
        if not (math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
                and h["grad_norm"] > 0):
            fail(f"train step {h['step']}: loss {h['loss']}, grad norm "
                 f"{h['grad_norm']}")
    losses = [h["loss"] for h in hist]
    if not losses[-1] < losses[0]:
        fail(f"trainer: the loss did not fall over {TRAIN_STEPS} steps at "
             f"peak_lr {TRAIN_LR}: {losses}")
    per_step = step_launches(cfg)
    expect = {k: TRAIN_STEPS * n for k, n in per_step.items()}
    if {k: counts[k] for k in expect} != expect:
        fail(f"trainer launches {counts}, expected {expect} "
             f"({per_step} a step)")
    if routed:
        fail(f"trainer routed calls to plain versions: {routed}")
    walls = [h["wall_s"] for h in hist]
    steps = [b - a for a, b in zip(walls, walls[1:])]
    step_s = float(np.median(steps))
    tokens = TRAIN_SEQ * TRAIN_BATCH
    n_mm = matmul_params(cfg)
    print(f"train: {ARCH} full width, {cfg.num_layers} layers, seq "
          f"{TRAIN_SEQ}, batch {TRAIN_BATCH}, remat, f32 masters + AdamW, "
          f"peak_lr {TRAIN_LR}, bf16 compute; losses "
          f"{[round(x, 4) for x in losses]} (fell "
          f"{losses[0] - losses[-1]:.4f}), grad norms "
          f"{[round(h['grad_norm'], 4) for h in hist]}")
    print(f"train: step 1 {walls[0]:.3f} s (first launches), steps 2-5 "
          f"{[round(x, 4) for x in steps]} s, median {step_s:.4f} s: "
          f"{tokens / step_s:.1f} tokens/s, MFU "
          f"{100 * 6 * n_mm * tokens / step_s / H100_BF16:.2f}% (6 N tokens "
          f"/ step / 989 TFLOP/s, N = {n_mm} matmul parameters); peak "
          f"memory {peak / 2**30:.2f} GiB (max_memory_allocated)")
    print(f"train: launches over {TRAIN_STEPS} steps {json.dumps(counts)}; "
          f"a step {json.dumps(per_step)}; routed {routed}")
    return counts, result["params"]


def profile_train_step(cfg, params, dev):
    """torch.profiler over one more training step (fresh AdamW state):
    device busy share and device time by kernel."""
    from torch.profiler import ProfilerActivity, profile
    ocfg = adamw.AdamWConfig(peak_lr=TRAIN_LR, warmup_steps=1,
                             total_steps=TRAIN_STEPS)
    step = make_step(cfg, ocfg, remat=True)
    opt = adamw.init(params)
    batch = train_batch(cfg, dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(params, opt, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    report_profile(prof, wall, 1, "train step")


def report_profile(prof, wall: float, steps: int, what: str) -> None:
    rows = []   # kernels only: host ops also carry their kernels' time
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if dev_us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((dev_us, ev.count, ev.key))
    if not rows:
        print(f"profile {what}: no device time in the trace (not measured)")
        return
    busy = sum(r[0] for r in rows) / 1e6
    print(f"profile: {steps} {what}(s) in {1e3 * wall:.2f} ms host wall, "
          f"device busy {1e3 * busy:.2f} ms ({100 * busy / wall:.1f}% of "
          f"the window, idle {100 * (1 - busy / wall):.1f}%)")
    for dev_us, count, key in sorted(rows, reverse=True)[:12]:
        print(f"profile: {dev_us / steps / 1e3:8.3f} ms/step "
              f"{count // steps:5d}/step  {key[:90]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    card = smi_line()
    print(f"card: {card}")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    built = _build.build()
    print(f"build: {built} in {time.perf_counter() - t0:.1f} s "
          f"into {_build.BUILD_DIR.relative_to(ROOT)}")
    for name in _build.SOURCES:
        log = _build.BUILD_DIR / f"{name}.ptxas"
        for line in log.read_text().splitlines() if log.exists() else ():
            spills = "spill" in line and "0 bytes spill stores" not in line
            if "registers" in line or spills:
                print(f"ptxas {name}: {line.split(':', 1)[-1].strip()}")

    phases = {"build": time.perf_counter() - t0}

    def phase(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        phases[name] = time.perf_counter() - t
        print(f"phase {name}: {phases[name]:.1f} s", flush=True)
        return out

    gen = torch.Generator(device=dev).manual_seed(0)
    rows = phase("kernel checks", lambda: check_sma_gemm(gen, dev,
                                                         SERVE_GEMMS)
                 + check_sma_gemm(gen, dev, TRAIN_GEMMS, " (train)")
                 + check_rmsnorm_gemm(gen, dev) + check_decode(gen, dev)
                 + check_flash(gen, dev))
    for row in rows:
        print(f"kernel {row['name']} [{row['shape']}]: max|err| "
              f"{row['max_abs_err']:.3g}, {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms, library {row['library_ms']}, "
              f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
    torch.cuda.empty_cache()

    # The serving path, without autograd.
    cfg = get_config(ARCH)
    with torch.inference_mode():
        t0 = time.perf_counter()
        params = lm.init(cfg, seed=0, device=dev)
        torch.cuda.synchronize()
        print(f"init: {ARCH} full width ({cfg.num_layers} layers, d_model "
              f"{cfg.d_model}, vocab {lm.padded_vocab(cfg)}) in "
              f"{time.perf_counter() - t0:.3f} s, "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
        serve_counts = phase("serve", serve, cfg, params, dev)
        phase("decode logits", check_decode_logits, cfg, params, dev)
        phase("decode profile", profile_decode, cfg, params, dev)
        phase("entry overhead", entry_overhead, cfg, params, dev)
    del params
    torch.cuda.empty_cache()

    # The training path.
    phase("train step vs plain", check_train_step, cfg, dev)
    torch.cuda.empty_cache()
    train_counts, tparams = phase("trainer", run_trainer, cfg, dev)
    phase("train profile", profile_train_step, cfg, tparams, dev)
    print(f"phases (s): "
          f"{json.dumps({k: round(x, 1) for k, x in phases.items()})}")

    for row in rows:
        by_path = {"serve": serve_counts[row["name"]],
                   "train": train_counts[row["name"]]}
        row["launches"] = sum(by_path.values())
        row["launches_by_path"] = by_path
        if row["launches"] == 0 and row["name"] != "decode_attention":
            fail(f"kernel {row['name']} was not launched on a main path")
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0

if __name__ == "__main__":
    sys.exit(main())
