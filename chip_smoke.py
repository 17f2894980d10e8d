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
   skipped KV tile, the diagonal key dropped, the last visible tile of a
   diagonal block skipped, the ragged-S mask off by one, the second
   64-column box of K at D 128 read one row late, the backward's D term
   dropped, one query tile's dQ dropped), which their checks must catch,
   and every flash launch must take the ``wgmma`` route.
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
6. Recurrent path: the RG-LRU scan kernel against its plain version at
   the prefill's shape (with planted faults: the carry reset mid-sequence,
   h_last one step early, a read one step late), the flash forward and the
   contiguous decode kernel at recurrentgemma's MQA head_dim 256; then
   full-width, full-depth RecurrentGemma-2B (random bf16 weights from a
   seed) through ``lm.prefill`` of 4 x 4,096 tokens and 32 greedy
   ``lm.decode_step``s, with launch counts as predicted and nothing
   routed; a 3-layer full-width model's prefill and decode logits through
   the kernels against the plain versions, with planted faults; and a
   profile of one prefill and a few decode steps.
7. xLSTM path: the chunkwise mLSTM kernel against its plain version (h and
   the final state) at the prefill's shape, at a ragged S and at a small
   head dim, with planted faults (the state dropped at a chunk boundary,
   one key dropped, the input gate one step late); then full-width,
   full-depth xlstm-1.3b (random bf16 weights from a seed) through
   ``lm.prefill`` of 4 x 2,048 tokens and 32 greedy ``lm.decode_step``s,
   with launch counts as predicted and nothing routed; a 3-layer
   full-width model's logits through the kernels against the plain
   versions, with planted faults; a profile of one prefill and a few
   decode steps, and the host time of one sLSTM block's step loop.
8. Prints the kernel table as one JSON line, then the result line
   ``{"ok": true, "device": {...}}`` last.

Imports nothing of JAX or of the JAX package.  Any failed check raises and
the script exits non-zero before the result line.
"""
from __future__ import annotations

import collections
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
from repro_torch.kernels import mlstm as kmlstm  # noqa: E402
from repro_torch.kernels import norm_gemm as knorm  # noqa: E402
from repro_torch.kernels import rglru as krglru  # noqa: E402
from repro_torch.kernels import sma_gemm as kgemm  # noqa: E402
from repro_torch.launch.train import (TrainLoopConfig, make_step,  # noqa: E402
                                      train)
from repro_torch.models import lm, recurrent  # noqa: E402
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
# time_ms's device-side sleep, ~20 ms at the H100's 1.755 GHz boost
# clock: longer than the host takes to queue 20 calls of any checked entry.
QUEUE_CYCLES = 35_000_000
# Flash forward vs its plain version, bf16 outputs, per element
# |err| <= FLASH_ATOL + FLASH_RTOL * |plain|: twice the decode attention's
# limit, since the kernel rounds P to bf16 before the PV product (the
# plain version keeps it f32).  Rows of few keys average values up to ~4,
# so P's rounding moves them by up to 2 bf16 ulps; at the decode limit
# the first run read 1.19 limits (PERF.md).
FLASH_ATOL, FLASH_RTOL = 4e-3, 2e-2
# Flash backward vs its plain version (fed the same out and lse): max |err|
# over a gradient tensor, relative to that tensor's max |plain|.  dq is
# summed by reduce-adds in the L2 in no fixed order, so its low bits vary
# by run.
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

# The recurrent path: recurrentgemma-2b at full width.  The prompts are a
# multiple of the window (2048): the reference's cache layout after a
# longer prompt only matches its decode's ring slots then (ROADMAP.md).
RG_ARCH = "recurrentgemma-2b"
RG_BATCH, RG_PROMPT, RG_NEW = 4, 4096, 32
# RG-LRU kernel vs its plain version, per element |err| <= RGLRU_ATOL +
# RGLRU_RTOL * |plain|: both round the same f32 product and sum at every
# step, so they should agree exactly; the limit passes one rounding of a
# bf16 output and no more.  Each planted fault of check_rglru must fail it
# on every element it moves by more than FAULT_MARGIN limits.
RGLRU_ATOL, RGLRU_RTOL = 1e-6, 2.0 ** -8
# Logits of the 3-layer recurrent model (prefill's last position, then one
# decode step), kernels vs plain versions, max |err|.  On an H100 the noise
# reads 0.031 (one bf16 step of a logit near 4) and the faults of RG_FAULTS
# marked must 1.93 and 3.10 (PERF.md); the limit lies between them.
RG_LOGIT_ATOL = 0.1

# The xLSTM path: xlstm-1.3b at full width and depth.  2,048-token prompts
# are 16 chunks of 128, so the mLSTM state crosses 15 chunk boundaries.
XL_ARCH = "xlstm-1.3b"
XL_BATCH, XL_PROMPT, XL_NEW = 4, 2048, 32
# mLSTM kernel vs its plain version.  h, per element, |err| <= atol + rtol
# * |plain|, (atol, rtol) by h's dtype: both sum the same f32 terms in
# other orders, so for bf16 rtol passes one rounding flip of h (2^-7) and
# atol the f32 noise of outputs near 0; f32 h is held at the reference's
# own tol_for (tests/test_kernels.py), 2e-4.  The state (f32), per tensor,
# max |err| <= MLSTM_STATE_LIMIT * max |plain|: on an H100 it reads ~4e-7
# (PERF.md).  Each planted fault of mlstm_controls must fail the h check
# on every element it moves by more than FAULT_MARGIN limits.
MLSTM_TOL = {torch.bfloat16: (2e-3, 2.0 ** -7), torch.float32: (2e-4, 2e-4)}
MLSTM_STATE_LIMIT = 1e-5
# check_mlstm's cases (B, H, S, D, dtype): the prefill's shape, a ragged
# S, a small head dim; chunk 128, xlstm-1.3b's.
MLSTM_CASES = [(XL_BATCH, 4, XL_PROMPT, 1024, torch.bfloat16),
               (XL_BATCH, 4, 2000, 1024, torch.bfloat16),
               (2, 4, 1000, 64, torch.float32)]
MLSTM_CHUNK = 128
# Logits of the 3-layer xLSTM model (prefill's last position, then one
# decode step), kernels vs plain versions, max |err|; the faults of
# XL_FAULTS marked must lie above it (PERF.md).
XL_LOGIT_ATOL = 0.1

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
    "rglru_scan": ("src/repro_torch/kernels/csrc/rglru_scan.cu",
                   "src/repro/kernels/rglru.py:55"),
    "mlstm_chunkwise": ("src/repro_torch/kernels/csrc/mlstm_chunkwise.cu",
                        "src/repro/kernels/mlstm.py:108"),
}


def fail(msg: str) -> None:
    raise RuntimeError(f"chip_smoke: {msg}")


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, args_list, iters: int = 20, paced: bool = False) -> float:
    """Mean device time of ``fn(*args)`` in ms over ``iters`` launches,
    cycling through ``args_list`` (copies that together exceed L2).

    The calls are queued behind a device-side sleep of QUEUE_CYCLES, so
    the card runs them back to back: a small kernel's host-side call (tens
    of us on the machines measured) would otherwise pace the card and be
    read as its time.  ``paced=True`` times them without the sleep: the
    host's pace where it is the slower."""
    for args in args_list[:3]:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if not paced:
        torch.cuda._sleep(QUEUE_CYCLES)
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
        before = dict(kgemm.ROUTES)
        got = kgemm.sma_gemm(a, ws[0], epilogue=ep)
        route = routes_since(before)
        err = compare(got, ref.gemm_ref(a, ws[0], epilogue=ep),
                      f"sma_gemm M={m} {k}->{n} {ep}")
        args = [(a, w) for w in ws]
        big = 2 * m * n * k > 1e11
        ms = time_ms(lambda a_, w_: kgemm.sma_gemm(a_, w_, epilogue=ep),
                     args, 5 if big else 20)
        paced_ms = time_ms(
            lambda a_, w_: kgemm.sma_gemm(a_, w_, epilogue=ep), args,
            5 if big else 20, paced=True)
        plain_ms = time_ms(
            lambda a_, w_: ref.gemm_ref(a_, w_, epilogue=ep), args,
            3 if big else 20)
        lib_ms = (time_ms(torch.matmul, args, 5 if big else 20)
                  if ep == "none" else None)
        b = bound(2 * (m * k + k * n + m * n), 2 * m * n * k, dt)
        out.append(entry("sma_gemm", f"M={m} K={k} N={n} {ep} bf16{tag}",
                         err, ms, plain_ms, b, lib_ms))
        out[-1].update(gemm_route=route, paced_ms=paced_ms)
        del a, ws, got, args
    return out


def routes_since(before: dict) -> str:
    """The one ``sma_gemm`` route launched since ``before`` (a copy of
    ``sma_gemm.routes``)."""
    moved = {r for r, n in kgemm.ROUTES.items() if n != before[r]}
    if len(moved) != 1:
        fail(f"sma_gemm: routes {moved} since the last reading, expected one")
    return moved.pop()


def gemm_multiples(got, want):
    """Per element |err| / (ATOL + RTOL |plain|): above 1 where the GEMM
    check fails."""
    return ((got.float() - want.float()).abs()
            / (ATOL + RTOL * want.float().abs()))


def gemm_controls(gen, dev):
    """Planted faults fed to ``sma_gemm``, each held against the plain
    version of the right inputs: on the split-K route (M 8, 2048->5632) the
    last K slice of B zeroed; on the wgmma route (M 200, 2056->392: K one
    8-row step past the 64-deep tiles, N three boxes and a ragged fourth)
    the last, ragged K tile of B zeroed, and one 64-column box of B
    (columns 64-127, the second box of the first tile) negated.  Each
    must fail the check on every element it moves by more than
    FAULT_MARGIN limits (measured on the plain version of the faulty
    inputs)."""
    dt = torch.bfloat16
    cases = []
    m, k, n = 8, 2048, 5632
    slices, kslice = kgemm._slices(n, k)
    a = torch.randn((m, k), generator=gen, device=dev).to(dt)
    w = (torch.randn((k, n), generator=gen, device=dev) * k ** -0.5).to(dt)
    bad = w.clone()
    bad[(slices - 1) * kslice:] = 0
    cases.append((f"split-K, last K slice (rows {(slices - 1) * kslice}-"
                  f"{k - 1} of {slices}) zeroed", "splitk", a, w, bad))
    m, k, n = 200, 2056, 392
    a = torch.randn((m, k), generator=gen, device=dev).to(dt)
    w = (torch.randn((k, n), generator=gen, device=dev) * k ** -0.5).to(dt)
    bad = w.clone()
    bad[k // 64 * 64:] = 0
    cases.append((f"wgmma, last ragged K tile (rows {k // 64 * 64}-{k - 1}) "
                  f"zeroed", "wgmma", a, w, bad))
    bad = w.clone()
    bad[:, 64:128] = -bad[:, 64:128]
    cases.append(("wgmma, one 64-column box of B (columns 64-127) negated",
                  "wgmma", a, w, bad))
    for name, route, a, w, bad in cases:
        want = ref.gemm_ref(a, w)
        effect = gemm_multiples(ref.gemm_ref(a, bad), want)
        before = dict(kgemm.ROUTES)
        got = gemm_multiples(kgemm.sma_gemm(a, bad), want)
        if routes_since(before) != route:
            fail(f"sma_gemm control '{name}' did not take the {route} route")
        must = effect > FAULT_MARGIN
        n_must, n_caught = int(must.sum()), int((got[must] > 1).sum())
        print(f"sma_gemm control, {name}: moves {n_must} of {must.numel()} "
              f"elements by > {FAULT_MARGIN} limits; the check fails "
              f"{n_caught} of them (min multiple "
              f"{got[must].min().item() if n_must else 0:.3g})")
        if n_must == 0 or n_caught < n_must:
            fail(f"sma_gemm control '{name}' passes the check where it "
                 f"moves the output")


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
    out[-1]["paced_ms"] = time_ms(kdecode.paged_decode_attention, args,
                                  paced=True)

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
    out[-1]["paced_ms"] = time_ms(kdecode.decode_attention, args,
                                  paced=True)
    return out


# ---------------------------------------------------------------------------
# Flash attention, forward and backward, at the trainer's shapes
# ---------------------------------------------------------------------------
FLASH_CASES = {   # B 4, S 2048, bf16, causal; Hq/Hkv, window and D vary
    "causal": (32, 32, None, 64),
    "GQA 32/8": (32, 8, None, 64),
    "window 512": (32, 32, 512, 64),
    "GQA 32/8 D 128": (32, 8, None, 128),
}
# The wgmma kernels' tiles (csrc/flash_attention.cu): 128 query rows and
# 128 keys a forward block (64 keys at D 256), 64 query rows a backward tile.
FLASH_BQ, FLASH_TK, FLASH_BWD_BQ = 128, 128, 64


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


def fault_caught(name, effect, bad):
    """A planted forward fault: ``effect`` and ``bad`` are the row limit
    multiples of the plain version and of the kernel on the faulty inputs.
    The check must fail every row the fault moves by > FAULT_MARGIN."""
    must = effect > FAULT_MARGIN
    n_must, n_caught = int(must.sum()), int((bad[must] > 1).sum())
    print(f"flash control, {name}: moves {n_must} of {must.numel()} rows by "
          f"> {FAULT_MARGIN} limits (largest {effect.max().item():.3g}); "
          f"the check fails {n_caught} of them (min multiple "
          f"{bad[must].min().item() if n_must else 0:.3g}) and "
          f"{(bad > 1).float().mean():.3f} of all rows")
    if n_must == 0 or n_caught < n_must:
        fail(f"flash control '{name}' passes the check on a row it changes")


def flash_controls(q, k, v, dout, out, lse):
    """Planted faults fed to the kernels at B 4, H 32, S 2048, D 64,
    causal, each held against the plain version of the right inputs.

    Forward: the 64 newest keys of every query dropped (row i + 64 run with
    keys 0..i); the diagonal key dropped (row i + 1 run with keys 0..i);
    the last visible KV tile of a diagonal block skipped (the block's 128
    rows run with the keys before its diagonal tile, unmasked), for blocks
    1, 4 and 15; the ragged-S mask off by one (non-causal, Skv 9 and 128,
    run with one key more).  Each must fail the forward check on every row
    it moves by more than FAULT_MARGIN limits.  Backward: the D =
    rowsum(dO * O) term dropped (O fed as zeros) must fail the dq and dk
    checks; one query tile's dQ dropped (dO of rows 64-127, or 1024-1087,
    of one head zeroed, which zeroes those rows' dS and so every dQ
    reduce-add they get) must fail the dq check."""
    want = ref.flash_attention_ref(q, k, v)[0]
    for name, drop in (("KV tile skipped (64 newest keys)", 64),
                       ("diagonal key dropped", 1)):
        args = (q[:, :, drop:], k[:, :, :-drop], v[:, :, :-drop])
        fault_caught(name,
                     row_multiples(ref.flash_attention_ref(*args)[0],
                                   want[:, :, drop:]),
                     row_multiples(kflash.flash_attention_fwd(*args)[0],
                                   want[:, :, drop:]))
    for blk in (1, 4, 15):
        rows = slice(blk * FLASH_BQ, (blk + 1) * FLASH_BQ)
        keys = slice(0, blk * FLASH_BQ)
        args = (q[:, :, rows], k[:, :, keys], v[:, :, keys])
        fault_caught(f"last visible KV tile of diagonal block {blk} "
                     f"skipped",
                     row_multiples(ref.flash_attention_ref(
                         *args, causal=False)[0], want[:, :, rows]),
                     row_multiples(kflash.flash_attention_fwd(
                         *args, causal=False)[0], want[:, :, rows]))
    for skv in (9, FLASH_TK):
        qs = q[:, :, :256]
        good = ref.flash_attention_ref(qs, k[:, :, :skv], v[:, :, :skv],
                                       causal=False)[0]
        args = (qs, k[:, :, :skv + 1], v[:, :, :skv + 1])
        fault_caught(f"ragged-S mask off by one (Skv {skv} read as "
                     f"{skv + 1})",
                     row_multiples(ref.flash_attention_ref(
                         *args, causal=False)[0], good),
                     row_multiples(kflash.flash_attention_fwd(
                         *args, causal=False)[0], good))
    wants = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout)
    bad = kflash.flash_attention_bwd(q, k, v, torch.zeros_like(out), lse,
                                     dout)
    errs = [grad_error(g, w) for g, w in zip(bad, wants)]
    print(f"flash control, backward D term dropped: dq {errs[0]:.4g}, dk "
          f"{errs[1]:.4g}, dv {errs[2]:.4g} (limit {FLASH_GRAD_LIMIT}): "
          f"{errs[0] / FLASH_GRAD_LIMIT:.3g} and "
          f"{errs[1] / FLASH_GRAD_LIMIT:.3g} limits")
    if min(errs[:2]) <= FLASH_GRAD_LIMIT:
        fail("flash control 'D term dropped' passes the dq or dk check")
    for tile in (1, 16):
        rows = slice(tile * FLASH_BWD_BQ, (tile + 1) * FLASH_BWD_BQ)
        hole = dout.clone()
        hole[0, 0, rows] = 0
        dq_bad = kflash.flash_attention_bwd(q, k, v, out, lse, hole)[0]
        err = grad_error(dq_bad, wants[0])
        print(f"flash control, dQ of query tile {tile} (rows {rows.start}-"
              f"{rows.stop - 1}, batch 0, head 0) dropped: dq {err:.4g} = "
              f"{err / FLASH_GRAD_LIMIT:.3g} limits")
        if err <= FLASH_GRAD_LIMIT:
            fail(f"flash control 'dQ of query tile {tile} dropped' passes "
                 f"the dq check")


def flash_box_control(q, k, v, want):
    """Planted fault at D 128, causal: the second 64-column box of K read
    one row late (K's columns 64-127 taken from the next key).  It must
    fail the forward check on every row it moves by more than FAULT_MARGIN
    limits."""
    bad_k = k.clone()
    bad_k[..., :-1, 64:] = k[..., 1:, 64:]
    fault_caught("second 64-column box of K at D 128 read one row late",
                 row_multiples(ref.flash_attention_ref(q, bad_k, v)[0],
                               want),
                 row_multiples(kflash.flash_attention_fwd(q, bad_k, v)[0],
                               want))


#: The flash routes each path's run launched, filled as the paths run.
FLASH_ROUTES_BY_PATH = {}


def check_flash_routes(where: str, counts: dict) -> dict:
    """Every flash launch in ``counts`` (``ops.launch_counts`` since the
    last ``ops.reset_counts``) went the ``wgmma`` route; returns the
    launches by route."""
    got = {"flash_attention": nonzero(kflash.FWD_ROUTES),
           "flash_attention_bwd": nonzero(kflash.BWD_ROUTES)}
    for name in got:
        want = {"wgmma": counts[name]} if counts.get(name) else {}
        if got[name] != want:
            fail(f"{where}: {name} routes {got[name]}, expected {want}")
    return got


def check_flash(gen, dev):
    """Each case: forward (out, lse) and backward (dq, dk, dv, fed the
    kernel's out and lse) against the plain versions; the causal case also
    feeds the planted faults and is timed."""
    dt = torch.bfloat16
    rows = []
    ops.reset_counts()
    for case, (hq, hkv, window, d) in FLASH_CASES.items():
        q, k, v, dout = flash_inputs(gen, dev, hq, hkv, d=d)
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
        if d == 128:
            flash_box_control(q, k, v, want)
        if case != "causal":
            continue
        routes = check_flash_routes("flash checks", ops.launch_counts())
        print(f"flash routes of the checks so far: {json.dumps(routes)}")
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
    routes = dict(kgemm.ROUTES)

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
    # Decode ticks (M = batch <= 8) on split-K; prefill ticks on wgmma,
    # or split-K where a tick holds 16 tokens or fewer.
    if routes["tile"] or routes["f32"] \
            or routes["splitk"] < per_layer * len(ticks["decode"]):
        fail(f"serve: sma_gemm routes {routes}, expected wgmma and split-K "
             f"only, split-K on every decode tick")
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
          f"decode; routed to plain by design {json.dumps(routed)}; "
          f"sma_gemm routes {json.dumps(routes)}")
    del eng
    torch.cuda.empty_cache()
    return counts, routes


@contextlib.contextmanager
def plain_kernels():
    """Swap every kernel wrapper for its plain version, where the entry
    points and the autograd Functions look them up, to run the same step
    (forward and backward) without the kernels."""
    swaps = {(kgemm, "sma_gemm"): ref.gemm_ref,
             (knorm, "rmsnorm_gemm"): ref.rmsnorm_gemm_ref,
             (kdecode, "paged_decode_attention"):
                 ref.paged_decode_attention_ref,
             (kdecode, "decode_attention"): ref.decode_attention_ref,
             (krglru, "rglru_scan"): ref.rglru_scan_ref,
             (kmlstm, "mlstm_chunkwise"): ref.mlstm_chunkwise_ref,
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
    routes = nonzero(kgemm.ROUTES)
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
    if routes != {"wgmma": counts["sma_gemm"]}:
        fail(f"trainer: sma_gemm routes {routes}, expected every launch on "
             f"wgmma")
    FLASH_ROUTES_BY_PATH["train"] = check_flash_routes("trainer", counts)
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
          f"a step {json.dumps(per_step)}; routed {routed}; sma_gemm routes "
          f"{json.dumps(routes)}; flash routes "
          f"{json.dumps(FLASH_ROUTES_BY_PATH['train'])}")
    return counts, routes, result["params"]


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
    for dev_us, count, key in sorted(rows, reverse=True)[:16]:
        print(f"profile: {dev_us / steps / 1e3:8.3f} ms/step "
              f"{count // steps:5d}/step  {key[:90]}")


# ---------------------------------------------------------------------------
# The recurrent path: recurrentgemma-2b through lm.prefill / lm.decode_step
# ---------------------------------------------------------------------------
def scan_inputs(gen, dev, b, s, d, dt):
    """Decays in (0, 1) and inputs of 0.1 scale, as the reference's kernel
    test draws them; h0 of unit scale."""
    a = torch.sigmoid(torch.randn((b, s, d), generator=gen, device=dev))
    u = torch.randn((b, s, d), generator=gen, device=dev) * 0.1
    h0 = torch.randn((b, d), generator=gen, device=dev)
    return a.to(dt), u.to(dt), h0.to(dt)


def rglru_multiples(got, want):
    return ((got.float() - want.float()).abs()
            / (RGLRU_ATOL + RGLRU_RTOL * want.float().abs()))


def rglru_controls(a, u, h0, want_seq, want_last):
    """Planted faults fed to the kernel, each held against the plain
    version of the right inputs: the carry reset to h0 at t = S/2 (the
    sequence run as two halves), h_last taken one step early (the last
    step left out) and a read one step late (a_t replaced by a_{t-1}).
    Each must fail the check on every element it moves by more than
    FAULT_MARGIN limits (measured on the plain version of the faulty
    inputs)."""
    half = a.shape[1] // 2
    late = torch.cat([a[:, :1], a[:, :-1]], 1)

    def reset(fn):
        s1, _ = fn(a[:, :half], u[:, :half], h0)
        s2, last = fn(a[:, half:], u[:, half:], h0)
        return torch.cat([s1, s2], 1), last

    faults = {
        f"carry reset to h0 at t={half}": (reset, 0),
        "h_last one step early": (
            lambda fn: fn(a[:, :-1], u[:, :-1], h0), 1),
        "a read at t-1": (lambda fn: fn(late, u, h0), 0),
    }
    for name, (run, which) in faults.items():
        want = (want_seq, want_last)[which]
        effect = rglru_multiples(run(ref.rglru_scan_ref)[which], want)
        bad = rglru_multiples(run(krglru.rglru_scan)[which], want)
        must = effect > FAULT_MARGIN
        n_must = int(must.sum())
        n_caught = int((bad[must] > 1).sum())
        print(f"rglru control, {name}: moves {n_must} of {must.numel()} "
              f"{'h_seq' if which == 0 else 'h_last'} elements by > "
              f"{FAULT_MARGIN} limits; the check fails {n_caught} of them")
        if n_must == 0 or n_caught < n_must:
            fail(f"rglru control '{name}' passes the check where it moves "
                 f"the output")


def check_rglru(gen, dev):
    """The scan kernel against its plain version at the prefill's shape
    (B 4, S 4096, D 2560, bf16) with and without h0, and at a ragged
    (1, 4097, 2568) in f32; the planted faults on the first; the prefill's
    call (no h0) timed."""
    rows = []
    cases = [(RG_BATCH, RG_PROMPT, 2560, torch.bfloat16, True),
             (RG_BATCH, RG_PROMPT, 2560, torch.bfloat16, False),
             (1, RG_PROMPT + 1, 2568, torch.float32, True)]
    for i, (b, s, d, dt, with_h0) in enumerate(cases):
        a, u, h0 = scan_inputs(gen, dev, b, s, d, dt)
        h0 = h0 if with_h0 else None
        got = krglru.rglru_scan(a, u, h0)
        want = ref.rglru_scan_ref(a, u, h0)
        mult = max(rglru_multiples(g, w).max().item()
                   for g, w in zip(got, want))
        err = max((g.float() - w.float()).abs().max().item()
                  for g, w in zip(got, want))
        shape = (f"B={b} S={s} D={d} {str(dt)[6:]}"
                 f"{' h0' if with_h0 else ''}")
        print(f"rglru {shape}: max |err| {err:.4g}, max limit multiple "
              f"{mult:.3g} of {RGLRU_ATOL} + {RGLRU_RTOL:.4g}|plain|")
        if not all(torch.isfinite(g.float()).all() for g in got) \
                or mult > 1:
            fail(f"rglru_scan {shape}: kernel disagrees with its plain "
                 f"version")
        if i == 0:
            rglru_controls(a, u, h0, *want)
        if i == 1:
            nbytes = 3 * a.numel() * a.element_size() \
                + b * d * a.element_size()
            rows.append(entry(
                "rglru_scan", shape, err,
                time_ms(krglru.rglru_scan, [(a, u)]),
                time_ms(ref.rglru_scan_ref, [(a, u)], 2),
                bound(nbytes, 2 * a.numel(), torch.float32), None))
        del a, u, h0, got, want
    return rows


def check_flash_mqa(gen, dev):
    """The flash forward at recurrentgemma's prefill shape: B 4, Hq 10,
    Hkv 1, S 4096, D 256, window 2048, bf16; timed against the plain
    version and scaled_dot_product_attention with the windowed mask.  One
    key more in a window of 2048 moves a row by about 1/2048 of its
    values, under the tolerance, so the planted fault 'the window one key
    too wide' is fed at window 8 (S 512) as well, where it must be
    caught."""
    dt = torch.bfloat16
    b, hq, s, d, window = RG_BATCH, 10, RG_PROMPT, 256, 2048
    rows = []
    for seq, win, timed in ((s, window, True), (512, 8, False)):
        q, k, v, _ = flash_inputs(gen, dev, hq, 1, seq=seq, b=b, d=d)
        out, lse = kflash.flash_attention_fwd(q, k, v, window=win)
        want, want_lse = ref.flash_attention_ref(q, k, v, window=win)
        mult = row_multiples(out, want)
        err = (out.float() - want.float()).abs().max().item()
        lse_err = (lse - want_lse).abs().max().item()
        wide_plain = ref.flash_attention_ref(q, k, v, window=win + 1)[0]
        effect = row_multiples(wide_plain, want)
        bad = row_multiples(
            kflash.flash_attention_fwd(q, k, v, window=win + 1)[0], want)
        must = effect > FAULT_MARGIN
        n_must, n_caught = int(must.sum()), int((bad[must] > 1).sum())
        print(f"flash MQA D={d} S={seq} window {win}: out max |err| "
              f"{err:.4g} (max limit multiple {mult.max().item():.3g}), lse "
              f"{lse_err:.3g}; control, window one key too wide: moves "
              f"{n_must} of {must.numel()} rows by > {FAULT_MARGIN} limits "
              f"(largest {effect.max().item():.3g}), the check fails "
              f"{n_caught} of them")
        del wide_plain, want_lse
        if not torch.isfinite(out.float()).all() or mult.max() > 1:
            fail(f"flash forward MQA D={d} window {win}: kernel disagrees "
                 f"with its plain version")
        if lse_err > 1e-2:
            fail(f"flash forward MQA D={d}: lse off by {lse_err:.3g}")
        if not timed and (n_must == 0 or n_caught < n_must):
            fail(f"flash control 'window one key too wide' at window {win} "
                 f"passes the check on a row it changes")
        if not timed:
            continue
        args = [(q, k, v)]
        mask = ref.flash_mask(seq, seq, causal=True, window=win, device=dev)

        def sdpa(q_, k_, v_):
            return F.scaled_dot_product_attention(
                q_, k_.expand(-1, hq, -1, -1), v_.expand(-1, hq, -1, -1),
                attn_mask=mask)

        pairs = visible_pairs(seq, seq, win, dev) * b * hq
        io = 2 * (2 * q.numel() + 2 * k.numel()) + 4 * b * hq * seq
        rows.append(entry(
            "flash_attention",
            f"B={b} Hq={hq} Hkv=1 S={seq} D={d} causal window={win} bf16",
            err, time_ms(lambda *a_: kflash.flash_attention_fwd(
                *a_, window=win), args),
            time_ms(lambda *a_: ref.flash_attention_ref(*a_, window=win),
                    args, 2),
            bound(io, 4 * d * pairs, dt), time_ms(sdpa, args, 5)))
        del out, want, args, mask
        torch.cuda.empty_cache()
    return rows


RG_KV_LENS = (1, 17, 100, 256, 511, 1024, 1777, 2048)


def split_controls(q, kc, vc, lens, want):
    """Planted faults fed to the split-KV decode over a full cache (every
    length Smax), each held against the plain version of the right
    inputs: one key changed in the last split only (position Smax - 1
    set to the sum of the g query rows, so every row weighs it heavily),
    and the first position of each split dropped (those positions cut out
    of the cache).  Each must fail the attention check on every (request,
    query head) row it moves by more than FAULT_MARGIN limits (measured on
    the plain version of the faulty inputs)."""
    b, hq, d = q.shape
    hkv, smax = kc.shape[1], kc.shape[2]
    splits = kdecode._splits(b, hkv, smax)
    chunk = -(-smax // splits)
    last = kc.clone()
    last[:, :, -1] = q.float().reshape(b, hkv, hq // hkv, d).sum(2).to(
        kc.dtype)
    keep = torch.tensor([p for p in range(smax) if p % chunk],
                        device=q.device)
    firsts = (lens[:, None] > torch.arange(0, smax, chunk,
                                           device=q.device)).sum(1)
    faults = {
        f"key at {smax - 1} (last of {splits} splits) changed":
            (q, last, vc, lens),
        f"first position of each of {splits} splits dropped":
            (q, kc[:, :, keep].contiguous(), vc[:, :, keep].contiguous(),
             (lens - firsts).to(lens.dtype)),
    }
    for name, args in faults.items():
        effect = limit_multiples(ref.decode_attention_ref(*args)
                                 .reshape(b * hq, d), want.reshape(b * hq, d),
                                 ATTN_ATOL, ATTN_RTOL)
        bad = limit_multiples(kdecode.decode_attention(*args)
                              .reshape(b * hq, d), want.reshape(b * hq, d),
                              ATTN_ATOL, ATTN_RTOL)
        must = effect > FAULT_MARGIN
        n_must, n_caught = int(must.sum()), int((bad[must] > 1).sum())
        print(f"decode MQA control, {name}: moves {n_must} of {b * hq} rows "
              f"by > {FAULT_MARGIN} limits; the check fails {n_caught} of "
              f"them (min multiple "
              f"{bad[must].min().item() if n_must else 0:.3g})")
        if n_must == 0 or n_caught < n_must:
            fail(f"decode MQA control '{name}' passes the attention "
                 f"tolerance on a row it moves")


def check_decode_mqa(gen, dev):
    """The contiguous decode kernel at recurrentgemma's decode shape: B 8,
    Hq 10, Hkv 1, D 256, Smax 2048 (the ring of a local layer), bf16,
    lengths 1..2048 checked; timed with every length 2048, as a decode
    step past the window reads it."""
    dt = torch.bfloat16
    b, hq, d, smax = 8, 10, 256, 2048
    q = torch.randn((b, hq, d), generator=gen, device=dev).to(dt)
    caches = [tuple(torch.randn((b, 1, smax, d), generator=gen,
                                device=dev).to(dt) for _ in range(2))
              for _ in range(copies(2 * b * smax * d * 2))]
    ragged = torch.tensor(RG_KV_LENS, dtype=torch.int32, device=dev)
    full = torch.full((b,), smax, dtype=torch.int32, device=dev)
    errs = []
    for lens in (ragged, full):
        got = kdecode.decode_attention(q, *caches[0], lens)
        want = ref.decode_attention_ref(q, *caches[0], lens)
        errs.append(compare(got, want, f"decode_attention MQA D={d}",
                            ATTN_ATOL, ATTN_RTOL))
        mult = limit_multiples(got, want, ATTN_ATOL, ATTN_RTOL)
        print(f"decode MQA D={d}, kernel vs plain: limit multiple by "
              f"kv_len {lens.tolist()}: {[round(x, 4) for x in mult.tolist()]}")
    split_controls(q, *caches[0], full, want)   # want: the full lengths
    args = [(q, kc, vc, full) for kc, vc in caches]
    mask = (torch.arange(smax, device=dev)[None, :]
            < full[:, None])[:, None, None, :]

    def sdpa(q_, k_, v_, _lens):
        return F.scaled_dot_product_attention(
            q_[:, :, None], k_.expand(-1, hq, -1, -1),
            v_.expand(-1, hq, -1, -1), attn_mask=mask)

    nbytes = 2 * 2 * b * hq * d + 2 * 2 * b * smax * d + 4 * b
    row = entry(
        "decode_attention",
        f"B={b} Hq={hq} Hkv=1 D={d} Smax={smax} kv_len={smax} bf16 "
        f"(checked also at {list(RG_KV_LENS)})",
        max(errs), time_ms(kdecode.decode_attention, args),
        time_ms(ref.decode_attention_ref, args),
        bound(nbytes, 4 * b * hq * smax * d, dt), time_ms(sdpa, args))
    row["paced_ms"] = time_ms(kdecode.decode_attention, args, paced=True)
    return [row]


def rg_launches(cfg, phase: str) -> dict:
    """Launches of one call: an rglru block makes 8 projections (w_in,
    w_gate, w_a, w_x, w_out and the MLP's 3), a local block 7; prefill
    runs one scan per rglru block and one flash forward per local block,
    a decode step one contiguous decode per local block; the head is one
    rmsnorm_gemm."""
    n_rglru = cfg.num_groups * cfg.block_pattern.count("rglru")
    n_local = cfg.num_groups * cfg.block_pattern.count("local")
    out = {"sma_gemm": 8 * n_rglru + 7 * n_local, "rmsnorm_gemm": 1}
    if phase == "prefill":
        out.update(rglru_scan=n_rglru, flash_attention=n_local)
    else:
        out["decode_attention"] = n_local
    return out


def rg_tokens(cfg, dev, shape, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, shape, generator=gen, device=dev)


def nonzero(counts: dict) -> dict:
    return {k: n for k, n in counts.items() if n}


def serve_recurrent(cfg, params, dev, launches, batch, prompt, new):
    """lm.prefill of ``batch`` x ``prompt`` tokens, then ``new`` greedy
    lm.decode_steps, at full width and depth.  Checks finite logits, the
    launches of every call (``launches(cfg, phase)``) and that nothing was
    routed; prints prefill ms, the median decode step, tokens/s and peak
    memory.  Returns the run's launch counts."""
    cache = prompt + 64
    toks = rg_tokens(cfg, dev, (batch, prompt), 0)
    # Warm-up (first launches, allocator): a short prompt and one step.
    logits, state, cl = lm.prefill(params, cfg, {"tokens": toks[:, :256]},
                                   cache_size=cache)
    lm.decode_step(params, state, cl, cfg,
                   {"tokens": logits.argmax(-1, keepdim=True)})
    del logits, state, cl
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    total = collections.Counter()
    ops.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, state, cl = lm.prefill(params, cfg, {"tokens": toks},
                                   cache_size=cache)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    calls = [("prefill", ops.launch_counts(), dict(ops.ROUTED),
              nonzero(kgemm.ROUTES), logits)]
    flash_r = check_flash_routes(f"{cfg.name} prefill", calls[0][1])
    FLASH_ROUTES_BY_PATH[cfg.name] = flash_r
    steps, out_tokens = [], []
    for _ in range(new):
        nxt = logits.argmax(-1, keepdim=True)
        out_tokens.append(nxt)
        ops.reset_counts()
        t = time.perf_counter()
        logits, state, cl = lm.decode_step(params, state, cl, cfg,
                                           {"tokens": nxt})
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t)
        calls.append(("decode", ops.launch_counts(), dict(ops.ROUTED),
                      nonzero(kgemm.ROUTES), logits))
    peak = torch.cuda.max_memory_allocated()
    vpad = lm.padded_vocab(cfg)
    routes = collections.Counter()
    for i, (phase, counts, routed, gemm_routes, lg) in enumerate(calls):
        if lg.shape != (batch, vpad) or not torch.isfinite(lg).all():
            fail(f"{cfg.name} call {i} ({phase}): logits "
                 f"{tuple(lg.shape)} or non-finite")
        if nonzero(counts) != launches(cfg, phase) or routed:
            fail(f"{cfg.name} call {i} ({phase}): launches "
                 f"{nonzero(counts)}, expected {launches(cfg, phase)}; "
                 f"routed {routed}")
        want = {"prefill": "wgmma", "decode": "splitk"}[phase]
        if gemm_routes != {want: counts["sma_gemm"]}:
            fail(f"{cfg.name} call {i} ({phase}): sma_gemm routes "
                 f"{gemm_routes}, expected every launch on {want}")
        total.update(counts)
        routes.update(gemm_routes)
    if cl.tolist() != [prompt + new] * batch:
        fail(f"{cfg.name}: cache_len {cl.tolist()} after the run")
    toks_out = torch.cat(out_tokens, 1)
    step_ms = 1e3 * float(np.median(steps))
    n_params = sum(t.numel() for t in leaves(params))
    print(f"{cfg.name}: full width ({cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, vocab {vpad}, {n_params / 1e9:.3f} B "
          f"parameters), bf16, random weights; prefill {batch} x {prompt} "
          f"tokens in {1e3 * prefill_s:.2f} ms "
          f"({batch * prompt / prefill_s:.1f} tokens/s); {new} decode "
          f"steps, median {step_ms:.3f} ms (min {1e3 * min(steps):.3f}, "
          f"max {1e3 * max(steps):.3f}): {batch * new / sum(steps):.1f} "
          f"tokens/s; peak memory {peak / 2**30:.2f} GiB "
          f"(max_memory_allocated)")
    print(f"{cfg.name}: launches a prefill "
          f"{json.dumps(launches(cfg, 'prefill'))}, a decode step "
          f"{json.dumps(launches(cfg, 'decode'))}, as predicted; nothing "
          f"routed; sma_gemm routes {json.dumps(dict(routes))} (prefill "
          f"wgmma, decode split-K); the prefill's flash routes "
          f"{json.dumps(flash_r)}; row 0 tokens "
          f"{toks_out[0, :8].tolist()}")
    return dict(total), dict(routes)


# Planted faults of check_recurrent_logits, each one wrong launch: must
# the logit limit catch it?  A carry reset mid-sequence is forgotten
# within a few steps (a = exp(-8 softplus(lambda) r) is ~e^-4.8 with these
# weights) and one ring slot is 1 of 2048 keys: both are readings.
RG_FAULTS = {"rglru: carry reset at t = S/2": False,
             "rglru: h_seq one step late": True,
             "decode: oldest ring slot skipped": False,
             "decode: eff_len taken mod the window (1 slot read)": True}


@contextlib.contextmanager
def planted_recurrent(fault: str, pos: int, smax: int):
    """One wrong launch, made by feeding a kernel wrong inputs: the second
    scan of the prefill (the rglru layer just before the local layer) with
    its carry reset at S/2 or its h_seq shifted one step late, or the
    decode step's attention (which writes position ``pos`` into a full
    ring of ``smax`` slots) without the oldest slot or over
    ``(pos + 1) % smax`` slots.  Yields the call counts."""
    scan, attn = ops.rglru_scan, ops.decode_attention
    calls = {"scan": 0, "attn": 0}

    def wrong_scan(a, u, h0=None):
        calls["scan"] += 1
        if calls["scan"] != 2 or not fault.startswith("rglru"):
            return scan(a, u, h0)
        if "reset" in fault:
            half = a.shape[1] // 2
            s1, _ = scan(a[:, :half], u[:, :half], h0)
            s2, last = scan(a[:, half:], u[:, half:])
            return torch.cat([s1, s2], 1), last
        seq, last = scan(a, u, h0)
        return torch.cat([torch.zeros_like(seq[:, :1]), seq[:, :-1]], 1), last

    def wrong_attn(q, k_cache, v_cache, lens, **kw):
        calls["attn"] += 1
        if "oldest" in fault:
            keep = torch.tensor([i for i in range(smax)
                                 if i != (pos + 1) % smax], device=q.device)
            return attn(q, k_cache[:, :, keep], v_cache[:, :, keep],
                        lens - 1, **kw)
        if "mod the window" in fault:
            lens = torch.full_like(lens, (pos + 1) % smax)
        return attn(q, k_cache, v_cache, lens, **kw)

    ops.rglru_scan, ops.decode_attention = wrong_scan, wrong_attn
    try:
        yield calls
    finally:
        ops.rglru_scan, ops.decode_attention = scan, attn


def check_logits(cfg3, dev, prompt, launches, faults, planted, calls,
                 limit):
    """A 3-layer full-width model ``cfg3``: the prefill's last-position
    logits (B 2, ``prompt`` tokens) and one decode step's, through the
    kernels and through the plain versions; then each fault of ``faults``
    (name -> must it be caught) planted by ``planted(name)``, a context
    that yields its call counts, which must equal ``calls``.  The noise
    must lie under ``limit`` and the faults marked must above it."""
    params = lm.init(cfg3, seed=0, device=dev)
    b = 2
    toks = rg_tokens(cfg3, dev, (b, prompt), 1)
    nxt = rg_tokens(cfg3, dev, (b, 1), 2)
    tag = f"{cfg3.name} 3-layer logits"

    def run():
        logits, state, cl = lm.prefill(params, cfg3, {"tokens": toks},
                                       cache_size=prompt + 64)
        step = lm.decode_step(params, state, cl, cfg3, {"tokens": nxt})[0]
        return logits.float(), step.float()

    ops.reset_counts()
    got = run()
    counts = nonzero(ops.launch_counts())
    expect = collections.Counter(launches(cfg3, "prefill"))
    expect.update(launches(cfg3, "decode"))
    if counts != dict(expect):
        fail(f"{tag}: launches {counts}, expected {dict(expect)}")
    with plain_kernels():
        want = run()
    for name, g in zip(("prefill", "decode step"), got):
        if g.shape != (b, lm.padded_vocab(cfg3)) \
                or not torch.isfinite(g).all():
            fail(f"{tag}, {name}: shape {tuple(g.shape)} or non-finite")

    def readings(outs) -> list:
        return [(g - w).abs().max().item() for g, w in zip(outs, want)]

    noise = max(readings(got))
    agree = [int((g.argmax(-1) == w.argmax(-1)).sum())
             for g, w in zip(got, want)]
    print(f"{tag}, kernels vs plain versions: max |err| prefill "
          f"{readings(got)[0]:.4g}, decode step {readings(got)[1]:.4g} "
          f"(|logit| max {want[0].abs().max().item():.3g}); top-1 agree on "
          f"{agree} of {b} rows; limit {limit}")
    missed = []
    for fault, must in faults.items():
        with planted(fault) as made:
            r = readings(run())
        if made != calls:
            fail(f"{tag} control '{fault}': {made} launches, so the fault "
                 f"may have missed its target")
        print(f"{tag} control, {fault}: max |err| prefill {r[0]:.4g}, "
              f"decode step {r[1]:.4g} ({max(r) / limit:.3g} limits; "
              f"{'must be caught' if must else 'a reading'})")
        if must and max(r) <= limit:
            missed.append(fault)
    if noise > limit:
        fail(f"{tag}: max |err| {noise:.4g} > {limit}")
    if missed:
        fail(f"{tag}: planted faults within the limit: {missed}")


def check_recurrent_logits(cfg, dev):
    """check_logits for pattern (rglru, rglru, local) x 1 group, with
    RG_FAULTS."""
    cfg3 = dataclasses.replace(cfg, block_pattern=("rglru", "rglru", "local"),
                               num_groups=1)
    check_logits(cfg3, dev, RG_PROMPT, rg_launches, RG_FAULTS,
                 lambda f: planted_recurrent(f, RG_PROMPT, cfg3.window),
                 {"scan": 2, "attn": 1}, RG_LOGIT_ATOL)


def profile_serving(cfg, params, dev, batch, prompt, steps: int = 5):
    """torch.profiler over one full-width prefill of ``batch`` x ``prompt``
    tokens (device activity only: a CPU-side trace of xLSTM's ~270,000
    launches takes minutes to reduce, and the report reads device rows
    only) and over a few decode steps after it: device busy share and
    device time by kernel of each."""
    from torch.profiler import ProfilerActivity, profile
    toks = rg_tokens(cfg, dev, (batch, prompt), 3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        logits, state, cl = lm.prefill(params, cfg, {"tokens": toks},
                                       cache_size=prompt + 64)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    report_profile(prof, wall, 1, f"{cfg.name} prefill")
    del prof
    nxt = {"tokens": logits.argmax(-1, keepdim=True)}
    lm.decode_step(params, state, cl, cfg, nxt)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            lm.decode_step(params, state, cl, cfg, nxt)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    report_profile(prof, wall, steps, f"{cfg.name} decode step")


# ---------------------------------------------------------------------------
# The xLSTM path: xlstm-1.3b through lm.prefill / lm.decode_step
# ---------------------------------------------------------------------------
def mlstm_inputs(gen, dev, b, h, s, d, dt):
    """q, k, v unit normals in ``dt`` (the projections' scale); the gates
    as the model makes them: log_i ~ N(0, 0.5), log_f = log_sigmoid(N(0,
    0.5) + the reference's forget bias linspace(3, 6) over the heads), so
    f is 0.95-0.998 and the state is remembered across chunks."""
    q, k, v = (torch.randn((b, h, s, d), generator=gen, device=dev).to(dt)
               for _ in range(3))
    bias = torch.linspace(3.0, 6.0, h, device=dev)[None, :, None]
    lf = F.logsigmoid(0.5 * torch.randn((b, h, s), generator=gen,
                                        device=dev) + bias)
    li = 0.5 * torch.randn((b, h, s), generator=gen, device=dev)
    return q, k, v, lf, li


def mlstm_multiples(got, want):
    atol, rtol = MLSTM_TOL[want.dtype]
    return ((got.float() - want.float()).abs()
            / (atol + rtol * want.float().abs()))


def state_errors(got, want) -> list:
    """max |err| / max |plain| of C, n and m."""
    return [((g - w).abs().max() / w.abs().max().clamp(min=1e-30)).item()
            for g, w in zip(got, want)]


def mlstm_flops(b, h, s, d, chunk) -> float:
    """Operations of the chunkwise function on this run's chunks: per
    chunk of l steps and (b, h), 2 d for each of the l (l + 1) / 2 causal
    (query, key) pairs in S = q k^T and again in (S . D) v; 2 l d^2 for q
    C0 (not on the first chunk, where C0 is zero) and for the state
    update."""
    L = min(chunk, s)
    lens = [min(L, s - t0) for t0 in range(0, s, L)]
    return b * h * (sum(2 * (l * l + l) * d + 4 * l * d * d for l in lens)
                    - 2 * lens[0] * d * d)


def mlstm_controls(ins, chunk, want, want_state):
    """Planted faults fed to the kernel, each held against the plain
    version of the right inputs: the state dropped at the chunk boundary
    nearest S/2 (the second half run on its own), one key dropped (a zero
    k row at the first chunk's last position, so the fault reaches every
    later chunk through the state) and the input gate one step late
    (log_i shifted by one).  Each must fail the h check on every element it
    moves by more than FAULT_MARGIN limits (measured on the plain version
    of the faulty inputs); the state readings are printed."""
    q, k, v, lf, li = ins
    s = q.shape[2]
    cut = (s // 2) // chunk * chunk

    def halves(fn):
        h1 = fn(q[:, :, :cut], k[:, :, :cut], v[:, :, :cut], lf[..., :cut],
                li[..., :cut], chunk=chunk)
        h2, st = fn(q[:, :, cut:], k[:, :, cut:], v[:, :, cut:],
                    lf[..., cut:], li[..., cut:], chunk=chunk,
                    return_state=True)
        return torch.cat([h1, h2], 2), st

    k_drop = k.clone()
    k_drop[:, :, chunk - 1] = 0
    late = torch.cat([li[..., :1], li[..., :-1]], -1)
    faults = {
        f"state dropped at t={cut}": halves,
        f"key at t={chunk - 1} dropped": lambda fn: fn(
            q, k_drop, v, lf, li, chunk=chunk, return_state=True),
        "input gate one step late": lambda fn: fn(
            q, k, v, lf, late, chunk=chunk, return_state=True),
    }
    for name, run in faults.items():
        effect_h = run(ref.mlstm_chunkwise_ref)[0]
        bad_h, bad_state = run(kmlstm.mlstm_chunkwise)
        effect = mlstm_multiples(effect_h, want)
        bad = mlstm_multiples(bad_h, want)
        must = effect > FAULT_MARGIN
        n_must, n_caught = int(must.sum()), int((bad[must] > 1).sum())
        st = state_errors(bad_state, want_state)
        print(f"mlstm control, {name}: moves {n_must} of {must.numel()} h "
              f"elements by > {FAULT_MARGIN} limits; the check fails "
              f"{n_caught} of them; state C, n, m off by "
              f"{[float(f'{x:.3g}') for x in st]} of max |plain| (limit "
              f"{MLSTM_STATE_LIMIT})")
        if n_must == 0 or n_caught < n_must:
            fail(f"mlstm control '{name}' passes the check where it moves "
                 f"the output")
        del effect_h, bad_h, bad_state, effect, bad, must


def check_mlstm(gen, dev):
    """The chunkwise mLSTM kernel against its plain version, h and the
    final (C, n, m): at the prefill's shape (B 4, H 4, S 2048, D 1024,
    chunk 128, bf16), at a ragged S 2000, and at a small head dim (B 2,
    H 4, S 1000, D 64, f32); the planted faults on the first; the first
    timed, with its bound."""
    rows = []
    chunk = MLSTM_CHUNK
    for i, (b, h, s, d, dt) in enumerate(MLSTM_CASES):
        ins = mlstm_inputs(gen, dev, b, h, s, d, dt)
        got, state = kmlstm.mlstm_chunkwise(*ins, chunk=chunk,
                                            return_state=True)
        want, want_state = ref.mlstm_chunkwise_ref(*ins, chunk=chunk,
                                                   return_state=True)
        mult = mlstm_multiples(got, want).max().item()
        err = (got.float() - want.float()).abs().max().item()
        st = state_errors(state, want_state)
        shape = f"B={b} H={h} S={s} D={d} chunk={chunk} {str(dt)[6:]}"
        print(f"mlstm {shape}: h max |err| {err:.4g} (max limit multiple "
              f"{mult:.3g} of {MLSTM_TOL[dt][0]} + "
              f"{MLSTM_TOL[dt][1]:.4g}|plain|); "
              f"state C, n, m off by {[float(f'{x:.3g}') for x in st]} of "
              f"max |plain| (limit {MLSTM_STATE_LIMIT})")
        if not torch.isfinite(got.float()).all() or mult > 1 \
                or max(st) > MLSTM_STATE_LIMIT:
            fail(f"mlstm_chunkwise {shape}: kernel disagrees with its plain "
                 f"version")
        if i == 0:
            mlstm_controls(ins, chunk, want, want_state)
            q = ins[0]
            nbytes = (4 * q.numel() * q.element_size() + 2 * 4 * b * h * s
                      + 4 * b * h * (d * d + d + 1))

            def run(*a):
                return kmlstm.mlstm_chunkwise(*a, chunk=chunk,
                                              return_state=True)

            def plain(*a):
                return ref.mlstm_chunkwise_ref(*a, chunk=chunk,
                                               return_state=True)

            rows.append(entry(
                "mlstm_chunkwise", shape + " with state", err,
                time_ms(run, [ins], 10), time_ms(plain, [ins], 3),
                bound(nbytes, mlstm_flops(b, h, s, d, chunk), dt), None))
        del ins, got, state, want, want_state
        torch.cuda.empty_cache()
    return rows


def xl_launches(cfg, phase: str) -> dict:
    """Launches of one call: an mLSTM layer makes 6 products (w_up, w_q,
    w_k, w_v, w_if, w_down), an sLSTM layer 3 (w_gates, w_ff1, w_ff2);
    prefill runs one chunkwise kernel per mLSTM layer, a decode step none
    (its one-step recurrence is plain tensor ops, as in the reference); the
    head is one rmsnorm_gemm."""
    n_m = cfg.num_groups * cfg.block_pattern.count("mlstm")
    n_s = cfg.num_groups * cfg.block_pattern.count("slstm")
    out = {"sma_gemm": 6 * n_m + 3 * n_s, "rmsnorm_gemm": 1}
    if phase == "prefill":
        out["mlstm_chunkwise"] = n_m
    return out


# Planted faults of check_xlstm_logits, each one wrong launch (the first
# mLSTM layer's prefill): must the logit limit catch it?  With forget
# gates of 0.95-0.998 a state dropped 128 steps before the end is still
# mostly remembered; one dropped 1,024 steps before has decayed to a few
# per cent in the slowest head, so that one is a reading.
XL_FAULTS = {"mlstm: state dropped at the last chunk boundary": True,
             "mlstm: state dropped at S/2": False,
             "mlstm: input gate one step late": True,
             "mlstm: final state one chunk early": True}


@contextlib.contextmanager
def planted_xlstm(fault: str):
    """One wrong launch, made by feeding the kernel wrong inputs: the first
    mLSTM layer's prefill with its state dropped at the last chunk
    boundary or at S/2 (the rest run on its own), with log_i one step
    late, or returning the state of one chunk before the end as its final
    state.  Yields the call count."""
    mlstm = ops.mlstm_chunkwise
    calls = {"mlstm": 0}

    def wrong(q, k, v, lf, li, *, chunk, return_state=False):
        calls["mlstm"] += 1
        if calls["mlstm"] != 1:
            return mlstm(q, k, v, lf, li, chunk=chunk,
                         return_state=return_state)
        s = q.shape[2]
        cut = s // 2 if "S/2" in fault else s - chunk

        def part(lo, hi, state):
            return mlstm(q[:, :, lo:hi], k[:, :, lo:hi], v[:, :, lo:hi],
                         lf[..., lo:hi], li[..., lo:hi], chunk=chunk,
                         return_state=state)

        if "late" in fault:
            li = torch.cat([li[..., :1], li[..., :-1]], -1)
            h, st = mlstm(q, k, v, lf, li, chunk=chunk, return_state=True)
        elif "dropped" in fault:
            h2, st = part(cut, s, True)
            h = torch.cat([part(0, cut, False), h2], 2)
        else:
            h = mlstm(q, k, v, lf, li, chunk=chunk)
            st = part(0, cut, True)[1]
        return (h, st) if return_state else h

    ops.mlstm_chunkwise = wrong
    try:
        yield calls
    finally:
        ops.mlstm_chunkwise = mlstm


def check_xlstm_logits(cfg, dev):
    """check_logits for pattern (mlstm, mlstm, slstm) x 1 group, with
    XL_FAULTS."""
    cfg3 = dataclasses.replace(cfg, block_pattern=("mlstm", "mlstm",
                                                   "slstm"), num_groups=1)
    check_logits(cfg3, dev, XL_PROMPT, xl_launches, XL_FAULTS, planted_xlstm,
                 {"mlstm": 2}, XL_LOGIT_ATOL)


def profile_xlstm(cfg, params, dev):
    """The host time of one sLSTM block over the prompt (its step loop is
    2,048 steps of small launches) against a whole prefill, then
    profile_serving."""
    toks = rg_tokens(cfg, dev, (XL_BATCH, XL_PROMPT), 3)
    p = cfg.block_pattern.index("slstm")
    mixer = lm.unstack(params["blocks"][p]["mixer"], cfg.num_groups)[0]
    x = torch.randn((XL_BATCH, XL_PROMPT, cfg.d_model), device=dev).to(
        cfg.activation_dtype)
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        recurrent.slstm_block_prefill(mixer, x, cfg)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    n_s = cfg.num_groups * cfg.block_pattern.count("slstm")
    t0 = time.perf_counter()
    lm.prefill(params, cfg, {"tokens": toks}, cache_size=XL_PROMPT + 64)
    torch.cuda.synchronize()
    whole = time.perf_counter() - t0
    print(f"xlstm: one sLSTM block over {XL_BATCH} x {XL_PROMPT} tokens "
          f"{1e3 * walls[-1]:.2f} ms host wall; x {n_s} layers = "
          f"{1e3 * n_s * walls[-1]:.1f} ms of a {1e3 * whole:.1f} ms prefill "
          f"({100 * n_s * walls[-1] / whole:.1f}%)")
    del x
    profile_serving(cfg, params, dev, XL_BATCH, XL_PROMPT)


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
        entry_fn = ""
        for line in log.read_text().splitlines() if log.exists() else ():
            if "Compiling entry function" in line:
                # the mangled name, cut before its parameter list
                entry_fn = line.split("'")[1].split("EEv")[0][:72]
            spills = "spill" in line and "0 bytes spill stores" not in line
            if "registers" in line or spills:
                print(f"ptxas {name} {entry_fn}: "
                      f"{line.split(':', 1)[-1].strip()}")

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
    phase("sma_gemm controls", gemm_controls, gen, dev)
    torch.cuda.empty_cache()
    rows += phase("recurrent kernel checks",
                  lambda: check_rglru(gen, dev) + check_flash_mqa(gen, dev)
                  + check_decode_mqa(gen, dev))
    torch.cuda.empty_cache()
    rows += phase("mlstm kernel checks", check_mlstm, gen, dev)
    for row in rows:
        route = f" {row['gemm_route']}" if "gemm_route" in row else ""
        paced = (f" (host-paced {row['paced_ms']:.4f})"
                 if "paced_ms" in row else "")
        print(f"kernel {row['name']}{route} [{row['shape']}]: max|err| "
              f"{row['max_abs_err']:.3g}, {row['ms']:.4f} ms{paced}, plain "
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
        serve_counts, serve_routes = phase("serve", serve, cfg, params, dev)
        phase("decode logits", check_decode_logits, cfg, params, dev)
        phase("decode profile", profile_decode, cfg, params, dev)
        phase("entry overhead", entry_overhead, cfg, params, dev)
    del params
    torch.cuda.empty_cache()

    # The training path.
    phase("train step vs plain", check_train_step, cfg, dev)
    torch.cuda.empty_cache()
    train_counts, train_routes, tparams = phase("trainer", run_trainer, cfg,
                                                dev)
    phase("train profile", profile_train_step, cfg, tparams, dev)
    del tparams
    torch.cuda.empty_cache()

    # The recurrent path, without autograd.
    rg_cfg = get_config(RG_ARCH)
    with torch.inference_mode():
        t0 = time.perf_counter()
        params = lm.init(rg_cfg, seed=0, device=dev)
        torch.cuda.synchronize()
        print(f"init: {RG_ARCH} full width ({rg_cfg.num_layers} layers, "
              f"d_model {rg_cfg.d_model}, vocab "
              f"{lm.padded_vocab(rg_cfg)}) in {time.perf_counter() - t0:.3f}"
              f" s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB on the "
              f"card")
        rg_counts, rg_routes = phase(
            "serve recurrentgemma", serve_recurrent, rg_cfg, params, dev,
            rg_launches, RG_BATCH, RG_PROMPT, RG_NEW)
        phase("recurrent profile", profile_serving, rg_cfg, params, dev,
              RG_BATCH, RG_PROMPT)
        del params
        torch.cuda.empty_cache()
        phase("recurrent logits", check_recurrent_logits, rg_cfg, dev)

    # The xLSTM path, without autograd.
    xl_cfg = get_config(XL_ARCH)
    with torch.inference_mode():
        t0 = time.perf_counter()
        params = lm.init(xl_cfg, seed=0, device=dev)
        torch.cuda.synchronize()
        print(f"init: {XL_ARCH} full width ({xl_cfg.num_layers} layers, "
              f"d_model {xl_cfg.d_model}, vocab "
              f"{lm.padded_vocab(xl_cfg)}) in {time.perf_counter() - t0:.3f}"
              f" s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB on the "
              f"card")
        xl_counts, xl_routes = phase("serve xlstm", serve_recurrent, xl_cfg,
                                     params, dev, xl_launches, XL_BATCH,
                                     XL_PROMPT, XL_NEW)
        phase("xlstm profile", profile_xlstm, xl_cfg, params, dev)
        del params
        torch.cuda.empty_cache()
        phase("xlstm logits", check_xlstm_logits, xl_cfg, dev)
    print(f"phases (s): "
          f"{json.dumps({k: round(x, 1) for k, x in phases.items()})}")

    for row in rows:
        by_path = {"serve": serve_counts[row["name"]],
                   "train": train_counts[row["name"]],
                   "recurrentgemma": rg_counts.get(row["name"], 0),
                   "xlstm": xl_counts.get(row["name"], 0)}
        row["launches"] = sum(by_path.values())
        row["launches_by_path"] = by_path
        if row["launches"] == 0:
            fail(f"kernel {row['name']} was not launched on a main path")
    print(f"sma_gemm routes by path: " + json.dumps(
        {"serve": serve_routes, "train": train_routes,
         "recurrentgemma": rg_routes, "xlstm": xl_routes}))
    print(f"flash routes by path: {json.dumps(FLASH_ROUTES_BY_PATH)}")
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0

if __name__ == "__main__":
    sys.exit(main())
