#!/usr/bin/env python3
"""Build and drive the PyTorch/CUDA port on one NVIDIA card, and check it.

    python3 chip_smoke.py

1. Prints the card's name and power limit (``nvidia-smi``).  Without a card
   it exits non-zero and prints no result.
2. Builds every kernel of the serving path from
   ``src/repro_torch/kernels/csrc/`` with ``nvcc`` for ``sm_90a`` into
   ``build/kernels/`` (one ``nvcc`` per source, all at once).
3. Holds each kernel entry against its plain PyTorch version in bf16 at the
   serving path's own shapes, and times kernel, plain version, the one
   PyTorch call that computes the same function where there is one
   (``library_ms``, a yardstick the port never calls), and the bound.
4. Serves full-width StableLM-2-1.6B (random weights from a seed) through
   ``repro_torch.serving.ServeEngine``: 8 requests with prompts of 64-512
   tokens and 32 new tokens each, greedy.  Checks that every request
   finishes with 32 tokens, that every kernel of the path was launched in
   that run, and that one decode step's logits through the kernels agree
   with the same step through the plain versions.
5. Prints the kernel table as one JSON line, then the result line
   ``{"ok": true, "device": {...}}`` last.

Imports nothing of JAX or of the JAX package.  Any failed check raises and
the script exits non-zero before the result line.
"""
from __future__ import annotations

import contextlib
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
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import decode_attention as kdecode  # noqa: E402
from repro_torch.kernels import norm_gemm as knorm  # noqa: E402
from repro_torch.kernels import sma_gemm as kgemm  # noqa: E402
from repro_torch.models import lm  # noqa: E402
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
def check_sma_gemm(gen, dev):
    out = []
    dt = torch.bfloat16
    for m in (1, 8, 1024, 2048):
        for k, n, ep in ((2048, 2048, "none"), (2048, 5632, "none"),
                         (2048, 5632, "silu"), (5632, 2048, "none")):
            a = torch.randn((m, k), generator=gen, device=dev).to(dt)
            ws = [(torch.randn((k, n), generator=gen, device=dev)
                   * k ** -0.5).to(dt)
                  for _ in range(copies(k * n * 2))]
            got = kgemm.sma_gemm(a, ws[0], epilogue=ep)
            err = compare(got, ref.gemm_ref(a, ws[0], epilogue=ep),
                          f"sma_gemm M={m} {k}->{n} {ep}")
            args = [(a, w) for w in ws]
            ms = time_ms(lambda a_, w_: kgemm.sma_gemm(a_, w_, epilogue=ep),
                         args)
            plain_ms = time_ms(
                lambda a_, w_: ref.gemm_ref(a_, w_, epilogue=ep), args)
            lib_ms = (time_ms(torch.matmul, args) if ep == "none" else None)
            b = bound(2 * (m * k + k * n + m * n), 2 * m * n * k, dt)
            out.append(entry("sma_gemm", f"M={m} K={k} N={n} {ep} bf16",
                             err, ms, plain_ms, b, lib_ms))
    return out


def check_rmsnorm_gemm(gen, dev):
    out = []
    dt = torch.bfloat16
    k, n = 2048, lm.padded_vocab(get_config(ARCH))
    w = (torch.randn((k, n), generator=gen, device=dev) * k ** -0.5).to(dt)
    scale = torch.rand((k,), generator=gen, device=dev) + 0.5
    for m in (1, 8):
        x = (torch.randn((m, k), generator=gen, device=dev) * 3).to(dt)
        got = knorm.rmsnorm_gemm(x, scale, w)
        err = compare(got, ref.rmsnorm_gemm_ref(x, scale, w),
                      f"rmsnorm_gemm M={m} {k}->{n}")
        args = [(x, scale, w)]
        ms = time_ms(knorm.rmsnorm_gemm, args)
        plain_ms = time_ms(ref.rmsnorm_gemm_ref, args)
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
    """Swap the entry points the models call for the plain versions, to run
    the same step without the kernels."""
    saved = {n: getattr(ops, n) for n in
             ("sma_gemm", "rmsnorm_gemm", "paged_decode_attention")}

    def paged(q, k_pool, v_pool, table, q_pos, kv_len, *, window=None,
              scale=None):
        if q.shape[1] != 1 or window is not None:
            return saved["paged_decode_attention"](
                q, k_pool, v_pool, table, q_pos, kv_len, window=window,
                scale=scale)
        return ref.paged_decode_attention_ref(
            q[:, 0], k_pool, v_pool, table, kv_len, scale=scale)[:, None]

    ops.sma_gemm, ops.rmsnorm_gemm = ref.gemm_ref, ref.rmsnorm_gemm_ref
    ops.paged_decode_attention = paged
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(ops, n, fn)


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
    rows = []   # kernels only: host ops also carry their kernels' time
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if dev_us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((dev_us, ev.count, ev.key))
    busy = sum(r[0] for r in rows) / 1e6
    if not rows:
        print("profile: no device time in the trace (not measured)")
        return
    print(f"profile: {steps} decode steps (B=8) in {1e3 * wall:.2f} ms "
          f"host wall, device busy {1e3 * busy:.2f} ms "
          f"({100 * busy / wall:.1f}% of the window, idle "
          f"{100 * (1 - busy / wall):.1f}%)")
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

    gen = torch.Generator(device=dev).manual_seed(0)
    rows = check_sma_gemm(gen, dev) + check_rmsnorm_gemm(gen, dev) \
        + check_decode(gen, dev)
    for row in rows:
        print(f"kernel {row['name']} [{row['shape']}]: max|err| "
              f"{row['max_abs_err']:.3g}, {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms, library {row['library_ms']}, "
              f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})")

    cfg = get_config(ARCH)
    t0 = time.perf_counter()
    params = lm.init(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    print(f"init: {ARCH} full width ({cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, vocab {lm.padded_vocab(cfg)}) in "
          f"{time.perf_counter() - t0:.3f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    counts = serve(cfg, params, dev)
    check_decode_logits(cfg, params, dev)
    profile_decode(cfg, params, dev)

    for row in rows:
        row["launches"] = counts[row["name"]]
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
