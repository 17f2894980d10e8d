#!/usr/bin/env python3
"""Time ``sma_gemm``, the decode-attention, the flash, the ``rmsnorm_gemm``,
the ``mlstm_chunkwise`` and the ``rglru_scan`` kernels of one checkout.

    python3 kernel_times.py [--root DIR]

Imports ``repro_torch`` from ``DIR/src`` (default: this checkout), builds
its kernels there, and times each entry at the main paths' shapes (the
``SERVE_GEMMS`` and ``TRAIN_GEMMS`` of ``chip_smoke.py``, its paged and
contiguous decode shapes, the flash forward and backward at the training
shape and the forward at RecurrentGemma's prefill shape, the head's
``rmsnorm_gemm`` at decode (M 8) and training (M 8192) sizes, the chunkwise
mLSTM at xLSTM's prefill shape with its state, the RG-LRU scan at
RecurrentGemma's prefill shape with and without h0) two ways, over inputs
rotated past the 50 MB L2 where they fit:

* ``device_ms``: the calls queued behind a device-side sleep, so the card
  runs them back to back (the kernel's own time);
* ``paced_ms``: the same calls without the sleep, as a caller that waits
  on nothing sees them (the host's pace where it is the slower).

Last, the public entries ``ops.flash_attention`` and ``ops.sma_gemm`` at
shapes small enough that their ``paced_ms`` is the host's cost of one
entry call: the median of ENTRY_READINGS readings of 200 calls each, all
kept as ``paced_readings``.

Beside each flash row, ``sdpa_ms`` is the device time of PyTorch's
``scaled_dot_product_attention`` (and its backward) on the same inputs, and
beside each head ``matmul_ms`` is ``torch.matmul`` of the pre-normalized x
by the head (the GEMM alone), and beside the scan ``add_ms`` is
``torch.add(a, u)``, one elementwise pass over the same bytes (no PyTorch
call computes the recurrence): yardsticks, never called by the port.
Only the public wrappers are called, so an older checkout's kernels are
timed the same way.  Prints the card (``nvidia-smi``) and one JSON line.
To compare two commits on one card, unpack the other into a directory
that ``.gitignore`` lists and run both in one call, in turns (A B B A).
Needs a card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path

GEMMS = ([(m, k, n) for m in (1, 8, 1024, 2048)
          for k, n in ((2048, 2048), (2048, 5632), (5632, 2048))]
         + [(8192, 2048, 2048), (8192, 2048, 5632), (8192, 5632, 2048),
            (2048, 8192, 5632), (5632, 8192, 2048), (2048, 8192, 100352),
            (8192, 100352, 2048)])
KV_LENS = (0, 1, 17, 100, 256, 511, 777, 1024)
COLD_BYTES = 160 << 20
QUEUE_CYCLES = 35_000_000
ENTRY_READINGS = 9


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent))
    root = Path(ap.parse_args().root).resolve()
    sys.path.insert(0, str(root / "src"))
    import numpy as np
    import torch
    from repro_torch.kernels import _build
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as kdecode
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import mlstm as kmlstm
    from repro_torch.kernels import norm_gemm as knorm
    from repro_torch.kernels import ref
    from repro_torch.kernels import rglru as krglru
    from repro_torch.kernels import sma_gemm as kgemm
    if not torch.cuda.is_available():
        print("kernel_times: needs an NVIDIA card", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    _build.build(["sma_gemm", "decode_attention", "flash_attention",
                  "norm_gemm", "mlstm_chunkwise", "rglru_scan"])
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def timed(fn, args_list, iters, queued):
        for args in args_list[:3]:
            fn(*args)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(QUEUE_CYCLES)
        start.record()
        for i in range(iters):
            fn(*args_list[i % len(args_list)])
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    rows = []

    def row(name, shape, fn, args_list, iters=20, **extra):
        rows.append({"name": name, "shape": shape,
                     "device_ms": timed(fn, args_list, iters, True),
                     "paced_ms": timed(fn, args_list, iters, False),
                     **extra})

    dt = torch.bfloat16
    for m, k, n in GEMMS:
        a = torch.randn((m, k), generator=gen, device=dev).to(dt)
        ws = [(torch.randn((k, n), generator=gen, device=dev)
               * k ** -0.5).to(dt)
              for _ in range(max(1, min(16, math.ceil(
                  COLD_BYTES / (2 * k * n)))))]
        row("sma_gemm", f"M={m} K={k} N={n}", kgemm.sma_gemm,
            [(a, w) for w in ws], 5 if 2 * m * n * k > 1e11 else 20)
        del a, ws

    b, h, d, bs, nb, smax = 8, 32, 64, 16, 512, 1024
    mb = smax // bs
    perm = np.random.default_rng(0).permutation(nb)
    table = np.full((b, mb), nb, np.int32)
    used = 0
    for r, n in enumerate(KV_LENS):
        pages = max(1, -(-n // bs))
        table[r, :pages] = perm[used:used + pages]
        used += pages
    table = torch.from_numpy(table).to(dev)
    lens = torch.tensor(KV_LENS, dtype=torch.int32, device=dev)
    q = torch.randn((b, h, d), generator=gen, device=dev).to(dt)
    pools = [tuple(torch.randn((nb, h, bs, d), generator=gen,
                               device=dev).to(dt) for _ in range(2))
             for _ in range(2)]
    row("paged_decode_attention",
        f"B={b} Hq=Hkv={h} D={d} BS={bs} kv_len={list(KV_LENS)}",
        kdecode.paged_decode_attention,
        [(q, kp, vp, table, lens) for kp, vp in pools])
    caches = [tuple(torch.randn((b, h, smax, d), generator=gen,
                                device=dev).to(dt) for _ in range(2))
              for _ in range(2)]
    row("decode_attention", f"B={b} Hq=Hkv={h} D={d} Smax={smax} "
        f"kv_len={list(KV_LENS)}", kdecode.decode_attention,
        [(q, kc, vc, lens) for kc, vc in caches])
    del pools, caches
    hq, d, smax = 10, 256, 2048
    q = torch.randn((b, hq, d), generator=gen, device=dev).to(dt)
    full = torch.full((b,), smax, dtype=torch.int32, device=dev)
    caches = [tuple(torch.randn((b, 1, smax, d), generator=gen,
                                device=dev).to(dt) for _ in range(2))
              for _ in range(8)]
    row("decode_attention", f"B={b} Hq={hq} Hkv=1 D={d} Smax={smax} full",
        kdecode.decode_attention, [(q, kc, vc, full) for kc, vc in caches])
    del caches

    # Flash: B 4, H 32, S 2048, D 64, causal (training), forward and
    # backward; B 4, Hq 10, Hkv 1, S 4096, D 256, window 2048 (RecurrentGemma
    # prefill), forward.
    def qkv(b_, hq_, hkv_, s_, d_):
        return [tuple(torch.randn((b_, h_, s_, d_), generator=gen,
                                  device=dev).to(dt)
                      for h_ in (hq_, hkv_, hkv_, hq_)) for _ in range(2)]

    sets = qkv(4, 32, 32, 2048, 64)
    fwd_args = [x[:3] for x in sets]
    outs = [kflash.flash_attention_fwd(*a) for a in fwd_args]
    bwd_args = [(*a[:3], o, l, a[3]) for a, (o, l) in zip(sets, outs)]
    lib_sets = []
    for q_, k_, v_, do_ in sets:
        leaves = [t.detach().clone().requires_grad_() for t in (q_, k_, v_)]
        lib_sets.append((F.scaled_dot_product_attention(
            *leaves, is_causal=True), leaves, do_))
    shape = "B=4 H=32 S=2048 D=64 causal"
    row("flash_attention", shape, kflash.flash_attention_fwd, fwd_args,
        sdpa_ms=timed(lambda *a: F.scaled_dot_product_attention(
            *a, is_causal=True), fwd_args, 20, True))
    row("flash_attention_bwd", shape, kflash.flash_attention_bwd, bwd_args,
        sdpa_ms=timed(lambda o, lv, do_: torch.autograd.grad(
            o, lv, do_, retain_graph=True), lib_sets, 20, True))
    del sets, fwd_args, outs, bwd_args, lib_sets
    b, hq, s, win = 4, 10, 4096, 2048
    args = [x[:3] for x in qkv(b, hq, 1, s, 256)]
    mask = torch.ones((s, s), dtype=torch.bool, device=dev).tril()
    mask &= ~torch.ones_like(mask).tril(-win)

    def sdpa_mqa(q_, k_, v_):
        return F.scaled_dot_product_attention(
            q_, k_.expand(-1, hq, -1, -1), v_.expand(-1, hq, -1, -1),
            attn_mask=mask)

    row("flash_attention", f"B={b} Hq={hq} Hkv=1 S={s} D=256 window={win}",
        lambda *a: kflash.flash_attention_fwd(*a, window=win), args, 10,
        sdpa_ms=timed(sdpa_mqa, args, 5, True))
    del args

    # The head: final_norm -> head, 2048 -> 100352 (StableLM's padded
    # vocab), at a decode tick (M 8) and the training step (M 8192).
    k, n = 2048, 100352
    w = (torch.randn((k, n), generator=gen, device=dev) * k ** -0.5).to(dt)
    scale = torch.rand((k,), generator=gen, device=dev) + 0.5
    for m in (8, 8192):
        x = (torch.randn((m, k), generator=gen, device=dev) * 3).to(dt)
        normed = (x.float() * ref.rms_inverse(x) * scale).to(dt)
        iters = 20 if m <= 16 else 3
        row("rmsnorm_gemm", f"M={m} K={k} N={n}", knorm.rmsnorm_gemm,
            [(x, scale, w)], iters,
            matmul_ms=timed(torch.matmul, [(normed, w)], iters, True))
        del x, normed
    del w

    # The chunkwise mLSTM at xlstm-1.3b's prefill shape, with its state.
    b, h, s, d = 4, 4, 2048, 1024
    q, k_, v = (torch.randn((b, h, s, d), generator=gen, device=dev).to(dt)
                for _ in range(3))
    lf = F.logsigmoid(0.5 * torch.randn((b, h, s), generator=gen,
                                        device=dev)
                      + torch.linspace(3.0, 6.0, h, device=dev)[None, :,
                                                                 None])
    li = 0.5 * torch.randn((b, h, s), generator=gen, device=dev)
    row("mlstm_chunkwise", f"B={b} H={h} S={s} D={d} chunk=128 with state",
        lambda *a: kmlstm.mlstm_chunkwise(*a, chunk=128, return_state=True),
        [(q, k_, v, lf, li)], 10)
    del q, k_, v, lf, li

    # The RG-LRU scan at recurrentgemma-2b's prefill shape (lru width 2560),
    # without h0 (the prefill's call) and with one; a and u of 84 MB each
    # exceed the L2.
    b, s, d = 4, 4096, 2560
    a = torch.sigmoid(torch.randn((b, s, d), generator=gen,
                                  device=dev)).to(dt)
    u = (torch.randn((b, s, d), generator=gen, device=dev) * 0.1).to(dt)
    h0 = torch.randn((b, d), generator=gen, device=dev).to(dt)
    row("rglru_scan", f"B={b} S={s} D={d}", krglru.rglru_scan, [(a, u)],
        add_ms=timed(torch.add, [(a, u)], 20, True))
    row("rglru_scan", f"B={b} S={s} D={d} h0", krglru.rglru_scan,
        [(a, u, h0)])
    # The public entries (kernels.ops) at shapes where the host sets the
    # pace: paced_ms is the host's cost of one entry call, launch included.
    from repro_torch.kernels import ops
    tiny = torch.randn((1, 1, 128, 64), generator=gen, device=dev).to(dt)
    w = torch.randn((64, 64), generator=gen, device=dev).to(dt)
    with torch.no_grad():
        for name, shape, fn, args in (
                ("ops.flash_attention",
                 "B=1 H=1 S=128 D=64 causal, host-bound",
                 ops.flash_attention, (tiny, tiny, tiny)),
                ("ops.sma_gemm", "M=1 K=64 N=64, host-bound", ops.sma_gemm,
                 (tiny[0, 0, :1], w))):
            paced = [timed(fn, [args], 200, False)
                     for _ in range(ENTRY_READINGS)]
            rows.append({"name": name, "shape": shape,
                         "device_ms": timed(fn, [args], 200, True),
                         "paced_ms": float(np.median(paced)),
                         "paced_readings": paced})
    # The launches of each route over the whole run, where the checkout
    # counts them.
    routes = {fn.__name__: dict(fn.routes)
              for fn in (kgemm.sma_gemm, knorm.rmsnorm_gemm,
                         kmlstm.mlstm_chunkwise, krglru.rglru_scan)
              if hasattr(fn, "routes")}
    print(card)
    print(json.dumps({"root": str(root), "card": card, "routes": routes,
                      "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
