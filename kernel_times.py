#!/usr/bin/env python3
"""Time ``sma_gemm``, the decode-attention and the flash kernels of one
checkout.

    python3 kernel_times.py [--root DIR]

Imports ``repro_torch`` from ``DIR/src`` (default: this checkout), builds
its kernels there, and times each entry at the main paths' shapes (the
``SERVE_GEMMS`` and ``TRAIN_GEMMS`` of ``chip_smoke.py``, its paged and
contiguous decode shapes, the flash forward and backward at the training
shape and the forward at RecurrentGemma's prefill shape) two ways, over
inputs rotated past the 50 MB L2 where they fit:

* ``device_ms``: the calls queued behind a device-side sleep, so the card
  runs them back to back (the kernel's own time);
* ``paced_ms``: the same calls without the sleep, as a caller that waits
  on nothing sees them (the host's pace where it is the slower).

Beside each flash row, ``sdpa_ms`` is the device time of PyTorch's
``scaled_dot_product_attention`` (and its backward) on the same inputs: a
yardstick, never called by the port.  Prints the card (``nvidia-smi``)
and one JSON line.  To compare two
commits on one card, unpack the other into a directory that
``.gitignore`` lists and run both in one call, in turns (A B B A).
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
    from repro_torch.kernels import sma_gemm as kgemm
    if not torch.cuda.is_available():
        print("kernel_times: needs an NVIDIA card", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    _build.build(["sma_gemm", "decode_attention", "flash_attention"])
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
    print(card)
    print(json.dumps({"root": str(root), "card": card, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
