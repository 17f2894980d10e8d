#!/usr/bin/env python3
"""Host time of one compiled serving decode tick, for one checkout.

    python3 host_times.py [--root DIR] [--rounds N] [--steps N]

Imports ``repro_torch`` from ``DIR/src`` (default: this checkout), builds
its kernels there, makes full-width StableLM-2-1.6B (random bf16 weights
from seed 0), prefills 8 rows of a ragged 64-token chunk, and times the
``ServeEngine``'s compiled decode step (``engines["decode"]``, one
``sma_jit`` signature for 8 rows, compiled before timing): the host wall
of ``steps`` ticks until the last returns, the card idle before and
drained after, ``rounds`` times.  Prints the card (``nvidia-smi``) and
one JSON line with each reading (ms a tick) and their median.

Only the entry points both trees have are called, so an older checkout is
timed the same way.  To compare two commits on one card, unpack the other
into a directory that ``.gitignore`` lists and run both in one call in
turns (A B B A); ``chip_smoke.py --parent DIR`` does that.  Needs a card;
imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent))
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root / "src"))
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import lm
    from repro_torch.serving import CacheConfig, SchedulerConfig, ServeEngine
    from repro_torch.serving import model as smodel
    if not torch.cuda.is_available():
        print("host_times: needs an NVIDIA card", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    _build.build(["sma_gemm", "norm_gemm", "decode_attention"])
    dev = torch.device("cuda", 0)
    cfg = get_config("stablelm-1.6b")
    cache = CacheConfig(block_size=16, num_blocks=512, max_seq_len=1024)
    b, c = 8, 64
    with torch.inference_mode():
        params = lm.init(cfg, seed=0, device=dev)
        eng = ServeEngine(cfg, params, cache=cache, max_batch=b,
                          sched=SchedulerConfig(prefill_chunk=c), device=dev)
        state = eng.state          # zeroed pools, in every checkout
        mb = cache.max_blocks_per_req
        table = torch.arange(b * mb, dtype=torch.int32,
                             device=dev).reshape(b, mb) % cache.num_blocks
        gen = torch.Generator(device=dev).manual_seed(1)
        toks = torch.randint(0, cfg.vocab_size, (b, c), generator=gen,
                             device=dev, dtype=torch.int32)
        n_tok = torch.tensor([64, 1, 17, 33, 64, 50, 8, 40],
                             dtype=torch.int32, device=dev)
        zero = torch.zeros(b, dtype=torch.int32, device=dev)
        logits, _, cl = smodel.paged_prefill_step(params, state, table, zero,
                                                  n_tok, cfg,
                                                  {"tokens": toks})
        cl = cl.to(torch.int32)
        batch = {"tokens": logits.argmax(-1, keepdim=True).to(torch.int32)}
        decode = eng.engines["decode"]
        t0 = time.perf_counter()
        decode(params, state, table, cl, batch)          # compiles
        compile_s = time.perf_counter() - t0
        for _ in range(3):
            decode(params, state, table, cl, batch)
        readings = []
        for _ in range(args.rounds):
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(args.steps):
                decode(params, state, table, cl, batch)
            wall = time.perf_counter() - t
            torch.cuda.synchronize()
            readings.append(1e3 * wall / args.steps)
    print(f"card: {card}")
    print(json.dumps({"root": str(root), "card": card,
                      "torch": torch.__version__,
                      "compile_s": compile_s, "steps": args.steps,
                      "host_ms": readings,
                      "median_ms": float(np.median(readings))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
