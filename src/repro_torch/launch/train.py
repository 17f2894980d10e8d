"""Training driver (counterpart of ``repro.launch.train``).

    python -m repro_torch.launch.train --arch stablelm-1.6b --steps 5 \\
        --seq-len 2048 --batch 4

Float32 master weights and AdamW state, compute in the config's activation
dtype (bf16 for the full configs), as in the JAX package; the data are the
JAX package's synthetic token pipeline (copied).  Each step is
``lm.loss_fn`` forward and backward, then an in-place
:func:`repro_torch.optim.adamw.update`.  On the card every projection,
forward and backward, is an ``sma_gemm`` launch, the head an
``rmsnorm_gemm`` and every attention the flash kernels; the step runs
eagerly (the JAX step is built on ``sma_jit``, which has no counterpart
here).  Checkpoint/resume, ``halt_at_step`` and int8 gradient compression
are not ported yet.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Dict, Optional

import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig, get_config, reduced
from repro_torch.data.pipeline import DataConfig, DataPipeline
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.tree import leaves


@dataclasses.dataclass
class TrainLoopConfig:
    steps: int = 100
    seq_len: int = 128
    global_batch: int = 8
    log_every: int = 10
    seed: int = 0
    peak_lr: float = 3e-3
    remat: bool = True


def make_step(cfg: ModelConfig, ocfg: adamw.AdamWConfig, *, remat: bool):
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``;
    parameters and optimizer state are updated in place."""
    def step(params, opt_state, batch):
        loss, metrics = lm.loss_fn(params, cfg, batch, remat=remat)
        grads = torch.autograd.grad(loss, leaves(params))
        params, opt_state, om = adamw.update(list(grads), opt_state, params,
                                             ocfg)
        return params, opt_state, {**metrics, **om}
    return step


def train(cfg: ModelConfig, loop: TrainLoopConfig, *,
          device: DeviceLike = None,
          params: Optional[dict] = None) -> Dict[str, Any]:
    """Train for ``loop.steps`` steps.  Runs on ``cuda`` unless ``device``
    says otherwise.  ``params`` (float32 masters on ``device``, updated in
    place) default to ``lm.init(cfg, seed=loop.seed)`` in
    ``cfg.parameter_dtype``.  Returns ``{"history", "params"}``; history
    has one entry per logged step with the metrics, ``step`` and
    ``wall_s`` (host seconds since the first step began, taken after the
    metrics reach the host)."""
    dev = resolve_device(device)
    if params is None:
        params = lm.init(cfg, seed=loop.seed, device=dev,
                         dtype=cfg.parameter_dtype)
    for p in leaves(params):
        p.requires_grad_(True)
    opt_state = adamw.init(params)
    pipe = DataPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                   seq_len=loop.seq_len,
                                   global_batch=loop.global_batch,
                                   seed=loop.seed), device=dev)
    ocfg = adamw.AdamWConfig(peak_lr=loop.peak_lr,
                             warmup_steps=max(loop.steps // 10, 1),
                             total_steps=loop.steps)
    step_fn = make_step(cfg, ocfg, remat=loop.remat)

    history = []
    t0 = time.perf_counter()
    for i in range(loop.steps):
        params, opt_state, metrics = step_fn(params, opt_state, next(pipe))
        if (i + 1) % loop.log_every == 0 or i == loop.steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = i + 1
            m["wall_s"] = time.perf_counter() - t0
            history.append(m)
            print(f"[train] step {i + 1:5d} loss={m['loss']:.4f} "
                  f"acc={m['accuracy']:.3f} gnorm={m['grad_norm']:.2f}",
                  flush=True)
    return {"history": history, "params": params}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--device", default=None,
                    help="default cuda; 'cpu' runs the plain versions")
    args = ap.parse_args()

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    loop = TrainLoopConfig(steps=args.steps, seq_len=args.seq_len,
                           global_batch=args.batch, peak_lr=args.lr)
    train(cfg, loop, device=args.device)


if __name__ == "__main__":
    main()
