"""GPipe-style pipeline parallelism over a mesh axis (counterpart of
``repro.distributed.pipeline``).

Stages hold contiguous layer groups; microbatches stream through them
tick by tick, and the stage-to-stage hand-off of a tick is one
send/receive to the next stage (``repro_torch::sendrecv``, the
reference's ``ppermute``).  GPipe with M microbatches over P stages
takes M + P - 1 ticks; the bubble fraction is (P - 1) / (M + P - 1).
:func:`pipeline_apply` is forward-generic: it pipelines any per-stage
function of one microbatch.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.distributed import collectives
from repro_torch.tree import tree_map

__all__ = ["bubble_fraction", "pipeline_apply"]


def pipeline_apply(stage_fn: Callable, mesh, axis: str, stage_params: Any,
                   x_micro: torch.Tensor) -> torch.Tensor:
    """Run microbatches through the pipeline stages laid out along
    ``axis``.

    ``stage_fn(params_slice, x) -> y``: one stage's compute, shape kept.
    ``stage_params``: a tree whose leaves have a leading stage axis of
    ``mesh.shape[axis]``; stage s runs on its slice.  ``x_micro``: (M,
    micro_batch, ...), the same on every rank (stage 0 feeds it in order).
    Returns the last stage's (M, micro_batch, ...) outputs on every
    rank."""
    n_stages = mesh.shape[axis]
    n_micro = x_micro.shape[0]
    stage = mesh.coords[axis]
    key = mesh.group_key(axis)
    params = tree_map(lambda p: p[stage], stage_params)
    dst = stage + 1 if stage + 1 < n_stages else -1
    src = stage - 1 if stage > 0 else -1
    buf = torch.zeros_like(x_micro[0])
    outs = torch.zeros_like(x_micro)
    for t in range(n_micro + n_stages - 1):
        if stage == 0:
            x_in = x_micro[t] if t < n_micro else torch.zeros_like(buf)
        else:
            x_in = buf
        y = stage_fn(params, x_in)
        buf = collectives.sendrecv(y, key, dst, src, span="comm.pipeline")
        emit = t - (n_stages - 1)
        if stage == n_stages - 1 and emit >= 0:
            outs[emit] = y
    return collectives.broadcast(outs, key, n_stages - 1,
                                 span="comm.pipeline_out")


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)
