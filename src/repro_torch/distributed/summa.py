"""SUMMA sharded GEMM with comm/compute overlap (counterpart of
``repro.distributed.summa``).

At mesh scale the paper's lever, keeping the systolic array busy, becomes
hiding collective traffic behind the products: a schedule that
broadcasts panel ``t + 1`` while panel ``t`` multiplies pays for
communication once, at step 0.

Algorithm (textbook SUMMA on a ``(pr, pc)`` process grid):

* ``A`` is block-distributed ``(M/pr, K/pc)``, ``B`` ``(K/pr, N/pc)``,
  ``C`` ``(M/pr, N/pc)``; A and B are padded to the grid first (edge
  tiles in M, N and K).
* The contraction runs over ``S = lcm(pr, pc)`` K-panels.  At step ``t``
  the column that owns A-panel ``t`` broadcasts it along its row, the row
  that owns B-panel ``t`` broadcasts it along its column, and every rank
  adds ``A_panel @ B_panel`` (the local
  :func:`repro_torch.kernels.ops.sma_gemm` with ``mesh=False``, in the
  operands' dtype: on the card a kernel launch a step) into an f32
  accumulator; bias and the epilogue come after the last step.
* **Overlap** (``overlap=True``): step ``t + 1``'s broadcasts are issued
  (``async_op``) before step ``t``'s product and waited for after it.
  ``overlap=False`` waits for each step's product before issuing the next
  broadcasts.  The two give the same bits (same panels, same order).
* The ``C`` blocks are all-gathered at the end (a ``comm.gather_c`` span,
  outside :func:`summa_comm_stats`, whose numbers are the reference's),
  so every rank returns the whole ``epilogue(A @ B + bias)``, as the
  reference's global array is.

:func:`summa_comm_stats` is the shared cost model: the lowering's per-op
``comm_bytes`` (:mod:`repro_torch.compiler.lower`), the plan report's
``comm`` section and the schedule above are priced by it.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.sma import EPILOGUES
from repro_torch.distributed import collectives
from repro_torch.obs import trace as _obs_trace

__all__ = ["comm_coster_for", "sma_gemm_sharded", "summa_comm_stats",
           "summa_grid", "summa_schedule"]


# --------------------------------------------------------------------------
# Grid derivation + the shared comm cost model
# --------------------------------------------------------------------------
def summa_grid(mesh, axes: Optional[Sequence[str]] = None
               ) -> Tuple[Optional[str], Optional[str], int, int]:
    """``(row_axis, col_axis, pr, pc)`` for a SUMMA launch on ``mesh``.

    ``axes`` names (row, col) mesh axes; default is the mesh's first two
    axis names.  The row axis shards M (and B's K); the col axis shards N
    (and A's K).  A missing axis contributes extent 1."""
    names = tuple(mesh.axis_names)
    if axes is None:
        axes = names[:2]
    axes = tuple(axes)[:2]
    sizes = dict(mesh.shape)
    row = axes[0] if len(axes) >= 1 and axes[0] in names else None
    col = axes[1] if len(axes) >= 2 and axes[1] in names else None
    pr = sizes.get(row, 1) if row else 1
    pc = sizes.get(col, 1) if col else 1
    return row, col, pr, pc


def _ceil_to(x: int, q: int) -> int:
    return -(-x // q) * q


def summa_schedule(m: int, n: int, k: int, *, pr: int, pc: int,
                   itemsize_a: int = 4, itemsize_b: int = 4
                   ) -> Dict[str, Any]:
    """The step schedule one ``sma_gemm_sharded`` call runs, with per-step
    collective bytes.  Bytes count traffic: a panel broadcast along an
    axis of extent ``p`` delivers one copy to each of the ``p - 1``
    non-owners, in every row/column of the grid."""
    steps = math.lcm(pr, pc)
    mb = _ceil_to(m, pr) // pr
    nb = _ceil_to(n, pc) // pc
    kp = _ceil_to(k, steps) // steps
    per_step = []
    for t in range(steps):
        a_bytes = mb * kp * itemsize_a * (pc - 1) * pr if pc > 1 else 0
        b_bytes = kp * nb * itemsize_b * (pr - 1) * pc if pr > 1 else 0
        per_step.append({"step": t, "bcast_a_bytes": a_bytes,
                         "bcast_b_bytes": b_bytes})
    return {"grid": [pr, pc], "steps": steps,
            "block": [mb, nb, kp], "per_step": per_step}


def summa_comm_stats(m: int, n: int, k: int, *, pr: int, pc: int,
                     itemsize_a: int = 4, itemsize_b: int = 4,
                     overlap: bool = True,
                     row_axis: Optional[str] = None,
                     col_axis: Optional[str] = None) -> Dict[str, Any]:
    """Collective traffic one sharded GEMM moves, and how much of it the
    double-buffered schedule hides: steps ``1..S-1``'s broadcasts are
    issued while steps ``0..S-2`` compute, so ``(S-1)/S`` of the traffic is
    predicted hidden; ``overlap=False`` hides nothing."""
    sched = summa_schedule(m, n, k, pr=pr, pc=pc,
                           itemsize_a=itemsize_a, itemsize_b=itemsize_b)
    steps = sched["steps"]
    bytes_a = sum(s["bcast_a_bytes"] for s in sched["per_step"])
    bytes_b = sum(s["bcast_b_bytes"] for s in sched["per_step"])
    total = bytes_a + bytes_b
    hidden = total * (steps - 1) / steps if (overlap and steps > 1) else 0.0
    collectives_: Dict[str, int] = {}
    if pc > 1:
        collectives_[col_axis or "col"] = steps     # A-panel broadcasts
    if pr > 1:
        collectives_[row_axis or "row"] = steps     # B-panel broadcasts
    return {
        "grid": sched["grid"],
        "steps": steps,
        "bytes_a": bytes_a,
        "bytes_b": bytes_b,
        "bytes_total": total,
        "hidden_bytes": hidden,
        "predicted_overlap_fraction": (hidden / total) if total else 0.0,
        "collectives_per_axis": collectives_,
    }


def comm_coster_for(mesh, axes: Optional[Sequence[str]] = None):
    """``coster(m, n, k, itemsize_a, itemsize_b) -> bytes`` for one GEMM
    site on ``mesh``'s grid (the lowering's hook), or None on one rank."""
    row, col, pr, pc = summa_grid(mesh, axes)
    if pr * pc <= 1:
        return None

    def coster(m: int, n: int, k: int, itemsize_a: int,
               itemsize_b: int) -> float:
        return float(summa_comm_stats(
            m, n, k, pr=pr, pc=pc, itemsize_a=itemsize_a,
            itemsize_b=itemsize_b)["bytes_total"])

    return coster


# --------------------------------------------------------------------------
# The sharded GEMM
# --------------------------------------------------------------------------
def _fetch(block: torch.Tensor, t: int, panels_local: int, kp: int,
           key: Optional[str], k_dim: int, tag: str, skip: bool = False):
    """Issue the broadcast of global K-panel ``t`` of a block-distributed
    operand along ``key``'s axis (``k_dim``: the block's K dimension).
    Returns a handle whose ``wait()`` gives the panel.  ``skip`` is a
    planted fault: no broadcast, so the ranks that do not own the panel
    multiply zeros."""
    owner, off = divmod(t, panels_local)
    panel = block.narrow(k_dim, off * kp, kp).contiguous()
    if key is None:
        return _Ready(panel)
    if skip:
        mine = collectives.index_of(key) == owner
        return _Ready(panel if mine else torch.zeros_like(panel))
    return collectives.broadcast_async(panel, key, owner,
                                       span=f"comm.bcast_{tag}", step=t)


class _Ready:
    def __init__(self, value: torch.Tensor) -> None:
        self.value = value

    def wait(self) -> torch.Tensor:
        return self.value


def sma_gemm_sharded(a: torch.Tensor, b: torch.Tensor, *, mesh,
                     axes: Optional[Sequence[str]] = None,
                     bias: Optional[torch.Tensor] = None,
                     epilogue: str = "none",
                     overlap: bool = True) -> torch.Tensor:
    """Multi-rank SUMMA GEMM: ``epilogue(A @ B + bias)`` on ``mesh``,
    comm/compute-overlapped by default (module docstring).  The same
    ``(..., K) @ (K, N)`` contract as :func:`repro_torch.kernels.ops.
    sma_gemm`, in A's dtype; every rank passes the whole A and B and gets
    the whole result."""
    return _summa(a, b, mesh=mesh, axes=axes, bias=bias, epilogue=epilogue,
                  overlap=overlap)


def _summa(a, b, *, mesh, axes, bias, epilogue, overlap,
           skip_a_step: Optional[int] = None) -> torch.Tensor:
    """:func:`sma_gemm_sharded`; ``skip_a_step`` plants a fault (that
    step's A-panel is not broadcast)."""
    if b.dim() != 2:
        raise ValueError(f"sma_gemm_sharded needs a 2-D stationary operand, "
                         f"got B of shape {tuple(b.shape)}")
    if a.shape[-1] != b.shape[0]:
        raise ValueError(f"contraction mismatch: A {tuple(a.shape)} @ B "
                         f"{tuple(b.shape)}")
    from repro_torch.kernels import ops
    lead = tuple(a.shape[:-1])
    m = math.prod(lead) if lead else 1
    k, n = int(b.shape[0]), int(b.shape[1])
    a2 = a.reshape(m, k)
    row, col, pr, pc = summa_grid(mesh, axes)
    if pr * pc <= 1:
        out = ops.sma_gemm(a2, b, bias=bias, epilogue=epilogue, mesh=False)
        return out.reshape(*lead, n)

    steps = math.lcm(pr, pc)
    mp, np_, kp_tot = _ceil_to(m, pr), _ceil_to(n, pc), _ceil_to(k, steps)
    kp = kp_tot // steps
    mb, nb = mp // pr, np_ // pc
    ri = mesh.coords[row] if row else 0
    ci = mesh.coords[col] if col else 0
    a_pad = F.pad(a2, (0, kp_tot - k, 0, mp - m))
    b_pad = F.pad(b, (0, np_ - n, 0, kp_tot - k))
    bias_pad = (F.pad(bias, (0, np_ - n)) if bias is not None
                else torch.zeros(np_, dtype=a.dtype, device=a.device))
    ka, kb = kp_tot // pc, kp_tot // pr
    a_loc = a_pad[ri * mb:(ri + 1) * mb, ci * ka:(ci + 1) * ka]
    b_loc = b_pad[ri * kb:(ri + 1) * kb, ci * nb:(ci + 1) * nb]
    bias_loc = bias_pad[ci * nb:(ci + 1) * nb]
    key_a = mesh.group_key(col) if pc > 1 else None
    key_b = mesh.group_key(row) if pr > 1 else None

    def fetch(t):
        return (_fetch(a_loc, t, steps // pc, kp, key_a, 1, "a",
                       skip=t == skip_a_step),
                _fetch(b_loc, t, steps // pr, kp, key_b, 0, "b"))

    span = _obs_trace.span("distributed.sma_gemm_sharded",
                           cat="distributed", grid=[pr, pc], steps=steps,
                           overlap=overlap, m=m, n=n, k=k)
    with span as sp:
        acc = torch.zeros(mb, nb, dtype=torch.float32, device=a.device)
        nxt = fetch(0)
        for t in range(steps):
            a_cur, b_cur = nxt[0].wait(), nxt[1].wait()
            if overlap and t + 1 < steps:
                nxt = fetch(t + 1)          # issued before this product
            acc += ops.sma_gemm(a_cur, b_cur, mesh=False).float()
            if not overlap and t + 1 < steps:
                nxt = fetch(t + 1)          # issued after it
        acc += bias_loc.float()[None, :]
        c = EPILOGUES[epilogue](acc).to(a.dtype)
        if pc > 1:
            c = collectives.all_gather(c, key_a, dim=1, span="comm.gather_c")
        if pr > 1:
            c = collectives.all_gather(c, key_b, dim=0, span="comm.gather_c")
        out = c[:m, :n].reshape(*lead, n)
        if sp is not None:
            sp.block(out)
    return out
