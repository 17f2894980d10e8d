"""Decode context parallelism: the ``kv_seq`` split of a KV cache over the
``model`` line.

Under the decode rules (:func:`repro_torch.distributed.sharding.rules_for`
with ``kind="decode"``) a model whose KV-head count the ``model`` axis does
not divide puts its KV cache's *sequence* over that axis (the reference's
``src/repro/distributed/sharding.py:164-168``): a cache of ``Smax`` slots
is held as ``Smax / m`` slots on each of the line's m ranks, rank r holding
global slots ``[r Smax/m, (r + 1) Smax/m)``.  A decode step then

* writes the new key and value on the rank that owns their slot alone
  (:func:`slot_owner`; every rank computes them, the projections being
  whole);
* attends on every rank over its own slots (:func:`local_lengths`) with
  the decode kernel's log-sum-exp output
  (:func:`repro_torch.kernels.ops.decode_attention` ``return_lse``);
* merges the ranks' (output, log-sum-exp) pairs (:func:`merge`): one
  all-gather over the line, then :func:`fold` in rank order, with no
  unordered add.

The valid slots of a cache are ``[0, min(pos + 1, Smax))`` for a ring (a
windowed layer) and ``[0, pos + 1)`` otherwise, whatever order the ring
wrote them in: rope was applied when each key was written, and softmax
attention does not depend on the order of its keys.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.distributed import collectives

__all__ = ["fold", "local_lengths", "merge", "slot_owner"]


def slot_owner(slot: torch.Tensor, local: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the rank along the line that holds each global ``slot``, the slot
    within that rank's block of ``local`` slots)."""
    return slot // local, slot % local


def local_lengths(cache_len: torch.Tensor, smax: int, window: Optional[int],
                  parts: int) -> torch.Tensor:
    """Each rank's valid slots of each row, (parts, B): the row's valid
    slots of the whole cache (``min(pos + 1, Smax)`` for a ring,
    ``pos + 1`` otherwise, ``pos`` = ``cache_len``, the position the step
    writes) less the slots of the ranks before it, between 0 and the
    ``Smax / parts`` a rank holds."""
    pos = cache_len.long()
    valid = (pos + 1).clamp(max=smax) if window is not None else pos + 1
    local = smax // parts
    first = torch.arange(parts, device=pos.device)[:, None] * local
    return (valid[None, :] - first).clamp(0, local)


def fold(outs: Sequence[torch.Tensor], lses: Sequence[torch.Tensor]
         ) -> torch.Tensor:
    """The attention over every part's keys from each part's own: outs (B,
    H, D) float32, each normalised over its part; lses (B, H) float32, the
    log of each part's softmax denominator (-inf for a part with no key).
    With M the largest lse, each part weighs ``exp(lse_i - M)``, and the
    weighted outputs and the weights are summed in the parts' order.  A row
    with no key in any part gives 0."""
    top = torch.stack(list(lses)).amax(0)
    top = torch.where(torch.isinf(top), 0.0, top)
    num = torch.zeros_like(outs[0])
    den = torch.zeros_like(lses[0])
    for out, lse in zip(outs, lses):
        w = torch.exp(lse - top)
        num = num + w[..., None] * out
        den = den + w
    return num / torch.where(den == 0, 1.0, den)[..., None]


def merge(out: torch.Tensor, lse: torch.Tensor, ax) -> torch.Tensor:
    """:func:`fold` of every rank's ``(out, lse)`` over the line ``ax`` (a
    :class:`repro_torch.distributed.tensor_parallel.ModelAxis`), in rank
    order, on every rank: one all-gather of the pairs (span
    ``comm.cp_merge``)."""
    pairs = torch.cat([out.float(), lse.float()[..., None]], -1)[None]
    every = collectives.all_gather(pairs.contiguous(), ax.key, dim=0,
                                   span="comm.cp_merge")
    parts: List[torch.Tensor] = list(every.unbind(0))
    return fold([p[..., :-1] for p in parts], [p[..., -1] for p in parts])
