"""Tensor parallelism by the rules: the helpers the layers call where the
reference calls ``shard`` (the Megatron form of what GSPMD derives from
the same specs).

Under ``train(mesh=)`` with a ``model`` axis of more than one rank
(:func:`model_axis`, from the mesh :class:`repro_torch.distributed.
sharding.use_rules` installs), each rank holds its ``model`` block of
every parameter whose spec resolves a dim to ``"model"``
(:func:`repro_torch.distributed.sharding.spec_tree_to_shardings`), and a
layer whose weights are so split (:func:`split_of`: the local width below
the whole one) computes on its block:

* a column-parallel product reads its input whole: the input passes
  :meth:`ModelAxis.enter` first (*f*: the identity, whose gradient is
  all-reduced, since each rank's is partial);
* a row-parallel product gives a partial sum, which :meth:`ModelAxis.exit`
  completes (*g*: an all-reduce, whose gradient passes unchanged);
* a product whose input is split by channels but whose weight's rows are
  whole reads the input through :meth:`ModelAxis.gather` (an all-gather,
  then *f*: the whole input's gradient is partial on each rank);
* a replicated weight read on only this rank's share of the work (the
  head's fused norm scale, an MQA layer's whole ``wk`` / ``wv``, mLSTM's
  gate projection, sLSTM's norm scale) passes :meth:`ModelAxis.enter`,
  so its gradient arrives summed over the line and every replica takes the
  same update.

A layer whose weights are whole computes whole on every rank, with no
collective.  Without a model axis every helper is the identity, so
unmeshed code and its numbers do not change.  Every product stays a
device-local ``ops.sma_gemm`` on the rank's block.

:func:`vocab_embed` and :func:`vocab_cross_entropy` are the vocab-parallel
embedding and loss (``repro.models.layers.cross_entropy`` written for a
vocab-sharded logit tensor).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import current_mesh

__all__ = ["ModelAxis", "WHOLE_ATTENTION_REASON", "model_axis", "split_of",
           "vocab_cross_entropy", "vocab_embed"]

#: The ``ops.ROUTED`` reason of an attention computed whole on every rank
#: of the line (``head_dim -> model``: neither head count divides it).
WHOLE_ATTENTION_REASON = ("tensor parallel: heads do not divide the model "
                          "axis; attention whole on each rank")


@dataclasses.dataclass(frozen=True)
class ModelAxis:
    """The ``model`` axis line of this rank: its collectives' group key,
    its ranks and this rank's index along it."""

    key: str
    size: int
    index: int

    def enter(self, x: torch.Tensor,
              span: str = "comm.tp_enter") -> torch.Tensor:
        """*f*: ``x``, whose gradient is all-reduced over the line."""
        return collectives.tp_enter(x, self.key, span=span)

    def exit(self, x: torch.Tensor,
             span: str = "comm.tp_exit") -> torch.Tensor:
        """*g*: the sum of the ranks' partial ``x``, whose gradient passes
        unchanged."""
        return collectives.all_reduce(x, self.key, span=span)

    def gather(self, x: torch.Tensor, dim: int = -1,
               span: str = "comm.tp_gather") -> torch.Tensor:
        """The ranks' blocks of ``x`` along ``dim``, whole; the whole
        tensor's gradient is all-reduced before this rank keeps its
        block."""
        return self.enter(collectives.all_gather(x, self.key, dim=dim,
                                                 span=span))

    def max(self, x: torch.Tensor,
            span: str = "comm.tp_max") -> torch.Tensor:
        """The largest of the ranks' ``x``, elementwise (no gradient)."""
        return collectives.all_reduce(x.detach(), self.key, op="max",
                                      span=span)

    def block(self, n_local: int) -> slice:
        """This rank's indices of a dim split into blocks of ``n_local``."""
        return slice(self.index * n_local, (self.index + 1) * n_local)


def model_axis() -> Optional[ModelAxis]:
    """The ambient mesh's ``model`` line when it has more than one rank
    (else None: no tensor parallelism)."""
    mesh = current_mesh()
    if mesh is None or mesh.shape.get("model", 1) <= 1:
        return None
    return ModelAxis(mesh.group_key("model"), mesh.shape["model"],
                     mesh.coords["model"])


def split_of(local: int, whole: int) -> Optional[ModelAxis]:
    """The model axis when a weight's dim of ``whole`` is held as a block of
    ``local`` on this rank, else None (the layer computes whole)."""
    ax = model_axis()
    if ax is None or local == whole:
        return None
    if local * ax.size != whole:
        raise ValueError(f"a block of {local} is not 1/{ax.size} of "
                         f"{whole}: the weights were not laid out for this "
                         f"mesh")
    return ax


def vocab_embed(ax: ModelAxis, table: torch.Tensor, tokens: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    """The rows of ``tokens`` in ``dtype`` from a table split by rows: this
    rank looks up the tokens its block holds (zeros for the others) and
    the ranks' rows are summed (*g*); each block's gradient is its own
    tokens'."""
    n = table.shape[0]
    local = tokens.long() - ax.index * n
    own = (local >= 0) & (local < n)
    rows = table[local.clamp(0, n - 1)].to(dtype)
    return ax.exit(torch.where(own[..., None], rows, 0.0),
                   span="comm.tp_embed")


def vocab_cross_entropy(ax: ModelAxis, logits32: torch.Tensor,
                        labels: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each position's cross-entropy (0 where the label is -1) and whether
    its argmax is the label, from this rank's block of the vocab
    (``logits32`` (..., V/m) float32, columns ``index * V/m`` on):

    * the shift is the ranks' largest logit, without gradient;
    * the sum of exponentials is *g*, so each block's softmax gets the
      whole gradient;
    * the label's logit comes from the rank whose block holds its column,
      summed over the line;
    * the argmax is the largest value over the ranks, the lowest column
      among equal values (``argmax``'s first occurrence)."""
    n = logits32.shape[-1]
    lo = ax.index * n
    m = ax.max(logits32.amax(-1))
    sumexp = ax.exit((logits32 - m[..., None]).exp().sum(-1),
                     span="comm.tp_loss")
    lse = sumexp.log() + m
    valid = labels >= 0
    local = labels.long() - lo
    own = valid & (local >= 0) & (local < n)
    picked = logits32.gather(-1, local.clamp(0, n - 1)[..., None])[..., 0]
    label_logit = ax.exit(torch.where(own, picked, 0.0), span="comm.tp_loss")
    ce = torch.where(valid, lse - label_logit, 0.0)
    with torch.no_grad():
        best, arg = logits32.max(-1)
        top = ax.max(best)
        col = torch.where(best == top, (arg + lo).float(),
                          float(2 ** 24))
        first = -ax.max(-col)
        hit = (first == labels.float()) & valid
    return ce, hit
