"""Beam-search decoding ops in PyTorch: ``beam_search``, ``gather_tree``
and ``beam_search_decode``.

Counterpart of ``paddle_tpu/ops/beam_ops.py``, with its fixed [batch,
beam] shapes: a finished hypothesis stays in the beam as an end-token
self-continuation at its frozen score, and a step is one sort over
[batch, beam x width] candidates.  None has a grad.

* ``beam_search`` breaks ties as ``lax.top_k`` does, lower index first:
  a stable descending sort (``torch.topk`` promises no order on the
  card).  Ties are common: in float32 -1e9 plus a log-probability of a
  few units rounds back to -1e9 (its ulp is 64), so the dead beams of the
  first step and the masked slots of a finished hypothesis all tie.
* ``beam_search_decode``'s length is the first end token's position + 1,
  found as the least position holding one (no ``argmax`` over a bool
  tensor).
"""
from __future__ import annotations

import torch

from .registry import in_var, register_op, set_out

NEG_INF = -1e9


def _beam_search_infer(op, block):
    scores = in_var(op, block, "Scores")       # [B, K, W] accumulated
    B, K = scores.shape[0], op.attr("beam_size")
    set_out(op, block, "SelectedIds", (B, K), "int64")
    set_out(op, block, "SelectedScores", (B, K), scores.dtype)
    set_out(op, block, "ParentIdx", (B, K), "int64")


@register_op("beam_search", infer=_beam_search_infer, grad=None)
def _beam_search(ctx, op):
    """One fixed-shape beam step.  PreIds / PreScores [B, K]: each
    hypothesis's last token and accumulated score; Scores [B, K, W] the
    candidates' accumulated scores, Ids [B, K, W] their tokens (without
    Ids, candidate w is token w).  Outputs [B, K]: the best K candidates'
    tokens and scores, and the hypothesis each extends.  A hypothesis
    whose last token is end_id offers one candidate, end_id again at its
    frozen score."""
    pre_ids = ctx.get_input(op, "PreIds")
    pre_scores = ctx.get_input(op, "PreScores")
    ids = ctx.get_input(op, "Ids") if op.single_input("Ids") else None
    scores = ctx.get_input(op, "Scores")
    K = op.attr("beam_size")
    end_id = op.attr("end_id")
    B, K_in, W = scores.shape
    finished = pre_ids == end_id                          # [B, K_in]
    slot0 = (torch.arange(W, device=scores.device) == 0)[None, None, :]
    neg = torch.full((), NEG_INF, dtype=scores.dtype, device=scores.device)
    cand = torch.where(finished[:, :, None],
                       torch.where(slot0, pre_scores[:, :, None], neg),
                       scores)
    vals, idx = torch.sort(cand.reshape(B, K_in * W), dim=1,
                           descending=True, stable=True)
    top_scores, top_idx = vals[:, :K], idx[:, :K]
    parent = torch.div(top_idx, W, rounding_mode="floor")
    end = torch.full((), end_id, dtype=torch.int64, device=scores.device)
    if ids is None:
        # a candidate extending a finished hypothesis is its end_id
        # self-continuation (slot 0), not token 0
        sel = torch.where(torch.gather(finished, 1, parent), end,
                          top_idx % W)
    else:
        cand_ids = torch.where(finished[:, :, None], end.to(ids.dtype), ids)
        sel = torch.gather(cand_ids.reshape(B, K_in * W), 1,
                           top_idx).to(torch.int64)
    ctx.set_output(op, "SelectedIds", sel)
    ctx.set_output(op, "SelectedScores", top_scores)
    ctx.set_output(op, "ParentIdx", parent)


def _gather_tree_infer(op, block):
    ids = in_var(op, block, "Ids")
    set_out(op, block, "Out", ids.shape, ids.dtype)


def _backtrack(ids, parents):
    """Ids / Parents [T, B, K] -> [T, B, K]: Out[t, b, k] follows the
    parent chain from (T - 1, b, k) back to step t (reference
    gather_tree_op.h), whole [B, K] slices a step."""
    T = ids.shape[0]
    rows = [None] * T
    rows[T - 1] = ids[T - 1]
    parent = parents[T - 1].to(torch.int64)
    for t in range(T - 2, -1, -1):
        rows[t] = torch.gather(ids[t], 1, parent)
        parent = torch.gather(parents[t].to(torch.int64), 1, parent)
    return torch.stack(rows, 0)


@register_op("gather_tree", infer=_gather_tree_infer, grad=None)
def _gather_tree(ctx, op):
    ctx.set_output(op, "Out", _backtrack(ctx.get_input(op, "Ids"),
                                         ctx.get_input(op, "Parents")))


def _bsd_infer(op, block):
    ids = in_var(op, block, "Ids")             # [T, B, K]
    T, B, K = ids.shape
    set_out(op, block, "SentenceIds", (B, K, T), "int64")
    set_out(op, block, "SentenceScores", (B, K),
            in_var(op, block, "Scores").dtype)
    set_out(op, block, "SentenceLengths", (B, K), "int64")


@register_op("beam_search_decode", infer=_bsd_infer, grad=None)
def _beam_search_decode(ctx, op):
    """Final hypotheses from the steps' Ids / Parents [T, B, K] and the
    final Scores [B, K]: SentenceIds [B, K, T], end_id past each
    hypothesis's end; SentenceScores; SentenceLengths, the tokens up to
    and including the first end_id, or T."""
    ids = ctx.get_input(op, "Ids")
    end_id = op.attr("end_id")
    T = ids.shape[0]
    sent = _backtrack(ids, ctx.get_input(op, "Parents")).permute(
        1, 2, 0).to(torch.int64)                           # [B, K, T]
    pos = torch.arange(T, device=ids.device)
    first = torch.where(sent == end_id, pos, T).amin(-1)   # T: no end
    length = torch.where(first < T, first + 1, T)
    end = torch.full((), end_id, dtype=torch.int64, device=ids.device)
    ctx.set_output(op, "SentenceIds",
                   torch.where(pos < length[..., None], sent, end))
    ctx.set_output(op, "SentenceScores", ctx.get_input(op, "Scores"))
    ctx.set_output(op, "SentenceLengths", length.to(torch.int64))
