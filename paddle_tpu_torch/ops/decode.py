"""Beam-search decode ops of the port.

Counterpart of paddle_tpu/ops/decode.py (parity:
operators/beam_search_op.cc with math/beam_search.cc, and
beam_search_decode_op.cc), with its dense design: beams are a [B, K]
axis, one top-k over the [B, K·V] joint candidates a step, and the
backtrace walks the parents from the last step (the gather_tree of
operators/gather_tree_op.cc).  Ties among the candidates go to the
lower index, as ``jax.lax.top_k`` (the port's ``top_k`` op).
"""
from __future__ import annotations

import torch

from ..core.registry import out, register_op, single

_NEG_INF = -1e30


@register_op("beam_search",
             inputs=("pre_ids", "pre_scores", "ids", "scores"),
             outputs=("selected_ids", "selected_scores", "parent_idx"),
             no_grad_slots=("pre_ids", "pre_scores", "ids", "scores"))
def beam_search(ctx, inputs, attrs):
    """One beam step.  pre_ids/pre_scores [B, K]; scores [B, K, V]
    (probabilities — their log is taken here — unless is_accumulated).
    A beam whose pre_id is end_id is finished: its only candidate is
    (end_id, pre_score), so it keeps its score and cannot fork.  The
    first step passes pre_scores with only beam 0 live (others -1e30)."""
    pre_ids = single(inputs, "pre_ids")
    pre_scores = single(inputs, "pre_scores")
    scores = single(inputs, "scores")
    k = int(attrs["beam_size"])
    end_id = int(attrs["end_id"])
    b, kin, v = scores.shape
    if attrs.get("is_accumulated", True):
        acc = scores.float()
    else:
        acc = pre_scores[..., None] + torch.log(
            scores.float().clamp_min(1e-30))
    finished = pre_ids == end_id
    acc = torch.where(finished[..., None],
                      torch.full_like(acc, _NEG_INF), acc)
    end_col = torch.where(finished, pre_scores.to(acc.dtype),
                          acc[:, :, end_id])
    acc = torch.cat([acc[:, :, :end_id], end_col[..., None],
                     acc[:, :, end_id + 1:]], dim=-1)
    flat = acc.reshape(b, kin * v)
    vals, idx = torch.sort(flat, dim=-1, descending=True, stable=True)
    sel_scores, flat_idx = vals[:, :k], idx[:, :k]
    parent = torch.div(flat_idx, v, rounding_mode="floor").to(torch.int32)
    token = (flat_idx % v).to(pre_ids.dtype)
    ids_in = single(inputs, "ids")
    if ids_in is not None:
        token = torch.gather(ids_in.reshape(b, kin * v), 1,
                             flat_idx).to(pre_ids.dtype)
    return out(selected_ids=token, selected_scores=sel_scores,
               parent_idx=parent)


def gather_tree(ids, parents):
    """Beam-search backtrace: ids/parents [T, B, K]; walking the parents
    from the last step re-threads each beam into one token path."""
    steps = ids.shape[0]
    parent = parents[steps - 1].long()
    rows = [ids[steps - 1]]
    for t in range(steps - 2, -1, -1):
        rows.append(torch.gather(ids[t], -1, parent))
        parent = torch.gather(parents[t].long(), -1, parent)
    return torch.stack(rows[::-1])


@register_op("beam_search_decode",
             inputs=("Ids", "Scores", "ParentIdx"),
             outputs=("SentenceIds", "SentenceScores"),
             no_grad_slots=("Ids", "Scores", "ParentIdx"))
def beam_search_decode(ctx, inputs, attrs):
    """Ids/Scores/ParentIdx [T, B, K], each step's beam_search outputs
    stacked: SentenceIds [T, B, K] are the re-threaded token paths,
    SentenceScores [B, K] the last step's accumulated scores."""
    ids = single(inputs, "Ids")
    parents = single(inputs, "ParentIdx")
    scores = single(inputs, "Scores")
    return out(SentenceIds=gather_tree(ids, parents),
               SentenceScores=scores[-1])
