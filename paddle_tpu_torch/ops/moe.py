"""Mixture-of-Experts: the ``moe_ffn`` op (counterpart of
paddle_tpu/ops/moe.py; SURVEY.md §7, the ``expert`` mesh axis).

GShard-style dense dispatch in plain PyTorch, as the JAX package runs it
outside any Pallas kernel: top-k routing into a [tokens, experts,
capacity] 0/1 dispatch tensor (capacity ``max(1, int(k·N/E·cf))``; a
token past its expert's capacity is dropped), the kept gates
renormalized per token, the experts' FFNs as batched einsums, and the
GShard auxiliary load-balancing loss over the pre-capacity top-1
fractions.  The combine weights are ``dispatch · probs`` (a round's
gate is the token's probability of the expert it picked), the same
values the JAX op accumulates.

Under a mesh (core/spmd.py) the op keeps GSPMD's global semantics:

* **data axis** (the tokens split over the batch axes): the routing is
  global — every rank gathers the ranks' gate probabilities (without
  gradient), routes the whole token set in the global order with the
  global capacity, and keeps its own rows of the dispatch tensor; the
  experts' inputs are the forward sum of the ranks' dispatched tokens,
  and the aux loss's mean probabilities the sum of the ranks' partial
  sums over the global N (``sum_both_ways``: a rank's cotangent of the
  loss is its share, core/spmd.py's rule).  The experts' inputs need no sum in
  the backward: a capacity slot holds one token and the experts work
  slot by slot, so a rank's cotangent of a slot is nonzero only where
  the rank's own outputs read it, and there it is whole;
* **expert axis** (``moe_sharding_rules``: the ``.expert_`` weights
  split on dim 0): each rank runs its E/ep experts for all of its tokens
  and the combine's partial sums go through a forward sum over the
  expert axis; the tokens and gates entering the experts pass a
  backward sum, so every expert rank holds the whole gradient of the
  gate and of the layers below.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.registry import out, register_op, single
from ..parallel import _collectives as col


@torch.no_grad()
def top_k_dispatch(probs, k, capacity):
    """[N, E, C] 0/1 dispatch of ``probs`` [N, E]: k rounds of each
    token's best remaining expert, in token order; a token whose rank in
    its expert (earlier rounds first) reaches ``capacity`` is dropped."""
    n, e = probs.shape
    remaining = probs.clone()
    position = torch.zeros(e, dtype=probs.dtype, device=probs.device)
    dispatch = torch.zeros((n, e, capacity), dtype=probs.dtype,
                           device=probs.device)
    rows = torch.arange(n, device=probs.device)
    for _ in range(k):
        idx = torch.argmax(remaining, dim=1)
        mask = F.one_hot(idx, e).to(probs.dtype)
        rank = torch.cumsum(mask, dim=0) - mask + position[None, :]
        rank_tok = (rank * mask).sum(dim=1).to(torch.int64)
        keep = (rank_tok < capacity).to(probs.dtype)
        dispatch[rows, idx, rank_tok.clamp(0, capacity - 1)] += keep
        position = position + (mask * keep[:, None]).sum(dim=0)
        remaining = remaining * (1.0 - mask)
    return dispatch


@register_op(
    "moe_ffn",
    inputs=("X", "GateW", "W1", "B1", "W2", "B2"),
    outputs=("Out", "AuxLoss"),
)
def moe_ffn(ctx, inputs, attrs):
    """Top-k gated expert FFN.

    X [.., D] (leading dims flattened to tokens), GateW [D, E],
    W1 [E, D, H], B1 [E, H], W2 [E, H, D], B2 [E, D].
    attrs: top_k, capacity_factor, act ('gelu'|'relu').
    Out matches X; AuxLoss is the GShard load-balancing loss (scalar)."""
    from ..core import spmd

    x = single(inputs, "X")
    gate_w = single(inputs, "GateW")
    w1, b1 = single(inputs, "W1"), single(inputs, "B1")
    w2, b2 = single(inputs, "W2"), single(inputs, "B2")
    k = int(attrs.get("top_k", 2))
    cf = float(attrs.get("capacity_factor", 2.0))
    act = (lambda h: F.gelu(h, approximate="tanh")) \
        if attrs.get("act", "gelu") == "gelu" else F.relu
    d = x.shape[-1]
    tokens = x.reshape(-1, d)
    e = gate_w.shape[1]
    if k > e:
        raise ValueError(f"moe top_k={k} exceeds num_experts={e}")
    if tokens.is_meta:                      # shape inference
        return out(Out=torch.empty_like(x),
                   AuxLoss=torch.empty((), dtype=x.dtype, device="meta"))
    mx = spmd.active()
    how = mx.moe_mode if mx is not None else None
    data = mx.batch_groups if how is not None and how["batch"] else []
    egroup = mx.group(how["expert_axis"]) if how is not None \
        and how["expert_axis"] else None

    probs = torch.softmax(tokens @ gate_w, dim=-1)          # [n, E]
    # the global routing: every rank's probabilities, in rank order
    probs_all = probs.detach()
    for _, g in reversed(data):
        probs_all = col.gather_along(probs_all, g, 0)
    n_all = probs_all.shape[0]
    capacity = max(1, int((k * n_all / e) * cf))
    dispatch_all = top_k_dispatch(probs_all, k, capacity)
    lo = mx.moe_row_offset(tokens.shape[0]) if data else 0
    dispatch = dispatch_all[lo:lo + tokens.shape[0]]

    gates = col.backward_sum(probs, egroup)
    combine = dispatch * gates[:, :, None]
    combine = combine / (combine.sum(dim=(1, 2), keepdim=True) + 1e-9)
    e0, e1 = 0, e
    if egroup is not None:
        per = e // mx.size(how["expert_axis"])
        e0 = mx.rank(how["expert_axis"]) * per
        e1 = e0 + per
    tok = col.backward_sum(tokens, egroup)
    expert_in = torch.einsum("nec,nd->ecd", dispatch[:, e0:e1], tok)
    for _, g in data:
        # each slot is one rank's token: that rank's cotangent is whole
        expert_in = col.forward_sum(expert_in, g)
    h = act(torch.einsum("ecd,edh->ech", expert_in, w1[e0:e1])
            + b1[e0:e1, None, :])
    expert_out = torch.einsum("ech,ehd->ecd", h, w2[e0:e1]) \
        + b2[e0:e1, None, :]
    y = torch.einsum("nec,ecd->nd", combine[:, e0:e1], expert_out)
    y = col.forward_sum(y, egroup)

    # GShard aux loss: E * sum_e(frac_e * mean_prob_e), frac_e the
    # PRE-capacity fraction of tokens whose top-1 choice is e
    top1 = F.one_hot(torch.argmax(probs_all, dim=1), e).to(probs.dtype)
    frac = top1.mean(dim=0)
    psum = probs.sum(dim=0)
    for _, g in data:
        # every rank's cotangent of the mean is a share (core/spmd.py)
        psum = col.sum_both_ways(psum, g)
    aux = (frac * (psum / n_all)).sum() * e
    return out(Out=y.reshape(x.shape), AuxLoss=aux)
