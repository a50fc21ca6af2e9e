"""Manipulation ops of the port: ``gather_nd`` and ``cos_sim``.

Counterpart of paddle_tpu/ops/manip.py (parity:
operators/gather_nd_op.cc, cos_sim_op.cc); its other 27 ops wait
(ROADMAP.md Queue 1 item 6.5).
"""
from __future__ import annotations

import torch

from ..core.registry import out, register_op, single


@register_op("gather_nd", inputs=("X", "Index"), outputs=("Out",),
             no_grad_slots=("Index",))
def gather_nd(ctx, inputs, attrs):
    """Index[..., K] indexes the first K dims of X; Out.shape =
    Index.shape[:-1] + X.shape[K:]."""
    x = single(inputs, "X")
    index = single(inputs, "Index").long()
    return out(Out=x[tuple(index.movedim(-1, 0))])


@register_op("cos_sim", inputs=("X", "Y"), outputs=("Out", "XNorm", "YNorm"))
def cos_sim(ctx, inputs, attrs):
    """operators/cos_sim_op.cc: row-wise cosine similarity over the last
    axis; Y may be a single row broadcast against X."""
    x = single(inputs, "X")
    y = single(inputs, "Y")
    xn = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    yn = torch.sqrt(torch.sum(y * y, dim=-1, keepdim=True))
    sim = torch.sum(x * y, dim=-1, keepdim=True) / (xn * yn)
    return out(Out=sim, XNorm=xn, YNorm=yn)
