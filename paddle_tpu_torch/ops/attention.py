"""Plain attention over packed heads.

Counterpart of paddle_tpu/ops/pallas_ops.py ``xla_attention_packed`` /
``xla_attention`` — an XLA composite there, not a kernel — with the
semantics the LM needs: f32 scores, an optional start-aligned causal
mask (query i sees keys 0..i + Tk - Tq), softmax, weighted sum.  Bias
and dropout belong to the training slices and are not ported yet.
"""
from __future__ import annotations

import math

import torch

__all__ = ["_NEG_INF", "attention_packed"]

#: finite mask value shared by every plain attention of the port (a
#: fully masked row stays finite, as in the reference)
_NEG_INF = -1e30


def attention_packed(q, k, v, num_heads, causal=False, sm_scale=None):
    """q [B, Tq, H], k/v [B, Tk, H] (H = num_heads * d_head) ->
    [B, Tq, H]."""
    B, Tq, Hd = q.shape
    Tk = k.shape[1]
    D = Hd // num_heads
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    qh = q.reshape(B, Tq, num_heads, D).transpose(1, 2)
    kh = k.reshape(B, Tk, num_heads, D).transpose(1, 2)
    vh = v.reshape(B, Tk, num_heads, D).transpose(1, 2)
    s = torch.einsum("bhqd,bhkd->bhqk", qh, kh).float() * sm_scale
    if causal:
        mask = torch.ones(Tq, Tk, dtype=torch.bool,
                          device=q.device).tril(Tk - Tq)
        s = s.masked_fill(~mask, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(vh.dtype), vh)
    return o.transpose(1, 2).reshape(B, Tq, Hd)
