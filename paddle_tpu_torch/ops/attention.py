"""Plain (composite) attention of the port.

Counterpart of paddle_tpu/ops/pallas_ops.py ``xla_attention`` and
``xla_attention_packed`` — XLA composites there, not kernels — with their
semantics: f32 scores times ``sm_scale``, an additive bias, an end-aligned
causal mask (query i sees keys 0..i + Tk - Tq) with the finite mask value
-1e30, softmax, dropout on the probabilities (kept ones scaled by
1 / (1 - rate)), weighted sum.  Differentiable by autograd.  The LM's
recompute and the CPU path of the 4-D ``fused_attention`` op use them;
the packed training path goes through ops/flash_attention.py.
"""
from __future__ import annotations

import math

import torch

__all__ = ["_NEG_INF", "attention", "attention_packed"]

#: finite mask value shared by every plain attention of the port (a
#: fully masked row stays finite, as in the reference)
_NEG_INF = -1e30


def attention(q, k, v, bias=None, causal=False, sm_scale=None,
              dropout_rate=0.0, keep_mask=None, generator=None):
    """q [B, H, Tq, D], k/v [B, H, Tk, D] -> [B, H, Tq, D].  ``bias`` is
    broadcastable to [B, H, Tq, Tk].  With ``dropout_rate`` > 0 the keep
    mask is ``keep_mask`` (bool, broadcastable to the scores) or drawn
    from ``generator``."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q, k.transpose(-1, -2)).float() * sm_scale
    if bias is not None:
        s = s + bias.float()
    if causal:
        Tq, Tk = s.shape[-2], s.shape[-1]
        mask = torch.ones(Tq, Tk, dtype=torch.bool,
                          device=s.device).tril(Tk - Tq)
        s = s.masked_fill(~mask, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    if dropout_rate > 0.0:
        if keep_mask is None:
            keep_mask = torch.rand(p.shape, generator=generator,
                                   device=p.device) >= dropout_rate
        p = torch.where(keep_mask, p / (1.0 - dropout_rate),
                        torch.zeros_like(p))
    return torch.matmul(p.to(v.dtype), v)


def _heads(x, num_heads):
    B, T, Hd = x.shape
    return x.reshape(B, T, num_heads, Hd // num_heads).transpose(1, 2)


def attention_packed(q, k, v, num_heads, causal=False, sm_scale=None,
                     bias=None, dropout_rate=0.0, keep_mask=None,
                     generator=None):
    """q [B, Tq, H], k/v [B, Tk, H] (H = num_heads * d_head) ->
    [B, Tq, H]: ``attention`` over the heads of the packed layout."""
    B, Tq, Hd = q.shape
    o = attention(_heads(q, num_heads), _heads(k, num_heads),
                  _heads(v, num_heads), bias=bias, causal=causal,
                  sm_scale=sm_scale, dropout_rate=dropout_rate,
                  keep_mask=keep_mask, generator=generator)
    return o.transpose(1, 2).reshape(B, Tq, Hd)
