"""Plain paged decode attention: one query token per sequence attends
over that sequence's page list.

Counterpart of the plain half of paddle_tpu/generation/attention.py.
``gathered_decode_attention`` is the one masked-softmax function every
plain attention of the generation path reduces to (f32 scores and
softmax whatever the input dtype); ``paged_ref_decode_attention``
gathers a page list into the contiguous layout first.  The paged decode
kernel serves the legacy scheduler and comes with it in a later slice.

Shapes (packed head layout, H = num_heads * d_head):
  q [S, H]; k_pages/v_pages [num_pages, page_size, H];
  page_table [S, pages_per_seq] int; eff_lens [S] int (keys
  0..len-1 are visible).
"""
from __future__ import annotations

import math

import torch

from ..ops.attention import _NEG_INF

__all__ = ["paged_decode_shapes_ok", "gathered_decode_attention",
           "paged_ref_decode_attention"]


def paged_decode_shapes_ok(page_size, hidden, num_heads):
    """Shape gate of the TPU decode kernels: whole heads in 128-lane
    tiles and sublane-aligned pages."""
    if hidden % num_heads:
        return False
    d = hidden // num_heads
    return d <= 128 and 128 % d == 0 and page_size % 8 == 0


def gathered_decode_attention(q, k_ctx, v_ctx, eff_lens, num_heads,
                              sm_scale=None):
    """Decode attention over CONTIGUOUS per-slot KV:
    q [S, H], k_ctx/v_ctx [S, L, H], eff_lens [S] -> [S, H]."""
    S, L, H = k_ctx.shape
    D = H // num_heads
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    qh = q.reshape(S, num_heads, D)
    kh = k_ctx.reshape(S, L, num_heads, D)
    vh = v_ctx.reshape(S, L, num_heads, D)
    s = torch.einsum("snd,slnd->snl", qh, kh).float() * sm_scale
    mask = (torch.arange(L, device=q.device)[None, None, :]
            < eff_lens.to(q.device)[:, None, None])
    s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1)
    ctx = torch.einsum("snl,slnd->snd", p.to(vh.dtype), vh)
    return ctx.reshape(S, H).to(q.dtype)


def paged_ref_decode_attention(q, k_pages, v_pages, page_table, eff_lens,
                               num_heads, sm_scale=None):
    """Gather each slot's pages into the contiguous layout, then the
    shared masked-softmax math."""
    S = q.shape[0]
    H = k_pages.shape[-1]
    idx = page_table.long()
    k_ctx = k_pages[idx].reshape(S, -1, H)
    v_ctx = v_pages[idx].reshape(S, -1, H)
    return gathered_decode_attention(q, k_ctx, v_ctx, eff_lens, num_heads,
                                     sm_scale=sm_scale)
