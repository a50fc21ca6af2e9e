"""Sequence ops of the port over padded batches (parity:
paddle/fluid/operators/sequence_ops/ — sequence_pool/softmax/reverse/
expand/concat/conv/mask/pad/unpad/reshape/slice/scatter/enumerate/erase).

Counterpart of paddle_tpu/ops/sequence.py, op for op.  A sequence batch
is DENSE PADDED ``X [B, T, ...]`` plus ``SeqLen [B]``, as in the JAX
package, and every op is mask arithmetic in plain PyTorch (XLA compiled
these with no Pallas kernel).  Indices that the JAX scatters drop (an
id past the row, ``mode="drop"``) are routed to one extra column that
is sliced off, so no out-of-range index reaches a CUDA index op.
Host-side ragged<->padded conversion lives in paddle_tpu_torch/lod.py.
"""
from __future__ import annotations

import torch

from ..core.registry import out, register_op, single
from ..core.types import runtime_dtype


def _mask(seq_len, t, dtype):
    """[B, T] validity mask from lengths."""
    steps = torch.arange(t, device=seq_len.device)
    return (steps[None, :] < seq_len.reshape(-1)[:, None]).to(dtype)


def _expand_mask(m, x):
    """Broadcast a [B, T] mask onto x [B, T, ...]."""
    return m.reshape(tuple(m.shape) + (1,) * (x.dim() - 2))


def _gather_time(x, idx):
    """x [B, T, ...] at per-row time indices idx [B, T'] -> [B, T', ...]
    (jnp.take_along_axis over axis 1)."""
    tail = tuple(x.shape[2:])
    full = idx.reshape(tuple(idx.shape) + (1,) * len(tail)).expand(
        tuple(idx.shape) + tail)
    return torch.gather(x, 1, full.long())


@register_op("sequence_mask", inputs=("X",), outputs=("Y",),
             no_grad_slots=("X",))
def sequence_mask(ctx, inputs, attrs):
    """lengths [B] -> [B, maxlen] 0/1 (parity: sequence_mask_op.cc)."""
    x = single(inputs, "X")
    maxlen = int(attrs["maxlen"])
    dtype = runtime_dtype(attrs.get("out_dtype", "float32"))
    steps = torch.arange(maxlen, device=x.device)
    return out(Y=(steps[None, :] < x[:, None]).to(dtype))


@register_op("sequence_pool", inputs=("X", "SeqLen"), outputs=("Out",),
             no_grad_slots=("SeqLen",))
def sequence_pool(ctx, inputs, attrs):
    """pooltype: SUM/AVERAGE/SQRT/MAX/LAST/FIRST over valid steps
    (parity: sequence_pool_op.cc + math/sequence_pooling.cc).  MAX fills
    padded steps with the dtype's finfo.min (a length-0 row gives it) and
    splits the gradient evenly among tied maxima, as jnp.max does;
    AVERAGE and SQRT divide by max(len, 1); FIRST reads step 0."""
    x = single(inputs, "X")
    seq_len = single(inputs, "SeqLen")
    ptype = attrs.get("pooltype", "AVERAGE").upper()
    m = _expand_mask(_mask(seq_len, x.shape[1], x.dtype), x)
    lead = (-1,) + (1,) * (x.dim() - 2)
    if ptype == "SUM":
        return out(Out=torch.sum(x * m, dim=1))
    if ptype == "AVERAGE":
        denom = seq_len.to(x.dtype).clamp_min(1.0)
        return out(Out=torch.sum(x * m, dim=1) / denom.reshape(lead))
    if ptype == "SQRT":
        denom = torch.sqrt(seq_len.to(x.dtype).clamp_min(1.0))
        return out(Out=torch.sum(x * m, dim=1) / denom.reshape(lead))
    if ptype == "MAX":
        neg = torch.full_like(x, torch.finfo(x.dtype).min)
        return out(Out=torch.amax(torch.where(m > 0, x, neg), dim=1))
    if ptype == "FIRST":
        return out(Out=x[:, 0])
    if ptype == "LAST":
        idx = (seq_len - 1).clamp_min(0).reshape(-1, 1)
        return out(Out=_gather_time(x, idx)[:, 0])
    raise ValueError(f"unknown pooltype {ptype}")


@register_op("sequence_softmax", inputs=("X", "SeqLen"), outputs=("Out",),
             no_grad_slots=("SeqLen",))
def sequence_softmax(ctx, inputs, attrs):
    """Masked softmax over the time axis (parity:
    sequence_softmax_op.cc; invalid steps get probability 0)."""
    x = single(inputs, "X")
    seq_len = single(inputs, "SeqLen")
    m = _mask(seq_len, x.shape[1], x.dtype)
    neg = torch.full_like(x, -1e30)
    probs = torch.softmax(torch.where(m > 0, x, neg), dim=1)
    return out(Out=probs * m)


@register_op("sequence_reverse", inputs=("X", "SeqLen"), outputs=("Y",),
             no_grad_slots=("SeqLen",))
def sequence_reverse(ctx, inputs, attrs):
    """Reverse each row's valid prefix, padding stays in place (parity:
    sequence_reverse_op.h)."""
    x = single(inputs, "X")
    seq_len = single(inputs, "SeqLen").reshape(-1, 1)
    ar = torch.arange(x.shape[1], device=x.device)[None, :]
    src = torch.where(ar < seq_len, seq_len - 1 - ar, ar)
    return out(Y=_gather_time(x, src))


@register_op("sequence_expand_as", inputs=("X", "Y", "SeqLen"),
             outputs=("Out",), no_grad_slots=("Y", "SeqLen"))
def sequence_expand_as(ctx, inputs, attrs):
    """Broadcast per-sequence X [B, ...] along Y's time axis, masked to
    Y's lengths (parity: sequence_expand_as_op.cc)."""
    x = single(inputs, "X")
    y = single(inputs, "Y")
    seq_len = single(inputs, "SeqLen")
    t = y.shape[1]
    rep = x[:, None].expand((x.shape[0], t) + tuple(x.shape[1:]))
    return out(Out=rep * _expand_mask(_mask(seq_len, t, x.dtype), rep))


@register_op("sequence_concat", inputs=("X", "XLen", "Y", "YLen"),
             outputs=("Out", "OutLen"), no_grad_slots=("XLen", "YLen"))
def sequence_concat(ctx, inputs, attrs):
    """Concat two padded batches along time per row: row i holds
    x_i[:lx_i] ++ y_i[:ly_i] then padding (parity:
    sequence_concat_op.cc over two inputs)."""
    x = single(inputs, "X")
    xl = single(inputs, "XLen").reshape(-1, 1)
    y = single(inputs, "Y")
    yl = single(inputs, "YLen").reshape(-1, 1)
    tx, ty = x.shape[1], y.shape[1]
    ar = torch.arange(tx + ty, device=x.device)[None, :]
    from_x = ar < xl
    y_pos = (ar - xl).clamp(0, ty - 1)
    x_pos = ar.clamp(0, tx - 1).expand(x.shape[0], -1)
    gx = _gather_time(x, x_pos)
    gy = _gather_time(y, y_pos)
    merged = torch.where(_expand_mask(from_x, gx), gx, gy)
    out_len = (xl + yl).reshape(-1)
    valid = (ar < out_len[:, None]).to(x.dtype)
    return out(Out=merged * _expand_mask(valid, merged), OutLen=out_len)


@register_op("sequence_conv", inputs=("X", "SeqLen", "Filter"),
             outputs=("Out",), no_grad_slots=("SeqLen",))
def sequence_conv(ctx, inputs, attrs):
    """Context-window convolution over time (parity:
    sequence_conv_op.cc + math/context_project.h): each step's
    contextLength window of features (zero outside the sequence) is
    flattened and projected by Filter [ctx*D, M].  The default
    contextStart is ``-(ctx_len - 1) // 2`` (floor division: -2 for a
    window of 4).  The input is masked before the window and the output
    after the product."""
    x = single(inputs, "X")          # [B, T, D]
    seq_len = single(inputs, "SeqLen")
    filt = single(inputs, "Filter")  # [ctx*D, M]
    ctx_len = int(attrs.get("contextLength", 3))
    ctx_start = int(attrs.get("contextStart", -(ctx_len - 1) // 2))
    t = x.shape[1]
    m = _mask(seq_len, t, x.dtype)[:, :, None]
    xm = x * m
    ar = torch.arange(t, device=x.device)
    cols = []
    for k in range(ctx_len):
        off = ctx_start + k
        rolled = torch.roll(xm, -off, dims=1)
        valid = ((ar + off >= 0) & (ar + off < t)).to(x.dtype)
        cols.append(rolled * valid[None, :, None])
    stacked = torch.cat(cols, dim=2)             # [B, T, ctx*D]
    y = torch.matmul(stacked, filt)              # [B, T, M]
    return out(Out=y * m)


@register_op("sequence_expand", inputs=("X", "Y"), outputs=("Out",),
             no_grad_slots=("Y",))
def sequence_expand(ctx, inputs, attrs):
    """sequence_expand_op.cc under the padded policy: repeat each row of X
    along a new time axis sized by Y's time dim (uniform expansion)."""
    x = single(inputs, "X")
    y = single(inputs, "Y")
    t = y.shape[1]
    rep = x[:, None].expand((x.shape[0], t) + tuple(x.shape[1:]))
    return out(Out=rep.reshape((x.shape[0] * t,) + tuple(x.shape[1:])))


@register_op("sequence_pad", inputs=("X", "PadValue", "SeqLen"),
             outputs=("Out", "Length"), no_grad_slots=("PadValue", "SeqLen"))
def sequence_pad(ctx, inputs, attrs):
    """sequence_pad_op.cc: positions past each row's length become
    PadValue; Length echoes the lengths (already-dense input per the
    padded policy).  ``padded_length`` cuts or zero-pads the time axis
    first."""
    x = single(inputs, "X")
    pad = single(inputs, "PadValue")
    seq_len = single(inputs, "SeqLen")
    B, T = x.shape[0], x.shape[1]
    if seq_len is None:
        seq_len = torch.full((B,), T, dtype=torch.int32, device=x.device)
    plen = int(attrs.get("padded_length", -1))
    if plen > 0 and plen != T:
        if plen < T:
            x = x[:, :plen]
        else:
            x = torch.cat([x, x.new_zeros((B, plen - T)
                                          + tuple(x.shape[2:]))], dim=1)
        T = plen
    m = _expand_mask(_mask(seq_len, T, torch.bool), x)
    fill = pad.reshape((1,) * (x.dim() - 1) + (-1,)) if pad.dim() else pad
    return out(Out=torch.where(m, x, fill.to(x.dtype)),
               Length=seq_len.to(runtime_dtype("int64")))


@register_op("sequence_unpad", inputs=("X", "Length"), outputs=("Out",),
             no_grad_slots=("Length",))
def sequence_unpad(ctx, inputs, attrs):
    """sequence_unpad_op.cc: static shapes forbid a ragged result, so the
    padded positions are zeroed — downstream masked ops see the values
    of the reference's unpadded LoD tensor."""
    x = single(inputs, "X")
    length = single(inputs, "Length").reshape(-1)
    m = _expand_mask(_mask(length, x.shape[1], x.dtype), x)
    return out(Out=x * m)


@register_op("sequence_reshape", inputs=("X",), outputs=("Out",))
def sequence_reshape(ctx, inputs, attrs):
    """sequence_reshape_op.cc: refold the trailing dims so the last dim
    becomes new_dim."""
    x = single(inputs, "X")
    return out(Out=x.reshape(x.shape[0], -1, int(attrs["new_dim"])))


@register_op("sequence_slice", inputs=("X", "Offset", "Length"),
             outputs=("Out",), no_grad_slots=("Offset", "Length"))
def sequence_slice(ctx, inputs, attrs):
    """sequence_slice_op.cc: per-row [offset, offset+length) window; the
    window lands left-aligned, the remainder zero-padded (static shape).
    The start follows lax.dynamic_slice over the row with T zero steps
    appended: a negative offset counts from that 2T-long row's end, and
    the start is then clamped to [0, T]."""
    x = single(inputs, "X")
    off = single(inputs, "Offset").reshape(-1, 1)
    length = single(inputs, "Length").reshape(-1, 1)
    T = x.shape[1]
    ar = torch.arange(T, device=x.device)[None, :]
    padded = torch.cat([x, torch.zeros_like(x)], dim=1)
    start = torch.where(off < 0, off + 2 * T, off).clamp(0, T)
    window = _gather_time(padded, start + ar)
    keep = (ar < length).to(x.dtype)
    return out(Out=window * _expand_mask(keep, window))


@register_op("sequence_scatter", inputs=("X", "Ids", "Updates"),
             outputs=("Out",), no_grad_slots=("Ids",))
def sequence_scatter(ctx, inputs, attrs):
    """sequence_scatter_op.cc: per-row scatter-add of Updates[b, k] into
    X[b, Ids[b, k]].  Repeated ids accumulate; a negative id counts from
    the row's end and an id outside [-T, T) is dropped, as the JAX
    ``.at[].add`` does."""
    x = single(inputs, "X")
    ids = single(inputs, "Ids").long()
    upd = single(inputs, "Updates")
    T = x.shape[1]
    ids = torch.where(ids < 0, ids + T, ids)
    ids = torch.where((ids >= 0) & (ids < T), ids, torch.full_like(ids, T))
    tail = tuple(upd.shape[2:])
    full = ids.reshape(tuple(ids.shape) + (1,) * len(tail)).expand(
        tuple(upd.shape))
    # one zero step appended takes the dropped ids' updates
    padded = torch.cat([x, torch.zeros_like(x[:, :1])], dim=1)
    res = padded.scatter_add(1, full, upd.to(x.dtype))
    return out(Out=res[:, :T])


@register_op("sequence_enumerate", inputs=("X",), outputs=("Out",),
             no_grad_slots=("X",))
def sequence_enumerate(ctx, inputs, attrs):
    """sequence_enumerate_op.cc: sliding win_size windows per position,
    positions past the end filled with pad_value."""
    x = single(inputs, "X")
    win = int(attrs["win_size"])
    pad = int(attrs.get("pad_value", 0))
    T = x.shape[1]
    xp = torch.cat([x, torch.full((x.shape[0], win - 1), pad,
                                  dtype=x.dtype, device=x.device)], dim=1)
    return out(Out=torch.stack([xp[:, i:i + T] for i in range(win)],
                               dim=-1))


@register_op("sequence_erase", inputs=("X",), outputs=("Out",),
             no_grad_slots=("X",))
def sequence_erase(ctx, inputs, attrs):
    """sequence_erase_op.cc: drop the listed tokens; survivors left-pack,
    the tail zero-fills (static shape)."""
    x = single(inputs, "X")
    tokens = list(attrs.get("tokens", []))
    B, T = x.shape
    if tokens:
        tok = torch.tensor(tokens, dtype=x.dtype, device=x.device)
        keep = torch.all(x[:, :, None] != tok[None, None, :], dim=-1)
    else:
        keep = torch.ones((B, T), dtype=torch.bool, device=x.device)
    tgt = torch.cumsum(keep.long(), dim=1) - 1
    tgt = torch.where(keep, tgt, torch.full_like(tgt, T))
    res = x.new_zeros((B, T + 1)).scatter(
        1, tgt, torch.where(keep, x, torch.zeros_like(x)))
    return out(Out=res[:, :T])
