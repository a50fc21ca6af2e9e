"""Tensor-manipulation ops of the ported training path.

Counterpart of paddle_tpu/ops/tensor.py (parity: the reference's
fill_constant/assign/sum/cast/reshape/transpose/slice/squeeze/unsqueeze/
lookup_table/range operator files).  Views where torch gives them
(slice, transpose, squeeze): a slice of the packed qkv projection reaches
the flash-attention kernel as a strided view, not a copy.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.registry import out, register_op, single
from ..core.types import runtime_dtype


@register_op("fill_constant", inputs=(), outputs=("Out",))
def fill_constant(ctx, inputs, attrs):
    shape = tuple(int(d) for d in attrs.get("shape", ()))
    dtype = runtime_dtype(attrs.get("dtype", "float32"))
    return out(Out=torch.full(shape, attrs.get("value", 0.0), dtype=dtype,
                              device=ctx.device))


@register_op("assign", inputs=("X",), outputs=("Out",))
def assign(ctx, inputs, attrs):
    return out(Out=single(inputs, "X"))


@register_op("sum", inputs=("X",), outputs=("Out",))
def sum_op(ctx, inputs, attrs):
    xs = inputs["X"]
    acc = xs[0]
    for x in xs[1:]:
        acc = acc + x
    return out(Out=acc)


@register_op("cast", inputs=("X",), outputs=("Out",))
def cast(ctx, inputs, attrs):
    dtype = runtime_dtype(attrs.get("out_dtype", attrs.get("dtype", "float32")))
    return out(Out=single(inputs, "X").to(dtype))


@register_op("reshape", inputs=("X",), outputs=("Out",))
def reshape(ctx, inputs, attrs):
    x = single(inputs, "X")
    # Reference semantics (reshape_op.cc): 0 => copy dim from input,
    # -1 => inferred.
    shape = [x.shape[i] if d == 0 else d
             for i, d in enumerate(attrs["shape"])]
    return out(Out=x.reshape(shape))


@register_op("transpose", inputs=("X",), outputs=("Out",))
def transpose(ctx, inputs, attrs):
    x = single(inputs, "X")
    perm = attrs.get("axis", list(reversed(range(x.dim()))))
    return out(Out=x.permute(*perm))


@register_op("slice", inputs=("Input",), outputs=("Out",))
def slice_op(ctx, inputs, attrs):
    x = single(inputs, "Input")
    idx = [slice(None)] * x.dim()
    for ax, st, en in zip(attrs["axes"], attrs["starts"], attrs["ends"]):
        idx[ax] = slice(st, en)
    return out(Out=x[tuple(idx)])


@register_op("squeeze", inputs=("X",), outputs=("Out",))
def squeeze(ctx, inputs, attrs):
    x = single(inputs, "X")
    axes = attrs.get("axes", None)
    if axes:
        axes = tuple(a % x.dim() for a in axes)
        for a in axes:
            if x.shape[a] != 1:    # jnp.squeeze raises; torch skips the axis
                raise ValueError(
                    f"squeeze: axis {a} has size {x.shape[a]}, not 1")
        return out(Out=x.squeeze(axes))
    return out(Out=x.squeeze())


@register_op("unsqueeze", inputs=("X",), outputs=("Out",))
def unsqueeze(ctx, inputs, attrs):
    x = single(inputs, "X")
    for ax in sorted(attrs["axes"]):
        x = x.unsqueeze(ax)
    return out(Out=x)


@register_op("lookup_table", inputs=("W", "Ids"), outputs=("Out",),
             no_grad_slots=("Ids",))
def lookup_table(ctx, inputs, attrs):
    """Embedding lookup (parity: operators/lookup_table_op.cc); its
    gradient is autograd's dense scatter-add into the table."""
    w = single(inputs, "W")
    ids = single(inputs, "Ids")
    if ids.dim() >= 2 and ids.shape[-1] == 1:
        ids = ids.squeeze(-1)
    res = F.embedding(ids.long(), w)
    padding_idx = attrs.get("padding_idx", -1)
    if padding_idx is not None and padding_idx >= 0:
        res = torch.where((ids != padding_idx)[..., None], res,
                          torch.zeros_like(res))
    return out(Out=res)


@register_op("range", inputs=(), outputs=("Out",))
def range_op(ctx, inputs, attrs):
    dtype = runtime_dtype(attrs.get("dtype", "int32"))
    return out(Out=torch.arange(attrs["start"], attrs["end"],
                                attrs.get("step", 1), dtype=dtype,
                                device=ctx.device))
