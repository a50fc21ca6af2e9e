"""Tensor-manipulation ops.

Counterpart of paddle_tpu/ops/tensor.py, op for op, plus
``assign_value`` (paddle_tpu/initializer.py registers it there) (parity:
the reference's assign/cast/concat/split/reshape/transpose/slice/gather/
stack/fill_constant/sum/... operator files).  Views where torch gives
them (slice, transpose, squeeze, unstack): a slice of the packed qkv
projection reaches the flash-attention kernel as a strided view, not a
copy.
"""
from __future__ import annotations

import functools
import math

import numpy as np
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


@register_op("assign_value", inputs=(), outputs=("Out",))
def assign_value(ctx, inputs, attrs):
    """A constant baked into the attrs (layers.assign of a numpy array)."""
    arr = np.asarray(attrs["values"])
    t = torch.tensor(arr, dtype=runtime_dtype(attrs.get("dtype", "float32")),
                     device=ctx.device)
    return out(Out=t.reshape(tuple(attrs["shape"])))


@register_op("cast", inputs=("X",), outputs=("Out",))
def cast(ctx, inputs, attrs):
    dtype = runtime_dtype(attrs.get("out_dtype", attrs.get("dtype", "float32")))
    x = single(inputs, "X")
    if x.is_floating_point() and dtype != torch.bool \
            and not dtype.is_floating_point and not dtype.is_complex:
        return out(Out=_saturating_cast(x, dtype))
    return out(Out=x.to(dtype))


def _saturating_cast(x, dtype):
    """Float to integer as XLA's convert: NaN gives 0, and a value past
    the type's range (an infinity included) gives its nearest end.
    Tensor.to leaves those conversions undefined (int32 NaN -> INT_MIN,
    uint8 300.0 -> 44).  A clamp to the float type's values nearest the
    range from inside it and a NaN -> 0 keep only exact conversions; an
    end the float type cannot hold (int32's max in float32) is set
    after, where the input passed it.  Three ops (five for such an end):
    the decoder's step casts its token buffer each step."""
    info = torch.iinfo(dtype)
    lo, hi = _cast_bounds(x.dtype, dtype)
    y = x.clamp(lo, hi).nan_to_num_(0.0).to(dtype)
    if hi < info.max:
        y = y.masked_fill(x > hi, info.max)
    if lo > info.min:
        y = y.masked_fill(x < lo, info.min)
    return y


@functools.lru_cache(maxsize=None)
def _cast_bounds(float_dtype, int_dtype):
    """(lo, hi): the values of ``float_dtype`` nearest to ``int_dtype``'s
    range from inside it (its finite max where the range is wider)."""
    fi, ii = torch.finfo(float_dtype), torch.iinfo(int_dtype)

    def inside(end):
        v = float(torch.tensor(float(end), dtype=torch.float64)
                  .to(float_dtype))
        if math.isinf(v):
            return math.copysign(fi.max, end)
        if abs(v) > abs(end):
            # rounded past the end (2^k - 1 -> 2^k): one spacing back
            v -= math.copysign(abs(v) * fi.eps / 2, end)
        return v

    return inside(ii.min), inside(ii.max)


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


@register_op("concat", inputs=("X",), outputs=("Out",))
def concat(ctx, inputs, attrs):
    return out(Out=torch.cat(list(inputs["X"]), dim=attrs.get("axis", 0)))


@register_op("split", inputs=("X",), outputs=("Out",))
def split(ctx, inputs, attrs):
    x = single(inputs, "X")
    axis = attrs.get("axis", 0)
    sections = attrs.get("sections", None)
    if sections:
        idx, acc = [], 0
        for s in sections[:-1]:
            acc += s
            idx.append(acc)
        parts = torch.tensor_split(x, idx, dim=axis)
    else:
        num = attrs.get("num", 0)
        if x.shape[axis] % num:
            raise ValueError(f"split: axis {axis} of size {x.shape[axis]} "
                             f"does not divide into {num} parts")
        parts = torch.split(x, x.shape[axis] // num, dim=axis)
    return {"Out": list(parts)}


@register_op("slice", inputs=("Input",), outputs=("Out",))
def slice_op(ctx, inputs, attrs):
    x = single(inputs, "Input")
    idx = [slice(None)] * x.dim()
    for ax, st, en in zip(attrs["axes"], attrs["starts"], attrs["ends"]):
        idx[ax] = slice(st, en)
    return out(Out=x[tuple(idx)])


@register_op("stack", inputs=("X",), outputs=("Out",))
def stack(ctx, inputs, attrs):
    return out(Out=torch.stack(list(inputs["X"]), dim=attrs.get("axis", 0)))


@register_op("unstack", inputs=("X",), outputs=("Y",))
def unstack(ctx, inputs, attrs):
    x = single(inputs, "X")
    return {"Y": list(torch.unbind(x, dim=attrs.get("axis", 0)))}


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


@register_op("expand", inputs=("X",), outputs=("Out",))
def expand(ctx, inputs, attrs):
    return out(Out=torch.tile(single(inputs, "X"),
                              tuple(attrs["expand_times"])))


@register_op("gather", inputs=("X", "Index"), outputs=("Out",),
             no_grad_slots=("Index",))
def gather(ctx, inputs, attrs):
    """jnp.take(x, index, axis): the result's shape is x's with ``axis``
    replaced by index's shape (a scalar index drops the axis)."""
    x = single(inputs, "X")
    index = single(inputs, "Index")
    axis = attrs.get("axis", 0) % x.dim()
    safe, invalid = _take_index(index, x.shape[axis])
    picked = torch.index_select(x, axis, safe.reshape(-1))
    picked = picked.reshape(tuple(x.shape[:axis]) + tuple(index.shape)
                            + tuple(x.shape[axis + 1:]))
    invalid = invalid.reshape((1,) * axis + tuple(index.shape)
                              + (1,) * (x.dim() - axis - 1))
    return out(Out=_fill_invalid(picked, invalid))


def _take_index(index, n):
    """jnp.take's default index rule over an axis of ``n``: an index in
    [-n, 0) wraps, one outside [-n, n) selects the fill row.  Returns
    (an index in [0, n), int64; the mask of the entries to fill), so that
    no index out of range reaches a gather kernel (on the card that is a
    device-side assert).  Three ops: a decode step is host-bound."""
    idx = index.long()
    return idx.remainder(n), idx.clamp(-n, n - 1) != idx


def _fill_invalid(picked, invalid):
    """``picked`` with the rows where ``invalid`` holds set to jnp.take's
    fill value: NaN for floats, True for bool, the type's largest value
    for unsigned and its smallest for signed integers.  The gradient of
    a filled row is zero."""
    dt = picked.dtype
    if dt.is_floating_point or dt.is_complex:
        fill = float("nan")
    elif dt == torch.bool:
        fill = True
    else:
        info = torch.iinfo(dt)
        fill = info.max if info.min == 0 else info.min
    return picked.masked_fill(invalid, fill)


@register_op("scatter", inputs=("X", "Ids", "Updates"), outputs=("Out",),
             no_grad_slots=("Ids",))
def scatter(ctx, inputs, attrs):
    x = single(inputs, "X")
    ids = single(inputs, "Ids").long()
    upd = single(inputs, "Updates")
    return out(Out=torch.index_put(
        x, (ids,), upd, accumulate=not attrs.get("overwrite", True)))


@register_op("one_hot", inputs=("X",), outputs=("Out",),
             no_grad_slots=("X",))
def one_hot(ctx, inputs, attrs):
    """jax.nn.one_hot: an index outside [0, depth) gives a zero row."""
    x = single(inputs, "X")
    if x.dim() >= 2 and x.shape[-1] == 1:
        x = x.squeeze(-1)
    depth = torch.arange(attrs["depth"], device=x.device)
    return out(Out=(x.long().unsqueeze(-1) == depth).to(torch.float32))


class _Lookup(torch.autograd.Function):
    """``F.embedding`` whose table gradient sums a repeated id's rows in
    a fixed order (ops/misc2.py's ``merge_table_rows`` and
    ``scatter_rows``, the SelectedRows path's): CUDA's embedding
    backward adds them in an order that changes from run to run, so two
    runs of one step parted in the last bits of a row many ids read
    (the type embedding's row 0, read by every token)."""

    @staticmethod
    def forward(ctx, w, ids):
        ctx.save_for_backward(ids)
        ctx.table_shape = w.shape
        return F.embedding(ids, w)

    @staticmethod
    def backward(ctx, g):
        from .misc2 import merge_table_rows, scatter_rows

        ids, = ctx.saved_tensors
        merged, rows = merge_table_rows(g.reshape(-1, g.shape[-1]),
                                        ids.reshape(-1),
                                        ctx.table_shape[0])
        return scatter_rows(g.new_zeros(ctx.table_shape), rows, merged,
                            accumulate=False), None


def embedding_rows(w, ids):
    """The rows of table ``w`` at ``ids`` under jnp.take's index rule (a
    negative id wraps, one past the table gives a NaN row), through
    ``_Lookup`` when the table takes a gradient."""
    safe, invalid = _take_index(ids, w.shape[0])
    looked = (_Lookup.apply(w, safe)
              if torch.is_grad_enabled() and w.requires_grad
              else F.embedding(safe, w))
    return _fill_invalid(looked, invalid[..., None])


@register_op("lookup_table", inputs=("W", "Ids"), outputs=("Out",),
             no_grad_slots=("Ids",))
def lookup_table(ctx, inputs, attrs):
    """Embedding lookup (parity: operators/lookup_table_op.cc); its
    gradient is the dense table of each id's summed rows (``_Lookup``)."""
    w = single(inputs, "W")
    ids = single(inputs, "Ids")
    if ids.dim() >= 2 and ids.shape[-1] == 1:
        ids = ids.squeeze(-1)
    res = embedding_rows(w, ids)
    padding_idx = attrs.get("padding_idx", -1)
    if padding_idx is not None and padding_idx >= 0:
        res = res.masked_fill((ids == padding_idx)[..., None], 0.0)
    return out(Out=res)


@register_op("lookup_table_sparse_grad", inputs=("Ids", "OutGrad"),
             outputs=("Values", "Rows"),
             no_grad_slots=("Ids", "OutGrad"))
def lookup_table_sparse_grad(ctx, inputs, attrs):
    """SelectedRows-form embedding gradient (parity:
    operators/lookup_table_op.cc grad with is_sparse=True +
    framework/selected_rows.h:32): (Rows=[n] ids, Values=[n, dim]
    cotangents) instead of a dense [vocab, dim] buffer — O(batch·dim)
    memory regardless of vocab.  The ids stay as fed, as in the JAX
    package; the consumers (ops/misc2.py, ops/optim.py) wrap an id in
    [-vocab, 0) and drop one outside [-vocab, vocab), the forward's rule."""
    ids = single(inputs, "Ids")
    og = single(inputs, "OutGrad")
    if ids.dim() >= 2 and ids.shape[-1] == 1:
        ids = ids.squeeze(-1)
    rows = ids.reshape(-1)
    values = og.reshape(-1, og.shape[-1])
    padding_idx = attrs.get("padding_idx", -1)
    if padding_idx is not None and padding_idx >= 0:
        values = values.masked_fill((rows == padding_idx)[:, None], 0.0)
    return out(Values=values, Rows=rows)


@register_op("shape", inputs=("Input",), outputs=("Out",),
             no_grad_slots=("Input",))
def shape_op(ctx, inputs, attrs):
    x = single(inputs, "Input")
    return out(Out=torch.tensor(tuple(x.shape), dtype=torch.int32,
                                device=x.device))


@register_op("fill_constant_batch_size_like", inputs=("Input",),
             outputs=("Out",), no_grad_slots=("Input",))
def fill_constant_batch_size_like(ctx, inputs, attrs):
    x = single(inputs, "Input")
    shape = list(attrs["shape"])
    shape[attrs.get("output_dim_idx", 0)] = x.shape[
        attrs.get("input_dim_idx", 0)]
    dtype = runtime_dtype(attrs.get("dtype", "float32"))
    return out(Out=torch.full(tuple(shape), attrs.get("value", 0.0),
                              dtype=dtype, device=x.device))


@register_op("range", inputs=(), outputs=("Out",))
def range_op(ctx, inputs, attrs):
    dtype = runtime_dtype(attrs.get("dtype", "int32"))
    return out(Out=torch.arange(attrs["start"], attrs["end"],
                                attrs.get("step", 1), dtype=dtype,
                                device=ctx.device))


@register_op("tril_triu", inputs=("X",), outputs=("Out",))
def tril_triu(ctx, inputs, attrs):
    x = single(inputs, "X")
    diagonal = attrs.get("diagonal", 0)
    if attrs.get("lower", True):
        return out(Out=torch.tril(x, diagonal))
    return out(Out=torch.triu(x, diagonal))


@register_op("pad", inputs=("X",), outputs=("Out",))
def pad(ctx, inputs, attrs):
    x = single(inputs, "X")
    paddings = attrs["paddings"]  # flat [before0, after0, before1, ...]
    if any(p < 0 for p in paddings):
        # jnp.pad refuses them; F.pad would crop
        raise ValueError(f"pad: negative paddings {list(paddings)}")
    # F.pad takes the last dim's pair first
    flat = []
    for i in reversed(range(x.dim())):
        flat += [paddings[2 * i], paddings[2 * i + 1]]
    return out(Out=F.pad(x, flat, value=attrs.get("pad_value", 0.0)))


@register_op("where", inputs=("Condition", "X", "Y"), outputs=("Out",),
             no_grad_slots=("Condition",))
def where(ctx, inputs, attrs):
    return out(Out=torch.where(single(inputs, "Condition"),
                               single(inputs, "X"), single(inputs, "Y")))


@register_op("increment", inputs=("X",), outputs=("Out",))
def increment(ctx, inputs, attrs):
    """x + step in x's own dtype (the LR schedules' int64 step counter)."""
    x = single(inputs, "X")
    return out(Out=x + torch.full((), attrs.get("step", 1.0), dtype=x.dtype,
                                  device=x.device))
