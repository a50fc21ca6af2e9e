"""SelectedRows and optimizer-auxiliary ops of the port.

Counterpart of the sparse-gradient, ModelAverage and DGC ops of
paddle_tpu/ops/misc2.py (parity: get_tensor_from_selected_rows_op.cc,
merge_selected_rows_op.cc, clip_op.h's SelectedRows branch,
average_accumulates_op.cc, dgc_clip_by_norm_op.cc).

A SelectedRows gradient is a (Values [n, dim], Rows [n]) pair of static
length n, as in the JAX package.  Duplicate rows merge in a fixed order:
a stable sort of the rows, then a segment sum over the sorted values
(``torch.segment_reduce``), so two runs give the same bits — no
atomics decide the order of an addition.  A row scatter never hands an
index past the table to a CUDA index op: the table is extended by one
dropped row, every padding or out-of-range row is routed there, and the
extra row is sliced off (``scatter_rows``).  Every op returns new
tensors and writes none of its inputs.
"""
from __future__ import annotations

import torch

from ..core.registry import out, register_op, single


def _merge_rows(v, rows, pad_row=0):
    """Static-shape duplicate-row merge of a (Values, Rows) pair
    (merge_selected_rows_op.cc; the JAX package's ``jnp.unique(rows,
    size=n, fill_value=pad_row)`` + ``segment_sum``): returns
    (merged [n, ...], uniq [n], valid [n]) — the distinct rows in
    ascending order, their summed values, then padding slots with row id
    ``pad_row``, zero values and ``valid`` False."""
    n = rows.shape[0]
    srt, perm = torch.sort(rows, stable=True)
    first = torch.ones(n, dtype=torch.bool, device=rows.device)
    first[1:] = srt[1:] != srt[:-1]
    seg = torch.cumsum(first, 0) - 1
    uniq = torch.full((n,), pad_row, dtype=rows.dtype,
                      device=rows.device).scatter(0, seg, srt)
    counts = torch.zeros(n, dtype=torch.long, device=rows.device) \
        .scatter_add(0, seg, torch.ones_like(seg))
    merged = torch.segment_reduce(v[perm], "sum", lengths=counts, axis=0,
                                  unsafe=True)
    return merged, uniq, counts > 0


def table_rows(rows, n):
    """The rows of a table of ``n`` rows that ``rows`` name, by a JAX
    scatter's index rule: a row in [-n, 0) wraps, one outside [-n, n)
    names the dropped row ``n`` (one past the end)."""
    r = rows.long()
    return torch.where((r >= -n) & (r < n), r.remainder(n),
                       torch.full_like(r, n))


def merge_table_rows(v, rows, n):
    """(merged values, their table rows) of a SelectedRows gradient of
    a table of ``n`` rows: duplicates (a wrapped negative id included)
    merged in a fixed order; padding and out-of-range rows name the
    dropped row ``n``."""
    merged, uniq, _ = _merge_rows(v, table_rows(rows, n), pad_row=n)
    return merged, uniq


def scatter_rows(table, idx, vals, accumulate):
    """``table`` with rows ``idx`` set to (or, with ``accumulate``,
    increased by) ``vals``, as a new tensor.  ``idx`` holds distinct rows
    of the table, or ``n``: those updates land on an extra row that is
    sliced off, so none reaches an index past the table."""
    n = table.shape[0]
    buf = torch.cat([table, table.new_zeros((1,) + tuple(table.shape[1:]))])
    buf.index_put_((idx,), vals.to(table.dtype), accumulate=accumulate)
    return buf[:n]


@register_op("get_tensor_from_selected_rows", inputs=("X",),
             outputs=("Out",))
def get_tensor_from_selected_rows(ctx, inputs, attrs):
    """get_tensor_from_selected_rows_op.cc: the identity, as in the JAX
    package (a dense gradient is already a tensor)."""
    return out(Out=single(inputs, "X"))


@register_op("merge_selected_rows", inputs=("X",), outputs=("Out",))
def merge_selected_rows(ctx, inputs, attrs):
    """merge_selected_rows_op.cc: the identity on a dense gradient, as in
    the JAX package."""
    return out(Out=single(inputs, "X"))


@register_op("squared_l2_norm_sparse", inputs=("Values", "Rows"),
             outputs=("Out",))
def squared_l2_norm_sparse(ctx, inputs, attrs):
    """Squared L2 norm of a SelectedRows grad, duplicate rows merged
    first so it equals squared_l2_norm of the densified gradient
    (reference: clip.py:398 merge_selected_rows +
    get_tensor_from_selected_rows before the square-sum)."""
    v = single(inputs, "Values")
    rows = single(inputs, "Rows")
    merged, _, _ = _merge_rows(v.float(), rows)
    return out(Out=merged.square().sum())


@register_op("clip_sparse", inputs=("Values", "Rows"),
             outputs=("OutValues", "OutRows"))
def clip_sparse(ctx, inputs, attrs):
    """Elementwise clip of a SelectedRows grad (clip_op.h SelectedRows
    branch): duplicates are merged BEFORE clipping — clip(sum) is the
    densified semantics, not sum(clip).  Padding slots carry row id
    ``pad_row`` (the table's length, one past its end) and zero values,
    so clip(0)=min never leaks into a row."""
    v = single(inputs, "Values")
    rows = single(inputs, "Rows")
    pad_row = int(attrs["pad_row"])
    merged, uniq = merge_table_rows(v, rows, pad_row)
    clipped = merged.clamp(float(attrs["min"]), float(attrs["max"]))
    clipped = clipped.masked_fill((uniq == pad_row)[:, None], 0.0)
    return out(OutValues=clipped, OutRows=uniq.to(rows.dtype))


@register_op("sparse_to_dense_grad", inputs=("Values", "Rows"),
             outputs=("Out",))
def sparse_to_dense_grad(ctx, inputs, attrs):
    """Densify a SelectedRows grad into a zero tensor of the parameter's
    shape (the reference's sum op does this implicitly when
    regularization adds a dense decay term, regularizer.py:42)."""
    v = single(inputs, "Values")
    rows = single(inputs, "Rows")
    shape = tuple(int(d) for d in attrs["shape"])
    merged, idx = merge_table_rows(v, rows, shape[0])
    return out(Out=scatter_rows(v.new_zeros(shape), idx, merged, False))


@register_op("average_accumulates",
             inputs=("param", "in_sum_1", "in_sum_2", "in_sum_3",
                     "in_num_accumulates", "in_old_num_accumulates",
                     "in_num_updates"),
             outputs=("out_sum_1", "out_sum_2", "out_sum_3",
                      "out_num_accumulates", "out_old_num_accumulates",
                      "out_num_updates"))
def average_accumulates(ctx, inputs, attrs):
    """average_accumulates_op.h (ModelAverage): rotate the three
    accumulator sums when num_updates passes max_average_window."""
    p = single(inputs, "param")
    s1 = single(inputs, "in_sum_1")
    s2 = single(inputs, "in_sum_2")
    s3 = single(inputs, "in_sum_3")
    na = single(inputs, "in_num_accumulates").reshape(())
    ona = single(inputs, "in_old_num_accumulates").reshape(())
    nu = single(inputs, "in_num_updates").reshape(())
    avg_w = float(attrs.get("average_window", 0))
    max_w = int(attrs.get("max_average_window", 10000))
    min_w = int(attrs.get("min_average_window", 10000))
    s1 = s1 + p
    na = na + 1
    nu = nu + 1
    # reference: fold sum_1 into sum_2 every kMaxNumAccumulates updates
    fold = (nu % 16384) == 0
    s2 = torch.where(fold, s2 + s1, s2)
    s1 = torch.where(fold, torch.zeros_like(s1), s1)
    thresh = torch.minimum(
        torch.full_like(nu, max_w), (nu.float() * avg_w).to(nu.dtype))
    rotate = (na >= min_w) & (na >= thresh)
    s3 = torch.where(rotate, s1 + s2, s3)
    new_s1 = torch.where(rotate, torch.zeros_like(s1), s1)
    new_s2 = torch.where(rotate, torch.zeros_like(s2), s2)
    new_ona = torch.where(rotate, na, ona)
    new_na = torch.where(rotate, torch.zeros_like(na), na)
    return {
        "out_sum_1": [new_s1], "out_sum_2": [new_s2], "out_sum_3": [s3],
        "out_num_accumulates": [new_na.reshape(1)],
        "out_old_num_accumulates": [new_ona.reshape(1)],
        "out_num_updates": [nu.reshape(1)],
    }


@register_op("dgc_clip_by_norm", inputs=("X", "current_step"),
             outputs=("Out",), no_grad_slots=("current_step",))
def dgc_clip_by_norm(ctx, inputs, attrs):
    """dgc_clip_by_norm_op.cc: clip_by_norm, active only once
    current_step >= rampup_begin_step."""
    x = single(inputs, "X")
    step = single(inputs, "current_step").reshape(())
    max_norm = float(attrs["max_norm"])
    begin = float(attrs.get("rampup_begin_step", 0.0))
    norm = x.square().sum().sqrt()
    clipped = torch.where(norm > max_norm, x * (max_norm / norm), x)
    return out(Out=torch.where(step >= begin, clipped, x))
