"""Differentiable collectives of sequence parallelism, as
``torch.autograd.Function``s over a process group:

* ``ring_shift`` — each rank sends its tensors to rank + 1 and receives
  rank - 1's (``lax.ppermute`` with the ring permutation); its backward
  shifts the cotangents the other way, which is ppermute's transpose.
* ``all_to_all`` — the tiled all-to-all of Ulysses (``lax.all_to_all(...,
  tiled=True)``): split along one axis, chunk j to rank j, the received
  chunks concatenated along another axis in rank order; its backward is
  the all-to-all with the two axes swapped.

A group of one rank (or ``None``: no process group) makes both the
identity, with nothing sent.

The Program lowering's collectives under a mesh (core/spmd.py,
core/lowering.py, parallel/pipeline.py, ops/moe.py), each over the group
of one named mesh axis (``DeviceMesh.get_group(axis)``):

* ``forward_sum`` — the sum over the group whose backward passes the
  cotangent through unscaled (``backward_sum`` is its dual);
* ``sum_both_ways`` — the sum whose backward sums the cotangents too
  (a statistic that every rank's rows feed and every rank reads:
  sync-BN's batch sums);
* ``all_gather`` — concatenation along a dim whose backward keeps the
  rank's slice (``gather_along`` without autograd);
* ``gather_whole`` — the same concatenation whose backward sums the
  cotangents over the group and keeps the rank's slice (a
  reduce-scatter), and ``take_rows`` — the rank's slice of a whole value
  whose backward puts the cotangent back in place among zeros: the
  data axis's row movers (core/spmd.py's rule: a rank's cotangent of a
  whole value is its share of the whole one);
* ``reduce_extreme``, ``reduce_prod``, ``reduce_logical`` — the max,
  min, product, and and or of the ranks' partial reductions, the first
  two with jnp.max's tie rule in their backward;
* ``gather_rows`` — the ragged all-gather of rows (each rank's count
  sent first), for SelectedRows gradients;
* ``sum_gradients`` — the bucketed sum of parameter gradients;
* ``exchange`` — point-to-point sends and receives (the pipeline's
  stage-to-stage transfers), ``broadcast_from`` one rank's tensor.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["group_rank_size", "shift", "ring_shift", "all_to_all",
           "forward_sum", "backward_sum", "sum_both_ways", "all_gather",
           "gather_along", "gather_whole", "take_rows", "reduce_extreme",
           "reduce_prod", "reduce_logical", "gather_rows",
           "sum_gradients", "broadcast_from", "exchange"]


def group_rank_size(group):
    """(rank within ``group``, its size); (0, 1) for ``None``."""
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def shift(tensors, group, step=1):
    """Each of ``tensors`` sent ``step`` ranks on around ``group``'s ring
    (to rank + step, received from rank - step) in one batch of
    point-to-point operations; ``None`` entries pass through.  Not
    differentiable: the flash ring's backward calls it itself."""
    rank, size = group_rank_size(group)
    if size == 1:
        return list(tensors)
    dst = dist.get_global_rank(group, (rank + step) % size)
    src = dist.get_global_rank(group, (rank - step) % size)
    ops, outs = [], []
    for t in tensors:
        if t is None:
            outs.append(None)
            continue
        t = t.contiguous()
        recv = torch.empty_like(t)
        ops += [dist.P2POp(dist.isend, t, dst, group),
                dist.P2POp(dist.irecv, recv, src, group)]
        outs.append(recv)
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return outs


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *tensors):
        ctx.group = group
        return tuple(shift(tensors, group, 1))

    @staticmethod
    def backward(ctx, *grads):
        return (None, *shift(grads, ctx.group, -1))


def ring_shift(tensors, group):
    """``shift`` by one rank, differentiable: the backward shifts the
    cotangents back.  Every rank must use every shifted tensor (or none),
    so that all ranks run the backward shifts in the same order."""
    if group_rank_size(group)[1] == 1:
        return list(tensors)
    live = [t for t in tensors if t is not None]
    moved = iter(_RingShift.apply(group, *live))
    return [None if t is None else next(moved) for t in tensors]


def _all_to_all(x, group, split_axis, concat_axis):
    size = group_rank_size(group)[1]
    sends = [c.contiguous() for c in x.chunk(size, dim=split_axis)]
    recvs = [torch.empty_like(c) for c in sends]
    dist.all_to_all(recvs, sends, group=group)
    return torch.cat(recvs, dim=concat_axis)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.args = (group, split_axis, concat_axis)
        return _all_to_all(x, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        group, split_axis, concat_axis = ctx.args
        return _all_to_all(g, group, concat_axis, split_axis), None, None, None


def all_to_all(x, group, split_axis, concat_axis):
    """Tiled all-to-all over ``group``: ``x`` split into group-size
    chunks along ``split_axis`` (which must divide), chunk j to rank j,
    the received chunks concatenated along ``concat_axis`` in rank
    order.  Differentiable."""
    size = group_rank_size(group)[1]
    if x.shape[split_axis] % size:
        raise ValueError(f"all_to_all: axis {split_axis} of {tuple(x.shape)}"
                         f" does not split into {size} chunks")
    if size == 1:
        return x
    return _AllToAll.apply(x, group, split_axis, concat_axis)


# -- the collectives of the Program lowering under a mesh ---------------------
# (data parallelism, ZeRO-1, sharded parameters, pipeline stages, MoE).
# Unlike the ring's, these run whenever the axis has a process group, a
# one-rank group included (the data-parallel step on one card still goes
# through its all-reduce); ``None`` (no process group) is the identity.

class _ForwardSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def forward_sum(x, group):
    """The sum of ``x`` over ``group``'s ranks; the backward passes the
    cotangent through unscaled.  Every rank computes the same value from
    the sum (a global loss), so each rank's cotangent is already the
    whole one: summing it again (``torch.distributed.nn``'s all_reduce,
    or ``psum``'s transpose under ``shard_map``) would scale the gradient
    by the group's size."""
    if group is None:
        return x
    return _ForwardSum.apply(x, group)


class _BackwardSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, tally):
        ctx.group, ctx.tally = group, tally
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        if ctx.tally is not None:
            ctx.tally["backward_sum"] += 1
        return g, None, None


def backward_sum(x, group, tally=None):
    """``x`` itself; the backward sums the cotangent over ``group`` (the
    dual of :func:`forward_sum`: a value every rank holds whole, each
    rank using it for its own part of the work, as the expert ranks use
    the tokens and the gates).  ``tally`` (a Counter): its
    ``backward_sum`` entry counts the backward's all-reduces."""
    if group is None:
        return x
    return _BackwardSum.apply(x, group, tally)


class _SumBothWays(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def sum_both_ways(x, group):
    """The sum of ``x`` over ``group``, whose backward sums the
    cotangents over ``group`` as well: each rank's cotangent of the sum
    is only its own rows' share (the sum feeds every rank's rows, as a
    batch statistic does), and every rank's ``x`` owes the whole of it.
    ``forward_sum``'s identity backward would drop the other ranks'
    shares."""
    if group is None:
        return x
    return _SumBothWays.apply(x, group)


def gather_along(x, group, dim=0):
    """The ranks' ``x`` concatenated along ``dim`` in rank order (not
    differentiable)."""
    if group is None:
        return x
    size = dist.get_world_size(group)
    x = x.movedim(dim, 0).contiguous()
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts).movedim(0, dim)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.args = (group, dim, x.shape[dim])
        return gather_along(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        group, dim, n = ctx.args
        rank = dist.get_rank(group)
        return g.narrow(dim, rank * n, n), None, None


def all_gather(x, group, dim=0):
    """The ranks' ``x`` concatenated along ``dim`` in rank order; the
    backward keeps the rank's own slice of the cotangent (each rank
    computes the same function of the gathered value, so its cotangent
    of its own slice is whole)."""
    if group is None:
        return x
    return _AllGather.apply(x, group, dim)


def _rank_slice(x, group, dim):
    """The rank's equal part of ``x`` along ``dim`` (raises when the
    group's size does not divide it)."""
    rank, size = group_rank_size(group)
    n = x.shape[dim]
    if n % size:
        raise ValueError(f"a dim of {n} rows does not split into {size} "
                         f"ranks")
    per = n // size
    return x.narrow(dim, rank * per, per)


class _GatherWhole(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.args = (group, dim)
        return gather_along(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        group, dim = ctx.args
        g = g.contiguous().clone()
        dist.all_reduce(g, group=group)
        return _rank_slice(g, group, dim).contiguous(), None, None


def gather_whole(x, group, dim=0):
    """The ranks' ``x`` concatenated along ``dim`` in rank order, every
    rank then computing on the whole value; the backward sums the ranks'
    cotangent shares and keeps the rank's slice (a reduce-scatter)."""
    if group is None:
        return x
    return _GatherWhole.apply(x, group, dim)


class _TakeRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.args = (group, dim, tuple(x.shape))
        return _rank_slice(x, group, dim).clone()

    @staticmethod
    def backward(ctx, g):
        group, dim, shape = ctx.args
        full = g.new_zeros(shape)
        _rank_slice(full, group, dim).copy_(g)
        return full, None, None


def take_rows(x, group, dim=0):
    """The rank's equal part of a whole ``x`` along ``dim``; the backward
    puts the rank's cotangent in place among zeros (its share of the
    whole value's cotangent)."""
    if group is None:
        return x
    return _TakeRows.apply(x, group, dim)


class _ReduceExtreme(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, ties, group, kind):
        out = y.clone()
        dist.all_reduce(out, op=dist.ReduceOp.MAX if kind == "max"
                        else dist.ReduceOp.MIN, group=group)
        ctx.save_for_backward(y, out, ties)
        ctx.group = group
        return out

    @staticmethod
    def backward(ctx, g):
        y, out, ties = ctx.saved_tensors
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        mine = (y == out).to(ties.dtype) * ties
        total = mine.clone()
        dist.all_reduce(total, group=ctx.group)
        return g * (mine / total).to(g.dtype), None, None, None


def reduce_extreme(y, ties, group, kind):
    """The max (``kind`` "max") or min of the ranks' partial reductions
    ``y``; ``ties`` counts, for each element of ``y``, the rank's input
    elements equal to it.  The backward sums the cotangent shares and
    hands each rank the part of its tied elements among every rank's, so
    the local reduction's own backward splits it evenly over the ties:
    jnp.max's rule over the global batch."""
    if group is None:
        return y
    return _ReduceExtreme.apply(y, ties.to(torch.float32), group, kind)


class _ReduceProd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, group):
        rank, size = group_rank_size(group)
        parts = [torch.empty_like(y) for _ in range(size)]
        dist.all_gather(parts, y.contiguous(), group=group)
        parts = torch.stack(parts)
        ctx.save_for_backward(parts)
        ctx.group, ctx.rank = group, rank
        return parts.prod(0)

    @staticmethod
    def backward(ctx, g):
        (parts,) = ctx.saved_tensors
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        others = torch.cat([parts[:ctx.rank], parts[ctx.rank + 1:]])
        return g * others.prod(0), None


def reduce_prod(y, group):
    """The product of the ranks' partial products ``y``; the backward
    multiplies the summed cotangent by the other ranks' partials (exact
    where the rank's own partial is zero)."""
    if group is None:
        return y
    return _ReduceProd.apply(y, group)


def reduce_logical(y, group, kind):
    """The and (``kind`` "all") or or ("any") of the ranks' booleans
    ``y`` (no gradient)."""
    if group is None:
        return y
    v = y.to(torch.int32)
    dist.all_reduce(v, op=dist.ReduceOp.MIN if kind == "all"
                    else dist.ReduceOp.MAX, group=group)
    return v.to(y.dtype)


def gather_rows(x, group):
    """The ranks' ``x`` concatenated along dim 0 in rank order, where
    each rank's row count may differ: the counts go first, then the rows
    padded to the largest count (not differentiable)."""
    if group is None:
        return x
    size = dist.get_world_size(group)
    n = torch.tensor([x.shape[0]], dtype=torch.int64, device=x.device)
    counts = [torch.empty_like(n) for _ in range(size)]
    dist.all_gather(counts, n, group=group)
    counts = [int(c) for c in counts]
    top = max(counts)
    pad = x.new_zeros((top,) + tuple(x.shape[1:]))
    pad[:x.shape[0]] = x
    parts = [torch.empty_like(pad) for _ in range(size)]
    dist.all_gather(parts, pad, group=group)
    return torch.cat([p[:c] for p, c in zip(parts, counts)])


#: bytes of one bucket of the gradient sum
BUCKET_BYTES = 64 << 20


def sum_gradients(tensors, group, bucket_bytes=BUCKET_BYTES):
    """Each tensor summed over ``group``, in buckets: tensors of one dtype
    are copied into flat buffers of up to ``bucket_bytes``, each buffer
    all-reduced once, and the sums copied out (the reference's
    fuse_all_reduce_op_pass).  Returns new tensors in the input order;
    the inputs are not changed."""
    tensors = list(tensors)
    if group is None or not tensors:
        return tensors
    out = [None] * len(tensors)
    by_dtype = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault((t.dtype, t.device), []).append(i)
    for idx in by_dtype.values():
        bucket, nbytes = [], 0
        for k, i in enumerate(idx):
            t = tensors[i]
            bucket.append(i)
            nbytes += t.numel() * t.element_size()
            if nbytes >= bucket_bytes or k == len(idx) - 1:
                flat = torch.cat([tensors[j].reshape(-1) for j in bucket])
                dist.all_reduce(flat, group=group)
                off = 0
                for j in bucket:
                    n = tensors[j].numel()
                    out[j] = flat[off:off + n].view_as(tensors[j])
                    off += n
                bucket, nbytes = [], 0
    return out


def broadcast_from(x, group, src):
    """``x`` of group rank ``src`` on every rank of ``group`` (a new
    tensor; ``x`` gives the shape and dtype elsewhere)."""
    if group is None:
        return x
    x = x.contiguous().clone()
    dist.broadcast(x, dist.get_global_rank(group, src), group=group)
    return x


def exchange(sends, recvs, group):
    """Point-to-point transfers over ``group`` in one batch: ``sends`` is
    [(tensor, group rank)], ``recvs`` [(like tensor, group rank)] (a
    buffer shaped like the tensor is received).  Returns the received
    tensors in order.  Both ends of a transfer must post it in the same
    call, as the pipeline's ticks do."""
    ops, got = [], []
    for t, dst in sends:
        ops.append(dist.P2POp(dist.isend, t.contiguous(),
                              dist.get_global_rank(group, dst), group))
    for like, src in recvs:
        buf = torch.empty_like(like)
        got.append(buf)
        ops.append(dist.P2POp(dist.irecv, buf,
                              dist.get_global_rank(group, src), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return got
