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
"""
from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["group_rank_size", "shift", "ring_shift", "all_to_all"]


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
