"""Host-driven cross-process collectives over ``torch.distributed``,
shared by the collective fleet's LocalSGD and the fleet's process-group
start.

Counterpart of paddle_tpu/distributed/collectives.py: where the JAX
package joins one ``jax.distributed`` job and gathers over the global
mesh, the port starts the default process group and all-reduces (or
all-gathers) over it.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["cross_process_mean", "dgc_sparse_allreduce",
           "ensure_distributed_initialized"]


def ensure_distributed_initialized(coordinator, num_processes,
                                   process_id):
    """Start the default process group exactly once (shared by
    ``fleet.init``): ``init_process_group`` at ``tcp://<coordinator>``
    with this world size and rank.  The backend is the launcher's
    PADDLE_DIST_BACKEND, else the one this rank's device calls for
    (:func:`~paddle_tpu_torch.distributed.launch.trainer_device`: gloo on
    the CPU, NCCL on a card).  An NCCL rank first selects its card: the
    index of its device, else its rank modulo the cards."""
    if dist.is_initialized():
        return
    if coordinator is None:
        raise RuntimeError(
            "no coordinator address: set PADDLE_COORDINATOR or "
            "PADDLE_TRAINER_ENDPOINTS (the launcher sets both)")
    from .launch import trainer_device

    device = trainer_device()
    backend = os.environ.get("PADDLE_DIST_BACKEND") or (
        "gloo" if device.type == "cpu" else "nccl")
    if backend == "nccl":
        torch.cuda.set_device(device.index if device.index is not None
                              else process_id % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=int(num_processes),
                            rank=int(process_id))


def _host(arr):
    if torch.is_tensor(arr):
        return arr.detach().cpu().numpy()
    return np.asarray(arr)


def cross_process_mean(arr, group=None) -> np.ndarray:
    """Mean of ``arr`` (an array or a tensor) across the processes of the
    default group (or ``group``); identity in one process.

    Returns HOST numpy with ``np.mean``'s dtype and accumulation, as the
    JAX package's ``np.mean`` over the gathered stack: an ``all_reduce``
    sum over the group (on the card under NCCL) in float64 for integer
    and bool inputs and in at least float32 for floating ones, divided
    by the group's size, then cast to the dtype ``np.mean`` returns."""
    if not dist.is_initialized() or dist.get_world_size(group) <= 1:
        return _host(arr)
    t = arr.detach() if torch.is_tensor(arr) else torch.from_numpy(
        np.ascontiguousarray(arr))
    result = np.mean(np.zeros(1, _host(t[:0]).dtype)).dtype
    if t.is_floating_point():
        acc = torch.promote_types(t.dtype, torch.float32)
    else:
        acc = torch.float64
    if dist.get_backend(group) == "nccl":
        t = t.to(torch.device("cuda", torch.cuda.current_device()))
    t = t.to(acc, copy=True)
    dist.all_reduce(t, group=group)
    return (t / dist.get_world_size(group)).cpu().numpy().astype(
        result, copy=False)


def dgc_sparse_allreduce(grad, k, group=None):
    """Wire-level DGC gradient exchange (parity: the reference's
    sparse_all_reduce_op_handle — the part of DGC, arXiv:1712.01887, that
    optimizer.DGCMomentumOptimizer leaves to the interconnect).

    Each rank contributes only its top-|k| entries (ties: the lower index
    first, as ``jax.lax.top_k``): the indices and values are
    ``all_gather``ed (2k words a rank on the wire) and scatter-added.
    Returns ``(reduced, residual)``: ``reduced`` is the dense sum of every
    rank's top-k contribution (divide by the world size for a mean);
    ``residual = grad - own_topk`` is the local error-feedback term to
    fold into the next step's gradient.  Without a process group, or in
    one process, the group is this rank alone."""
    flat = grad.reshape(-1)
    idx = torch.sort(flat.abs(), descending=True, stable=True)[1][:k]
    sel = flat[idx]
    if dist.is_initialized() and dist.get_world_size(group) > 1:
        n = dist.get_world_size(group)
        all_idx = [torch.empty_like(idx) for _ in range(n)]
        all_val = [torch.empty_like(sel) for _ in range(n)]
        dist.all_gather(all_idx, idx, group=group)
        dist.all_gather(all_val, sel, group=group)
        all_idx, all_val = torch.cat(all_idx), torch.cat(all_val)
    else:
        all_idx, all_val = idx, sel
    reduced = torch.zeros_like(flat).index_add_(0, all_idx, all_val)
    residual = flat.clone()
    residual[idx] = 0.0
    return reduced.reshape(grad.shape), residual.reshape(grad.shape)
