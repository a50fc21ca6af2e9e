"""All-reduce bandwidth microbench (reference infra analog:
operators/benchmark/op_tester.cc — config-driven repeatable op timing).

Counterpart of paddle_tpu/distributed/allreduce_bench.py: it times
``torch.distributed.all_reduce`` over the default group (or ``group``),
the collective the data-parallel gradient sum runs, and reports
algorithmic bandwidth under the ring model: wire bytes per rank =
2(n-1)/n · payload.  In one process the all-reduce moves nothing, so
the entry records n=1 with bandwidth None: the harness exists so the
number appears on a group of cards.
"""
from __future__ import annotations

import time

import torch
import torch.distributed as dist

from .._device import resolve_device

__all__ = ["allreduce_bandwidth"]


def allreduce_bandwidth(sizes_mb=(4, 16, 64), reps=5, inner=8, group=None,
                        device=None):
    """Returns a list of dicts: payload MB, min seconds per all-reduce,
    GB/s (ring model; None when n == 1).

    Timing discipline (the JAX harness's): ``inner`` all-reduces are
    CHAINED — each runs in place on the previous one's result, so its
    input depends on the last — and the per-all-reduce time is
    total/inner.  On the card the chain sits between two CUDA events
    (device time); on the CPU between host clock reads.  ``device`` is
    the card unless the caller asks for the CPU; the process group must
    be initialized."""
    if not dist.is_initialized():
        raise RuntimeError("allreduce_bandwidth needs an initialized "
                           "process group (init_process_group)")
    device = resolve_device(device)
    n = dist.get_world_size(group)
    on_card = device.type == "cuda"
    results = []
    for mb in sizes_mb:
        num = int(mb * (1 << 20)) // 4
        x = torch.zeros(num, dtype=torch.float32, device=device)

        def chain():
            for _ in range(inner):
                dist.all_reduce(x, group=group)

        chain()                              # warmup (NCCL's set-up)
        best = float("inf")
        for _ in range(reps):
            if on_card:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize(device)
                start.record()
                chain()
                end.record()
                end.synchronize()
                secs = start.elapsed_time(end) / 1e3
            else:
                t0 = time.perf_counter()
                chain()
                secs = time.perf_counter() - t0
            best = min(best, secs)
        per_ar = best / inner
        wire = 2.0 * (n - 1) / n * num * 4
        results.append({
            "payload_mb": mb,
            "n_devices": n,
            "min_s": round(per_ar, 6),
            "gbps": None if n == 1 else round(wire / per_ar / 1e9, 3),
            "reps": reps,
            "inner_chained": inner,
            "model": "ring 2(n-1)/n",
        })
    return results
