"""Multi-step trainer: the DeviceWorker of dataset-driven training.

Parity: the reference's dataset-driven trainers (framework/trainer.h
MultiTrainer, hogwild_worker.cc TrainFiles hot loop, executor.cc:182
RunFromDataset).  Counterpart of paddle_tpu/core/trainer.py, where the
hot loop is one jitted ``lax.scan`` over K staged batches.

Here a chunk of K batches runs as K eager steps of ONE lowered block
(core/lowering.py, with the fusion pass's knobs), the same function
``Executor.run`` runs:

* the chunk is stacked on the host and copied to the device once (from
  pinned memory, without blocking the host, on a card); step i reads its
  slice on the device;
* the mutable persistables (parameters, optimizer state) stay on the
  device from step to step; the persistables a step writes without
  reading (the JAX loop's ``extra``) go back to the scope after the
  chunk, with the final parameters;
* the chunk draws one seed (``Executor._next_seed``) and step i runs on
  ``fold_seed(seed, i)`` — the JAX loop's ``fold_in(rng, i)`` — so a
  threaded and an unthreaded run draw the same dropout;
* fetches stay on the device for the chunk, which ends with one host
  copy per fetch: the last step's values (and the chunk's mean when
  ``print_period`` or ``debug`` prints).

The scope reads and write-back, the ``run:<id>`` span and the count of
library loads after the first chunk are ``Executor.run``'s own
(``Executor._run_lowered``), as is the lowering cache's accounting
(``Executor._cached_lowering``).

Capturing the K steps as one CUDA graph is not done here.
"""
from __future__ import annotations

import numpy as np
import torch

from .._rng import fold_seed
from ..flags import flag
from .lowering import lower_block
from .types import runtime_dtype

__all__ = ["MultiStepLoop", "run_from_dataset"]


class MultiStepLoop:
    """K steps of one lowered block (built once per program and chunk
    signature)."""

    def __init__(self, program, feed_names, fetch_names, k_steps, device,
                 fuse_epilogues=True, fuse_block_epilogues=True):
        self.k = k_steps
        self.fetch_names = tuple(fetch_names)
        self.lowered = lower_block(
            program, 0, tuple(feed_names), self.fetch_names, device,
            fuse_epilogues=fuse_epilogues,
            fuse_block_epilogues=fuse_epilogues and fuse_block_epilogues)

    @property
    def fusion_plan(self):
        return self.lowered.fusion_plan

    def run(self, stacked, mut, const, seed):
        """Run the chunk: ``stacked`` maps each feed to its [K, ...]
        tensor on the device.  Returns (per-fetch [K, ...] device
        tensors, the persistables to write back: the final mutable ones
        and the last step's other written ones)."""
        fn = self.lowered.fn
        mut_names = self.lowered.mut_param_names
        steps, extra = [], {}
        for i in range(self.k):
            feeds = {n: t[i] for n, t in stacked.items()}
            fetches, new_persist = fn(feeds, mut, const, fold_seed(seed, i))
            mut = {n: new_persist.get(n, mut[n]) for n in mut_names}
            extra = {n: v for n, v in new_persist.items() if n not in mut}
            steps.append(fetches)
        fetched = [torch.stack([s[j] for s in steps])
                   for j in range(len(self.fetch_names))]
        return fetched, {**mut, **extra}


def _stage(chunk, block, device):
    """Stack a chunk's batches per feed on the host, in each variable's
    runtime dtype, and copy each stack to the device once (pinned and
    non-blocking on a card: PyTorch's caching host allocator records an
    event on the copy's stream and reuses the pinned block only after
    that event, so the buffer may be dropped at once)."""
    out = {}
    for name in chunk[0]:
        var = block._find_var_recursive(name)
        t = torch.from_numpy(np.ascontiguousarray(
            np.stack([b[name] for b in chunk])))
        if var is not None and var.dtype is not None:
            t = t.to(runtime_dtype(var.dtype))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device)
        out[name] = t
    return out


def run_from_dataset(executor, program, dataset, scope, fetch_list,
                     fetch_info=None, print_period=100, debug=False,
                     thread=0, fuse_epilogues=True,
                     fuse_block_epilogues=True):
    """Drive MultiStepLoop over a Dataset (parity: executor.py:1116
    train_from_dataset).  Returns the last step's fetched values.

    thread > 0 enables the multithreaded feed (parity:
    framework/hogwild_worker.cc TrainFiles / MultiTrainer thread pool):
    `thread` parser threads inside Dataset.batches() plus a background
    stager thread ("paddle_tpu-feed") assembling chunks, so host-side
    parse/pad overlaps the device's steps instead of starving them."""
    if flag("FLAGS_check_nan_inf"):
        # parity with the JAX trainer, whose loop is one jitted scan the
        # per-op scan cannot see into
        raise ValueError(
            "FLAGS_check_nan_inf is not supported with the in-graph "
            "dataset trainer (the whole multi-step loop is one jitted "
            "scan); drive the program with Executor.run per step to "
            "locate the faulty op, then turn the flag off to train")
    fetch_list = fetch_list or []
    fetch_names = [f.name if hasattr(f, "name") else str(f)
                   for f in fetch_list]
    fetch_info = fetch_info or fetch_names

    k = max(1, dataset.steps_per_dispatch)
    device = executor.device
    block = program.global_block()
    last_fetches = None
    step = 0

    def get_loop(chunk):
        """Loops are cached on the program (keyed as the JAX trainer's,
        with the device and the fusion knobs) so repeated epochs do not
        lower again."""
        sig = ("multistep", len(chunk),
               tuple(sorted((n, a.shape, str(a.dtype))
                            for n, a in chunk[0].items())),
               tuple(fetch_names), str(device), fuse_epilogues,
               fuse_block_epilogues)
        loop, _ = executor._cached_lowering(
            program, sig, lambda: MultiStepLoop(
                program, tuple(chunk[0].keys()), fetch_names, len(chunk),
                device, fuse_epilogues, fuse_block_epilogues))
        return loop

    def flush(chunk):
        nonlocal last_fetches, step
        loop = get_loop(chunk)
        stacked = _stage(chunk, block, device)
        seed = executor._next_seed(program)

        def body(mut, const):
            with torch.no_grad():
                return loop.run(stacked, mut, const, seed)

        fetched = executor._run_lowered(program, loop.lowered, scope, body,
                                        steps=len(chunk))
        step += len(chunk)
        if fetch_names:
            printing = debug or (print_period
                                 and step % print_period < len(chunk))
            if printing:
                host = [f.detach().cpu().numpy() for f in fetched]
                last_fetches = [h[-1] for h in host]
                msg = ", ".join(f"{info}={h.mean():.6f}"
                                for info, h in zip(fetch_info, host))
                print(f"[paddle_tpu_torch] step {step}: {msg}")
            else:
                last_fetches = [f[-1].detach().cpu().numpy()
                                for f in fetched]

    def shapes_of(batch):
        return {n: a.shape for n, a in batch.items()}

    def chunks():
        pending = []
        for batch in dataset.batches():
            # a batch with different shapes (e.g. drop_last=False
            # remainder) cannot share a stacked chunk — flush what we
            # have first
            if pending and shapes_of(batch) != shapes_of(pending[0]):
                yield pending
                pending = []
            pending.append(batch)
            if len(pending) == k:
                yield pending
                pending = []
        if pending:
            yield pending

    if thread and int(thread) > 0:
        from ..dataio.prefetch import background_iter

        dataset.set_thread(int(thread))
        for chunk in background_iter(chunks, capacity=4,
                                     name="paddle_tpu-feed"):
            flush(chunk)
    else:
        for chunk in chunks():
            flush(chunk)
    return last_fetches
