"""Executor: run Programs on one device.

Counterpart of paddle_tpu/core/executor.py (parity: framework/executor.cc
Executor::Run and python/paddle/fluid/executor.py:432).  ``run`` lowers
(program, feed signature, fetch list) once into a Python function over
torch tensors (core/lowering.py), caches it on the program, and runs it
eagerly: every op dispatches its own PyTorch calls and CUDA kernels.

Fusion: ``run`` takes a program or a ``compiler.CompiledProgram``; the
GEMM-epilogue fusion pass (core/fusion.py) and its block patterns are on
unless the CompiledProgram's ``BuildStrategy`` turns them off
(``fuse_epilogues``, ``fuse_block_epilogues``), as in the JAX package.
The knobs join the cache signature.  The JAX package's environment
switches (``PADDLE_TPU_FUSE_EPILOGUES``, ``PADDLE_TPU_FUSE_BLOCK_EPILOGUES``)
and AMP are not carried over.

Flags (flags.py), as in the JAX executor: under ``FLAGS_check_nan_inf``
the lowering scans every op's floating outputs (core/lowering.py; one
host sync per op on the card) and the fusion pass is off, and the flag
joins the cache signature; under ``FLAGS_benchmark`` each run waits for
the card before it returns.

Runtime-wrapped programs: an object with ``custom_run(executor, feed,
fetch_list, scope, return_numpy)`` passed to ``run`` is handed the run,
as in the JAX Executor (the fleet's PS mode wraps its step so).

Dataset-driven training: ``train_from_dataset`` and
``infer_from_dataset`` drive a ``dataset.QueueDataset`` or
``InMemoryDataset`` through core/trainer.py's multi-step loop.

Meshes: a ``CompiledProgram`` after ``with_data_parallel`` or
``with_sharding`` runs on its mesh (core/spmd.py): the caller feeds the
global batch and each rank keeps the dim-0 slice at its coordinates on
the batch axes (for a pipelined program, its part of every microbatch);
a persistable the mesh shards is held in the scope as the rank's shard
(the scope's ``_shardings`` names them, so a checkpoint gathers them
whole); fetches come back global; the lowering cache is keyed by the
CompiledProgram's ``fingerprint()``.  Under a pipe axis the rank drops
the other stages' parameters and accumulators from the scope.

Placement: ``Executor()`` runs on the first CUDA card and raises when
there is none; ``Executor(CPUPlace())`` runs the plain PyTorch path on
the CPU (the tests do); ``Executor(CUDAPlace(i))`` names a card.

Telemetry, as in the JAX executor: each lowering (a miss of the
program's cache) counts on ``executor_compiles_total`` and
``executor_compile_seconds_total`` and records a ``lower:<id>`` span;
each run records a ``run:<id>`` span (and a Kineto range of that name
while the profiler's device trace runs) — while the profiler is on the
run first waits for the card, so the span covers device time (never
otherwise: an untraced step does not synchronize); the first lowering
of a ``CompiledProgram`` sets ``optimizer_state_bytes``
(``placement="global"`` and ``"per_device"``, equal without a mesh).

Random state: each run draws one step seed from the program's
``random_seed`` (or a seed chosen once per program when it is 0) and a
step counter, and each random op folds its uid into it — the port's
replacement for the JAX package's ``_next_rng`` key.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from .. import _cuda
from .. import profiler as _prof
from .._rng import fold_seed
from ..flags import flag as _flag
from ..observability import tracing as _tracing
from ..observability.monitor import (EXECUTOR_COMPILE_SECONDS,
                                     EXECUTOR_COMPILES,
                                     OPTIMIZER_STATE_BYTES)
from ..observability.registry import get_registry
from . import spmd
from .lowering import lower_block
from .program import Program, Variable, default_main_program
from .scope import Scope, global_scope
from .types import CUDAPlace, Place, runtime_dtype

__all__ = ["Executor"]


def _record_compile(seconds):
    """Count one program lowering (and its wall seconds) on the shared
    registry.  Resolved per call (lowerings are cache misses — rare by
    design), which keeps the handles valid across a registry.reset().
    Best-effort: telemetry must never fail a training step."""
    try:
        reg = get_registry()
        reg.counter(EXECUTOR_COMPILES,
                    "executor program lowerings").inc()
        reg.counter(EXECUTOR_COMPILE_SECONDS,
                    "seconds spent lowering programs").inc(seconds)
    except Exception:  # noqa: BLE001 — metrics are non-load-bearing
        pass


def _record_optimizer_state_bytes(block, compiled, placed):
    """Gauge the optimizer-state footprint of a compiled program:
    ``optimizer_state_bytes{placement="global"}`` (unique logical bytes,
    from the program's shapes) and ``{placement="per_device"}`` (bytes
    resident on this rank: its shards under ZeRO-1 or a rule).  Replicated
    state reports per_device == global.  Best-effort: telemetry must
    never fail a training step."""
    try:
        total = per_dev = 0
        for name, val in placed.items():
            var = block._find_var_recursive(name)
            if var is None or not getattr(var, "is_optimizer_state",
                                          False):
                continue
            full = var.shape if var.shape is not None else val.shape
            total += int(np.prod(full, dtype=np.int64)) * val.element_size()
            per_dev += val.numel() * val.element_size()
        if total == 0:
            # a program with no optimizer state (forward only, SGD) must
            # not clobber the training program's footprint
            return
        gauge = get_registry().gauge(
            OPTIMIZER_STATE_BYTES,
            "optimizer accumulator bytes (global vs per-device)")
        gauge.set(total, placement="global")
        gauge.set(per_dev, placement="per_device")
        get_registry().gauge(
            "data_parallel_degree",
            "data-axis size of the active mesh").set(
                compiled.data_parallel_degree if compiled.has_mesh else 1)
    except Exception:  # noqa: BLE001 — metrics are non-load-bearing
        pass


def fusion_knobs(program):
    """(program, the CompiledProgram or None, fuse_epilogues,
    fuse_block_epilogues): a CompiledProgram's BuildStrategy knobs, read
    before it is unwrapped; the default main program for None."""
    fuse, fuse_block, compiled = True, True, None
    if program is not None and hasattr(program, "build_strategy") \
            and hasattr(program, "program"):
        compiled = program
        bs = program.build_strategy
        fuse = bool(getattr(bs, "fuse_epilogues", True))
        fuse_block = fuse and bool(getattr(bs, "fuse_block_epilogues",
                                           True))
        program = program.program
    program = program if program is not None else default_main_program()
    return program, compiled, fuse, fuse_block


def _host_tensor(value):
    """A host value as a CPU tensor of the same shape (np.ascontiguousarray
    would turn a 0-d array — a beta power, the LR counter — into 1-d)."""
    arr = np.asarray(value)
    if not arr.flags.c_contiguous:
        arr = np.ascontiguousarray(arr)
    return torch.from_numpy(arr)


class Executor:
    def __init__(self, place: Place = None):
        self.place = place if place is not None else CUDAPlace(0)
        self.device = self.place.torch_device()
        #: kernel libraries built or loaded while a lowered block ran a
        #: step after its first (a steady-state compile; should stay 0)
        self.compiles_after_first_step = 0

    def run(self, program: Program = None, feed: dict = None,
            fetch_list=None, scope: Scope = None, return_numpy: bool = True):
        """Run a program's global block: feed -> compute -> fetch.

        Persistable outputs (parameters, optimizer accumulators) are
        written back into the scope, detached, after the step.

        A program object with ``custom_run`` (the fleet's PS-mode
        ``fleet.main_program``) is handed the run: it orchestrates its
        pulls and pushes around the step."""
        if program is not None and hasattr(program, "custom_run"):
            return program.custom_run(self, feed, fetch_list, scope,
                                      return_numpy)
        program, compiled, fuse, fuse_block = fusion_knobs(program)
        nan_check = _flag("FLAGS_check_nan_inf")
        # the per-op scan must see every op's output: no fused groups
        fuse = fuse and not nan_check
        fuse_block = fuse_block and not nan_check
        feed = feed or {}
        fetch_list = fetch_list or []
        scope = scope or global_scope()
        fetch_names = tuple(
            f.name if isinstance(f, Variable) else str(f) for f in fetch_list)
        block = program.global_block()
        mesh = compiled if compiled is not None and compiled.has_mesh \
            else None

        dev_feed = {n: self._feed_tensor(block, n, v) for n, v in feed.items()}
        if mesh is not None:
            dev_feed = {n: spmd.local_feed(mesh, program, t)
                        for n, t in dev_feed.items()}
        sig = (tuple(sorted((n, tuple(t.shape), str(t.dtype))
                            for n, t in dev_feed.items())), fetch_names,
               str(self.device), fuse, fuse_block,
               None if mesh is None else mesh.fingerprint(), nan_check)
        lowered, was_miss = self._cached_lowering(
            program, sig, lambda: lower_block(
                program, 0, tuple(dev_feed), fetch_names, self.device,
                fuse_epilogues=fuse, fuse_block_epilogues=fuse_block,
                mesh=mesh))
        fetches = self._run_lowered(
            program, lowered, scope,
            lambda mut, const: lowered.fn(dev_feed, mut, const,
                                          self._next_seed(program)),
            # once per lowering: publish the optimizer-state footprint
            record_state=was_miss and compiled is not None,
            compiled=compiled)
        if return_numpy:
            return [f.detach().cpu().numpy() for f in fetches]
        return [f.detach() for f in fetches]

    @staticmethod
    def _cached_lowering(program, sig, make):
        """(the program's lowering cached under ``sig``, whether it was a
        miss).  A miss calls ``make()``, caches it, counts a compile and
        records a ``lower:<id>`` span."""
        lowered = program._exec_cache.get(sig)
        if lowered is not None:
            return lowered, False
        t0 = time.perf_counter()
        lowered = program._exec_cache[sig] = make()
        t1 = time.perf_counter()
        _record_compile(t1 - t0)
        _tracing.record_span(f"lower:{id(program)}", t0, t1)
        return lowered, True

    def _run_lowered(self, program, lowered, scope, body, steps=1,
                     record_state=False, compiled=None):
        """The step body that ``run`` and the dataset trainer share:
        read the lowering's mutable and constant persistables from the
        scope, call ``body(mut, const) -> (fetches, new persistables)``
        inside the ``run:<id>`` span (waiting for the card under the
        profiler or ``FLAGS_benchmark``), count library loads made after
        the lowering's first run, and write the new persistables back,
        detached.  ``steps`` is how many steps ``body`` ran.  Returns the
        fetches."""
        block = program.global_block()
        mplan = lowered.mesh_plan
        if mplan is not None and lowered.runs == 0:
            for n in mplan.remote:
                if scope.has_var(n):
                    scope.erase(n)
        mut = {n: self._from_scope(scope, block, n, mplan)
               for n in lowered.mut_param_names}
        const = {n: self._from_scope(scope, block, n, mplan)
                 for n in lowered.const_param_names}
        if record_state:
            _record_optimizer_state_bytes(block, compiled, {**const, **mut})
        loads = _cuda.library_loads()
        t0 = time.perf_counter()
        # while a device trace runs, the run is also a Kineto range, so
        # the trace holds it beside its op scopes and kernels
        with (torch.profiler.record_function(f"run:{id(program)}")
              if _prof.device_tracing() else contextlib.nullcontext()):
            fetches, new_persist = body(mut, const)
            if (_prof.is_profiling() or _flag("FLAGS_benchmark")) \
                    and self.device.type == "cuda":
                # wait for the card so the run: span covers its device
                # time (the JAX executor's block_until_ready); other
                # runs stay asynchronous
                torch.cuda.synchronize(self.device)
        _tracing.record_span(f"run:{id(program)}", t0, time.perf_counter(),
                             **({"steps": steps} if steps != 1 else {}))
        if lowered.runs > 0:
            self.compiles_after_first_step += _cuda.library_loads() - loads
        lowered.runs += steps
        for n, v in new_persist.items():
            scope.set_var(n, v.detach())
        return fetches

    def _feed_tensor(self, block, name, value):
        """A feed as a tensor on the device with the declared runtime
        dtype; a shape the program does not declare raises."""
        var = block._find_var_recursive(name)
        t = value if torch.is_tensor(value) else _host_tensor(value)
        if var is not None and var.shape is not None:
            declared = var.shape
            ok = len(t.shape) == len(declared) and all(
                d < 0 or d == a for d, a in zip(declared, t.shape))
            if not ok:
                raise ValueError(
                    f"Feed '{name}' has shape {tuple(t.shape)} but the "
                    f"program declares {tuple(declared)}")
        dtype = runtime_dtype(var.dtype) if var is not None and \
            var.dtype is not None else None
        return t.to(device=self.device, dtype=dtype)

    def _from_scope(self, scope: Scope, block, name: str, mplan=None):
        val = scope.find_var(name)
        if val is None:
            raise RuntimeError(
                f"Variable '{name}' is not initialized in the scope. "
                f"Run the startup program (exe.run(default_startup_program())) "
                f"or feed it.")
        if not (torch.is_tensor(val) and val.device == self.device):
            var = block._find_var_recursive(name)
            t = val if torch.is_tensor(val) else _host_tensor(val)
            dtype = runtime_dtype(var.dtype) if var is not None and \
                var.dtype is not None else None
            val = t.to(device=self.device, dtype=dtype)
            scope.set_var(name, val)
        if mplan is not None:
            # a whole value where the mesh holds a shard: keep the
            # rank's shard (the first run, or after a restore)
            val = spmd.place(scope, mplan, name, val)
        return val

    @staticmethod
    def _next_seed(program: Program) -> int:
        counter = getattr(program, "_rng_counter", 0)
        program._rng_counter = counter + 1
        seed = program.random_seed
        if not seed:
            seed = getattr(program, "_auto_seed", None)
            if seed is None:
                seed = int(np.random.randint(0, 2**31 - 1))
                program._auto_seed = seed
        return fold_seed(seed, counter)

    def train_from_dataset(self, program=None, dataset=None, scope=None,
                           thread=0, debug=False, fetch_list=None,
                           fetch_info=None, print_period=100):
        """Dataset-driven training with a multi-step loop (parity:
        executor.py:1116 train_from_dataset and the C++ trainer/
        DeviceWorker stack; see core/trainer.py).  A CompiledProgram's
        fusion knobs apply, as in ``run``.  Returns the last step's
        fetched values."""
        from .trainer import run_from_dataset

        program, compiled, fuse, fuse_block = fusion_knobs(program)
        if compiled is not None and compiled.has_mesh:
            raise NotImplementedError(
                "train_from_dataset over a mesh is not ported (ROADMAP.md, "
                "Queue 1 item 5): run the CompiledProgram with Executor.run")
        scope = scope or global_scope()
        return run_from_dataset(self, program, dataset, scope, fetch_list,
                                fetch_info, print_period, debug,
                                thread=thread, fuse_epilogues=fuse,
                                fuse_block_epilogues=fuse_block)

    def infer_from_dataset(self, program=None, dataset=None, scope=None,
                           thread=0, debug=False, fetch_list=None,
                           fetch_info=None, print_period=100):
        """Parity: executor.py:1049 — the same loop, over a
        clone(for_test=True) program with no optimizer ops."""
        return self.train_from_dataset(program, dataset, scope, thread,
                                       debug, fetch_list, fetch_info,
                                       print_period)

    def close(self):
        """Nothing to release: lowered blocks live on their programs."""
