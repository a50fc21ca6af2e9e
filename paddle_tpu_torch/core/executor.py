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
switches (``PADDLE_TPU_FUSE_EPILOGUES``, ``PADDLE_TPU_FUSE_BLOCK_EPILOGUES``),
``FLAGS_check_nan_inf`` and AMP are not carried over.

Placement: ``Executor()`` runs on the first CUDA card and raises when
there is none; ``Executor(CPUPlace())`` runs the plain PyTorch path on
the CPU (the tests do); ``Executor(CUDAPlace(i))`` names a card.

Random state: each run draws one step seed from the program's
``random_seed`` (or a seed chosen once per program when it is 0) and a
step counter, and each random op folds its uid into it — the port's
replacement for the JAX package's ``_next_rng`` key.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import _cuda
from .._rng import fold_seed
from .lowering import lower_block
from .program import Program, Variable, default_main_program
from .scope import Scope, global_scope
from .types import CUDAPlace, Place, runtime_dtype

__all__ = ["Executor"]


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
        written back into the scope, detached, after the step."""
        fuse, fuse_block = True, True
        if program is not None and hasattr(program, "build_strategy") \
                and hasattr(program, "program"):
            # a CompiledProgram: read its knobs before unwrapping it
            bs = program.build_strategy
            fuse = bool(getattr(bs, "fuse_epilogues", True))
            fuse_block = fuse and bool(getattr(bs, "fuse_block_epilogues",
                                               True))
            program = program.program
        program = program if program is not None else default_main_program()
        feed = feed or {}
        fetch_list = fetch_list or []
        scope = scope or global_scope()
        fetch_names = tuple(
            f.name if isinstance(f, Variable) else str(f) for f in fetch_list)
        block = program.global_block()

        dev_feed = {n: self._feed_tensor(block, n, v) for n, v in feed.items()}
        sig = (tuple(sorted((n, tuple(t.shape), str(t.dtype))
                            for n, t in dev_feed.items())), fetch_names,
               str(self.device), fuse, fuse_block)
        lowered = program._exec_cache.get(sig)
        if lowered is None:
            lowered = lower_block(program, 0, tuple(dev_feed), fetch_names,
                                  self.device, fuse_epilogues=fuse,
                                  fuse_block_epilogues=fuse_block)
            program._exec_cache[sig] = lowered

        mut = {n: self._from_scope(scope, block, n)
               for n in lowered.mut_param_names}
        const = {n: self._from_scope(scope, block, n)
                 for n in lowered.const_param_names}
        loads = _cuda.library_loads()
        fetches, new_persist = lowered.fn(dev_feed, mut, const,
                                          self._next_seed(program))
        if lowered.runs > 0:
            self.compiles_after_first_step += _cuda.library_loads() - loads
        lowered.runs += 1
        for n, v in new_persist.items():
            scope.set_var(n, v.detach())
        if return_numpy:
            return [f.detach().cpu().numpy() for f in fetches]
        return [f.detach() for f in fetches]

    def _feed_tensor(self, block, name, value):
        """A feed as a tensor on the device with the declared runtime
        dtype; a shape the program does not declare raises."""
        var = block._find_var_recursive(name)
        t = value if torch.is_tensor(value) else torch.from_numpy(
            np.ascontiguousarray(np.asarray(value)))
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

    def _from_scope(self, scope: Scope, block, name: str):
        val = scope.find_var(name)
        if val is None:
            raise RuntimeError(
                f"Variable '{name}' is not initialized in the scope. "
                f"Run the startup program (exe.run(default_startup_program())) "
                f"or feed it.")
        if torch.is_tensor(val) and val.device == self.device:
            return val
        var = block._find_var_recursive(name)
        t = val if torch.is_tensor(val) else torch.from_numpy(
            np.ascontiguousarray(np.asarray(val)))
        dtype = runtime_dtype(var.dtype) if var is not None and \
            var.dtype is not None else None
        t = t.to(device=self.device, dtype=dtype)
        scope.set_var(name, t)
        return t

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
