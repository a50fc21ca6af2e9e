"""CompiledProgram and its build strategy, on one device.

Counterpart of paddle_tpu/compiler.py (parity:
python/paddle/fluid/compiler.py:87 CompiledProgram and
framework/details/build_strategy.h).  Two knobs of ``BuildStrategy`` are
live: ``fuse_epilogues`` turns the GEMM-epilogue fusion pass
(core/fusion.py) on or off, and ``fuse_block_epilogues`` adds its block
patterns on top (the qkv projection folded into the flash-attention
entry, the FFN as one two-GEMM chain).  Both default to on, as in the
JAX package; the rest are informational.  ``Executor.run`` reads the two
knobs of a ``CompiledProgram`` and runs its program.

Meshes are not ported: ``with_data_parallel`` and ``with_sharding``
raise (ROADMAP.md, Queue 1 item 5).
"""
from __future__ import annotations

from .core.program import Program

__all__ = ["BuildStrategy", "ExecutionStrategy", "CompiledProgram"]

_NO_MESH = ("meshes are not ported to paddle_tpu_torch yet (ROADMAP.md, "
            "Queue 1 item 5): a CompiledProgram runs on one device")


class BuildStrategy:
    """Knob-parity object; only the two fusion knobs change what runs."""

    class ReduceStrategy:
        AllReduce = 0
        Reduce = 1

    def __init__(self):
        self.reduce_strategy = BuildStrategy.ReduceStrategy.AllReduce
        self.fuse_all_reduce_ops = True  # informational
        self.fuse_elewise_add_act_ops = True  # informational
        # GEMM-epilogue fusion (core/fusion.py): mul/matmul -> bias ->
        # act -> [dropout] -> [residual] -> [layer_norm] chains run as one
        # group on the fused matmul kernel.  Off = the unfused lowering.
        self.fuse_epilogues = True
        # Block patterns on top of fuse_epilogues: qkv + bias + slices
        # folded into the flash-attention entry, mul -> bias -> act -> mul
        # FFN chains as one two-GEMM kernel.
        self.fuse_block_epilogues = True
        self.memory_optimize = True  # informational
        self.enable_inplace = True  # informational
        self.num_trainers = 1
        self.trainer_id = 0


class ExecutionStrategy:
    def __init__(self):
        self.num_threads = 1  # informational: ops run eagerly, in order
        self.num_iteration_per_drop_scope = 1
        self.use_experimental_executor = True


class CompiledProgram:
    """A program with its build strategy; ``Executor.run`` takes it where
    it takes a program."""

    def __init__(self, program_or_graph, build_strategy=None):
        if isinstance(program_or_graph, CompiledProgram):
            raise ValueError("already compiled")
        if not isinstance(program_or_graph, Program):
            raise TypeError(f"CompiledProgram takes a Program, got "
                            f"{type(program_or_graph).__name__}")
        self._program = program_or_graph
        self._build_strategy = build_strategy or BuildStrategy()
        self._exec_strategy = ExecutionStrategy()

    def with_data_parallel(self, loss_name=None, build_strategy=None,
                           exec_strategy=None, places=None, mesh=None):
        raise NotImplementedError(_NO_MESH)

    def with_sharding(self, mesh, param_rules=None, batch_axes=None):
        raise NotImplementedError(_NO_MESH)

    @property
    def program(self):
        return self._program

    @property
    def build_strategy(self):
        return self._build_strategy
