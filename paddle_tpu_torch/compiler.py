"""CompiledProgram and its build strategy: one device, or a mesh of ranks.

Counterpart of paddle_tpu/compiler.py (parity:
python/paddle/fluid/compiler.py:87 CompiledProgram and
framework/details/build_strategy.h).  Two knobs of ``BuildStrategy`` are
live for the lowering: ``fuse_epilogues`` turns the GEMM-epilogue fusion
pass (core/fusion.py) on or off, and ``fuse_block_epilogues`` adds its
block patterns on top (the qkv projection folded into the
flash-attention entry, the FFN as one two-GEMM chain).  Both default to
on, as in the JAX package; ``reduce_strategy`` picks ZeRO-1 below; the
rest are informational.

Meshes: ``with_data_parallel`` and ``with_sharding`` record a mesh (a
``DeviceMesh`` over the default process group, one rank per process, or
``parallel.mesh.LocalMesh`` when no group is initialized), parameter
rules and the batch axes; the Executor (core/executor.py) and the
lowering (core/spmd.py) read them.  No graph rewrite, as in the JAX
package, but where XLA's partitioner derives the collectives there,
the port runs them itself:

* each rank keeps the dim-0 slice of every feed at its coordinates on
  the batch axes, and reductions over the batch go through a forward
  sum, so the step computes the loss of the global batch;
* parameter gradients are summed over the data axis (bucketed);
* a parameter a rule shards (and its accumulators) is stored as the
  rank's shard; each rank updates its shard.  Over a ``model`` axis of
  more than one rank the Megatron split computes on the shards (each
  rank its heads, FFN columns and vocab rows); a sharded parameter some
  other op reads is gathered whole before the forward;
* batch norm in training takes the global batch's statistics (sync-BN);
* ``ReduceStrategy.Reduce`` (ZeRO-1) with a data axis of size > 1
  shards every optimizer accumulator 1/dp on its first free divisible
  dim: each rank updates its slice of parameter and gradient, then the
  parameter is all-gathered.
"""
from __future__ import annotations

import re

from .core.program import Program
from .parallel import mesh as mesh_lib

__all__ = ["BuildStrategy", "ExecutionStrategy", "ShardingRules",
           "CompiledProgram"]


class BuildStrategy:
    """Knob-parity object; the fusion knobs and ``reduce_strategy`` change
    what runs."""

    class ReduceStrategy:
        AllReduce = 0
        Reduce = 1

    def __init__(self):
        self.reduce_strategy = BuildStrategy.ReduceStrategy.AllReduce
        self.fuse_all_reduce_ops = True  # gradients are always bucketed
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


class ShardingRules:
    """Maps variable names to specs (tuples of mesh-axis names, one per
    leading dim): the tensor-parallel analog of the reference's per-op
    placement decisions.  Rules are (regex, spec tuple) pairs; the first
    match wins; the default is full replication."""

    def __init__(self, rules=None):
        self.rules = [(re.compile(pat), tuple(spec)) for pat, spec in
                      (rules or [])]

    def spec_for(self, name):
        for pat, spec in self.rules:
            if pat.search(name):
                return spec
        return ()

    def fingerprint(self):
        return tuple((p.pattern, s) for p, s in self.rules)


class CompiledProgram:
    """A program with its build strategy and, after ``with_data_parallel``
    or ``with_sharding``, a mesh; ``Executor.run`` takes it where it takes
    a program."""

    def __init__(self, program_or_graph, build_strategy=None):
        if isinstance(program_or_graph, CompiledProgram):
            raise ValueError("already compiled")
        if not isinstance(program_or_graph, Program):
            raise TypeError(f"CompiledProgram takes a Program, got "
                            f"{type(program_or_graph).__name__}")
        self._program = program_or_graph
        self._mesh = None
        self._rules = ShardingRules()
        self._batch_axes = (mesh_lib.DATA_AXIS,)
        self._build_strategy = build_strategy or BuildStrategy()
        self._exec_strategy = ExecutionStrategy()

    # -- reference-parity entry points ---------------------------------
    def with_data_parallel(self, loss_name=None, build_strategy=None,
                           exec_strategy=None, places=None, mesh=None):
        """Data parallel over every rank of the default process group (or
        an explicit mesh); without an initialized group, the one-rank
        ``{data: 1}`` mesh of this process.  ``loss_name`` is accepted
        for parity; ``places`` names the device type (a place or a
        ``torch.device``), the card unless it says the CPU."""
        import torch.distributed as dist

        if mesh is None:
            device_type = None
            if places:
                p = places[0]
                p = p.torch_device() if hasattr(p, "torch_device") else p
                device_type = getattr(p, "type", p)
            mesh = (mesh_lib.build_mesh(device_type=device_type)
                    if dist.is_available() and dist.is_initialized()
                    else mesh_lib.LocalMesh(device_type=device_type))
        self._mesh = mesh
        if build_strategy is not None:
            self._build_strategy = build_strategy
        if exec_strategy is not None:
            self._exec_strategy = exec_strategy
        return self

    def with_sharding(self, mesh, param_rules=None, batch_axes=None):
        """General mesh execution: ``param_rules`` is [(name_regex, spec)]
        for tensor/expert-parallel parameter placement; ``batch_axes``
        are the mesh axes the feeds' batch dim is split over: ``data``
        or none (the gradient sum and the MoE routing run over the data
        axis alone, so another batch axis is refused)."""
        if batch_axes is not None:
            other = [a for a in batch_axes if a != mesh_lib.DATA_AXIS]
            if other:
                raise NotImplementedError(
                    f"batch axes other than '{mesh_lib.DATA_AXIS}' "
                    f"({other}) are not ported (ROADMAP.md, Queue 1 item "
                    f"5.4): split the batch over the data axis")
            self._batch_axes = tuple(batch_axes)
        self._mesh = mesh
        if param_rules is not None:
            self._rules = ShardingRules(param_rules)
        return self

    # -- used by the Executor ------------------------------------------
    @property
    def program(self):
        return self._program

    @property
    def build_strategy(self):
        return self._build_strategy

    @property
    def mesh(self):
        return self._mesh

    @property
    def has_mesh(self):
        return self._mesh is not None

    @property
    def is_multiprocess(self):
        """True when the mesh spans more than this process."""
        if self._mesh is None:
            return False
        return self._mesh.mesh.numel() > 1

    @property
    def reduce_mode(self):
        """True when this program runs the ZeRO-1 sharded-optimizer path:
        ``ReduceStrategy.Reduce`` on a mesh whose data axis has size > 1."""
        return (
            self._mesh is not None
            and self._build_strategy.reduce_strategy
            == BuildStrategy.ReduceStrategy.Reduce
            and mesh_lib.axis_size(self._mesh, mesh_lib.DATA_AXIS) > 1
        )

    @property
    def data_parallel_degree(self):
        return mesh_lib.axis_size(self._mesh, mesh_lib.DATA_AXIS)

    @property
    def batch_axes(self):
        return tuple(a for a in self._batch_axes
                     if a in mesh_lib.axis_names(self._mesh))

    def _is_optimizer_state(self, name):
        var = self._program.global_block()._find_var_recursive(name)
        return var is not None and getattr(var, "is_optimizer_state",
                                           False)

    @staticmethod
    def _zero1_spec(spec, shape, dp):
        """Insert the data axis into an accumulator's spec: the first
        unsharded dim whose extent divides evenly by dp is split over
        ``data``; if none qualifies (scalars, tiny biases) the spec
        stands (whole over data).  Composes with tensor/expert rules: a
        moment already split over ``model`` on dim 1 gains ``data`` on
        dim 0 — ZeRO-1 stacked on tensor parallelism."""
        entries = list(spec) + [None] * (len(shape) - len(spec))
        used = {a for e in entries if e is not None
                for a in (e if isinstance(e, tuple) else (e,))}
        if mesh_lib.DATA_AXIS in used:
            return tuple(entries)
        for i, (e, d) in enumerate(zip(entries, shape)):
            if e is None and d >= dp and d % dp == 0:
                entries[i] = mesh_lib.DATA_AXIS
                return tuple(entries)
        return tuple(entries)

    def feed_sharding(self, name, ndim=None):
        if ndim == 0 or not self.batch_axes:
            return mesh_lib.replicated(self._mesh)
        axes = self.batch_axes
        return mesh_lib.batch_sharding(self._mesh,
                                       axes[0] if len(axes) == 1 else axes)

    def param_sharding(self, name, ndim=None, shape=None, rule_name=None):
        """The placement of persistable ``name``: the spec of the rule
        matching ``rule_name`` (default ``name``; the lowering passes an
        accumulator's parameter, whose shard it follows), whole when the
        spec is longer than the rank (an accumulator of lower rank, a
        beta power), and under ZeRO-1 an optimizer accumulator also
        split over ``data``."""
        spec = self._rules.spec_for(name if rule_name is None else rule_name)
        if ndim is not None and len(spec) > ndim:
            spec = ()
        spec = tuple(a if a in mesh_lib.axis_names(self._mesh) else None
                     for a in spec)
        if shape is not None and self.reduce_mode \
                and self._is_optimizer_state(name):
            spec = self._zero1_spec(spec, tuple(shape),
                                    self.data_parallel_degree)
        return mesh_lib.Sharding(self._mesh, spec)

    def persist_sharding_fn(self):
        """Callable(name, value) -> the Sharding of a persistable the step
        writes back, or None in AllReduce mode: the JAX package's output
        constraint, kept for its API.  The port's lowering does not call
        it: core/spmd.py's ``plan_mesh`` places every persistable through
        ``param_sharding``."""
        if not self.reduce_mode:
            return None

        def fn(name, value):
            return self.param_sharding(name, ndim=value.dim(),
                                       shape=tuple(value.shape))

        return fn

    def fingerprint(self):
        # the axes, their sizes and this rank's coordinates: the lowering
        # bakes the rank's slices and groups into its step
        m = self._mesh
        return (
            type(m).__name__,
            tuple((a, mesh_lib.axis_size(m, a), mesh_lib.axis_rank(m, a))
                  for a in mesh_lib.axis_names(m)),
            self._rules.fingerprint(), self._batch_axes,
            "zero1" if self.reduce_mode else "allreduce",
        )
