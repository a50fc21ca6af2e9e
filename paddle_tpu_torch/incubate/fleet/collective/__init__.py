"""Fleet collective mode (parity: python/paddle/fluid/incubate/fleet/
collective/__init__.py — Collective fleet :45, DistributedStrategy :134,
CollectiveOptimizer :182).

Counterpart of paddle_tpu/incubate/fleet/collective/__init__.py.  The
reference rewrites the program with c_gen_nccl_id / c_comm_init /
per-grad c_allreduce_sum ops (transpiler/collective.py).  Here there is
no transpilation: ``fleet.init`` starts the default process group at the
role maker's coordinator endpoint (``init_process_group``: NCCL for CUDA
ranks with a card each, gloo otherwise), and ``minimize`` wraps the
program in a ``CompiledProgram`` data parallel over the world
(``with_data_parallel`` on ``parallel.mesh.build_mesh``; one process
without a group is ``LocalMesh``): the lowering sums the gradients over
the data axis.  As everywhere in the port's meshes, each rank feeds the
GLOBAL batch and keeps its own slice.  nccl_comm_num and the
hierarchical all-reduce knobs are accepted for parity and change
nothing.

The device: each rank runs where the launcher's PADDLE_TRAINER_DEVICE
puts it (``distributed.launch.trainer_device``), else on the card.
"""
from __future__ import annotations

import torch.distributed as dist

from ....compiler import BuildStrategy, CompiledProgram
from ....core.program import default_main_program, default_startup_program
from ..base.fleet_base import DistributedOptimizer, Fleet

__all__ = ["fleet", "Collective", "CollectiveOptimizer",
           "DistributedStrategy"]


class DistributedStrategy(BuildStrategy):
    """Parity: collective/__init__.py:134 DistributedStrategy(BuildStrategy).

    The knobs:
      * nccl_comm_num / use_hierarchical_allreduce / hierarchical_*:
        accepted, change nothing (one process group, one bucketed sum).
      * use_local_sgd (+ local_sgd_k_steps): each rank trains its local
        program and a LocalSGDSyncer averages params every k steps
        (fleet.local_sgd_syncer after minimize).
      * use_dgc: requires optimizer.DGCMomentumOptimizer (validated).
      * forward_recompute + recompute_checkpoints: wraps the inner
        optimizer in RecomputeOptimizer.
      * use_amp + amp_loss_scaling: wraps the inner optimizer in
        contrib.mixed_precision.decorate (bfloat16 AMP).
    """

    def __init__(self):
        super().__init__()
        self.nccl_comm_num = 1
        self.use_hierarchical_allreduce = False
        self.hierarchical_allreduce_inter_nranks = 0
        self.use_local_sgd = False
        self.local_sgd_k_steps = 1
        self.use_dgc = False
        self.forward_recompute = False
        self.recompute_checkpoints = []
        self.use_amp = False
        self.amp_loss_scaling = 2 ** 15


class Collective(Fleet):
    def __init__(self):
        super().__init__()
        self._origin_program = None
        self._compiled_program = None
        self.main_program = None

    @property
    def device(self):
        """This rank's ``torch.device`` (PADDLE_TRAINER_DEVICE, else the
        card)."""
        from ...._device import resolve_device
        from ....distributed.launch import trainer_device

        return resolve_device(trainer_device())

    def _post_init(self):
        """Start the default process group when launched multi-process
        (reference analog: c_gen_nccl_id rendezvous + c_comm_init)."""
        n = self.worker_num()
        if n <= 1:
            return
        from ....distributed.collectives import \
            ensure_distributed_initialized

        ensure_distributed_initialized(
            self._role_maker.coordinator_endpoint(), n,
            self.worker_index())

    def distributed_optimizer(self, optimizer, strategy=None):
        self._optimizer = CollectiveOptimizer(optimizer, strategy)
        return self._optimizer

    # -- save APIs (first worker writes; parity fleet_base.py:252) ---------
    def save_inference_model(self, executor, dirname, feeded_var_names,
                             target_vars, main_program=None,
                             export_for_deployment=True):
        from .... import io

        if not self.is_first_worker():
            return
        io.save_inference_model(dirname, feeded_var_names, target_vars,
                                executor,
                                main_program or self._origin_program)

    def save_persistables(self, executor, dirname, main_program=None):
        from .... import io

        if not self.is_first_worker():
            return
        io.save_persistables(executor, dirname,
                             main_program or self._origin_program)


class CollectiveOptimizer(DistributedOptimizer):
    """Parity: collective/__init__.py:182.  minimize() = inner minimize +
    the program data parallel over the world."""

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        from ....optimizer import RecomputeOptimizer
        from ....parallel import mesh as mesh_lib

        inner = self._optimizer
        strategy = self._strategy or DistributedStrategy()
        if getattr(strategy, "use_dgc", False):
            from ....optimizer import DGCMomentumOptimizer

            if not isinstance(inner, DGCMomentumOptimizer):
                raise ValueError(
                    "strategy.use_dgc=True requires the inner optimizer to "
                    "be optimizer.DGCMomentumOptimizer (the DGC algorithm "
                    "lives in the optimizer, reference parity: "
                    "fluid/optimizer.py:1011)")
        if getattr(strategy, "forward_recompute", False):
            rc = RecomputeOptimizer(inner)
            rc._set_checkpoints(list(strategy.recompute_checkpoints))
            inner = rc
        if getattr(strategy, "use_amp", False):
            from ....contrib import mixed_precision as amp

            inner = amp.decorate(
                inner, init_loss_scaling=strategy.amp_loss_scaling)

        opt_ops, params_grads = inner.minimize(
            loss, startup_program, parameter_list, no_grad_set)

        main = loss.block.program if hasattr(loss, "block") \
            else default_main_program()
        fleet._origin_program = main
        fleet.startup_program = default_startup_program()
        if getattr(strategy, "use_local_sgd", False):
            # LocalSGD: each rank trains its LOCAL program (no mesh —
            # weights intentionally diverge between syncs); the periodic
            # cross-process averaging is a host-side syncer
            from .local_sgd import LocalSGDSyncer

            fleet.main_program = main
            fleet.local_sgd_syncer = LocalSGDSyncer(
                main, k_steps=getattr(strategy, "local_sgd_k_steps", 1))
            return opt_ops, params_grads
        device = fleet.device
        # the data axis over every rank of the world, or this process
        mesh = (mesh_lib.build_mesh(device_type=device.type)
                if dist.is_initialized()
                else mesh_lib.LocalMesh(device_type=device.type))
        fleet._compiled_program = CompiledProgram(
            main, build_strategy=strategy).with_data_parallel(mesh=mesh)
        fleet.main_program = fleet._compiled_program
        return opt_ops, params_grads


fleet = Collective()
