"""Fleet parameter-server mode: the reference's one-API PS contract
(parity: python/paddle/fluid/incubate/fleet/parameter_server/
distribute_transpiler/__init__.py — fleet.init :147, init_worker :74,
init_server :117, run_server :126, distributed_optimizer :238,
save_persistables :218, stop_worker :103; config parity:
DistributeTranspilerConfig sync_mode / geo_sgd_mode /
geo_sgd_need_push_nums).

Counterpart of paddle_tpu/incubate/fleet/parameter_server/__init__.py.
The reference TRANSPILES the program (send/recv ops, pserver
sub-programs, listen_and_serv).  Here, as in the JAX package, the worker
program stays one forward+backward step through the Executor; the PS
protocol runs host-side around it:

    pull tables -> scope  |  step (grads fetched)  |  push grads

with the native TCP server (native/ps_server.cpp) applying the optimizer
server-side — workers are stateless, the reference's optimize-on-server
split.  `fleet.main_program` is a thin wrapper the Executor delegates to
(``custom_run``), so user code keeps the reference shape:
``exe.run(fleet.main_program, feed, fetch_list)``.

Where values cross the host protocol: pulled parameters go into the
scope as tensors on the Executor's device; the step's gradients come
back to the host as numpy, and every scope value the worker reads (the
startup's, the GEO snapshot) leaves the device explicitly
(``.detach().cpu().numpy()``).

Modes:
  * sync (sync_mode=True): pull -> barrier -> step -> push -> barrier
    (send_barrier/fetch_barrier parity).
  * async (sync_mode=False): no barriers; sparse grads ride the
    AsyncCommunicator merge pipeline (communicator.cc parity).
  * GEO (geo_sgd_mode=True): local optimizer ops stay in the program;
    every geo_sgd_need_push_nums steps the parameter DELTA is pushed
    (geo_sgd_transpiler.py parity, via distributed/geo.py).

Scale note: sparse tables are pulled in full each step here (the
program is one step; there is no mid-graph RPC prefetch).  For
vocabularies that don't fit a worker, use distributed.ps.
DistributedEmbedding / DeviceCachedEmbedding / ps_sharded directly —
those paths pull only touched rows.
"""
from __future__ import annotations

import numpy as np
import torch

from ....observability.tracing import span
from ..base.fleet_base import DistributedOptimizer, Fleet

__all__ = ["fleet", "ParameterServerFleet", "ParameterServerOptimizer",
           "DistributeTranspilerConfig"]


def _host(value):
    """A scope value (a tensor, possibly on the card, or an array) as
    host numpy."""
    if torch.is_tensor(value):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def _on(device, array):
    """A host array as a tensor on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(array)).to(device)


class DistributeTranspilerConfig:
    """Parity: transpiler/distribute_transpiler.py DistributeTranspilerConfig
    (the subset that changes behavior here) + server-side knobs."""

    def __init__(self):
        self.sync_mode = True
        self.geo_sgd_mode = False
        self.geo_sgd_need_push_nums = 100
        # server-side optimizer applied on push (native ps_server):
        self.server_optimizer = "sgd"
        # dense parameters are split into blocks of this many floats
        # (VarBlock parity); None = use the sparse embedding dim, or 64
        self.block_dim = None
        self.async_merge_every = 4


class _PSPlan:
    """What minimize() learned about the model, consumed by
    init_server/init_worker/custom_run."""

    def __init__(self, program, startup, loss, sparse, dense, lr, config):
        self.program = program
        self.startup = startup
        self.loss = loss
        self.sparse = sparse    # [(param, grad_name, rows_name)]
        self.dense = dense      # [(param, grad_name)]
        self.lr = lr
        self.config = config

    @property
    def dim(self):
        if self.sparse:
            return int(self.sparse[0][0].shape[1])
        return int(self.config.block_dim or 64)

    @property
    def num_tables(self):
        # table 0..n-1: one per sparse param; last table: dense blocks
        return len(self.sparse) + (1 if self.dense else 0)


class _PSProgram:
    """Executor-delegated wrapper: pull -> step -> push.  A sync or
    async run opens three spans (``observability.tracing``, recorded
    while the profiler runs): ``ps:pull`` (the pulls and, in sync mode,
    the barrier after them), ``ps:step`` (the Executor's step and the
    gradients' copy to the host) and ``ps:push`` (the pushes and their
    barrier)."""

    def __init__(self, flt, plan):
        self._fleet = flt
        self.plan = plan
        self.program = plan.program  # for save/clone-style introspection
        self._step = 0

    def custom_run(self, exe, feed, fetch_list, scope, return_numpy):
        import paddle_tpu_torch as pt

        flt = self._fleet
        plan = self.plan
        cfg = plan.config
        scope = scope or pt.global_scope()
        client = flt._client
        assert client is not None, "call fleet.init_worker() first"

        if cfg.geo_sgd_mode:
            return self._geo_run(exe, feed, fetch_list, scope,
                                 return_numpy)

        # 1. pull current parameters into the scope, on the device
        with span("ps:pull", step=self._step):
            for t, (p, _, _) in enumerate(plan.sparse):
                vocab = int(p.shape[0])
                rows = client.pull(t, np.arange(vocab, dtype=np.int64),
                                   plan.dim)
                scope.set_var(p.name,
                              _on(exe.device, rows.reshape(p.shape)))
            for table in flt._dense_tables.values():
                scope.set_var(table.name, _on(exe.device, table.pull()))
            if cfg.sync_mode:
                client.barrier()        # everyone computes on theta_t

        # 2. one forward+backward step, grads fetched alongside the
        #    user's fetch_list
        with span("ps:step", step=self._step):
            extra = []
            for _, g, r in plan.sparse:
                extra += [g, r]
            extra += [g for _, g in plan.dense]
            user = list(fetch_list or [])
            vals = exe.run(plan.program, feed=feed,
                           fetch_list=user + extra, scope=scope,
                           return_numpy=False)
            user_vals = [_host(v) for v in vals[: len(user)]] \
                if return_numpy else vals[: len(user)]
            # the gradients leave the card here, as host numpy
            grad_vals = [_host(v) for v in vals[len(user):]]

        # 3. push gradients; the SERVER applies the optimizer
        with span("ps:push", step=self._step):
            i = 0
            for t, (p, _, _) in enumerate(plan.sparse):
                values, rows = grad_vals[i], grad_vals[i + 1]
                i += 2
                if cfg.sync_mode or flt._communicators is None:
                    client.push(t, rows, values, lr=plan.lr)
                else:
                    flt._communicators[t].push(rows, values)
            for table in flt._dense_tables.values():
                table.push(grad_vals[i], lr=plan.lr)
                i += 1
            if cfg.sync_mode:
                client.barrier()        # all pushes landed
        self._step += 1
        return user_vals

    def _geo_run(self, exe, feed, fetch_list, scope, return_numpy):
        vals = exe.run(self.plan.program, feed=feed,
                       fetch_list=fetch_list, scope=scope,
                       return_numpy=return_numpy)
        self._step += 1
        geo = self._fleet._geo_worker
        params = {p.name: _host(scope.find_var(p.name))
                  for p, _ in self.plan.dense}
        synced = geo.maybe_sync(params, self._step - 1)
        if synced is not params:
            for name, v in synced.items():
                scope.set_var(name, _on(exe.device, v))
        return vals


class ParameterServerFleet(Fleet):
    def __init__(self):
        super().__init__()
        self._plan: _PSPlan | None = None
        self._client = None
        self._dense_tables = {}
        self._communicators = None
        self._geo_worker = None
        self.main_program = None
        self.startup_program = None

    # -- server role -------------------------------------------------------
    def init_server(self, model_dir=None):
        """Prepare the server role.  With model_dir, the server loads a
        pt_ps_save snapshot after startup (handled by run_server)."""
        assert self._plan is not None, \
            "run distributed_optimizer(...).minimize(loss) first"
        self._server_model_dir = model_dir

    def run_server(self):
        """Serve forever on this role's endpoint (listen_and_serv
        parity).  Blocks until a worker sends stop."""
        from ....distributed.ps import serve_forever

        plan = self._plan
        ep = self.server_endpoints()[self.server_index()]
        port = int(ep.rsplit(":", 1)[1])
        serve_forever(port, num_tables=plan.num_tables, dim=plan.dim,
                      optimizer=plan.config.server_optimizer,
                      init_range=0.1, seed=1234 + self.server_index(),
                      num_workers=self.worker_num())

    # -- worker role -------------------------------------------------------
    def init_worker(self):
        """Connect to the pservers, declare tables, seed dense params
        from this worker's startup values (worker 0 writes, barrier
        publishes — recv-startup parity)."""
        import paddle_tpu_torch as pt
        from ....distributed.ps_sharded import (AsyncCommunicator,
                                                DenseTable,
                                                ShardedPSClient)

        plan = self._plan
        assert plan is not None, \
            "run distributed_optimizer(...).minimize(loss) first"
        cfg = plan.config
        self._client = ShardedPSClient(self.server_endpoints(),
                                       worker_id=self.worker_index())
        dense_table_idx = len(plan.sparse)
        scope = pt.global_scope()

        def _local(p):
            v = scope.find_var(p.name)
            assert v is not None, \
                f"run the startup program before init_worker() " \
                f"(param {p.name} not initialized)"
            return v

        if cfg.geo_sgd_mode:
            from ....distributed.geo import GeoSGDWorker

            # GeoSGDWorker runs the bootstrap protocol itself (worker 0
            # seeds, barrier, everyone pulls the agreed global)
            self._geo_worker = GeoSGDWorker(
                self._client, dense_table_idx,
                {p.name: _host(_local(p)) for p, _ in plan.dense},
                dim=plan.dim,
                sync_every=cfg.geo_sgd_need_push_nums,
                trainers=self.worker_num())
            for name, v in self._geo_worker.initial_params().items():
                # on the device the startup left the parameter on
                old = scope.find_var(name)
                scope.set_var(name, _on(old.device, v)
                              if torch.is_tensor(old) else v)
            return
        for p, _ in plan.dense:
            t = DenseTable(self._client, dense_table_idx, p.name,
                           p.shape, plan.dim,
                           server_optimizer=cfg.server_optimizer)
            self._dense_tables[p.name] = t
        if self.worker_index() == 0:
            for p, _ in plan.dense:
                self._dense_tables[p.name].init(_host(_local(p)))
        self._client.barrier()
        if not cfg.sync_mode:
            self._communicators = {
                t: AsyncCommunicator(self._client, t, plan.lr,
                                     merge_every=cfg.async_merge_every)
                for t in range(len(plan.sparse))
            }

    def stop_worker(self):
        if self._communicators:
            for c in self._communicators.values():
                c.flush()
                c.stop()
        if self._client is not None:
            self._client.barrier()
            self._client.close()
            self._client = None

    # -- optimizer ---------------------------------------------------------
    def distributed_optimizer(self, optimizer, strategy=None):
        self._optimizer = ParameterServerOptimizer(
            optimizer, strategy or DistributeTranspilerConfig())
        return self._optimizer

    # -- save APIs ---------------------------------------------------------
    def save_persistables(self, executor, dirname, main_program=None):
        """First worker asks every pserver to snapshot its shard
        (pt_ps_save; reference fleet.save_persistables -> pserver
        checkpoint)."""
        if self._client is None or not self.is_first_worker():
            return
        self._client.save(dirname)

    def save_inference_model(self, executor, dirname, feeded_var_names,
                             target_vars, main_program=None,
                             export_for_deployment=True):
        from .... import io

        if not self.is_first_worker():
            return
        io.save_inference_model(dirname, feeded_var_names, target_vars,
                                executor,
                                main_program or self._plan.program)


class ParameterServerOptimizer(DistributedOptimizer):
    """minimize() = backward only (sync/async: the optimizer runs
    SERVER-side on push) or full local minimize (GEO), plus the pull/
    push plan recorded for the fleet runtime."""

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        import paddle_tpu_torch as pt

        inner = self._optimizer
        cfg = self._strategy
        lr = inner._learning_rate
        if not isinstance(lr, (int, float)):
            raise ValueError(
                "fleet PS mode needs a scalar learning rate (the "
                "optimizer runs server-side)")

        params_grads = inner.backward(loss, startup_program,
                                      parameter_list, no_grad_set)
        sparse, dense = [], []
        for p, g in params_grads:
            rows = getattr(g, "sparse_rows", None)
            if rows is not None:
                sparse.append((p, g.name, rows))
            else:
                dense.append((p, g.name))
        if cfg.geo_sgd_mode:
            if sparse:
                raise ValueError(
                    "GEO-SGD fleet mode supports dense parameters only "
                    "(reference geo_sgd_transpiler handles sparse via "
                    "a separate delta table; use sync/async mode for "
                    "is_sparse embeddings)")
            # local training: keep the optimizer ops in the program
            opt_ops = inner.apply_gradients(params_grads)
        else:
            opt_ops = []   # server applies the update on push

        main = loss.block.program if hasattr(loss, "block") \
            else pt.default_main_program()
        plan = _PSPlan(main, pt.default_startup_program(), loss,
                       sparse, dense, float(lr), cfg)
        if plan.sparse:
            dims = {int(p.shape[1]) for p, _, _ in plan.sparse}
            if len(dims) != 1:
                raise ValueError(
                    f"fleet PS mode: all is_sparse embeddings must share "
                    f"one dim (native server tables have a single row "
                    f"width); got {sorted(dims)}")
        fleet._plan = plan
        fleet.main_program = _PSProgram(fleet, plan)
        fleet.startup_program = plan.startup
        return opt_ops, params_grads


fleet = ParameterServerFleet()
