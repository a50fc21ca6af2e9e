"""GEO-SGD: geometric async SGD over the parameter server.

Counterpart of paddle_tpu/distributed/geo.py, copied (numpy over the
port's ``DenseTable``) with one repair: a barrier after the bootstrap
pull, so no worker pushes its first delta before every worker holds the
agreed starting point.

Parity: transpiler/geo_sgd_transpiler.py — trainers run k purely-local
SGD steps, then push the accumulated parameter DELTA (divided by the
trainer count) to the pserver, which adds it into the global parameter;
the trainer then pulls the fresh global value and keeps training.  The
reference wires this with send_op/recv_op + a delta-computing sub-program;
here `GeoSGDWorker` wraps the same protocol around any locally-trained
parameter dict, using the PS delta push (push with lr = -1 is exactly
`param += delta` on the server).
"""
from __future__ import annotations

import numpy as np

from .ps_sharded import DenseTable

__all__ = ["GeoSGDWorker"]


class GeoSGDWorker:
    """k-local-step delta-push training (GeoSgdTranspiler parity).

    Usage::

        geo = GeoSGDWorker(client, table, {"w": w0, "b": b0},
                           dim=16, sync_every=4, trainers=2)
        for step, batch in enumerate(data):
            params = train_step(params, batch)        # local SGD
            params = geo.maybe_sync(params, step)     # every k steps
    """

    def __init__(self, client, table, init_params, dim, sync_every=4,
                 trainers=1, init_on_server=True, server_optimizer="sgd"):
        if server_optimizer != "sgd":
            raise RuntimeError(
                "GEO-SGD needs the plain 'sgd' server optimizer: the "
                "delta push (lr=-1) is only `param += delta` under sgd")
        self.client = client
        self.sync_every = int(sync_every)
        self.trainers = int(trainers)
        self.tables = {
            name: DenseTable(client, table, name, np.shape(v), dim,
                             server_optimizer=server_optimizer)
            for name, v in init_params.items()
        }
        # Bootstrap protocol (the reference's pserver startup program
        # seeds the global params; trainers then recv them): exactly ONE
        # worker writes the init value, everyone barriers, everyone pulls
        # the agreed global as both starting params and delta snapshot.
        if init_on_server and getattr(client, "worker_id", 0) == 0:
            for name, v in init_params.items():
                self.tables[name].init(v)
        client.barrier()
        self._snapshot = self.pull_all()
        # as after each sync round: nobody may push a delta before every
        # worker holds its snapshot (the JAX package's copy has no barrier
        # here, so a worker that pulls late starts from another's delta)
        client.barrier()

    def initial_params(self):
        """The agreed global starting point — begin local training from
        this, NOT from your local init (they differ on workers != 0)."""
        return {k: v.copy() for k, v in self._snapshot.items()}

    def pull_all(self):
        return {k: t.pull() for k, t in self.tables.items()}

    def maybe_sync(self, params, step):
        """After local step `step` (0-based), push deltas / pull global
        every sync_every steps.  Returns the (possibly refreshed) params."""
        if (step + 1) % self.sync_every != 0:
            return params
        out = dict(params)                    # keep untracked entries
        for name, t in self.tables.items():
            delta = (np.asarray(params[name], np.float32)
                     - self._snapshot[name]) / self.trainers
            # server applies param += delta  (push with lr = -1)
            t.push(delta, lr=-1.0)
        self.client.barrier()                 # all round-r deltas landed
        for name, t in self.tables.items():
            fresh = t.pull()
            self._snapshot[name] = fresh.copy()
            out[name] = fresh
        # second barrier: nobody may push round r+1 before every worker
        # finished its round-r pull (schedule-independent trajectories)
        self.client.barrier()
        return out
