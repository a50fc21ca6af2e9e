"""Sharded multi-server parameter-server client: id-hash routing, dense
parameter tables, and the async client-side merge communicator.

Counterpart of paddle_tpu/distributed/ps_sharded.py, copied: numpy and
threads over the port's ``PSClient``.

Parity map:
  * N-pserver sharding — the reference splits every parameter into blocks
    round-robined across pservers
    (transpiler/distribute_transpiler.py:540 VarBlock splitting +
    ps_dispatcher.py RoundRobin/HashName;
    operators/distributed/parameter_send.cc splits the tensor rows,
    parameter_recv.cc concats them back).  Here `ShardedPSClient` routes
    each row id to server `id % N` (HashName) and `DenseTable` splits a
    dense parameter into dim-sized blocks whose block-ids round-robin the
    same way — so a 100B-feature table or a huge dense matrix spans every
    server's RAM instead of one host's.
  * Dense parameters with server-side optimize — the reference pserver
    runs one optimize block per received grad
    (operators/distributed_ops/listen_and_serv_op.cc); here the native
    server applies SGD/Adagrad on push (native/ps_server.cpp), and dense
    blocks ride the same path.
  * Async mode — the reference's client-side Communicator threads merge
    grads per variable and send asynchronously
    (operators/distributed/communicator.cc:  send_varname_to_queue ->
    MergeVars -> RpcSend).  `AsyncCommunicator` reproduces exactly that
    pipeline: send_queue -> merge-by-id -> push thread, with
    `send_wait_times`/`merge_every` knobs and a `flush()` barrier.
"""
from __future__ import annotations

import queue
import threading
import zlib

import numpy as np

from .ps import PSClient

__all__ = ["ShardedPSClient", "DenseTable", "AsyncCommunicator"]


class ShardedPSClient:
    """Client over N independent pserver processes.

    Routing is HashName-style (ps_dispatcher.py): row id -> server
    `id % N`.  Every server keeps its own table shard under the original
    ids, so pull/push just partition the batch."""

    def __init__(self, endpoints, worker_id=0):
        self.clients = [PSClient(h, int(p), worker_id)
                        for h, p in (e.split(":") if isinstance(e, str)
                                     else e for e in endpoints)]
        self.n = len(self.clients)
        self.worker_id = worker_id

    def _parts(self, ids):
        shard = ids % self.n
        return [(s, np.nonzero(shard == s)[0]) for s in range(self.n)
                if (shard == s).any()]

    def pull(self, table, ids, dim):
        ids = np.ascontiguousarray(ids, dtype=np.int64).ravel()
        out = np.empty((len(ids), dim), np.float32)
        for s, idx in self._parts(ids):
            out[idx] = self.clients[s].pull(table, ids[idx], dim)
        return out

    def push(self, table, ids, grads, lr):
        ids = np.ascontiguousarray(ids, dtype=np.int64).ravel()
        grads = np.ascontiguousarray(grads, dtype=np.float32)
        for s, idx in self._parts(ids):
            self.clients[s].push(table, ids[idx], grads[idx], lr)

    # fan-out control ops -------------------------------------------------
    def barrier(self):
        for c in self.clients:
            c.barrier()

    def heartbeat(self):
        for c in self.clients:
            c.heartbeat()

    def save(self, path):
        for i, c in enumerate(self.clients):
            c.save(f"{path}.shard{i}")

    def load(self, path):
        for i, c in enumerate(self.clients):
            c.load(f"{path}.shard{i}")

    def stats(self):
        sts = [c.stats() for c in self.clients]
        return {"rows": sum(s["rows"] for s in sts), "per_server": sts}

    def stop_servers(self):
        for c in self.clients:
            try:
                c.stop_server()
            except Exception:
                pass

    def close(self):
        for c in self.clients:
            c.close()


def _name_base(name: str) -> int:
    """Stable namespace per parameter name so different dense params
    never collide in one table (the reference keeps them apart by
    variable name; ids are the wire key here).  31 crc bits << 32 leaves
    a 2^32-block window per name inside the positive int64 id space."""
    return np.int64(zlib.crc32(name.encode()) & 0x7FFFFFFF) << 32


class DenseTable:
    """A dense parameter hosted across the PS shards.

    The flat parameter is split into `dim`-wide blocks (VarBlock parity,
    distribute_transpiler.py:80); block k lives at row id base+k, which
    HashName-routes blocks round-robin across servers.  `pull()` returns
    the reassembled parameter; `push(grad, lr)` ships the block grads and
    the SERVER runs the optimizer step (listen_and_serv optimize-block
    parity) — so workers stay stateless."""

    def __init__(self, client, table, name, shape, dim,
                 server_optimizer="sgd"):
        self.client = client
        self.table = table
        self.name = name
        self.shape = tuple(int(d) for d in shape)
        self.dim = int(dim)
        self.server_optimizer = server_optimizer
        n = int(np.prod(self.shape))
        self.numel = n
        self.n_blocks = (n + dim - 1) // dim
        if self.n_blocks >= 2 ** 32:
            raise ValueError(
                f"DenseTable '{name}': {self.n_blocks} blocks exceeds the "
                f"2^32 per-name id namespace; raise `dim` (block width)")
        self.ids = _name_base(name) + np.arange(self.n_blocks,
                                                dtype=np.int64)

    def _flat(self, arr):
        flat = np.ascontiguousarray(arr, np.float32).reshape(-1)
        pad = self.n_blocks * self.dim - self.numel
        if pad:
            flat = np.concatenate([flat, np.zeros(pad, np.float32)])
        return flat.reshape(self.n_blocks, self.dim)

    def pull(self):
        rows = self.client.pull(self.table, self.ids, self.dim)
        return rows.reshape(-1)[: self.numel].reshape(self.shape)

    def push(self, grad, lr):
        self.client.push(self.table, self.ids, self._flat(grad), lr)

    def init(self, value):
        """Write an initial value: push (current - value) with lr=1 so
        the server lands exactly on `value` regardless of its init.

        Requires the plain `sgd` server optimizer (with adagrad the push
        is scaled by the accumulated squared grads and does NOT land on
        `value`), and must run on exactly ONE worker (pull-then-push is
        not atomic) — publish to the others with a barrier."""
        if self.server_optimizer != "sgd":
            raise RuntimeError(
                f"DenseTable.init needs server optimizer 'sgd', table "
                f"was declared with '{self.server_optimizer}' "
                f"(adagrad scales pushes by accumulated squared grads)")
        cur = self.pull()
        self.client.push(self.table, self.ids,
                         self._flat(cur - np.asarray(value, np.float32)),
                         1.0)


class AsyncCommunicator:
    """Client-side async grad pipeline (communicator.cc parity).

    push() enqueues and returns immediately; a daemon thread drains the
    queue, MERGES grads that hit the same row ids (merge_add semantics,
    operators/distributed/communicator.h MergeVars) and sends one
    combined push per `merge_every` enqueued batches (or on flush).
    flush() blocks until everything queued has reached the servers —
    the half-async barrier point."""

    def __init__(self, client, table, lr, merge_every=4):
        self.client = client
        self.table = table
        self.lr = float(lr)
        self.merge_every = int(merge_every)
        self._q: queue.Queue = queue.Queue()
        self._err = None
        self._stop = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def push(self, ids, grads):
        # surface a prior send failure BEFORE accepting new work — the
        # old order enqueued the new batch first, so the caller's retry
        # logic saw the error one batch late with a doomed batch queued
        if self._err:
            raise self._err
        self._q.put((np.asarray(ids, np.int64).ravel(),
                     np.asarray(grads, np.float32)))

    def _send(self, pending):
        if not pending:
            return
        ids = np.concatenate([p[0] for p in pending])
        grads = np.concatenate([p[1] for p in pending])
        uniq, inverse = np.unique(ids, return_inverse=True)
        merged = np.zeros((len(uniq), grads.shape[1]), np.float32)
        np.add.at(merged, inverse, grads)
        self.client.push(self.table, uniq, merged, self.lr)

    def _run(self):
        pending = []
        while True:
            try:
                item = self._q.get(timeout=0.05)
            except queue.Empty:
                if self._stop:
                    try:
                        self._send(pending)
                    except Exception as e:     # surface on next push/flush
                        self._err = e
                    return
                continue
            if isinstance(item, threading.Event):   # flush marker
                try:
                    self._send(pending)
                except Exception as e:
                    self._err = e
                pending = []
                item.set()     # the event travels WITH its marker, so
                continue       # concurrent flush() calls cannot race
            pending.append(item)
            if len(pending) >= self.merge_every:
                try:
                    self._send(pending)
                except Exception as e:
                    self._err = e
                pending = []

    def flush(self):
        if not self._thread.is_alive():
            raise RuntimeError(
                "AsyncCommunicator.flush after stop(): the send thread "
                "has exited; queued gradients would never be sent")
        done = threading.Event()
        self._q.put(done)
        if not done.wait(timeout=60):
            raise TimeoutError(
                "AsyncCommunicator.flush timed out: gradients may not "
                "have reached the parameter servers")
        if self._err:
            raise self._err

    def stop(self):
        self.flush()
        self._stop = True
        self._thread.join(timeout=10)
