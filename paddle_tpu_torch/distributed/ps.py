"""Parameter-server client and launcher over the native C++ service
(native/ps_server.cpp) — the giant-embedding path.

Counterpart of paddle_tpu/distributed/ps.py (parity:
operators/distributed/ sparse pull/push + parameter_prefetch.cc +
heart_beat_monitor.h + pslib DownpourWorker PullSparse/PushSparse).
``PSClient``, ``serve_forever``, ``PSServerProcess`` and
``DistributedEmbedding`` are the JAX package's, over the port's copy of
the server (``native.get_ps_server``).  ``DeviceCachedEmbedding`` keeps
its cache as a torch tensor on an explicit device: misses scatter in
with ``index_copy_``, the sgd mirror of ``push`` with ``index_add_``.
The module imports torch only there, so the server's process
(``serve_forever``) starts without it.

Training pattern (DownpourWorker parity, downpour_worker.cc)::

    ps = PSClient("127.0.0.1", port, worker_id=0)
    emb = DistributedEmbedding(ps, table=0, dim=16)
    rows, uniq, inverse = emb.pull(batch_ids)     # host-side prefetch
    ... feed `rows` into the step; fetch d(loss)/d(rows) ...
    emb.push(uniq, row_grads, lr=0.1)             # server-side optimize
"""
from __future__ import annotations

import ctypes
import heapq
import os
import subprocess
import sys
import time

import numpy as np

from ..native import get_ps_server

__all__ = ["PSClient", "PSServerProcess", "DistributedEmbedding",
           "DeviceCachedEmbedding", "serve_forever"]

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def serve_forever(port, num_tables=1, dim=16, optimizer="sgd",
                  init_range=0.1, seed=0, num_workers=1,
                  lost_timeout_ms=30_000):
    """Blocking server entry (run in a dedicated process)."""
    rc = get_ps_server().pt_ps_serve(
        port, num_tables, dim, optimizer.encode(), float(init_range),
        int(seed), int(num_workers), int(lost_timeout_ms))
    if rc != 0:
        raise RuntimeError(f"ps server exited with code {rc}")


class PSServerProcess:
    """Spawn the PS in a child process (reference analog: the pserver
    role process running listen_and_serv).  The child never touches the
    card: it runs with ``CUDA_VISIBLE_DEVICES=""``."""

    def __init__(self, port, num_tables=1, dim=16, optimizer="sgd",
                 init_range=0.1, seed=0, num_workers=1,
                 lost_timeout_ms=30_000):
        get_ps_server()  # build the .so before spawning
        code = (
            "from paddle_tpu_torch.distributed.ps import serve_forever; "
            f"serve_forever({port}, {num_tables}, {dim}, "
            f"'{optimizer}', {init_range}, {seed}, {num_workers}, "
            f"{lost_timeout_ms})")
        env = dict(os.environ)
        env["CUDA_VISIBLE_DEVICES"] = ""
        env["PYTHONPATH"] = _ROOT + os.pathsep + env.get("PYTHONPATH", "")
        self.proc = subprocess.Popen([sys.executable, "-c", code], env=env)
        self.port = port

    def alive(self):
        return self.proc.poll() is None

    def wait(self, timeout=None):
        return self.proc.wait(timeout)

    def kill(self):
        if self.alive():
            self.proc.kill()


class PSClient:
    # 30 s connect budget: the server child starts an interpreter before
    # it listens, which on a loaded machine can take seconds
    def __init__(self, host, port, worker_id=0, retries=300,
                 retry_delay=0.1):
        self._lib = get_ps_server()
        self._h = None
        for _ in range(retries):
            self._h = self._lib.pt_ps_connect(host.encode(), port,
                                              worker_id)
            if self._h:
                break
            time.sleep(retry_delay)
        if not self._h:
            raise ConnectionError(f"cannot reach ps at {host}:{port}")
        self.worker_id = worker_id

    def _check(self, rc, what):
        if rc != 0:
            raise RuntimeError(f"ps {what} failed (rc={rc})")

    def pull(self, table, ids, dim):
        ids = np.ascontiguousarray(ids, dtype=np.int64).ravel()
        out = np.empty((len(ids), dim), dtype=np.float32)
        self._check(self._lib.pt_ps_pull(
            self._h, table, ids.ctypes.data_as(ctypes.c_void_p),
            len(ids), dim, out.ctypes.data_as(ctypes.c_void_p)), "pull")
        return out

    def push(self, table, ids, grads, lr):
        ids = np.ascontiguousarray(ids, dtype=np.int64).ravel()
        grads = np.ascontiguousarray(grads, dtype=np.float32)
        assert grads.shape[0] == len(ids)
        self._check(self._lib.pt_ps_push(
            self._h, table, ids.ctypes.data_as(ctypes.c_void_p),
            len(ids), grads.shape[1],
            grads.ctypes.data_as(ctypes.c_void_p), float(lr)), "push")

    def barrier(self):
        self._check(self._lib.pt_ps_barrier(self._h), "barrier")

    def heartbeat(self):
        self._check(self._lib.pt_ps_heartbeat(self._h), "heartbeat")

    def save(self, path):
        self._check(self._lib.pt_ps_save(self._h, path.encode()), "save")

    def load(self, path):
        self._check(self._lib.pt_ps_load(self._h, path.encode()), "load")

    def stats(self):
        rows = ctypes.c_uint64()
        alive = ctypes.c_uint32()
        lost = ctypes.c_uint32()
        self._check(self._lib.pt_ps_stats(
            self._h, ctypes.byref(rows), ctypes.byref(alive),
            ctypes.byref(lost)), "stats")
        return {"rows": rows.value, "alive_workers": alive.value,
                "lost_workers": lost.value}

    def stop_server(self):
        self._check(self._lib.pt_ps_stop(self._h), "stop")

    def close(self):
        if self._h:
            self._lib.pt_ps_disconnect(self._h)
            self._h = None


class DistributedEmbedding:
    """Host-side sparse prefetch/update around the step (parity:
    distributed_lookup_table_op + parameter_prefetch.cc).

    pull() deduplicates the batch ids (SelectedRows semantics) and
    returns (rows [n_uniq, dim], uniq_ids, inverse) — feed ``rows`` and
    ``inverse`` to the program, gather rows per-position in-graph, and
    push d(loss)/d(rows) back with push()."""

    def __init__(self, client: PSClient, table=0, dim=16):
        self.client = client
        self.table = table
        self.dim = dim

    def pull(self, ids):
        ids = np.asarray(ids, dtype=np.int64).ravel()
        uniq, inverse = np.unique(ids, return_inverse=True)
        rows = self.client.pull(self.table, uniq, self.dim)
        return rows, uniq, inverse.astype(np.int32)

    def push(self, uniq_ids, row_grads, lr):
        self.client.push(self.table, uniq_ids, row_grads, lr)


class DeviceCachedEmbedding:
    """A device-resident hot-rows cache over a PS embedding table (parity:
    framework/fleet/box_wrapper.h: BoxPS keeps a device-side working set
    of the distributed table and feeds lookups from it).

    The cache is a FIXED-capacity ``[capacity, dim]`` float32 tensor on
    ``device`` (``None`` is the card, and raises without one): the host
    tracks id→slot, batches the misses into one PS pull, scatters them
    into free (or evicted) slots with ``index_copy_``, and hands the step
    per-batch SLOT indices — the in-graph lookup is a plain gather from
    the cache, and the sparse grads scatter back by slot.  Eviction is
    least-hit-count among rows not referenced by the current batch.

    Coherence contract (same shape as BoxPS's begin/end-pass): with the
    'sgd' server optimizer, ``push`` applies the identical update to
    the cached copy (``index_add_`` of ``-lr`` times the merged rows), so
    a SINGLE worker's cache stays exact between refreshes; with other
    workers training the same table concurrently call ``refresh()`` at
    sync points (barriers / pass ends) to re-pull cached ids.
    """

    def __init__(self, client, table=0, dim=16, capacity=1024,
                 server_optimizer="sgd", device=None):
        if server_optimizer != "sgd":
            raise ValueError(
                "DeviceCachedEmbedding needs the 'sgd' server optimizer: "
                "the cache mirrors pushes locally, which is only exact "
                "when the server update is plain sgd")
        import torch

        from .._device import resolve_device

        self.client = client
        self.table = table
        self.dim = int(dim)
        self.capacity = int(capacity)
        self.device = resolve_device(device)
        self.cache = torch.zeros((capacity, dim), dtype=torch.float32,
                                 device=self.device)
        self._slot_of = {}        # id -> slot
        self._id_at = {}          # slot -> id
        self._hits = {}           # id -> hit count (eviction order)
        # lazy min-heap of (hits, id): entries go stale when an id's hit
        # count changes or it is evicted; _pop_victim skips them.  Keeps
        # eviction O(log n) amortized instead of a full min() scan per
        # miss
        self._heap = []
        self._free = list(range(capacity - 1, -1, -1))
        self.misses = 0
        self.pulls = 0

    def _rows_in(self, slots, rows):
        """Write host ``rows`` into the cache at ``slots``."""
        import torch

        idx = torch.as_tensor(np.asarray(slots, np.int64),
                              device=self.device)
        src = torch.from_numpy(np.ascontiguousarray(rows, np.float32))
        self.cache.index_copy_(0, idx, src.to(self.device))

    def _bump(self, i):
        self._hits[i] = self._hits.get(i, 0) + 1
        heapq.heappush(self._heap, (self._hits[i], i))
        # stale entries are only drained by evictions; on hit-dominated
        # workloads (working set fits capacity) none ever happen, so
        # compact before the lazy heap grows without bound
        if len(self._heap) > 8 * self.capacity:
            self._heap = [(h, k) for k, h in self._hits.items()
                          if k in self._slot_of]
            heapq.heapify(self._heap)

    def _pop_victim(self, pinned):
        readd = []
        victim = None
        while self._heap:
            h, i = heapq.heappop(self._heap)
            if i not in self._slot_of or self._hits.get(i) != h:
                continue                       # stale entry
            if i in pinned:
                readd.append((h, i))           # needed by this batch
                continue
            victim = i
            break
        for e in readd:
            heapq.heappush(self._heap, e)
        return victim

    def _assign_slots(self, miss_ids, pinned):
        slots = []
        for i in miss_ids:
            if self._free:
                s = self._free.pop()
            else:
                victim = self._pop_victim(pinned)
                if victim is None:
                    raise RuntimeError(
                        f"DeviceCachedEmbedding: batch needs more rows "
                        f"than capacity={self.capacity}")
                s = self._slot_of.pop(victim)
                self._hits.pop(victim, None)
            self._slot_of[i] = s
            self._id_at[s] = i
            slots.append(s)
        return slots

    def lookup_slots(self, ids):
        """Ensure every id is cached; returns int32 slot indices with
        ids' shape.  Feed these to the program and gather
        ``cache[slots]`` in-graph."""
        ids_arr = np.asarray(ids, dtype=np.int64)
        uniq = np.unique(ids_arr.ravel())
        if len(uniq) > self.capacity:
            # checked BEFORE any state mutation: a partial assignment
            # would leave ids mapped to never-written (zero) slots
            raise RuntimeError(
                f"DeviceCachedEmbedding: batch references {len(uniq)} "
                f"unique rows > capacity={self.capacity}")
        pinned = set(int(u) for u in uniq)
        miss = [int(u) for u in uniq if int(u) not in self._slot_of]
        if miss:
            rows = self.client.pull(self.table,
                                    np.asarray(miss, np.int64), self.dim)
            self.pulls += 1
            self.misses += len(miss)
            slots = self._assign_slots(miss, pinned)
            self._rows_in(slots, rows)
        for u in pinned:
            self._bump(u)
        flat = np.asarray([self._slot_of[int(i)]
                           for i in ids_arr.ravel()], np.int32)
        return flat.reshape(ids_arr.shape)

    def push(self, ids, grads, lr):
        """Push sparse grads to the PS and mirror the sgd update onto
        the cached rows (exact single-worker coherence)."""
        ids = np.asarray(ids, np.int64).ravel()
        grads = np.asarray(grads, np.float32).reshape(len(ids), self.dim)
        self.client.push(self.table, ids, grads, lr)
        uniq, inv = np.unique(ids, return_inverse=True)
        merged = np.zeros((len(uniq), self.dim), np.float32)
        np.add.at(merged, inv, grads)
        # mirror only rows STILL cached — an interleaved lookup may have
        # evicted some (the server is already correct either way)
        keep = [k for k, i in enumerate(uniq)
                if int(i) in self._slot_of]
        if keep:
            import torch

            slots = torch.as_tensor(
                np.asarray([self._slot_of[int(uniq[k])] for k in keep],
                           np.int64), device=self.device)
            delta = torch.from_numpy(np.ascontiguousarray(
                -lr * merged[keep], np.float32))
            self.cache.index_add_(0, slots, delta.to(self.device))

    def refresh(self):
        """Re-pull every cached id (call at sync points when OTHER
        workers may have pushed to the same rows)."""
        if not self._slot_of:
            return
        ids = np.asarray(sorted(self._slot_of), np.int64)
        rows = self.client.pull(self.table, ids, self.dim)
        self._rows_in([self._slot_of[int(i)] for i in ids], rows)

    def stats(self):
        return {"cached": len(self._slot_of), "capacity": self.capacity,
                "misses": self.misses, "pulls": self.pulls}
