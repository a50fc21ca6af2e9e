"""WorkerPool — spawn, health-check and tear down cluster workers.

Counterpart of paddle_tpu/cluster/pool.py, copied without the JAX
package's CPU-device environment (``cpu_devices``, ``JAX_PLATFORMS``,
``XLA_FLAGS``): a child runs ``python -m paddle_tpu_torch.cluster.worker``
with the parent's environment, so it sees the parent's card.  Children
are spawned with ``subprocess.Popen`` (never forked: a forked child of
a process that has initialised CUDA cannot use it).

Process management reuses the launcher's machinery
(distributed/launch.py): ports come from a `PortReservation` (the
TOCTOU-free allocator), children get the PADDLE_* env contract the
launcher established (TRAINER_ID / TRAINERS_NUM / TRAINER_ENDPOINTS /
CURRENT_ENDPOINT / COORDINATOR), per-rank logs mirror its
``workerlog.N`` convention, and teardown is `terminate_procs` (SIGTERM,
shared deadline, SIGKILL stragglers).

Health: a monitor thread pings each worker over a DEDICATED health
connection (so a long-running infer on the request connection cannot
make a healthy worker look dead).  A failed ping or a dead child
process marks the handle dead and fires the registered death callbacks
— the Router uses that to stop dispatching to the worker and re-route
its in-flight request.

The pool is duck-typed: the Router only needs ``handles() /
alive_count() / mark_dead() / add_death_callback()``, which
`cluster.testing.StaticPool` also implements for in-process tier-1
tests.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

from ..distributed.launch import reserve_ports, terminate_procs
from .rpc import RpcClient, WorkerUnavailable

__all__ = ["WorkerSpec", "WorkerHandle", "WorkerPool"]

# keep each worker off its siblings' threads — on shared hosts N
# workers x M BLAS threads thrash; the device-bound regime the cluster
# models never needed host parallelism anyway
_THREAD_LIMIT_ENV = {
    "OMP_NUM_THREADS": "1",
    "OPENBLAS_NUM_THREADS": "1",
    "MKL_NUM_THREADS": "1",
}


@dataclasses.dataclass
class WorkerSpec:
    """What to run in each worker: a factory ``module:function`` import
    spec (resolved inside the child — the factory itself need not
    pickle), its kwargs, and the role (infer | prefill | decode)."""

    factory: str
    kwargs: dict = dataclasses.field(default_factory=dict)
    role: str = "infer"


class WorkerHandle:
    """One worker as the router sees it: endpoint, liveness, and the
    two connections (requests + health)."""

    def __init__(self, rank, host, port, proc=None, log_path=None):
        self.rank = rank
        self.host, self.port = host, port
        self.endpoint = f"{host}:{port}"
        self.proc = proc
        self.log_path = log_path
        self.client = None
        self.health_client = None
        self.alive = False
        self.draining = False    # router stops dispatching, stays alive
        self.model_id = None     # fleet multiplexing: which model it serves
        self.reaped = False      # proc/clients released exactly once

    def call(self, op, **payload):
        if not self.alive or self.client is None:
            raise WorkerUnavailable(
                f"worker {self.rank} ({self.endpoint}) is not alive")
        return self.client.call(op, **payload)

    def close(self):
        for c in (self.client, self.health_client):
            if c is not None:
                c.close()
        self.client = self.health_client = None


class WorkerPool:
    def __init__(self, spec, n, host="127.0.0.1",
                 log_dir=None, ready_timeout_s=120.0,
                 health_interval_s=0.5, health_timeout_s=2.0,
                 health_failures=3, python=None):
        if n < 1:
            raise ValueError("pool needs at least one worker")
        self.spec = spec
        self.n = int(n)
        self._host = host
        self._log_dir = log_dir or tempfile.mkdtemp(
            prefix="paddle_tpu_torch_cluster_")
        self._ready_timeout_s = ready_timeout_s
        self._health_interval_s = health_interval_s
        self._health_timeout_s = health_timeout_s
        # one dropped ping must not kill a healthy worker: only N
        # CONSECUTIVE failures (strikes) mark it dead; any success
        # resets the count.  A dead child process is still immediate.
        self._health_failures = int(health_failures)
        self._health_strikes = {}   # rank -> consecutive ping failures
        self._python = python or sys.executable
        self._lock = threading.Lock()
        self._death_cbs = []
        self._closed = False
        self._monitor = None
        self._log_files = []
        self.workers = []
        self._spawn_all()

    # -- spawning ----------------------------------------------------------
    def _child_env(self, rank, endpoints):
        env = os.environ.copy()
        env.update(_THREAD_LIMIT_ENV)
        env.update({
            "PADDLE_TRAINER_ID": str(rank),
            "PADDLE_TRAINERS_NUM": str(self.n),
            "PADDLE_TRAINER_ENDPOINTS": ",".join(endpoints),
            "PADDLE_CURRENT_ENDPOINT": endpoints[rank],
            "PADDLE_COORDINATOR": endpoints[0],
        })
        # the child runs `-m paddle_tpu_torch.cluster.worker`: make sure the
        # repo root is importable even when the parent runs from a
        # different cwd
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env["PYTHONPATH"] = (root + os.pathsep + env["PYTHONPATH"]
                             if env.get("PYTHONPATH") else root)
        return env

    def _spawn_one(self, rank, port, endpoints, spec):
        cmd_tail = ["-u", "-m", "paddle_tpu_torch.cluster.worker",
                    "--spec", spec.factory,
                    "--role", spec.role,
                    "--kwargs", json.dumps(spec.kwargs)]
        log_path = os.path.join(self._log_dir, f"workerlog.{rank}")
        f = open(log_path, "w")
        self._log_files.append(f)
        proc = subprocess.Popen(
            [self._python] + cmd_tail,
            env=self._child_env(rank, endpoints),
            stdout=f, stderr=subprocess.STDOUT)
        return WorkerHandle(rank, self._host, port, proc=proc,
                            log_path=log_path)

    def _spawn_all(self):
        os.makedirs(self._log_dir, exist_ok=True)
        with reserve_ports(self.n, host=self._host) as res:
            ports = list(res.ports)
        self._endpoints = [f"{self._host}:{p}" for p in ports]
        for rank, port in enumerate(ports):
            self.workers.append(
                self._spawn_one(rank, port, self._endpoints, self.spec))

    def _connect(self, h, budget, close_pool=True):
        """Connect both clients and confirm health; flips ``alive``."""
        try:
            h.client = RpcClient(h.host, h.port,
                                 connect_timeout_s=budget)
            h.health_client = RpcClient(h.host, h.port,
                                        connect_timeout_s=5.0)
            resp = h.health_client.call("health")
        except WorkerUnavailable:
            self._fail_bringup(h, close_pool=close_pool)
            raise
        if not resp.get("ok"):
            self._fail_bringup(h, close_pool=close_pool)
            raise WorkerUnavailable(
                f"worker {h.rank} failed health: {resp}")
        h.alive = True

    def wait_ready(self):
        """Block until every worker answers a health ping (covers the
        child's imports + engine warmup).  Returns self so
        ``pool = WorkerPool(...).wait_ready()`` composes."""
        deadline = time.monotonic() + self._ready_timeout_s
        for h in self.workers:
            self._connect(h, max(1.0, deadline - time.monotonic()))
        self._monitor = threading.Thread(
            target=self._health_loop, name="cluster-health", daemon=True)
        self._monitor.start()
        return self

    # -- elasticity ---------------------------------------------------------
    def spawn_worker(self, spec=None, model_id=None,
                     ready_timeout_s=None):
        """Launch ONE extra worker (autoscaler scale-up / rollout
        replacement) and block until it answers health — warmup happens
        in the child before READY, so by the time this returns the
        worker serves with zero steady-state compiles.  The new handle
        is NOT yet routable: the caller attaches it to a router
        (``router.attach_worker``) once any admission checks pass."""
        if self._closed:
            raise WorkerUnavailable("pool is closed")
        with self._lock:
            rank = len(self.workers)
        with reserve_ports(1, host=self._host) as res:
            port = res.ports[0]
        endpoints = list(getattr(self, "_endpoints", [])) + [
            f"{self._host}:{port}"]
        self._endpoints = endpoints
        h = self._spawn_one(rank, port, endpoints, spec or self.spec)
        h.model_id = model_id
        with self._lock:
            self.workers.append(h)
        # a failed elastic bringup must reap ONLY this worker — closing
        # the whole pool here would let one bad respawn nuke the fleet
        self._connect(h, ready_timeout_s or self._ready_timeout_s,
                      close_pool=False)
        return h

    def _fail_bringup(self, h, close_pool=True):
        tail = ""
        try:
            with open(h.log_path) as f:
                tail = f.read()[-2000:]
        except OSError:
            pass
        if tail:
            sys.stderr.write(
                f"--- worker {h.rank} log tail ---\n{tail}\n")
        if close_pool:
            self.close()
            return
        claimed, _was_alive = self._claim_reap(h)
        if claimed:
            h.close()
            if h.proc is not None:
                terminate_procs([h.proc], timeout=5.0)

    # -- health ------------------------------------------------------------
    def add_death_callback(self, fn):
        """fn(handle) — called (from the monitor or a marking thread)
        when a worker transitions alive -> dead."""
        self._death_cbs.append(fn)

    def mark_dead(self, rank):
        with self._lock:
            h = self.workers[rank]
            if not h.alive:
                return
            h.alive = False
            self._health_strikes.pop(rank, None)
        h.close()
        for cb in self._death_cbs:
            cb(h)

    def _health_check_once(self):
        """One sweep over the workers: a dead CHILD PROCESS is marked
        immediately (unambiguous), a failed PING only adds a strike —
        ``health_failures`` consecutive strikes mark the worker dead,
        any successful ping resets its count."""
        for h in self.workers:
            if self._closed or not h.alive:
                continue
            if h.proc is not None and h.proc.poll() is not None:
                self.mark_dead(h.rank)
                continue
            try:
                h.health_client.call(
                    "health", _io_timeout_s=self._health_timeout_s)
            except WorkerUnavailable:
                if self._closed:
                    continue
                with self._lock:
                    n = self._health_strikes.get(h.rank, 0) + 1
                    self._health_strikes[h.rank] = n
                if n >= self._health_failures:
                    self.mark_dead(h.rank)
            else:
                with self._lock:
                    self._health_strikes.pop(h.rank, None)

    def _health_loop(self):
        while not self._closed:
            time.sleep(self._health_interval_s)
            self._health_check_once()

    # -- router-facing surface ---------------------------------------------
    def handles(self):
        return list(self.workers)

    def alive_count(self):
        return sum(1 for h in self.workers if h.alive)

    # -- teardown ----------------------------------------------------------
    def kill(self, rank):
        """Hard-kill one worker (fault-injection tests); the health
        monitor notices and marks it dead."""
        h = self.workers[rank]
        if h.proc is not None:
            h.proc.kill()

    def _claim_reap(self, h):
        """Atomically claim the right to release this worker's proc and
        clients.  Returns ``(claimed, was_alive)``: the health
        monitor's death callback (via :meth:`mark_dead`) and
        ``close()``/``retire()`` can race on a worker that died
        mid-drain — whoever claims first reaps; everyone else sees
        ``claimed=False`` and does nothing.  ``was_alive`` tells the
        claimer whether the alive->dead transition (and therefore the
        death callbacks) is still theirs to run, so
        ``cluster_workers_alive`` ends at 0 and never goes negative."""
        with self._lock:
            if h.reaped:
                return False, False
            h.reaped = True
            was_alive = h.alive
            h.alive = False
        return True, was_alive

    def _reap(self, h, was_alive, graceful, timeout):
        if graceful and was_alive and h.client is not None:
            try:
                h.client.call("shutdown")
            except WorkerUnavailable:
                pass
        h.close()
        if h.proc is not None:
            terminate_procs([h.proc], timeout=timeout)
        if was_alive:
            for cb in self._death_cbs:
                cb(h)

    def retire(self, rank, timeout=10.0):
        """Graceful intentional removal (autoscaler scale-down /
        rollout): shutdown RPC, reap the proc exactly once, fire the
        death callbacks so gauges settle.  The caller is responsible
        for draining the worker through the router FIRST — retire does
        not wait for in-flight work."""
        h = self.workers[rank]
        claimed, was_alive = self._claim_reap(h)
        if claimed:
            self._reap(h, was_alive, graceful=True, timeout=timeout)

    def close(self, timeout=10.0):
        with self._lock:
            if self._closed:
                return
            self._closed = True
        claims, procs = [], []
        for h in self.workers:
            claimed, was_alive = self._claim_reap(h)
            if not claimed:
                continue
            if was_alive and h.client is not None:
                try:
                    h.client.call("shutdown")
                except WorkerUnavailable:
                    pass
            h.close()
            if h.proc is not None:
                procs.append(h.proc)
            claims.append((h, was_alive))
        terminate_procs(procs, timeout=timeout)
        for h, was_alive in claims:
            if was_alive:
                for cb in self._death_cbs:
                    cb(h)
        for f in self._log_files:
            try:
                f.close()
            except OSError:
                pass

    def __enter__(self):
        return self.wait_ready()

    def __exit__(self, *exc):
        self.close()
        return False
