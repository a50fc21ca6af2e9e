"""Cluster test/bench fixtures.

Counterpart of paddle_tpu/cluster/testing.py, copied; `tiny_lm_engine`
takes ``device`` (None = the card, as every port entry point) in place
of the JAX engine's ``interpret_kernel``.

Two kinds of thing live here:

* WORKER FACTORIES (`timed_backend`, `tiny_lm_engine`) — module-level
  ``module:function`` specs a `WorkerSpec` can name, so the multiproc
  pool tests and the bench build real worker processes from importable
  code instead of un-picklable closures.

* IN-PROCESS DOUBLES (`LoopbackHandle`, `StaticPool`) — the tier-1
  path.  A LoopbackHandle calls a `WorkerServicer` directly (no socket,
  no child process) but keeps the FAILURE SEMANTICS of the real RPC
  client: it runs the ``cluster_rpc`` fault site first and converts an
  injected fault into `WorkerUnavailable`, so the router's re-route
  logic is exercised by fast tests with `resilience.faults.FaultPlan`
  alone.

The timed backend models the DEVICE-BOUND serving regime: a tiny
matmul for realism, then a blocking sleep standing in for a device
dispatch in flight.  From the router's host the sleep is the honest
shape of an accelerator worker — the host thread blocks while the accelerator
works, consuming no host CPU — which is what makes N-worker scaling
measurable on a single-core CI box (N CPU-bound workers could never
scale there).  ``batch_buckets=(1,)`` pins service time to one request
per dispatch so worker-side coalescing cannot confound the router-level
scaling measurement.
"""
from __future__ import annotations

import threading
import time

import numpy as np

from ..resilience.faults import InjectedFault, maybe_fail
from .rpc import WorkerUnavailable
from .worker import WorkerServicer

__all__ = ["timed_backend", "tiny_lm_engine", "LoopbackHandle",
           "StaticPool"]


def timed_backend(service_ms=20.0, width=8):
    """Factory (for WorkerSpec / infer role): a ``feeds -> [y]``
    backend whose service time is ``service_ms`` of blocked-on-device
    emulation per single-request dispatch."""
    from ..serving.config import ServingConfig
    from ..serving.server import CallableBackend

    w = (np.arange(width * width, dtype=np.float32)
         .reshape(width, width) / width)

    def fn(feeds):
        y = np.asarray(feeds["x"], np.float32) @ w
        time.sleep(service_ms / 1e3)
        return [y]

    backend = CallableBackend(
        fn, input_names=["x"],
        input_spec={"x": ((width,), np.dtype(np.float32))})
    return backend, ServingConfig(batch_buckets=(1,),
                                  max_queue_size=1024,
                                  max_batch_wait_ms=0.0)


def tiny_lm_engine(seed=0, max_seqs=4, max_seq_len=64,
                   scheduling="chunked", speculation=None, spec_k=4,
                   prefix_cache=False, num_pages=None, device=None,
                   dtype="float32"):
    """Factory (for WorkerSpec / prefill+decode+generate roles): a small
    LM GenerationEngine with DETERMINISTIC params — every process that
    calls this with the same seed holds bit-identical weights (the JAX
    package's factory draws the same ones), which is what makes
    cross-process token parity a meaningful check.  ``device=None`` is
    the card; a spec's kwargs pass ``{"device": "cpu"}`` without one.
    ``dtype`` is the KV cache's (GenerationConfig.dtype)."""
    from ..generation import GenerationConfig, GenerationEngine
    from ..models.transformer import BertConfig, lm_random_params

    # initializer_range 0.5 (not the LM-training 0.02): at tiny scale a
    # 0.02 init degenerates to echoing the last prompt token through
    # the tied-embedding residual path — which would make greedy
    # token-parity checks pass even with a BROKEN KV handoff.  The
    # larger init gives chaotic, genuinely context-dependent argmax
    # trajectories, so parity certifies the shipped KV state.
    cfg = BertConfig(vocab_size=64, hidden_size=32, num_layers=2,
                     num_heads=4, ffn_size=64, max_position=max_seq_len,
                     type_vocab_size=1, initializer_range=0.5)
    params = lm_random_params(cfg, np.random.RandomState(seed))
    gcfg = GenerationConfig(
        page_size=8, max_seqs=max_seqs, max_seq_len=max_seq_len,
        seed=seed, scheduling=scheduling, speculation=speculation,
        spec_k=spec_k, prefix_cache=prefix_cache, num_pages=num_pages,
        dtype=dtype)
    return GenerationEngine(cfg, params, gcfg, device=device)


class LoopbackHandle:
    """A WorkerHandle stand-in that dispatches to an IN-PROCESS
    servicer through the same envelope (`WorkerServicer.handle`) and
    the same fault site as the socket path."""

    def __init__(self, rank, servicer):
        self.rank = rank
        self.endpoint = f"loopback:{rank}"
        self.proc = None
        self.alive = True
        self.draining = False
        self.model_id = None
        self.reaped = False
        self._servicer = servicer
        self._lock = threading.Lock()   # RpcClient's one-at-a-time rule

    def call(self, op, _io_timeout_s=None, **payload):
        # _io_timeout_s is the real RpcClient's per-call socket knob —
        # accepted (routers pass it) and meaningless in-process
        if not self.alive:
            raise WorkerUnavailable(
                f"worker {self.rank} ({self.endpoint}) is not alive")
        msg = {"op": op}
        msg.update(payload)
        with self._lock:
            try:
                maybe_fail("cluster_rpc", endpoint=self.endpoint, op=op)
            except InjectedFault as e:
                raise WorkerUnavailable(
                    f"worker at {self.endpoint} lost during {op!r}: "
                    f"{e}") from e
            return self._servicer.handle(msg)

    def cancel(self, uid):
        """The router's hedging loser-cancellation path.  Bypasses the
        one-at-a-time lock on purpose — the real transport sends cancel
        on the DEDICATED health connection precisely so it can overtake
        a request in flight on the request connection."""
        return self._servicer.handle({"op": "cancel", "uid": uid})

    def close(self):
        pass


class StaticPool:
    """The WorkerPool surface (handles / alive_count / mark_dead /
    add_death_callback / kill / close) over loopback handles — no
    processes, no sockets; tier-1 tests drive the full Router against
    it."""

    def __init__(self, role, factories, factory_kwargs=None):
        """``factories`` is a list of factory callables (one worker
        each); a single callable is shorthand for N identical workers
        only when wrapped by the caller."""
        self.role = role
        self._default_factory = factories[0] if factories else None
        self._default_kwargs = factory_kwargs
        self.workers = [
            LoopbackHandle(rank, WorkerServicer(
                role, fac, factory_kwargs=factory_kwargs, rank=rank))
            for rank, fac in enumerate(factories)]
        self._death_cbs = []
        self._lock = threading.Lock()

    def handles(self):
        return list(self.workers)

    def alive_count(self):
        return sum(1 for h in self.workers if h.alive)

    def add_death_callback(self, fn):
        self._death_cbs.append(fn)

    def mark_dead(self, rank):
        h = self.workers[rank]
        with self._lock:
            if not h.alive:
                return
            h.alive = False
        for cb in self._death_cbs:
            cb(h)

    def kill(self, rank):
        self.mark_dead(rank)

    # -- elasticity (the WorkerPool surface, in-process) --------------------
    def spawn_worker(self, factory=None, factory_kwargs=None,
                     model_id=None, role=None):
        """One extra loopback worker; the servicer warms up in-line
        (same admission-after-warmup contract as the real pool)."""
        with self._lock:
            rank = len(self.workers)
        h = LoopbackHandle(rank, WorkerServicer(
            role or self.role, factory or self._default_factory,
            factory_kwargs=(factory_kwargs
                            if factory_kwargs is not None
                            else self._default_kwargs),
            rank=rank))
        h.model_id = model_id
        with self._lock:
            self.workers.append(h)
        return h

    def retire(self, rank, timeout=None):
        h = self.workers[rank]
        with self._lock:
            if h.reaped:
                return
            h.reaped = True
            was_alive = h.alive
            h.alive = False
        h._servicer.close()
        if was_alive:
            for cb in self._death_cbs:
                cb(h)

    def close(self, timeout=None):
        for h in self.workers:
            self.retire(h.rank, timeout=timeout)
