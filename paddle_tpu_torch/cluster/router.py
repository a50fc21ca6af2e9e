"""Router — the cluster's front door.

Counterpart of paddle_tpu/cluster/router.py, copied.

Speaks the same client surface as `serving.InferenceServer`
(``submit() -> future`` / ``infer()`` / ``stats()`` / ``close(drain)``)
but instead of batching onto one in-process backend it fans requests
over a pool of worker PROCESSES, with:

* SLO-aware admission — per-tenant quotas (outstanding-request budget),
  priority queues (higher first, FIFO within a priority), and load
  shedding off queue depth and the router's own p99 latency signal
  (both live on the observability registry);
* health-based re-routing — a worker loss (health probe, dead child,
  or an RPC that dies mid-request) re-queues the in-flight request at
  the FRONT of the queue for the surviving workers, up to
  ``max_reroutes`` attempts;
* prefill/decode disaggregation (`GenerationRouter`) — prompts go to a
  PREFILL pool whose workers return serialized KV state
  (generation.PrefillHandoff); the router forwards the handoffs to a
  DECODE pool running the continuous-batching engine.  Because the
  handoff lives in router memory between the stages, a decode-worker
  death re-routes the sequence WITHOUT re-running its prefill.

Dispatch model: one dispatcher thread per worker.  Each worker's
RpcClient carries one request at a time, so per-worker concurrency is
1 — the queue in front is where batching pressure accumulates, and the
worker's own InferenceServer still coalesces (closed-loop clients >
workers keep it fed).  A dispatcher exits when its worker dies; the
queue drains through the survivors.

Tracing: ``submit`` captures the CLIENT thread's span context; the
dispatcher attaches it, opens a ``cluster:dispatch`` span, and ships
``(trace_id, span_id)`` in the RPC so the worker's spans parent on the
router's — one merged Chrome trace shows the full cross-process chain.
"""
from __future__ import annotations

import collections
import dataclasses
import heapq
import itertools
import threading
import time

import numpy as np

from ..observability import flightrec as _flightrec
from ..observability import ledger as _ledger
from ..observability import tracing as _tracing
from ..resilience.retry import degradations
from ..serving.batcher import (RequestTimeoutError, ServerClosedError,
                               ServingError)
from .rpc import WorkerUnavailable
from .stats import ClusterStats

__all__ = ["ClusterConfig", "QuotaExceededError", "ClusterOverloadError",
           "ModelUnavailableError", "Router", "GenerationRouter"]

#: Slack added on top of a request's remaining deadline budget when
#: deriving the per-call socket timeout — covers worker-side queueing
#: and the response's trip back.
_IO_GRACE_S = 5.0


class QuotaExceededError(ServingError):
    """The tenant (or model) is at its outstanding-request budget —
    shed, distinct from overload so clients can tell 'slow down' from
    'cluster busy'.  ``model_id`` names the model the request carried,
    so per-model shed accounting is attributable from the exception
    alone."""

    def __init__(self, msg, model_id=None):
        super().__init__(msg)
        self.model_id = model_id


class ClusterOverloadError(ServingError):
    """Admission shed: queue depth or p99 over the configured bound.
    ``model_id`` names the model the request carried."""

    def __init__(self, msg, model_id=None):
        super().__init__(msg)
        self.model_id = model_id


class ModelUnavailableError(ClusterOverloadError):
    """No warm worker serves this model — it is cold (never launched)
    or fully draining.  A fleet autoscaler treats the ``model_cold``
    shed series this raises as the background-warmup trigger; admission
    flips only after the warmed worker attaches."""


@dataclasses.dataclass
class ClusterConfig:
    """Router knobs.

    - ``max_queue_depth``: hard admission bound on queued requests.
    - ``tenant_quota``: max OUTSTANDING (queued + in-flight) requests
      per tenant — an int applied to every tenant, or a dict
      ``{tenant: quota}`` (missing tenants unlimited).
    - ``shed_p99_ms`` / ``shed_min_depth``: when the router's own p99
      exceeds ``shed_p99_ms`` AND at least ``shed_min_depth`` requests
      are queued, new work is shed (the depth floor keeps a latency
      spike from shedding an otherwise idle router).
    - ``slo_window_s``: the p99 driving SLO shedding (and the
      autoscaler's ``fleet_signals``) reads only the trailing window —
      a lifetime-cumulative read would let ONE latency incident poison
      the signal for the rest of the process.  Snapshots keep the
      cumulative read.
    - ``max_reroutes``: re-dispatch budget per request after worker
      losses.
    - ``reroute_wait_for_respawn``: when a loss empties the routable
      set, a re-routed request normally FAILS FAST ("no workers left" —
      nothing will ever revive an unsupervised pool, so waiting would
      hang).  Supervised deployments (`fleet.Supervisor`) set this True
      to REQUEUE instead: the request (still bounded by its
      ``max_reroutes`` budget and deadline) waits for the respawned
      worker to attach — a transient blip on the last survivor stops
      costing dropped requests.  An empty pool has no dispatcher left
      to pop the queue, so a dedicated park monitor enforces the
      bound: it fails a parked request the moment its deadline
      expires, the supervisor permanently degrades the model
      (``fleet.supervisor:<model>`` crash-loop budget exhausted), or
      ``respawn_wait_timeout_s`` elapses with no capacity restored.
    - ``respawn_wait_timeout_s``: longest a request parked by
      ``reroute_wait_for_respawn`` may wait for a replacement worker
      — the backstop for deadline-less requests when no supervisor is
      healing the pool (None = wait for the deadline alone).
    - ``hedge_after_p99_factor``: tail-latency hedging — when set, a
      request still unfinished after ``factor x windowed-p99`` gets a
      DUPLICATE dispatched to a second worker; first result wins and
      the loser is cancelled via the ``cancel`` worker verb.  The
      engines' folded per-(uid, position) sampling keys are schedule-
      invariant and the default sampling is greedy, so the duplicate
      computes IDENTICAL tokens — hedging is parity-safe by
      construction.  None disables (the default).
    - ``hedge_max_inflight``: total simultaneous copies of one request
      (primary + duplicates); the default 2 allows one duplicate.
    - ``default_timeout_ms``: per-request deadline (None = none).  The
      deadline PROPAGATES: every RPC carries the remaining budget
      (``deadline_ms``), workers reject already-expired work at
      admission (counted per site on
      ``cluster_deadline_expired_total``), and the socket I/O timeout
      derives from the budget instead of a flat constant.
    - ``drain_timeout_s``: close(drain=True) budget.
    - ``decode_batch``: GenerationRouter only — max handoffs grouped
      into one decode RPC (amortizes the per-call round trip into the
      worker's continuous batch).
    - ``stream_pages``: GenerationRouter two-pool mode — ship prefill
      KV to the decode worker CHUNK BY CHUNK as the prefill computes
      (overlapping transfer with compute, and letting the decode
      pool's prefix cache elide already-resident spans) instead of one
      monolithic post-prefill handoff.  The router still accumulates
      the full KV in its own memory, so a decode-worker death replays
      through the existing handoff path; workers without the
      streaming verbs fall back to the monolithic RPC automatically.
    """

    max_queue_depth: int = 256
    tenant_quota: object = None
    default_tenant: str = "default"
    shed_p99_ms: float = None
    shed_min_depth: int = 8
    slo_window_s: float = 30.0
    max_reroutes: int = 2
    reroute_wait_for_respawn: bool = False
    respawn_wait_timeout_s: float = 30.0
    hedge_after_p99_factor: float = None
    hedge_max_inflight: int = 2
    default_timeout_ms: float = None
    drain_timeout_s: float = 30.0
    decode_batch: int = 4
    stream_pages: bool = True
    # fleet multiplexing: requests carry a model id routed to that
    # model's warm-worker set; ``model_quota`` bounds OUTSTANDING
    # requests per model (int for all, or {model: quota})
    default_model: str = "default"
    model_quota: object = None

    def quota_for(self, tenant):
        if self.tenant_quota is None:
            return None
        if isinstance(self.tenant_quota, dict):
            return self.tenant_quota.get(tenant)
        return int(self.tenant_quota)

    def model_quota_for(self, model):
        if self.model_quota is None:
            return None
        if isinstance(self.model_quota, dict):
            return self.model_quota.get(model)
        return int(self.model_quota)


class ClusterFuture:
    """Client-side handle (the InferenceFuture contract: result /
    done / set_result / set_error), plus the routing state the
    dispatchers need (tenant, priority, attempts, payload)."""

    __slots__ = ("payload", "tenant", "model", "priority", "deadline",
                 "attempts", "trace_ctx", "t_submit", "handoff", "stream",
                 "uid", "hedges", "t_admit", "t_dispatch", "t_first_token",
                 "worker", "trace_id", "hedge_outcome", "led",
                 "_event", "_outputs", "_error", "_on_done", "_lock")

    def __init__(self, payload, tenant, priority, deadline, on_done,
                 model=None):
        self.payload = payload
        self.tenant = tenant
        self.model = model
        self.priority = priority
        self.deadline = deadline          # absolute monotonic or None
        self.attempts = 0
        self.uid = None                   # assigned at admission
        self.hedges = 0                   # duplicates fired so far
        self.trace_ctx = _tracing.current_span()
        self.t_submit = time.monotonic()
        self.handoff = None               # GenerationRouter stage state
        self.stream = None                # (decode rank, stream id) or None
        # request-ledger lifecycle state (stamped by admission and the
        # dispatch path, read once at the _on_request_done terminal)
        self.t_admit = 0.0
        self.t_dispatch = 0.0             # FIRST dispatch only
        self.t_first_token = 0.0
        self.worker = ""                  # rank of the first dispatch
        self.trace_id = ""                # dispatch span's trace id
        self.hedge_outcome = ""           # "won" when a hedge twin won
        self.led = None                   # engine counts off the reply
        self._event = threading.Event()
        self._outputs = None
        self._error = None
        self._on_done = on_done
        self._lock = threading.Lock()

    def done(self):
        return self._event.is_set()

    def expired(self, now=None):
        return self.deadline is not None and \
            (now if now is not None else time.monotonic()) > self.deadline

    def result(self, timeout=None):
        if not self._event.wait(timeout):
            raise RequestTimeoutError(
                f"no result within {timeout}s (request still in flight)")
        if self._error is not None:
            raise self._error
        return self._outputs

    def set_result(self, outputs):
        return self._finish(ok=True, outputs=outputs)

    def set_error(self, exc):
        return self._finish(ok=False, error=exc)

    def _finish(self, ok, outputs=None, error=None):
        # The terminal state is write-once: a hedge loser (or the cancel
        # fan-out bouncing an already-won request) must not clobber the
        # winner's outputs/error, so the assignment lives INSIDE the
        # locked done-check.  Returns whether this call won the race.
        with self._lock:
            if self._event.is_set():
                return False
            if ok:
                self._outputs = outputs
            else:
                self._error = error
            cb, self._on_done = self._on_done, None
            self._event.set()
        if cb is not None:
            cb(self, ok)
        return True


class _HedgeClone:
    """A tail-latency hedge: a DUPLICATE of a still-unfinished request
    riding the same work queue, dispatched by whichever worker grabs it
    first.  First result wins — `ClusterFuture._finish` is idempotent,
    so whichever copy lands second is silently ignored.  The clone
    carries its OWN reroute budget but shares the primary's uid, so the
    router's post-completion ``cancel`` fan-out drops whichever copy is
    still queued on a worker.  A clone's failure never fails the
    primary (the other copy may still win)."""

    is_hedge = True

    __slots__ = ("primary", "attempts", "_stats")

    def __init__(self, primary, stats):
        self.primary = primary
        self.attempts = primary.attempts
        self._stats = stats

    @property
    def payload(self):
        return self.primary.payload

    @property
    def tenant(self):
        return self.primary.tenant

    @property
    def model(self):
        return self.primary.model

    @property
    def priority(self):
        return self.primary.priority

    @property
    def deadline(self):
        return self.primary.deadline

    @property
    def trace_ctx(self):
        return self.primary.trace_ctx

    @property
    def uid(self):
        return self.primary.uid

    def done(self):
        return self.primary.done()

    def expired(self, now=None):
        return self.primary.expired(now)

    def set_result(self, outputs):
        # tentatively mark "won" BEFORE finishing: _finish runs the
        # terminal callback (which closes the ledger record) inline, so
        # the stamp must already be visible.  When the primary actually
        # beat us the record is already closed — the late stamp is a
        # no-op on it.
        self.primary.hedge_outcome = "won"
        won = self.primary.set_result(outputs)
        self._stats.on_hedge("won" if won else "lost")

    def set_error(self, exc):
        # the duplicate died (reroutes exhausted, worker bug): the
        # primary copy is still in flight — swallow, count the hedge
        self._stats.on_hedge("lost")


class _WorkQueue:
    """Priority queue (+ requeue-to-front) shared by a stage's
    dispatchers.  Heap entries are ``(-priority, seq, req)``: higher
    priority first, FIFO within a priority; a re-routed request takes a
    DECREMENTING seq so it beats everything queued at its priority."""

    def __init__(self):
        self._heap = []
        self._cond = threading.Condition()
        self._seq = itertools.count()
        self._front = itertools.count(-1, -1)
        self.closed = False

    def __len__(self):
        with self._cond:
            return len(self._heap)

    def put(self, req, front=False):
        with self._cond:
            seq = next(self._front) if front else next(self._seq)
            heapq.heappush(self._heap, (-req.priority, seq, req))
            self._cond.notify()

    def get(self, should_run):
        """Pop the next request; None means stop (queue closed and
        empty, or ``should_run()`` went false — worker death / router
        close wakes every waiter via :meth:`kick`)."""
        with self._cond:
            while True:
                if not should_run():
                    return None
                if self._heap:
                    return heapq.heappop(self._heap)[2]
                if self.closed:
                    return None
                self._cond.wait(timeout=0.1)

    def try_get(self):
        """Non-blocking pop (the decode-stage group gatherer)."""
        with self._cond:
            return heapq.heappop(self._heap)[2] if self._heap else None

    def kick(self):
        with self._cond:
            self._cond.notify_all()

    def purge_done(self):
        """Drop entries whose request already settled (the park
        monitor failed it, or a hedge's primary won) — on an empty
        pool no dispatcher will ever pop them, and a dead entry must
        not hold ``close(drain=True)`` for the full drain budget."""
        with self._cond:
            keep = [e for e in self._heap if not e[2].done()]
            if len(keep) != len(self._heap):
                self._heap = keep
                heapq.heapify(self._heap)
                self._cond.notify_all()

    def close(self):
        with self._cond:
            self.closed = True
            self._cond.notify_all()

    def drain_remaining(self):
        with self._cond:
            out = [e[2] for e in self._heap]
            self._heap.clear()
        return out


class _RouterBase:
    """Admission control + per-worker dispatcher lifecycle, shared by
    the flat Router and the two-stage GenerationRouter."""

    def __init__(self, config):
        self.cfg = config or ClusterConfig()
        self.stats_ = ClusterStats()
        # per-router request ledger: one lifecycle record per
        # completed/failed request, closed at _on_request_done
        self.ledger = _ledger.RequestLedger(
            name=str(self.stats_.router_id))
        self._lock = threading.Lock()
        self._tenant_out = {}     # tenant -> outstanding count
        self._model_out = {}      # model -> outstanding count
        self._model_inflight = {}  # model -> dispatched, not finished
        self._inflight = 0
        self._closed = False     # dispatchers stop
        self._closing = False    # admission stops (drain keeps running)
        self._threads = []
        self._queues = []
        self._model_queues = {}   # model -> _WorkQueue (subset of above)
        self._model_workers = {}  # model -> [handles] (warm-worker set)
        self._handle_threads = {}  # id(handle) -> [dispatcher threads]
        # tail-latency hedging state (armed by _start_hedging when the
        # config sets hedge_after_p99_factor)
        self._uid_seq = itertools.count()
        self._outstanding = {}    # uid -> ClusterFuture (hedgeable only)
        self._hedgeable = False
        self._hedge_thread = None
        # loser cancellation: bounded fire-and-forget queue drained off
        # the dispatcher threads (advisory — shedding the oldest entry
        # under overload is safe)
        self._cancel_q = collections.deque(maxlen=1024)
        self._cancel_wake = threading.Event()
        self._cancel_thread = None
        # reroute_wait_for_respawn: requests parked on an empty pool
        # (no dispatcher left to pop them) watched by a lazy monitor
        # thread that enforces deadline / degradation / park timeout
        self._parked = {}         # id(req) -> (req, queue, parked_at)
        self._park_thread = None

    # -- admission ---------------------------------------------------------
    def _model_routable(self, model):
        hs = self._model_workers.get(model)
        return (any(h.alive and not getattr(h, "draining", False)
                    for h in hs) if hs else False)

    def _ledger_shed(self, tenant, model, priority):
        """A shed IS a failed request: it gets its own ledger record
        (outcome="shed") at the admission site — nothing else will ever
        reach the terminal seam for it."""
        if not _ledger.enabled():
            return
        now = time.monotonic()
        self.ledger.record(tenant=tenant, model=model,
                           priority=priority, outcome="shed",
                           t_admit=now, t_done=now)

    def _admit(self, payload, tenant, priority, timeout_ms, model=None):
        if self._closed or self._closing:
            raise ServerClosedError("router is shut down")
        tenant = tenant or self.cfg.default_tenant
        model = model or self.cfg.default_model
        # cold/draining model first: no warm worker serves it, so the
        # request could only strand — shed with its own reason, which
        # is the autoscaler's background-warmup trigger
        if not self._model_routable(model):
            self.stats_.on_shed(tenant, "model_cold", model)
            self._ledger_shed(tenant, model, priority)
            raise ModelUnavailableError(
                f"model {model!r} has no warm worker (cold or "
                f"draining)", model_id=model)
        quota = self.cfg.quota_for(tenant)
        mquota = self.cfg.model_quota_for(model)
        with self._lock:
            out = self._tenant_out.get(tenant, 0)
            if quota is not None and out >= quota:
                self.stats_.on_shed(tenant, "quota", model)
                self._ledger_shed(tenant, model, priority)
                raise QuotaExceededError(
                    f"tenant {tenant!r} at quota ({quota} outstanding)",
                    model_id=model)
            mout = self._model_out.get(model, 0)
            if mquota is not None and mout >= mquota:
                self.stats_.on_shed(tenant, "model_quota", model)
                self._ledger_shed(tenant, model, priority)
                raise QuotaExceededError(
                    f"model {model!r} at quota ({mquota} outstanding)",
                    model_id=model)
            depth = sum(len(q) for q in self._queues)
            if depth >= self.cfg.max_queue_depth:
                self.stats_.on_shed(tenant, "overload", model)
                self._ledger_shed(tenant, model, priority)
                raise ClusterOverloadError(
                    f"router queue full ({depth} queued)",
                    model_id=model)
            if (self.cfg.shed_p99_ms is not None
                    and depth >= self.cfg.shed_min_depth):
                # windowed read: shed on what latency IS, not on what
                # it once was (cumulative stays in snapshots)
                p99 = self.stats_.latency.percentile(
                    99, window_s=self.cfg.slo_window_s)
                if p99 is not None and p99 > self.cfg.shed_p99_ms:
                    self.stats_.on_shed(tenant, "slo", model)
                    self._ledger_shed(tenant, model, priority)
                    _flightrec.trigger(
                        "slo_shed",
                        detail=f"p99 {p99:.1f}ms > "
                               f"{self.cfg.shed_p99_ms}ms",
                        tenant=str(tenant), model=str(model),
                        p99_ms=round(p99, 1), depth=depth)
                    raise ClusterOverloadError(
                        f"shedding: p99 {p99:.1f}ms over "
                        f"{self.cfg.shed_p99_ms}ms with {depth} queued",
                        model_id=model)
            self._tenant_out[tenant] = out + 1
            self._model_out[model] = mout + 1
        _flightrec.note("admit", tenant=str(tenant), model=str(model),
                        priority=priority)
        timeout_ms = (timeout_ms if timeout_ms is not None
                      else self.cfg.default_timeout_ms)
        deadline = (time.monotonic() + timeout_ms / 1e3
                    if timeout_ms is not None else None)
        req = ClusterFuture(payload, tenant, priority, deadline,
                            self._on_request_done, model=model)
        req.uid = f"r{self.stats_.router_id}-{next(self._uid_seq)}"
        req.t_admit = time.monotonic()
        if self._hedgeable:
            with self._lock:
                self._outstanding[req.uid] = req
        self._model_queues[model].put(req)
        self._update_depth()
        return req

    def _on_request_done(self, req, ok):
        if self._hedgeable:
            with self._lock:
                self._outstanding.pop(req.uid, None)
            if req.hedges:
                self._cancel_hedges(req)
        with self._lock:
            n = self._tenant_out.get(req.tenant, 1) - 1
            if n <= 0:
                self._tenant_out.pop(req.tenant, None)
            else:
                self._tenant_out[req.tenant] = n
            if req.model is not None:
                m = self._model_out.get(req.model, 1) - 1
                if m <= 0:
                    self._model_out.pop(req.model, None)
                else:
                    self._model_out[req.model] = m
        latency_ms = (time.monotonic() - req.t_submit) * 1e3
        ledger_on = _ledger.enabled()
        trace_id = (req.trace_id
                    or (str(req.trace_ctx[0]) if req.trace_ctx else "")
                    or req.uid)
        # the exemplar pairs the latency bucket with the request that
        # landed in it — an incident bundle resolves it back to the
        # flight-recorder spans of the same trace
        self.stats_.on_request_done(
            ok, latency_ms, exemplar=(trace_id if ledger_on else None))
        if req.model is not None:
            self.stats_.on_model_request_done(req.model, ok)
        if ledger_on:
            self._ledger_close(req, ok, latency_ms, trace_id)
        _flightrec.note("request_done", ok=bool(ok),
                        latency_ms=round(latency_ms, 2),
                        tenant=str(req.tenant), model=str(req.model))

    def _ledger_close(self, req, ok, latency_ms, trace_id):
        """Close the request's ledger record at the terminal seam —
        every field is already on the future (stamps from admission and
        dispatch, engine counts off the RPC reply), so this is one dict
        build, no extra round trips."""
        now = time.monotonic()
        err = req._error
        if ok:
            outcome = "ok"
        elif isinstance(err, RequestTimeoutError):
            outcome = "timeout"
        elif (isinstance(err, WorkerUnavailable)
                and "cancelled" in str(err)):
            outcome = "cancelled"
        else:
            outcome = "error"
        led = req.led or {}
        budget_ms = ((req.deadline - req.t_submit) * 1e3
                     if req.deadline is not None else 0.0)
        # worker-measured engine time when it rode the reply (true
        # device-time attribution), router-measured wall otherwise
        service_ms = led.get("service_ms") or (
            (now - req.t_dispatch) * 1e3 if req.t_dispatch else 0.0)
        self.ledger.record(
            uid=req.uid, trace_id=trace_id, tenant=req.tenant,
            model=req.model, worker=req.worker, priority=req.priority,
            outcome=outcome, reroutes=req.attempts,
            hedged=1 if req.hedges else 0,
            hedge_outcome=(req.hedge_outcome
                           or ("lost" if req.hedges else "")),
            t_admit=req.t_admit, t_dispatch=req.t_dispatch,
            t_first_token=req.t_first_token, t_done=now,
            queue_wait_ms=(max(0.0, (req.t_dispatch - req.t_admit) * 1e3)
                           if req.t_dispatch else 0.0),
            service_ms=service_ms, latency_ms=latency_ms,
            deadline_budget_ms=budget_ms,
            deadline_consumed_ms=(min(latency_ms, budget_ms)
                                  if budget_ms else 0.0),
            prefix_tokens=led.get("prefix_tokens"),
            prefill_chunks=led.get("prefill_chunks"),
            spec_drafted=led.get("spec_drafted"),
            spec_accepted=led.get("spec_accepted"),
            decode_tokens=led.get("decode_tokens"))

    def _update_depth(self):
        self.stats_.on_queue_depth(sum(len(q) for q in self._queues))

    # -- tail-latency hedging ----------------------------------------------
    def _start_hedging(self):
        """Arm the hedge monitor when the config asks for it.  Called
        by the flat Router and the single-pool GenerationRouter — the
        two-pool disaggregated wiring is excluded (a hedge would need
        its own prefill+decode chain)."""
        if self.cfg.hedge_after_p99_factor is None:
            return
        self._hedgeable = True
        self._hedge_thread = threading.Thread(
            target=self._hedge_loop, name="cluster-hedge", daemon=True)
        self._hedge_thread.start()
        self._cancel_thread = threading.Thread(
            target=self._cancel_loop, name="cluster-cancel",
            daemon=True)
        self._cancel_thread.start()

    def _hedge_loop(self):
        while not self._closed:
            time.sleep(0.01)
            try:
                self._hedge_tick()
            except Exception:  # noqa: BLE001 — monitor must not die
                pass

    def _hedge_tick(self, now=None):
        """One monitor pass: any outstanding request older than
        ``factor x windowed-p99`` (and another multiple per duplicate
        already fired) gets a clone queued AT THE FRONT, so an idle
        worker picks it up immediately.  Returns duplicates fired."""
        p99 = self.stats_.latency.percentile(
            99, window_s=self.cfg.slo_window_s)
        if p99 is None:
            return 0   # no latency signal yet — nothing to derive from
        delay_s = max(1e-3, self.cfg.hedge_after_p99_factor * p99 / 1e3)
        now = time.monotonic() if now is None else now
        with self._lock:
            reqs = list(self._outstanding.values())
        fired = 0
        for req in reqs:
            if req.done() or req.expired(now):
                continue
            if req.hedges + 1 >= self.cfg.hedge_max_inflight:
                continue
            if now - req.t_submit < delay_s * (req.hedges + 1):
                continue
            if len(self.workers_for(req.model)) < 2:
                continue   # nobody to hedge onto
            q = self._model_queues.get(req.model)
            if q is None:
                continue
            req.hedges += 1
            q.put(_HedgeClone(req, self.stats_), front=True)
            fired += 1
        if fired:
            self._update_depth()
        return fired

    def _cancel_hedges(self, req):
        """First result won: queue a cancel for the loser.  MUST NOT
        block — this runs on the dispatcher thread that just completed
        the winner, and a straggler worker can stall the cancel RPC by
        its full lag (stalled dispatchers snowball queue depth, which
        fires MORE hedges).  Advisory, so a bounded queue that sheds
        its oldest entries is safe: a cancel that never lands just
        means the duplicate computes and its result is ignored."""
        self._cancel_q.append((req.uid, req.model))
        self._cancel_wake.set()

    def _cancel_loop(self):
        while not self._closed:
            self._cancel_wake.wait(timeout=0.2)
            self._cancel_wake.clear()
            while True:
                try:
                    uid, model = self._cancel_q.popleft()
                except IndexError:
                    break
                self._send_cancel(uid, model)

    def _send_cancel(self, uid, model):
        """Fan the cancel out to the model's workers.  Best-effort —
        work already executing finishes normally and the idempotent
        future ignores the late result.  Rides the HEALTH connection:
        the request connection is busy executing the very work being
        cancelled."""
        for h in self.workers_for(model):
            try:
                cancel = getattr(h, "cancel", None)
                if cancel is not None:
                    cancel(uid)           # loopback path
                elif getattr(h, "health_client", None) is not None:
                    h.health_client.call("cancel", uid=uid,
                                         _io_timeout_s=2.0)
            except Exception:  # noqa: BLE001 — advisory only
                pass

    def _finish_rejected(self, req, res):
        """A worker bounced this member at admission: a hedge copy
        counts as cancelled (it computed nothing); a primary with a
        spent deadline fails with the timeout error (the worker already
        counted the site)."""
        if getattr(req, "is_hedge", False):
            self.stats_.on_hedge("cancelled")
            return
        if res.get("cancelled"):
            # a cancel can only race a primary that already finished
            # elsewhere — the idempotent future makes this a no-op
            req.set_error(WorkerUnavailable("request cancelled"))
            return
        req.set_error(RequestTimeoutError(
            "deadline budget spent before the worker ran it"))

    # -- deadline budgets --------------------------------------------------
    def _budget_ms(self, req, now=None):
        """Remaining deadline budget in ms (>= 0.0), None = unbounded.
        This is what rides the RPC — an ABSOLUTE deadline cannot cross
        processes (monotonic clocks don't compare), a budget can."""
        if req.deadline is None:
            return None
        now = time.monotonic() if now is None else now
        return max(0.0, (req.deadline - now) * 1e3)

    def _io_budget_s(self, reqs):
        """Socket timeout derived from the group's largest remaining
        budget: the worker may legitimately take the whole budget, plus
        grace for queueing and the response to travel.  None when any
        member is unbounded (fall back to the connection default)."""
        worst, now = 0.0, time.monotonic()
        for r in reqs:
            if r.deadline is None:
                return None
            worst = max(worst, r.deadline - now)
        return max(0.5, worst + _IO_GRACE_S)

    # -- worker wiring -----------------------------------------------------
    def _model_queue(self, model):
        """Get-or-create the model's work queue (registered in
        ``_queues`` so depth/drain/close sweep it)."""
        with self._lock:
            q = self._model_queues.get(model)
            if q is None:
                q = self._model_queues[model] = _WorkQueue()
                self._queues.append(q)
            return q

    def _wire_pool(self, pool, queue, dispatch_fn, tag,
                   register_model=True):
        pool.add_death_callback(lambda h: self._on_worker_death(h))
        for h in pool.handles():
            self.attach_worker(h, queue=queue, dispatch_fn=dispatch_fn,
                               tag=tag, register_model=register_model)

    def attach_worker(self, handle, model=None, queue=None,
                      dispatch_fn=None, tag="w", register_model=True):
        """Start dispatching to a (warmed-up) worker.  The fleet
        scale-up path: the pool spawns + warms the worker FIRST, then
        this attaches it — admission for a cold model flips only here,
        so no steady-state JIT ever runs on the serving path.

        ``register_model`` adds the handle to its model's warm-worker
        set (admission + routing); the disaggregated decode stage keeps
        it off (decode handles dispatch but don't admit)."""
        if register_model:
            model = (model or getattr(handle, "model_id", None)
                     or self.cfg.default_model)
            handle.model_id = model
            with self._lock:
                hs = self._model_workers.setdefault(model, [])
                if not any(h is handle for h in hs):
                    hs.append(handle)
            self.stats_.on_worker_state(model, handle.rank, "warm")
        q = queue if queue is not None else self._model_queue(model)
        fn = dispatch_fn or self._default_dispatch
        t = threading.Thread(
            target=self._dispatch_loop, args=(handle, q, fn),
            name=f"cluster-dispatch-{tag}{handle.rank}", daemon=True)
        self._handle_threads.setdefault(id(handle), []).append(t)
        t.start()
        self._threads.append(t)
        self.stats_.on_workers_alive(self._alive_total())
        return handle

    def drain_worker(self, handle, timeout=None):
        """Gracefully stop routing to one worker: flag it draining (its
        dispatchers finish the request in hand, then exit — dispatch is
        synchronous in the dispatcher thread, so thread exit proves
        nothing is in flight on the worker), wait for quiesce, detach.
        Queued work stays queued for the model's other workers — zero
        requests drop.  Returns True when quiesced within budget; False
        leaves the worker draining (non-routable) but attached, so the
        caller must not reap its process yet."""
        handle.draining = True
        model = getattr(handle, "model_id", None)
        if model is not None:
            self.stats_.on_worker_state(model, handle.rank, "draining")
        for q in self._queues:
            q.kick()
        budget = (timeout if timeout is not None
                  else self.cfg.drain_timeout_s)
        deadline = time.monotonic() + budget
        for t in self._handle_threads.get(id(handle), []):
            t.join(timeout=max(0.05, deadline - time.monotonic()))
            if t.is_alive():
                return False
        self.detach_worker(handle)
        return True

    def detach_worker(self, handle):
        """Forget a quiesced (or dead) worker: model set, dispatcher
        bookkeeping, state gauges."""
        self._handle_threads.pop(id(handle), None)
        model = getattr(handle, "model_id", None)
        if model is not None:
            with self._lock:
                hs = self._model_workers.get(model, [])
                self._model_workers[model] = \
                    [h for h in hs if h is not handle]
            self.stats_.on_worker_state(model, handle.rank, None)
        self.stats_.on_workers_alive(self._alive_total())

    def workers_for(self, model=None):
        """The model's ROUTABLE handles (alive, not draining) — the
        autoscaler's victim-selection and admission-flip view."""
        model = model or self.cfg.default_model
        with self._lock:
            hs = list(self._model_workers.get(model, ()))
        return [h for h in hs
                if h.alive and not getattr(h, "draining", False)]

    def _on_worker_death(self, handle):
        model = getattr(handle, "model_id", None)
        if model is not None:
            self.stats_.on_worker_state(model, handle.rank, None)
        self.stats_.on_workers_alive(self._alive_total())
        for q in self._queues:
            q.kick()
        # incident-class moment: fan out flight_dump collection while
        # the survivors' rings still hold the lead-up
        _flightrec.trigger("worker_death",
                           detail=f"rank {handle.rank}",
                           worker=handle.rank,
                           model=str(model) if model is not None
                           else None)

    def _alive_total(self):
        raise NotImplementedError

    def fleet_signals(self):
        """Per-model scaling signals off this router's own state + the
        registry series it already writes — what a fleet.ScalePolicy
        consumes each tick."""
        shed = self.stats_.shed_by_model()
        p99 = self.stats_.latency.percentile(
            99, window_s=self.cfg.slo_window_s)
        with self._lock:
            models = {m: list(hs)
                      for m, hs in self._model_workers.items()}
            inflight = dict(self._model_inflight)
        out = {}
        for m, hs in models.items():
            q = self._model_queues.get(m)
            out[m] = {
                "queue_depth": len(q) if q is not None else 0,
                "workers": sum(1 for h in hs
                               if h.alive
                               and not getattr(h, "draining", False)),
                "draining": sum(1 for h in hs
                                if h.alive
                                and getattr(h, "draining", False)),
                "inflight": int(inflight.get(m, 0)),
                "p99_ms": p99,
                "shed_total": int(shed.get(m, 0)),
            }
        return out

    def _dispatch_loop(self, handle, queue, dispatch_fn):
        while True:
            req = queue.get(
                lambda: handle.alive
                and not getattr(handle, "draining", False)
                and not self._closed)
            if req is None:
                return
            self._update_depth()
            if req.done():
                # already settled while queued: a hedge whose primary
                # won, or a parked request the park monitor failed —
                # either way it must not cost a worker anything
                if getattr(req, "is_hedge", False):
                    self.stats_.on_hedge("cancelled")
                continue
            if req.expired():
                if getattr(req, "is_hedge", False):
                    self.stats_.on_hedge("cancelled")
                else:
                    self.stats_.on_deadline_expired("router")
                    req.set_error(RequestTimeoutError(
                        "deadline passed while queued"))
                continue
            with self._lock:
                self._inflight += 1
                if req.model is not None:
                    self._model_inflight[req.model] = \
                        self._model_inflight.get(req.model, 0) + 1
            # ledger dispatch stamp — FIRST dispatch only, and always
            # on the primary (a hedge clone shares its twin's record)
            tgt = getattr(req, "primary", req)
            if tgt.t_dispatch == 0.0:
                tgt.t_dispatch = time.monotonic()
                tgt.worker = str(handle.rank)
            try:
                dispatch_fn(handle, req)
            except WorkerUnavailable as e:
                self._reroute(handle, queue, req, e)
                return   # this worker is gone; let survivors drain
            except Exception as e:  # noqa: BLE001 — fail the request
                req.set_error(e)
            finally:
                with self._lock:
                    self._inflight -= 1
                    if req.model is not None:
                        m = self._model_inflight.get(req.model, 1) - 1
                        if m <= 0:
                            self._model_inflight.pop(req.model, None)
                        else:
                            self._model_inflight[req.model] = m

    def _reroute(self, handle, queue, req, exc):
        # the RPC died mid-request: the worker is gone from this
        # router's perspective (the health monitor will confirm) — mark
        # it so no dispatcher picks it again, then give the request
        # another chance at the FRONT of the queue
        pool = self._pool_of(handle)
        pool.mark_dead(handle.rank)
        req.attempts += 1
        # fail fast against the pool that SERVES this queue: in the
        # disaggregated router a live decode fleet cannot rescue a
        # request whose prefill pool just emptied (and vice versa) —
        # requeueing it would strand it until its deadline.  Same for
        # the request's model: when its whole warm-worker set is gone,
        # workers serving OTHER models cannot rescue it.
        hs = self._model_workers.get(req.model)
        model_routable = (self._model_routable(req.model)
                          if hs is not None else True)
        if pool.alive_count() == 0 or not model_routable:
            if (self.cfg.reroute_wait_for_respawn
                    and not getattr(req, "is_hedge", False)
                    and req.attempts <= self.cfg.max_reroutes
                    and not req.expired()):
                # a supervisor is healing this pool: park the request
                # (front of queue, budget intact) until the replacement
                # attaches — the dispatcher it starts picks it up.  An
                # empty pool has nobody left to pop the queue, so the
                # park monitor (not the expiry-check-at-pop) enforces
                # the deadline, the supervisor's permanent-degrade
                # verdict, and the respawn_wait_timeout_s backstop.
                self.stats_.on_reroute()
                self._park_for_respawn(req, queue)
                queue.put(req, front=True)
                self._update_depth()
                return
            req.set_error(WorkerUnavailable(
                f"no workers left (last error: {exc})"))
        elif req.attempts > self.cfg.max_reroutes:
            req.set_error(WorkerUnavailable(
                f"request failed on {req.attempts} workers "
                f"(last error: {exc})"))
        else:
            self.stats_.on_reroute()
            queue.put(req, front=True)
            self._update_depth()

    def _pool_of(self, handle):
        raise NotImplementedError

    # -- parked-request monitor (reroute_wait_for_respawn) -----------------
    def _park_for_respawn(self, req, queue):
        """Watch a request parked on an empty pool.  With zero
        dispatchers, nothing ever pops the queue — so a monitor thread
        (started lazily, exits when nothing is parked) must enforce
        the bound the pop-time expiry check normally provides."""
        with self._lock:
            self._parked[id(req)] = (req, queue, time.monotonic())
            if self._park_thread is None:
                self._park_thread = threading.Thread(
                    target=self._park_loop, name="cluster-park",
                    daemon=True)
                self._park_thread.start()

    def _park_loop(self):
        while not self._closed:
            time.sleep(0.05)
            try:
                self._park_tick()
            except Exception:  # noqa: BLE001 — monitor must not die
                pass
            with self._lock:
                if not self._parked:
                    self._park_thread = None
                    return

    def _park_tick(self, now=None):
        """One monitor pass over the parked set.  A parked request
        fails the moment (a) its deadline expires, (b) the supervisor
        permanently degrades its model (crash-loop budget exhausted —
        capacity is never coming back), or (c) it has waited past
        ``respawn_wait_timeout_s`` (the backstop for deadline-less
        requests with no supervisor healing the pool).  A failed
        request stays physically queued; the dispatch loop's done-check
        skips it if a replacement worker ever does pop it."""
        now = time.monotonic() if now is None else now
        with self._lock:
            entries = list(self._parked.items())
        cap = self.cfg.respawn_wait_timeout_s
        purge = []
        for key, (req, queue, parked_at) in entries:
            if req.done():
                pass   # a respawned worker (or a hedge) served it
            elif req.expired(now):
                self.stats_.on_deadline_expired("router")
                req.set_error(RequestTimeoutError(
                    "deadline passed while parked for respawn"))
                purge.append(queue)
            elif degradations.is_degraded(
                    f"fleet.supervisor:{req.model}"):
                req.set_error(WorkerUnavailable(
                    f"model {req.model!r} degraded permanently "
                    f"(supervisor crash-loop budget exhausted) while "
                    f"parked for respawn"))
                purge.append(queue)
            elif cap is not None and now - parked_at > cap:
                req.set_error(WorkerUnavailable(
                    f"no worker respawned within {cap}s"))
                purge.append(queue)
            else:
                continue   # still waiting — keep watching
            with self._lock:
                self._parked.pop(key, None)
        for q in {id(q): q for q in purge}.values():
            # the settled request is still physically queued and no
            # dispatcher exists to pop it — drop it so close(drain=)
            # doesn't wait the full budget on a dead entry
            q.purge_done()
        if purge:
            self._update_depth()

    @staticmethod
    def _trace_payload(span_ctx, req):
        ctx = span_ctx or req.trace_ctx
        return tuple(ctx) if ctx is not None else None

    @staticmethod
    def _ledger_reply(req, res, sctx=None, first_token=False):
        """Fold one worker reply's ledger fields onto the (primary)
        request: the engine-side counts ride the RPC reply so the
        terminal seam closes the record WITHOUT a second round trip.
        Folding SUMS across stages (prefill + decode both contribute
        their engine time)."""
        tgt = getattr(req, "primary", req)
        if sctx is not None and not tgt.trace_id:
            tgt.trace_id = str(sctx[0])
        led = res.get("ledger") if isinstance(res, dict) else None
        if led:
            if tgt.led is None:
                tgt.led = dict(led)
            else:
                for k, v in led.items():
                    tgt.led[k] = tgt.led.get(k, 0) + v
        if first_token and tgt.t_first_token == 0.0:
            tgt.t_first_token = time.monotonic()

    @staticmethod
    def _ledger_stamp_group(group, handle):
        """Group members pulled straight off the queue inside a
        dispatch fn never pass the ``_dispatch_loop`` stamp site —
        stamp them here (first dispatch only, always on the primary)."""
        now = time.monotonic()
        for r in group:
            tgt = getattr(r, "primary", r)
            if tgt.t_dispatch == 0.0:
                tgt.t_dispatch = now
                tgt.worker = str(handle.rank)

    @staticmethod
    def _unwrap(resp, what):
        if not resp.get("ok"):
            raise ServingError(
                f"{what} failed on worker: "
                f"{resp.get('error_type', 'Error')}: "
                f"{resp.get('error', '?')}")
        return resp

    # -- lifecycle ---------------------------------------------------------
    def stats(self):
        snap = self.stats_.snapshot()
        snap["queue_depth"] = sum(len(q) for q in self._queues)
        snap["workers_alive"] = self._alive_total()
        return snap

    def close(self, drain=True, timeout=None):
        with self._lock:
            if self._closed:
                return
            self._closing = True
        budget = (timeout if timeout is not None
                  else self.cfg.drain_timeout_s)
        deadline = time.monotonic() + budget
        if drain:
            # admission is off; let dispatchers finish what's queued
            for q in self._queues:
                q.close()
            while (any(len(q) for q in self._queues)
                   or self._inflight > 0):
                if time.monotonic() > deadline:
                    break
                time.sleep(0.005)
        self._closed = True
        for q in self._queues:
            q.close()
            for req in q.drain_remaining():
                req.set_error(ServerClosedError("router shut down"))
        for q in self._queues:
            q.kick()
        for t in self._threads:
            t.join(timeout=max(0.1, deadline - time.monotonic()))
        if self._hedge_thread is not None:
            self._hedge_thread.join(timeout=1.0)
        if self._cancel_thread is not None:
            self._cancel_wake.set()
            self._cancel_thread.join(timeout=1.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close(drain=exc[0] is None)
        return False


class Router(_RouterBase):
    """Flat routing: every worker serves the ``infer`` op (its own
    in-process InferenceServer does the batching)."""

    def __init__(self, pool, config=None):
        super().__init__(config)
        self.pool = pool
        self._default_dispatch = self._dispatch_infer
        self._queue = self._model_queue(self.cfg.default_model)
        self.stats_.on_workers_alive(pool.alive_count())
        pool.add_death_callback(lambda h: self._on_worker_death(h))
        for h in pool.handles():
            self.attach_worker(h)
        self._start_hedging()

    def _alive_total(self):
        return self.pool.alive_count()

    def _pool_of(self, handle):
        return self.pool

    def submit(self, feeds, tenant=None, priority=0, timeout_ms=None,
               model_id=None):
        """Enqueue one request; returns a future.  Sheds BEFORE
        occupying queue space: QuotaExceededError (tenant/model
        budget), ModelUnavailableError (cold model) or
        ClusterOverloadError (depth / p99), matching InferenceServer's
        reject-at-submit contract."""
        return self._admit(feeds, tenant, priority, timeout_ms,
                           model=model_id)

    def infer(self, feeds, tenant=None, priority=0, timeout_ms=None,
              model_id=None):
        req = self.submit(feeds, tenant=tenant, priority=priority,
                          timeout_ms=timeout_ms, model_id=model_id)
        wait_s = ((req.deadline - time.monotonic() + 0.25)
                  if req.deadline is not None else None)
        return req.result(timeout=wait_s)

    def _dispatch_infer(self, handle, req):
        budget_ms = self._budget_ms(req)
        with _tracing.attach(req.trace_ctx), \
                _tracing.span("cluster:dispatch",
                              worker=handle.rank) as sctx:
            resp = handle.call(
                "infer", feeds=req.payload,
                timeout_ms=(max(1.0, budget_ms)
                            if budget_ms is not None else None),
                deadline_ms=budget_ms, uid=req.uid,
                _io_timeout_s=self._io_budget_s([req]),
                trace=self._trace_payload(sctx, req))
        self._unwrap(resp, "infer")
        self._ledger_reply(req, resp, sctx)
        if resp.get("expired") or resp.get("cancelled"):
            return self._finish_rejected(req, resp)
        req.set_result(resp["outputs"])


class GenerationRouter(_RouterBase):
    """Disaggregated generation: prompts -> PREFILL pool -> (handoff
    travels through the router) -> DECODE pool -> finished sequences.

    The prefill fleet sizes for prompt compute (its cache only holds
    prompts in flight); the decode fleet sizes for resident sequences.
    A handoff held in router memory makes decode-side worker loss
    recoverable without re-prefilling.

    CHUNKED single-pool mode (``decode_pool=None``): when every worker
    runs the chunked-scheduling engine, the prefill/decode split is
    unnecessary — the worker's unified step already interleaves prompt
    chunks with decode rows, so whole requests dispatch as ``generate``
    RPCs to ONE pool (grouped up to ``decode_batch`` per call so the
    worker's continuous batch advances them together)."""

    def __init__(self, prefill_pool, decode_pool=None, config=None):
        super().__init__(config)
        self.prefill_pool = prefill_pool
        self.decode_pool = decode_pool
        self._stream_seq = itertools.count()   # unique page-stream ids
        self._decode_rr = itertools.count()    # round-robin stream_open
        # prompts awaiting prefill/generate: the default model's queue
        # (additional models get their own queue at attach_worker time)
        self._pq = self._model_queue(self.cfg.default_model)
        if decode_pool is None:
            self._dq = None
            self._default_dispatch = self._dispatch_generate
            self.stats_.on_workers_alive(self._alive_total())
            self._wire_pool(prefill_pool, None,
                            self._dispatch_generate, "g")
            self._start_hedging()
            return
        self._dq = _WorkQueue()   # handoffs awaiting decode
        self._queues.append(self._dq)
        self._default_dispatch = self._dispatch_prefill
        self.stats_.on_workers_alive(self._alive_total())
        self._wire_pool(prefill_pool, self._pq, self._dispatch_prefill,
                        "p")
        self._wire_pool(decode_pool, self._dq, self._dispatch_decode,
                        "d", register_model=False)

    def _alive_total(self):
        n = self.prefill_pool.alive_count()
        if self.decode_pool is not None:
            n += self.decode_pool.alive_count()
        return n

    def _pool_of(self, handle):
        pools = [self.prefill_pool]
        if self.decode_pool is not None:
            pools.append(self.decode_pool)
        for pool in pools:
            if any(h is handle for h in pool.handles()):
                return pool
        raise ValueError(f"handle {handle.endpoint} not in either pool")

    def submit(self, prompt, sampling=None, tenant=None, priority=0,
               timeout_ms=None, model_id=None):
        """One prompt in, a future out; ``result()`` is a
        ``generation.GenerationResult`` equal (token for token, under
        greedy sampling) to what a single-process engine produces.
        ``model_id`` routes to that model's warm-worker set (single-
        pool chunked mode; the two-pool disaggregated wiring serves the
        default model only)."""
        return self._admit({"prompt": list(prompt),
                            "sampling": sampling},
                           tenant, priority, timeout_ms, model=model_id)

    def generate(self, prompts, sampling=None, tenant=None,
                 timeout_ms=None, model_id=None):
        """Blocking convenience: submit every prompt, gather results in
        order (the InferenceServer.infer analog for generation)."""
        futs = [self.submit(p, sampling=sampling, tenant=tenant,
                            timeout_ms=timeout_ms, model_id=model_id)
                for p in prompts]
        return [f.result(timeout=None) for f in futs]

    def engine_stats(self):
        """Poll every alive worker's engine snapshot (the worker
        ``stats`` op) and roll up the cluster-wide speculative-decoding
        acceptance — the fleet view of the per-engine
        ``generation_spec_*`` series.  Dead/unreachable workers are
        skipped, not fatal: this is an observability poll."""
        pools = [("prefill", self.prefill_pool)]
        if self.decode_pool is not None:
            pools.append(("decode", self.decode_pool))
        workers = {}
        drafted = accepted = 0
        for name, pool in pools:
            for h in pool.handles():
                if not h.alive:
                    continue
                try:
                    snap = self._unwrap(h.call("stats"),
                                        "stats")["stats"]
                except Exception:  # noqa: BLE001 — poll, not control
                    continue
                workers[f"{name}:{h.rank}"] = snap
                drafted += int(snap.get("spec_drafted") or 0)
                accepted += int(snap.get("spec_accepted") or 0)
        return {
            "workers": workers,
            "spec": {
                "drafted": drafted,
                "accepted": accepted,
                "accept_ratio": (round(accepted / drafted, 4)
                                 if drafted else None),
            },
        }

    def _dispatch_generate(self, handle, req):
        # single-pool chunked mode: ship whole requests; group queued
        # prompts into the RPC so the worker's chunked engine serves
        # them as ONE continuous batch (new prompts chunk-feed while
        # earlier ones decode).  The group gathers from the worker's
        # OWN model queue, so a multiplexed pool never mixes models in
        # one RPC.
        mq = self._model_queues.get(
            getattr(handle, "model_id", None) or self.cfg.default_model,
            self._pq)
        group = [req]
        while len(group) < self.cfg.decode_batch:
            nxt = mq.try_get()
            if nxt is None:
                break
            group.append(nxt)
        self._update_depth()
        self._ledger_stamp_group(group, handle)
        try:
            now = time.monotonic()
            with _tracing.attach(group[0].trace_ctx), \
                    _tracing.span("cluster:dispatch_generate",
                                  worker=handle.rank,
                                  n_prompts=len(group)) as sctx:
                resp = handle.call(
                    "generate",
                    prompts=[r.payload["prompt"] for r in group],
                    sampling=[r.payload["sampling"] for r in group],
                    uids=[r.uid for r in group],
                    deadline_ms=[self._budget_ms(r, now)
                                 for r in group],
                    _io_timeout_s=self._io_budget_s(group),
                    trace=self._trace_payload(sctx, group[0]))
            self._unwrap(resp, "generate")
        except WorkerUnavailable:
            # extra members re-queue to the front with their own
            # attempt accounting before _reroute handles `req`
            for extra_req in group[1:]:
                extra_req.attempts += 1
                if extra_req.attempts > self.cfg.max_reroutes:
                    extra_req.set_error(WorkerUnavailable(
                        f"generate failed on {extra_req.attempts} "
                        f"workers"))
                else:
                    self.stats_.on_reroute()
                    mq.put(extra_req, front=True)
            raise
        except Exception as e:  # noqa: BLE001 — fail the whole group
            for r in group:
                r.set_error(e)
            return
        from ..generation import GenerationResult

        for r, res in zip(group, resp["results"]):
            self._ledger_reply(r, res, sctx, first_token=True)
            if res.get("expired") or res.get("cancelled"):
                self._finish_rejected(r, res)
                continue
            r.set_result(GenerationResult(
                tokens=res["tokens"],
                finish_reason=res["finish_reason"],
                prompt_len=res["prompt_len"]))

    def _dispatch_prefill(self, handle, req):
        if self.cfg.stream_pages:
            return self._dispatch_prefill_streaming(handle, req)
        return self._dispatch_prefill_monolithic(handle, req)

    def _dispatch_prefill_monolithic(self, handle, req):
        with _tracing.attach(req.trace_ctx), \
                _tracing.span("cluster:dispatch_prefill",
                              worker=handle.rank) as sctx:
            resp = handle.call(
                "prefill", prompt=req.payload["prompt"],
                sampling=req.payload["sampling"],
                uid=req.uid, deadline_ms=self._budget_ms(req),
                _io_timeout_s=self._io_budget_s([req]),
                trace=self._trace_payload(sctx, req))
        self._unwrap(resp, "prefill")
        self._ledger_reply(req, resp, sctx, first_token=True)
        if resp.get("expired") or resp.get("cancelled"):
            return self._finish_rejected(req, resp)
        h = resp["handoff"]
        if resp["done"]:
            from ..generation import GenerationResult

            req.set_result(GenerationResult(
                tokens=[h.last_token],
                finish_reason=resp["finish_reason"],
                prompt_len=h.prompt_len))
            return
        # stage 2: the handoff (KV + first token) now lives in router
        # memory — a decode-worker death re-routes it without paying
        # the prefill again
        req.handoff = h
        self._dq.put(req)
        self._update_depth()

    # -- chunk-granular page streaming (stream_pages=True) -----------------
    def _pick_decode(self):
        """Round-robin over alive decode workers for ``stream_open``
        pinning; None when the pool is (momentarily) empty."""
        handles = [h for h in self.decode_pool.handles() if h.alive]
        if not handles:
            return None
        return handles[next(self._decode_rr) % len(handles)]

    def _abort_stream(self, req):
        """Best-effort decode-side leak guard: release the stream's
        pre-admitted slot/pages on its pinned worker and clear the
        pin.  Safe to call at any point — an adopted (decoded) or
        already-dropped stream aborts as a no-op on the worker."""
        st, req.stream = req.stream, None
        if st is None or self.decode_pool is None:
            return
        rank, sid = st
        for h in self.decode_pool.handles():
            if h.rank == rank and h.alive:
                try:
                    h.call("stream_abort", stream_id=sid)
                except Exception:  # noqa: BLE001 — guard must not raise
                    pass
                return

    def _on_request_done(self, req, ok):
        # ANY exit — success, deadline expiry, reroutes exhausted,
        # close(drain=False) — runs the stream leak guard exactly once
        # and drops the router's KV copy
        self._abort_stream(req)
        req.handoff = None
        super()._on_request_done(req, ok)

    def _dispatch_prefill_streaming(self, handle, req):
        """Stage 1 with page streaming: open a KV stream on a decode
        worker, pull prefill chunks as they retire and forward each
        one immediately — transfer overlaps the remaining prefill
        compute, and the decode worker's own prefix cache trims the
        shipped span (``cached_len``).  The router still accumulates
        the full KV locally: the replay handoff keeps decode-worker
        death recoverable, exactly like the monolithic path.  Any
        decode-side failure degrades to that inline handoff; a prefill
        worker without the streaming verbs degrades to the monolithic
        RPC."""
        from ..generation import (GenerationResult, PrefillHandoff,
                                  SamplingParams)

        prompt = req.payload["prompt"]
        sampling = req.payload["sampling"]
        sid = f"r{self.stats_.router_id}-{next(self._stream_seq)}"
        d_handle, d_cached = self._pick_decode(), 0
        if d_handle is not None:
            try:
                resp = d_handle.call("stream_open", stream_id=sid,
                                     prompt=prompt, sampling=sampling)
                if resp.get("ok"):
                    d_cached = int(resp["cached_len"])
                    req.stream = (d_handle.rank, sid)
                # not ok (pool full, engine not chunked, old worker):
                # no stream — the KV travels inline via the handoff
            except WorkerUnavailable:
                pass   # its dispatcher will notice; stream stays off
        try:
            with _tracing.attach(req.trace_ctx), \
                    _tracing.span("cluster:dispatch_prefill_stream",
                                  worker=handle.rank) as sctx:
                resp = handle.call(
                    "prefill_stream_start", stream_id=sid,
                    prompt=prompt, sampling=sampling,
                    deadline_ms=self._budget_ms(req),
                    trace=self._trace_payload(sctx, req))
                if resp.get("expired"):
                    self._abort_stream(req)
                    return self._finish_rejected(req, resp)
                if not resp.get("ok"):
                    # prefill worker predates the streaming verbs (or
                    # runs a non-chunked engine): monolithic fallback
                    self._abort_stream(req)
                    self.stats_.on_stream_fallback()
                    return self._dispatch_prefill_monolithic(handle, req)
                ks, vs, final = [], [], None
                while final is None:
                    pull = self._unwrap(
                        handle.call("prefill_pull", stream_id=sid),
                        "prefill_pull")
                    for item in pull["items"]:
                        if item["kind"] != "chunk":
                            final = item
                            continue
                        ks.append(item["k"])
                        vs.append(item["v"])
                        self.stats_.on_stream_chunk()
                        if req.stream is None or \
                                item["end"] <= d_cached:
                            continue
                        off = max(0, d_cached - item["start"])
                        try:
                            fwd = d_handle.call(
                                "stream_chunk", stream_id=sid,
                                start=item["start"] + off,
                                k=item["k"][:, off:],
                                v=item["v"][:, off:])
                            if not fwd.get("ok"):
                                raise ServingError(fwd.get("error", "?"))
                        except Exception:  # noqa: BLE001 — degrade
                            # forwarding failed (worker died, import
                            # rejected): drop the stream, keep pulling
                            # — the inline handoff still carries it
                            self._abort_stream(req)
        except WorkerUnavailable:
            # the PREFILL worker died mid-stream: release the decode
            # side before _reroute retries with a fresh stream id
            self._abort_stream(req)
            raise
        self._ledger_reply(req, final, sctx, first_token=True)
        if final["done"]:
            self._abort_stream(req)   # finished at prefill: no decode
            req.set_result(GenerationResult(
                tokens=[final["last_token"]],
                finish_reason=final["finish_reason"],
                prompt_len=final["prompt_len"]))
            return
        if req.stream is not None:
            try:
                resp = d_handle.call("stream_commit", stream_id=sid,
                                     last_token=final["last_token"])
                if not resp.get("ok"):
                    raise ServingError(resp.get("error", "?"))
            except Exception:  # noqa: BLE001 — degrade to inline
                self._abort_stream(req)
        # the replay handoff: full-prompt KV in router memory, so a
        # decode-worker death (or a dispatch by a worker other than
        # the pinned one) re-routes without re-prefilling
        req.handoff = PrefillHandoff(
            int(final["prompt_len"]), int(final["last_token"]),
            sampling or SamplingParams(),
            np.concatenate(ks, axis=1), np.concatenate(vs, axis=1),
            prompt_tokens=np.asarray(prompt, np.int32))
        self._dq.put(req)
        self._update_depth()

    def _handoff_payload(self, handle, req):
        """What stage 2 ships for this request: a ``{"stream": id}``
        reference when the KV already streamed to THIS worker (pages
        resident, nothing to re-send), else the inline handoff."""
        if req.stream is not None and req.stream[0] == handle.rank:
            return {"stream": req.stream[1]}
        return req.handoff

    def _dispatch_decode(self, handle, req):
        # group more queued handoffs into this RPC: the decode worker's
        # continuous batch advances them all per step, so one round
        # trip can retire several sequences
        group = [req]
        while len(group) < self.cfg.decode_batch:
            nxt = self._dq.try_get()
            if nxt is None:
                break
            group.append(nxt)
        self._update_depth()
        self._ledger_stamp_group(group, handle)
        try:
            now = time.monotonic()
            with _tracing.attach(group[0].trace_ctx), \
                    _tracing.span("cluster:dispatch_decode",
                                  worker=handle.rank,
                                  n_seqs=len(group)) as sctx:
                resp = handle.call(
                    "decode",
                    handoffs=[self._handoff_payload(handle, r)
                              for r in group],
                    uids=[r.uid for r in group],
                    deadline_ms=[self._budget_ms(r, now)
                                 for r in group],
                    _io_timeout_s=self._io_budget_s(group),
                    trace=self._trace_payload(sctx, group[0]))
            self._unwrap(resp, "decode")
        except WorkerUnavailable:
            # put the EXTRA members back before _reroute handles `req`;
            # each gets its own attempt accounting
            for extra_req in group[1:]:
                extra_req.attempts += 1
                if extra_req.attempts > self.cfg.max_reroutes:
                    extra_req.set_error(WorkerUnavailable(
                        f"decode failed on {extra_req.attempts} workers"))
                else:
                    self.stats_.on_reroute()
                    self._dq.put(extra_req, front=True)
            raise
        except Exception as e:  # noqa: BLE001 — fail the whole group
            for r in group:
                r.set_error(e)
            return
        from ..generation import GenerationResult

        for r, res in zip(group, resp["results"]):
            self._ledger_reply(r, res, sctx, first_token=True)
            if res.get("expired") or res.get("cancelled"):
                self._finish_rejected(r, res)
                continue
            r.set_result(GenerationResult(
                tokens=res["tokens"],
                finish_reason=res["finish_reason"],
                prompt_len=res["prompt_len"]))
