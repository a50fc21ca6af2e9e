"""ClusterStats — router-side counters/gauges, same contract as
serving.stats: every number is a labeled series (label ``router=<n>``)
on the process-wide observability registry, the JSON snapshot follows
the schema_version conventions (ints, v2 ``*_total``/``*_ms`` aliases,
kernel_degradations appended), and the gauges —
``cluster_queue_depth``, ``cluster_workers_alive``,
``cluster_shed_total{tenant}`` — scrape from ``get_registry()``
alongside the serving and generation metrics.

Counterpart of paddle_tpu/cluster/stats.py, copied: the series and the
snapshot's keys are the JAX router's.  ``kernel_degradations`` lists the
degradation registry's events, which in the port are the control
plane's alone (``fleet.*``, ``tuning.*``: a kernel launches or
raises)."""
from __future__ import annotations

import itertools
import json
import threading
import time

from ..observability.monitor import (CLUSTER_DEADLINE_EXPIRED,
                                     CLUSTER_HEDGES,
                                     CLUSTER_QUEUE_DEPTH,
                                     CLUSTER_REQUEST_LATENCY_MS,
                                     CLUSTER_REQUESTS, CLUSTER_REROUTES,
                                     CLUSTER_SHED,
                                     CLUSTER_STREAM_CHUNKS,
                                     CLUSTER_STREAM_FALLBACKS,
                                     CLUSTER_WORKERS_ALIVE,
                                     FLEET_MODEL_QPS, FLEET_REQUESTS,
                                     FLEET_RESPAWNS, FLEET_ROLLOUTS,
                                     FLEET_SCALE_EVENTS,
                                     FLEET_WORKER_STATE)
from ..observability.registry import get_registry
from ..serving.stats import LatencyHistogram, SNAPSHOT_SCHEMA_VERSION

WORKER_STATES = ("warming", "warm", "draining")

__all__ = ["ClusterStats"]

_router_seq = itertools.count(0)


class ClusterStats:
    def __init__(self, registry=None, router=None):
        reg = registry or get_registry()
        rid = str(next(_router_seq)) if router is None else str(router)
        self.router_id = rid
        lb = {"router": rid}
        self._lb = lb
        self._lock = threading.Lock()
        self._g_depth = reg.gauge(
            CLUSTER_QUEUE_DEPTH,
            "requests waiting in the router queue").labels(**lb)
        self._g_alive = reg.gauge(
            CLUSTER_WORKERS_ALIVE,
            "workers currently routable").labels(**lb)
        # shed_total is labeled per TENANT (the admission
        # contract), per reason AND per model, so a noisy neighbor or
        # a cold/over-quota model is attributable from the scrape alone
        self._m_shed = reg.counter(
            CLUSTER_SHED, "requests shed at admission, "
            "by tenant, reason and model")
        req = reg.counter(CLUSTER_REQUESTS,
                          "routed requests by outcome")
        self._c_ok = req.labels(outcome="ok", **lb)
        self._c_failed = req.labels(outcome="failed", **lb)
        self._c_reroutes = reg.counter(
            CLUSTER_REROUTES,
            "requests re-dispatched after a worker loss").labels(**lb)
        # page-streaming telemetry (GenerationRouter stream_pages):
        # chunks forwarded prefill->decode, and requests that fell back
        # to the monolithic prefill RPC (old worker / non-chunked)
        self._c_stream_chunks = reg.counter(
            CLUSTER_STREAM_CHUNKS,
            "KV chunks forwarded prefill->decode").labels(**lb)
        self._c_stream_fallbacks = reg.counter(
            CLUSTER_STREAM_FALLBACKS,
            "prefills that fell back to the monolithic "
            "handoff").labels(**lb)
        self.latency = reg.histogram(
            CLUSTER_REQUEST_LATENCY_MS,
            "router end-to-end request latency").labels(**lb)
        # fleet tier: per-worker lifecycle states, per-model request
        # accounting + QPS, autoscaler actions and rollout outcomes
        # (names defined once in observability.monitor)
        self._m_worker_state = reg.gauge(
            FLEET_WORKER_STATE,
            "1 for the worker's current state (warming|warm|draining)")
        self._m_fleet_req = reg.counter(
            FLEET_REQUESTS, "completed requests by model and outcome")
        self._m_model_qps = reg.gauge(
            FLEET_MODEL_QPS, "per-model completions/sec over the "
            "model's observed span")
        self._m_scale_events = reg.counter(
            FLEET_SCALE_EVENTS, "autoscaler actions by model, "
            "direction and reason")
        self._m_rollouts = reg.counter(
            FLEET_ROLLOUTS, "rolling weight swaps by model and outcome")
        # self-healing tier: supervisor respawns, tail-latency hedges,
        # and deadline-budget rejections.  deadline_expired has NO
        # router label on worker-side increments — those land on the
        # worker process's own registry and reach the fleet scrape via
        # the telemetry plane.
        self._m_respawns = reg.counter(
            FLEET_RESPAWNS, "supervisor respawns by model and outcome")
        self._m_hedges = reg.counter(
            CLUSTER_HEDGES, "hedged duplicate dispatches by outcome")
        self._m_deadline_expired = reg.counter(
            CLUSTER_DEADLINE_EXPIRED,
            "work rejected after its deadline budget expired, by site")
        self._t_first = None
        self._t_last = None
        self._model_t = {}   # model -> [t_first, t_last, n_done]

    # -- mutators ----------------------------------------------------------
    def on_queue_depth(self, depth):
        self._g_depth.set(depth)

    def on_workers_alive(self, n):
        self._g_alive.set(n)

    def on_shed(self, tenant, reason, model="default"):
        self._m_shed.labels(tenant=str(tenant), reason=reason,
                            model=str(model), **self._lb).inc()

    def on_reroute(self):
        self._c_reroutes.inc()

    def on_worker_state(self, model, worker, state):
        """Flip the worker's lifecycle gauge: exactly one of
        warming|warm|draining is 1 (``state=None`` zeroes all three —
        the worker is retired or dead)."""
        for s in WORKER_STATES:
            self._m_worker_state.labels(
                model=str(model), worker=str(worker), state=s,
                **self._lb).set(1 if s == state else 0)

    def on_model_request_done(self, model, ok):
        model = str(model)
        self._m_fleet_req.labels(
            model=model, outcome=("ok" if ok else "failed"),
            **self._lb).inc()
        now = time.perf_counter()
        with self._lock:
            t = self._model_t.setdefault(model, [now, now, 0])
            t[1] = now
            t[2] += 1
            span = t[1] - t[0]
            qps = round((t[2] - 1) / span, 2) if span > 0 else 0.0
        self._m_model_qps.labels(model=model, **self._lb).set(qps)

    def on_scale_event(self, model, direction, reason):
        self._m_scale_events.labels(
            model=str(model), direction=direction, reason=str(reason),
            **self._lb).inc()

    def on_rollout(self, model, outcome):
        self._m_rollouts.labels(model=str(model), outcome=outcome,
                                **self._lb).inc()

    def on_respawn(self, model, outcome):
        """outcome: ok (respawned+reattached) | failed (spawn raised) |
        gave_up (crash-loop budget exhausted, seam degraded) | refused
        (respawn requested while already degraded)."""
        self._m_respawns.labels(model=str(model), outcome=outcome,
                                **self._lb).inc()

    def on_hedge(self, outcome):
        """outcome: won (the duplicate finished first) | lost (the
        primary beat it) | cancelled (dropped before computing)."""
        self._m_hedges.labels(outcome=outcome, **self._lb).inc()

    def on_deadline_expired(self, site):
        """Router-side deadline rejection (site=router).  Worker sites
        increment on the worker's own registry, unlabeled."""
        self._m_deadline_expired.labels(site=site, **self._lb).inc()

    def on_stream_chunk(self):
        self._c_stream_chunks.inc()

    def on_stream_fallback(self):
        self._c_stream_fallbacks.inc()

    def on_request_done(self, ok, latency_ms, exemplar=None):
        # `exemplar` (a trace id) pins this observation to its latency
        # bucket so an incident bundle can join a bad p99 straight to
        # the request's flight-recorder spans
        now = time.perf_counter()
        (self._c_ok if ok else self._c_failed).inc()
        self.latency.observe(latency_ms, exemplar=exemplar)
        with self._lock:
            if self._t_first is None:
                self._t_first = now
            self._t_last = now

    # -- export ------------------------------------------------------------
    def _shed_by(self, key):
        out = {}
        for labels, s in self._m_shed.series():
            d = dict(labels)
            if d.get("router") != self.router_id:
                continue
            k = d.get(key, "")
            out[k] = out.get(k, 0) + int(s.value())
        return out

    def shed_by_tenant(self):
        """{tenant: shed count} summed over reasons+models, for THIS
        router."""
        return self._shed_by("tenant")

    def shed_by_model(self):
        """{model: shed count} summed over tenants+reasons, for THIS
        router."""
        return self._shed_by("model")

    def _count_by(self, metric, key, allow_unlabeled=False):
        """{key_value: count} over a counter's series for THIS router.
        ``allow_unlabeled`` also admits rows with no router label at
        all — worker-side increments (deadline sites) carry none."""
        out = {}
        for labels, s in metric.series():
            d = dict(labels)
            r = d.get("router")
            if r != self.router_id and not (allow_unlabeled
                                            and r is None):
                continue
            k = d.get(key, "")
            out[k] = out.get(k, 0) + int(s.value())
        return out

    def hedges_by_outcome(self):
        """{outcome: count} for won|lost|cancelled hedge duplicates."""
        return self._count_by(self._m_hedges, "outcome")

    def respawns_by_outcome(self):
        """{outcome: count} over supervisor respawns, all models."""
        return self._count_by(self._m_respawns, "outcome")

    def deadline_expired_by_site(self):
        """{site: count} of deadline-budget rejections visible in THIS
        process (router rows + any unlabeled worker-side rows that were
        merged into this registry)."""
        return self._count_by(self._m_deadline_expired, "site",
                              allow_unlabeled=True)

    def snapshot(self):
        ok = int(self._c_ok.value())
        failed = int(self._c_failed.value())
        shed = self.shed_by_tenant()
        with self._lock:
            span = ((self._t_last - self._t_first)
                    if (self._t_first is not None
                        and self._t_last > self._t_first) else None)
        n_done = ok + failed
        lat = LatencyHistogram.summarize(self.latency.state())
        snap = {
            "schema_version": SNAPSHOT_SCHEMA_VERSION,
            "router": self.router_id,
            "requests_ok": ok,
            "requests_failed": failed,
            "requests_shed": sum(shed.values()),
            "shed_by_tenant": shed,
            "shed_by_model": self.shed_by_model(),
            "reroutes": int(self._c_reroutes.value()),
            "stream_chunks": int(self._c_stream_chunks.value()),
            "stream_fallbacks": int(self._c_stream_fallbacks.value()),
            "queue_depth": int(self._g_depth.value()),
            "workers_alive": int(self._g_alive.value()),
            "qps": (round(n_done / span, 2) if span else None),
            "latency": lat,
            "hedges": self.hedges_by_outcome(),
            "respawns_total": sum(
                self.respawns_by_outcome().values()),
            "deadline_expired": self.deadline_expired_by_site(),
        }
        snap.update({
            "requests_ok_total": snap["requests_ok"],
            "requests_failed_total": snap["requests_failed"],
            "requests_shed_total": snap["requests_shed"],
            "reroutes_total": snap["reroutes"],
            "stream_chunks_total": snap["stream_chunks"],
            "stream_fallbacks_total": snap["stream_fallbacks"],
            "latency_ms": lat,
        })
        from ..resilience.retry import degradations

        snap["kernel_degradations"] = degradations.events()
        return snap

    def dump_json(self, path):
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=1)
        return path
