"""Request ledger — the per-request lifecycle record the aggregate
counters cannot answer.

The registry (``observability.registry``) answers "how many requests
and how slow"; the ledger answers "what happened to THIS request and
which tenant is consuming the fleet": a bounded, thread-safe ring of
structured records, one per completed/failed request, stamping the
request's whole lifecycle — admit / dispatch / first-token / done
times, tenant, model, worker, priority, outcome, reroutes, hedging,
deadline-budget consumption, and the engine-side work accounting
(cached-prefix tokens spliced, prefill chunks, speculation drafted and
accepted, decode tokens emitted) that rides the RPC reply back from
the worker.

Writers:

* ``cluster.router`` closes one record per request at its
  ``_on_request_done`` terminal seam (admission sheds write their own
  ``outcome="shed"`` record — a shed IS a failed request);
* ``cluster.worker`` appends per-served-member records to its process
  ledger (:func:`get_ledger`) and exposes them over the
  ``ledger_tail`` RPC verb, so the telemetry plane's
  ``fleet_snapshot()`` carries a fleet-wide ledger;
* ``generation.engine`` supplies the cumulative work counters
  (:meth:`GenerationEngine.ledger_counters`) the worker diffs around
  each op — the counts ride the reply, no second round trip.

The record schema is declared ONCE: :data:`monitor.LEDGER_FIELDS`.
``record()`` rejects unknown keys, and ``tools/metric_lint.py`` holds
every ledger-consuming tool to the same spelling — a dashboard
indexing ``rec["tenants"]`` (typo) fails the lint instead of reading
silent ``None``s.

Cost discipline: a record is one dict build + one deque append under a
lock; :func:`enabled` / :func:`set_enabled` is the kill switch the
``slo_observability`` bench uses to gate the whole pipe (ledger +
exemplars) at < 2% of an uninstrumented request.

Counterpart of paddle_tpu/observability/ledger.py, copied.
"""
from __future__ import annotations

import collections
import threading

from .monitor import (LEDGER_EVICTED, LEDGER_FIELDS, LEDGER_RECORDS,
                      LEDGER_ROLLUP_FIELDS)
from .registry import get_registry

__all__ = ["RequestLedger", "get_ledger", "enabled", "set_enabled",
           "rollup"]

#: Fields that hold identifiers / enums (default ``""``); everything
#: else in LEDGER_FIELDS is numeric (default 0).
_STR_FIELDS = frozenset({"uid", "trace_id", "tenant", "model", "worker",
                         "outcome", "hedge_outcome"})
_FIELD_SET = frozenset(LEDGER_FIELDS)

_enabled = True


def enabled():
    return _enabled


def set_enabled(value):
    """Process-wide ledger kill switch (also gates the exemplar writes
    the router pairs with each record).  Returns the previous value."""
    global _enabled
    prev, _enabled = _enabled, bool(value)
    return prev


class RequestLedger:
    """Bounded thread-safe ring of request records.

    ``capacity`` bounds memory no matter the traffic; once full, the
    oldest record is overwritten and ``ledger_evicted_total`` counts
    it — a sizing signal, not an error."""

    def __init__(self, capacity=4096, registry=None, name="0"):
        reg = registry or get_registry()
        self.name = str(name)
        lb = {"router": self.name}
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque(
            maxlen=max(1, int(capacity)))
        self._c_records = reg.counter(
            LEDGER_RECORDS,
            "per-request ledger records closed").labels(**lb)
        self._c_evicted = reg.counter(
            LEDGER_EVICTED,
            "ledger records overwritten by the bounded ring").labels(**lb)

    def record(self, **fields):
        """Close one request record.  Unknown keys raise (the schema is
        LEDGER_FIELDS, declared once in observability.monitor); missing
        keys default to ``""``/0.  No-op (returns None) while the
        ledger is disabled."""
        if not _enabled:
            return None
        unknown = set(fields) - _FIELD_SET
        if unknown:
            raise ValueError(
                f"unknown ledger fields {sorted(unknown)!r}; the schema "
                f"is observability.monitor.LEDGER_FIELDS")
        rec = {}
        for k in LEDGER_FIELDS:
            v = fields.get(k)
            if k in _STR_FIELDS:
                rec[k] = "" if v is None else str(v)
            elif v is None:
                rec[k] = 0
            elif isinstance(v, float):
                rec[k] = round(v, 6)
            else:
                rec[k] = int(v)
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self._c_evicted.inc()
            self._ring.append(rec)
        self._c_records.inc()
        return rec

    def __len__(self):
        with self._lock:
            return len(self._ring)

    def tail(self, n=None):
        """The most recent ``n`` records (all, when None), oldest
        first — copies, safe to mutate/serialize."""
        with self._lock:
            recs = list(self._ring)
        if n is not None:
            recs = recs[-int(n):]
        return [dict(r) for r in recs]

    def clear(self):
        with self._lock:
            self._ring.clear()

    def rollup(self):
        return rollup(self.tail())


def _group(records, key):
    out = {}
    for r in records:
        out.setdefault(r.get(key) or "", []).append(r)
    return out


def _aggregate(records, fleet_service_ms):
    n = len(records)
    ok = sum(1 for r in records if r.get("outcome") == "ok")
    tokens = sum(int(r.get("decode_tokens") or 0) for r in records)
    service = sum(float(r.get("service_ms") or 0.0) for r in records)
    hedged = sum(1 for r in records if r.get("hedged"))
    rerouted = sum(1 for r in records if r.get("reroutes"))
    dones = [r["t_done"] for r in records if r.get("t_done")]
    admits = [r["t_admit"] for r in records if r.get("t_admit")]
    span = (max(dones) - min(admits)) if dones and admits else 0.0
    return {
        "requests": n,
        "ok": ok,
        "failed": n - ok,
        "decode_tokens": tokens,
        "goodput_tokens_per_s": (round(tokens / span, 3)
                                 if span > 0 else 0.0),
        "service_ms_total": round(service, 3),
        "service_share": (round(service / fleet_service_ms, 4)
                          if fleet_service_ms > 0 else 0.0),
        "hedge_share": round(hedged / n, 4) if n else 0.0,
        "reroute_share": round(rerouted / n, 4) if n else 0.0,
        "span_s": round(max(0.0, span), 6),
    }


def rollup(records):
    """Per-tenant / per-model goodput and cost attribution over a batch
    of ledger records (a ``tail()``, or the fleet snapshot's merged
    ledger).  Output keys are :data:`monitor.LEDGER_ROLLUP_FIELDS` —
    goodput is emitted decode tokens per second of the group's observed
    span, ``service_ms_total`` is the group's worker-time attribution,
    and ``service_share`` its fraction of the fleet total, so "which
    tenant is consuming the fleet" reads straight off the table.  The
    per-group ``decode_tokens`` always sum exactly to the total (the
    bench's conservation gate)."""
    records = list(records)
    fleet_service = sum(float(r.get("service_ms") or 0.0)
                        for r in records)
    out = {
        "totals": _aggregate(records, fleet_service),
        "by_tenant": {},
        "by_model": {},
    }
    for key, dest in (("tenant", "by_tenant"), ("model", "by_model")):
        for val, recs in sorted(_group(records, key).items()):
            out[dest][val] = _aggregate(recs, fleet_service)
    return out


# keep the rollup output schema honest: a drift between _aggregate and
# the declared constant is a bug, caught at import time
assert set(_aggregate([], 0.0)) == set(LEDGER_ROLLUP_FIELDS), \
    "rollup keys drifted from monitor.LEDGER_ROLLUP_FIELDS"

#: The process-default ledger — what a WORKER process appends its
#: served-member records to and serves over the ``ledger_tail`` verb.
#: Routers construct their own instance (one ring per router).
#: Created lazily so a process that never serves requests does not
#: grow ``ledger_*`` series in its registry snapshot.
_default_ledger = None
_default_lock = threading.Lock()


def get_ledger():
    global _default_ledger
    with _default_lock:
        if _default_ledger is None:
            _default_ledger = RequestLedger(name="proc")
        return _default_ledger
