"""TelemetryScraper — the fleet telemetry plane.

Every cluster worker owns a private process :class:`MetricsRegistry`
that, before this module, nothing read: the router's roll-ups were
request-path proxies, and ``Autoscaler`` scaled on router-side truth
alone.  The scraper closes the loop over the EXISTING framed-TCP
control plane: each pass calls the ``registry_snapshot`` RPC verb on
every worker handle, re-labels every returned series with
``{worker, role, model}``, and caches it.

Two read forms:

* :meth:`fleet_snapshot` — one snapshot-shaped dict holding EVERY
  worker's series (worker-attributed, no double counting) PLUS the
  local process's own rows labeled ``worker="router"`` — so
  ``cluster_workers_alive``, the fleet gauges and each worker's
  KV/prefix/spec series appear in ONE document that
  ``tools/fleet_report.py`` / ``kv_report.py`` / ``metrics_diff.py``
  digest unchanged (their label-sum helpers treat ``worker`` as just
  another label).  A worker that stops answering keeps its last-known
  rows, marked ``"stale": true``, and drops its
  ``telemetry_worker_up`` gauge to 0 — a dead worker must never wedge
  the scrape loop OR silently vanish from the fleet picture.
* :meth:`rollup` — the merged fleet registry: counters summed across
  workers (keyed by their original labels), gauges kept as per-worker
  rows, histogram buckets/count/sum/max merged.

:meth:`worker_signals` distills the scraped truth into the three
signals the autoscaler wants from the workers themselves: KV-cache
occupancy, prefix-cache hit rate, spec-decode acceptance.

Counterpart of paddle_tpu/observability/scrape.py, copied.
"""
from __future__ import annotations

import threading
import time

from .monitor import (GENERATION_CACHE_OCCUPANCY,
                      GENERATION_PREFIX_HITS, GENERATION_PREFIX_LOOKUPS,
                      GENERATION_SPEC_ACCEPTED, GENERATION_SPEC_DRAFTED,
                      TELEMETRY_SCRAPE_MS, TELEMETRY_SCRAPES,
                      TELEMETRY_WORKER_UP)
from .registry import SNAPSHOT_SCHEMA_VERSION, get_registry

__all__ = ["TelemetryScraper"]


class TelemetryScraper:
    """Pull-based fleet telemetry over worker control-plane handles.

    Parameters
    ----------
    handles_fn : zero-arg callable returning the current worker handles
        (duck-typed: ``.call("registry_snapshot")``, optional
        ``.rank``/``.alive``/``.model_id``).  A callable — not a list —
        because the fleet is elastic: spawned/retired workers appear
        and disappear between passes.
    registry : where the scraper's OWN ``telemetry_*`` series land and
        whose rows become the ``worker="router"`` slice of the fleet
        snapshot (default: the process registry).
    interval_s : default period for :meth:`start`'s background loop.
    local_label : worker-label value for the local process's rows.
    ledgers_fn : zero-arg callable returning local
        :class:`~.ledger.RequestLedger` instances (a router passes its
        own) whose records become the fleet snapshot's CANONICAL
        ``ledger.records`` — one per request, the parity set.  Worker
        processes' own per-member records (the ``ledger_tail`` verb)
        land under ``ledger.workers`` keyed like everything else, kept
        separate because they attribute the SAME requests from the
        worker side and must not double-count in a rollup.
    """

    def __init__(self, handles_fn, registry=None, interval_s=1.0,
                 local_label="router", clock=time.monotonic,
                 ledgers_fn=None):
        self.handles_fn = handles_fn
        self.ledgers_fn = ledgers_fn
        self.interval_s = interval_s
        self.local_label = local_label
        self._registry = registry or get_registry()
        self._clock = clock
        self._cache: dict = {}        # worker key -> cached scrape
        self._cache_lock = threading.Lock()
        self._scrapes = self._registry.counter(
            TELEMETRY_SCRAPES, "per-worker scrape attempts")
        self._scrape_ms = self._registry.histogram(
            TELEMETRY_SCRAPE_MS, "full-fleet scrape pass wall (ms)")
        self._up = self._registry.gauge(
            TELEMETRY_WORKER_UP,
            "1 while the worker's last scrape succeeded")
        self._stop = threading.Event()
        self._thread = None
        self.passes = 0

    # -- one pass ----------------------------------------------------------
    def scrape(self):
        """One pull over every current handle.  Per-worker failures
        mark that worker's cached rows stale and move on — the loop
        never wedges on a dead worker.  Returns the number of workers
        scraped successfully."""
        t0 = time.perf_counter()
        ok = 0
        seen = set()
        for h in list(self.handles_fn() or []):
            key = f"w{getattr(h, 'rank', len(seen))}"
            seen.add(key)
            try:
                if not getattr(h, "alive", True):
                    raise ConnectionError("handle marked dead")
                rep = h.call("registry_snapshot")
                snap = rep.get("snapshot") if isinstance(rep, dict) \
                    else None
                if not isinstance(snap, dict):
                    raise ValueError("malformed registry_snapshot reply")
                entry = {
                    "snapshot": snap,
                    "role": (rep.get("role")
                             or getattr(h, "role", None) or "?"),
                    "model": str(getattr(h, "model_id", None) or ""),
                    "pid": rep.get("pid"),
                    "fresh": True,
                    "last_scrape_s": self._clock(),
                    "ledger_records": self._pull_ledger(h),
                }
                with self._cache_lock:
                    self._cache[key] = entry
                self._scrapes.inc(outcome="ok")
                self._up.set(1, worker=key, role=entry["role"])
                ok += 1
            except Exception:  # noqa: BLE001 — dead worker, stale rows
                with self._cache_lock:
                    entry = self._cache.get(key)
                    if entry is not None:
                        entry["fresh"] = False
                self._scrapes.inc(outcome="error")
                self._up.set(0, worker=key,
                             role=(entry or {}).get("role", "?"))
        # a handle that vanished from handles_fn (retired/reaped) also
        # goes stale rather than silently keeping fresh rows
        with self._cache_lock:
            for key, entry in self._cache.items():
                if key not in seen and entry["fresh"]:
                    entry["fresh"] = False
                    self._up.set(0, worker=key, role=entry["role"])
        self.passes += 1
        self._scrape_ms.observe((time.perf_counter() - t0) * 1e3)
        return ok

    @staticmethod
    def _pull_ledger(h):
        """Best-effort ``ledger_tail`` pull; a worker predating the
        verb (or with its ledger disabled) contributes no records."""
        try:
            rep = h.call("ledger_tail")
            if isinstance(rep, dict) and rep.get("ok"):
                return rep.get("records") or []
        except Exception:  # noqa: BLE001 — the scrape already succeeded
            pass
        return []

    # -- background loop ---------------------------------------------------
    def start(self, interval_s=None):
        if interval_s is not None:
            self.interval_s = interval_s
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="ptl-telemetry-scraper")
        self._thread.start()
        return self

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.scrape()
            except Exception:  # noqa: BLE001 — the loop must survive
                pass           # anything a handle can throw

    def stop(self, timeout=5.0):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

    # -- reads -------------------------------------------------------------
    def _cached(self):
        with self._cache_lock:
            return {k: dict(v) for k, v in sorted(self._cache.items())}

    def fleet_snapshot(self):
        """One snapshot-shaped dict over the whole fleet: every series
        of every scraped worker re-labeled ``{worker, role, model}``
        (stale workers' rows additionally carry ``"stale": true``),
        plus the local registry's rows as ``worker=<local_label>``.
        Top-level ``"workers"`` maps worker key -> scrape health."""
        out = {"schema_version": SNAPSHOT_SCHEMA_VERSION, "fleet": True,
               "metrics": {}, "workers": {}}

        def _absorb(snap, worker, role, model, stale):
            for name, entry in (snap.get("metrics") or {}).items():
                dst = out["metrics"].setdefault(
                    name, {"type": entry.get("type"),
                           "help": entry.get("help", ""), "series": []})
                for rec in entry.get("series", []):
                    rec = dict(rec)
                    labels = dict(rec.get("labels") or {})
                    # relabel WITHOUT clobbering: a series that already
                    # carries a semantic worker/role/model label (e.g.
                    # fleet_worker_state's per-rank rows) keeps it
                    labels.setdefault("worker", worker)
                    labels.setdefault("role", role)
                    if model:
                        labels.setdefault("model", model)
                    rec["labels"] = labels
                    if stale:
                        rec["stale"] = True
                    dst["series"].append(rec)

        _absorb(self._registry.snapshot(), self.local_label,
                self.local_label, "", False)
        for key, entry in self._cached().items():
            _absorb(entry["snapshot"], key, entry["role"],
                    entry["model"], not entry["fresh"])
            out["workers"][key] = {
                "role": entry["role"], "model": entry["model"],
                "pid": entry.get("pid"), "fresh": entry["fresh"],
                "last_scrape_s": entry.get("last_scrape_s"),
            }
        led = {"records": [], "workers": {}}
        if self.ledgers_fn is not None:
            for book in (self.ledgers_fn() or []):
                led["records"].extend(book.tail())
        for key, entry in self._cached().items():
            recs = entry.get("ledger_records")
            if recs:
                led["workers"][key] = recs
        out["ledger"] = led
        return out

    def rollup(self):
        """The merged fleet registry per the classic rules: counters
        summed across workers keyed by their ORIGINAL labels, gauges
        kept per-worker (a mean of occupancies is a lie), histogram
        buckets/count/sum/max merged.  Stale workers' series still
        count — their last-known totals are the best estimate of what
        they contributed before dying."""
        fleet = self.fleet_snapshot()
        out = {"schema_version": SNAPSHOT_SCHEMA_VERSION,
               "rollup": True, "metrics": {}}
        for name, entry in fleet["metrics"].items():
            kind = entry.get("type")
            dst = out["metrics"].setdefault(
                name, {"type": kind, "help": entry.get("help", ""),
                       "series": []})
            if kind == "gauge":
                dst["series"] = [dict(r) for r in entry["series"]]
                continue
            merged: dict = {}
            for rec in entry["series"]:
                labels = {k: v for k, v in
                          (rec.get("labels") or {}).items()
                          if k not in ("worker", "role")}
                key = tuple(sorted(labels.items()))
                m = merged.setdefault(key, {"labels": labels})
                if kind == "histogram":
                    m["count"] = m.get("count", 0) + rec.get("count", 0)
                    m["sum"] = round(
                        m.get("sum", 0.0) + rec.get("sum", 0.0), 6)
                    m["max"] = max(m.get("max", 0.0),
                                   rec.get("max", 0.0))
                    bk = m.setdefault("_buckets", {})
                    for bound, c in rec.get("buckets", []):
                        bound = (bound if isinstance(bound, str)
                                 else round(float(bound), 6))
                        bk[bound] = bk.get(bound, 0) + c
                else:
                    m["value"] = (m.get("value", 0.0)
                                  + (rec.get("value") or 0.0))
            for m in merged.values():
                bk = m.pop("_buckets", None)
                if bk is not None:
                    m["buckets"] = [
                        [b, c] for b, c in sorted(
                            bk.items(),
                            key=lambda kv: (float("inf")
                                            if kv[0] == "+Inf"
                                            else float(kv[0])))]
                dst["series"].append(m)
        return out

    # -- autoscaler signals ------------------------------------------------
    def worker_signals(self, model=None):
        """Worker-side truth for scaling decisions, over FRESH workers
        (optionally restricted to one model): mean KV-cache occupancy
        (p50 of each worker's ``generation_cache_occupancy``
        distribution), fleet prefix-cache hit rate, and spec-decode
        acceptance — each None when no worker reports the series."""
        occ, hits, lookups, accepted, drafted = [], 0.0, 0.0, 0.0, 0.0
        for entry in self._cached().values():
            if not entry["fresh"]:
                continue
            if model is not None and entry["model"] != str(model):
                continue
            metrics = entry["snapshot"].get("metrics") or {}

            def _total(name):
                e = metrics.get(name)
                return sum((r.get("value") or 0.0)
                           for r in e.get("series", [])) if e else 0.0

            e = metrics.get(GENERATION_CACHE_OCCUPANCY)
            for rec in (e.get("series", []) if e else []):
                if rec.get("p50") is not None:
                    occ.append(rec["p50"])
            hits += _total(GENERATION_PREFIX_HITS)
            lookups += _total(GENERATION_PREFIX_LOOKUPS)
            accepted += _total(GENERATION_SPEC_ACCEPTED)
            drafted += _total(GENERATION_SPEC_DRAFTED)
        return {
            "kv_occupancy": (round(sum(occ) / len(occ), 4)
                             if occ else None),
            "prefix_hit_rate": (round(hits / lookups, 4)
                                if lookups else None),
            "spec_accept_ratio": (round(accepted / drafted, 4)
                                  if drafted else None),
        }
