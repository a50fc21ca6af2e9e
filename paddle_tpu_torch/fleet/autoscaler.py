"""Autoscaler — the fleet's policy loop.

Each tick it reads the router's per-model signals (queue depth,
p99-vs-SLO, in-flight occupancy, shed deltas — all numbers the router
already scrapes onto the observability registry), asks that model's
:class:`~paddle_tpu_torch.fleet.policy.ScalePolicy` for a decision, and acts
through the pool + router:

* **scale-up** — ``pool.spawn_worker`` launches and WARMS the worker
  (engine warmup runs in the child before READY), then
  ``router.attach_worker`` makes it routable.  Admission for a cold
  model flips only at attach, so a steady-state kernel build never
  lands on the serving path.
* **scale-down** — ``router.drain_worker`` flags the victim draining
  (its dispatcher finishes the request in hand and exits; queued work
  stays queued for the survivors — zero requests drop), then
  ``pool.retire`` reaps the process exactly once.
* **cold-start** — a shed burst with reason ``model_cold`` for a model
  in the catalog triggers :meth:`ensure_model`: a worker warms up in
  the background and the model starts admitting when it attaches.

The clock and the loop sleep are injectable
(``clock=time.monotonic``, the ``resilience.retry`` seam), and
:meth:`tick` is callable directly — tests drive whole scaling
schedules with a fake clock and no threads.

Counterpart of paddle_tpu/fleet/autoscaler.py, copied: the port's
router and pool carry every call it makes (``attach_worker``,
``drain_worker``, ``workers_for``, ``fleet_signals``,
``_model_routable``, ``spawn_worker``, ``retire``).
"""
from __future__ import annotations

import itertools
import threading
import time

from ..observability import flightrec as _flightrec
from .policy import HysteresisPolicy, ScaleSignals

__all__ = ["Autoscaler"]


class Autoscaler:
    """Ties one router + one pool to per-model scale policies.

    Parameters
    ----------
    router : cluster Router / GenerationRouter (the single-pool modes).
    pool : the pool behind the router — needs the elastic surface
        (``spawn_worker`` / ``retire``), which both ``WorkerPool`` and
        ``cluster.testing.StaticPool`` provide.
    policy : prototype ScalePolicy; each model gets its own clone so
        debounce/cooldown state never leaks across models.
    catalog : {model_id: spawn kwargs} — what ``pool.spawn_worker``
        needs to launch a worker for that model (e.g. ``{"spec":
        WorkerSpec(...)}`` for a WorkerPool, ``{"factory": fn}`` for a
        StaticPool).  Models missing from the catalog scale with the
        pool's default spec; cold-start warmup only triggers for
        cataloged models.
    interval_s : period of the background loop (``start()``).
    drain_timeout_s : budget for a scale-down drain before the victim
        is parked on the pending list (retried next tick; its process
        is never reaped with work in flight).
    scraper : optional ``observability.TelemetryScraper`` — when wired,
        each tick folds worker-side truth (KV-cache occupancy,
        prefix-cache hit rate, spec-decode acceptance) into the
        :class:`ScaleSignals`, so policies can react to what the
        WORKERS measure instead of router-side proxies alone.
    slo_engine : optional ``observability.slo.SloEngine`` — its last
        burn evaluation rides every tick's signals as the advisory
        ``slo_page`` flag (a page-severity burn is an overload vote
        even when queue depth looks calm).
    """

    def __init__(self, router, pool, policy=None, catalog=None,
                 interval_s=1.0, drain_timeout_s=None,
                 clock=time.monotonic, scraper=None, slo_engine=None):
        self.router = router
        self.pool = pool
        self._prototype = policy or HysteresisPolicy(clock=clock)
        self._policies = {}
        self._catalog = catalog or {}
        self.interval_s = float(interval_s)
        self._drain_timeout_s = drain_timeout_s
        self.scraper = scraper
        self.slo_engine = slo_engine
        self._clock = clock
        self._lock = threading.Lock()
        self._warming = set()      # models with a background warmup
        self._pending_retire = []  # drained-but-not-quiesced handles
        self._last_shed = {}       # model -> cumulative shed seen
        self._seq = itertools.count()
        self._stop = threading.Event()
        self._thread = None
        self.last_error = None
        self.events = []           # every action this scaler took

    @property
    def stats(self):
        return self.router.stats_

    def policy_for(self, model):
        p = self._policies.get(model)
        if p is None:
            p = self._policies[model] = self._prototype.clone()
        return p

    # -- signal gathering --------------------------------------------------
    def signals(self):
        """{model: ScaleSignals} for every model the router knows,
        with shed converted to a per-tick delta."""
        out = {}
        shed_now = self.router.stats_.shed_by_model()
        slo_page = False
        if self.slo_engine is not None:
            try:
                slo_page = bool(self.slo_engine.paging())
            except Exception as e:  # noqa: BLE001 — signals survive
                self.last_error = e
        for m, d in self.router.fleet_signals().items():
            total = int(shed_now.get(m, d.get("shed_total", 0)))
            prev = self._last_shed.get(m, 0)
            self._last_shed[m] = total
            worker_truth = {}
            if self.scraper is not None:
                try:
                    worker_truth = self.scraper.worker_signals(model=m)
                except Exception as e:  # noqa: BLE001 — signals survive
                    self.last_error = e
            out[m] = ScaleSignals(
                queue_depth=d["queue_depth"], workers=d["workers"],
                draining=d["draining"], inflight=d["inflight"],
                p99_ms=d["p99_ms"], shed_rate=float(total - prev),
                slo_page=slo_page, **worker_truth)
        return out

    # -- one policy-loop iteration -----------------------------------------
    def tick(self):
        """Decide + act once for every model; returns the actions
        taken this tick (also appended to ``self.events``)."""
        events = []
        self._retry_pending(events)
        sigs = self.signals()
        for m, s in sigs.items():
            dec = self.policy_for(m).decide(s)
            if dec.delta > 0:
                events.append(self._scale_up(m, dec.reason))
            elif dec.delta < 0:
                events.append(self._scale_down(m, dec.reason))
        # cold models: shed accumulating for a model with NO worker set
        # — warm one up in the background; admission flips at attach
        for m, total in self.router.stats_.shed_by_model().items():
            if m in sigs:
                continue
            prev = self._last_shed.get(m, 0)
            self._last_shed[m] = int(total)
            if total > prev and m in self._catalog:
                if self.ensure_model(m, block=False):
                    events.append({"model": m, "action": "warmup",
                                   "reason": "model_cold", "ok": True})
        self.events.extend(events)
        return events

    # -- actions -----------------------------------------------------------
    def _spawn(self, model):
        kwargs = dict(self._catalog.get(model, {}))
        return self.pool.spawn_worker(model_id=model, **kwargs)

    def _scale_up(self, model, reason):
        # a visible "warming" row for the duration of the launch (the
        # real rank exists only once the pool assigns it)
        label = f"spawn{next(self._seq)}"
        self.stats.on_worker_state(model, label, "warming")
        try:
            h = self._spawn(model)
        except Exception as e:  # noqa: BLE001 — policy loop survives
            self.stats.on_worker_state(model, label, None)
            self.last_error = e
            return {"model": model, "action": "up", "reason": reason,
                    "ok": False, "error": str(e)}
        self.stats.on_worker_state(model, label, None)
        self.router.attach_worker(h, model=model)
        self.stats.on_scale_event(model, "up", reason)
        _flightrec.note("scale_event", model=str(model), direction="up",
                        reason=str(reason), worker=h.rank)
        return {"model": model, "action": "up", "reason": reason,
                "ok": True, "worker": h.rank}

    def _scale_down(self, model, reason):
        victims = self.router.workers_for(model)
        if len(victims) < 2:
            return {"model": model, "action": "down", "reason": reason,
                    "ok": False, "error": "last worker"}
        h = victims[-1]
        if self.router.drain_worker(h, timeout=self._drain_timeout_s):
            self.pool.retire(h.rank)
            self.stats.on_scale_event(model, "down", reason)
            _flightrec.note("scale_event", model=str(model),
                            direction="down", reason=str(reason),
                            worker=h.rank)
            return {"model": model, "action": "down", "reason": reason,
                    "ok": True, "worker": h.rank}
        # still busy past the budget: keep it draining (non-routable),
        # never reap a process with a request in flight
        with self._lock:
            self._pending_retire.append(h)
        return {"model": model, "action": "down", "reason": reason,
                "ok": False, "error": "drain timeout", "worker": h.rank}

    def _retry_pending(self, events):
        with self._lock:
            pending, self._pending_retire = self._pending_retire, []
        for h in pending:
            if self.router.drain_worker(h, timeout=0.05):
                self.pool.retire(h.rank)
                model = getattr(h, "model_id", None) \
                    or self.router.cfg.default_model
                self.stats.on_scale_event(model, "down", "drain_done")
                events.append({"model": model, "action": "down",
                               "reason": "drain_done", "ok": True,
                               "worker": h.rank})
            else:
                with self._lock:
                    self._pending_retire.append(h)

    def ensure_model(self, model, block=True):
        """Warm one worker for a cold model; admission flips when it
        attaches.  Returns True when a warmup was started (False: the
        model is already routable or already warming)."""
        with self._lock:
            if model in self._warming:
                return False
            self._warming.add(model)
        if self.router._model_routable(model):
            with self._lock:
                self._warming.discard(model)
            return False

        def _do():
            label = f"warmup{next(self._seq)}"
            self.stats.on_worker_state(model, label, "warming")
            try:
                h = self._spawn(model)
                self.stats.on_worker_state(model, label, None)
                self.router.attach_worker(h, model=model)
                self.stats.on_scale_event(model, "up", "cold_start")
            except Exception as e:  # noqa: BLE001 — warmup best effort
                self.stats.on_worker_state(model, label, None)
                self.last_error = e
            finally:
                with self._lock:
                    self._warming.discard(model)

        if block:
            _do()
        else:
            threading.Thread(target=_do, daemon=True,
                             name=f"fleet-warmup-{model}").start()
        return True

    # -- the loop ----------------------------------------------------------
    def start(self):
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="fleet-autoscaler", daemon=True)
        self._thread.start()
        return self

    def _run(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception as e:  # noqa: BLE001 — loop must survive
                self.last_error = e

    def stop(self):
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=10.0)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False
