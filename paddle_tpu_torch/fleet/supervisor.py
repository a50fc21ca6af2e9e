"""Supervisor — self-healing worker capacity.

The autoscaler restores capacity only when LOAD trips its policy; a
worker that dies under steady traffic leaves its capacity gone forever.
The Supervisor closes that hole the way the reference stack's
role_maker rendezvous restarts did: it subscribes to the pool's death
callbacks, and for every CRASH (not retire/drain — those are
intentional) it respawns a replacement, lets the pool warm it in the
child (engine warmup before READY), and reattaches it to the router.
Respawn follows the same warming-gauge discipline as the autoscaler's
scale-up: a `fleet_worker_state{state="warming"}` row is up for the
launch window and admission flips only at ``attach_worker`` — the
router never sees cold capacity.

Crash-loop protection: respawns within ``stability_window_s`` of each
other count as one escalating loop, spaced by the deterministic
`resilience.retry.backoff_delays` schedule (injectable clock/sleep, so
tests assert the timing without sleeping).  When a model burns through
``max_respawns`` within the window, the Supervisor stops respawning it
PERMANENTLY: ``fleet.supervisor:<model>`` lands in the degradation
registry (a control-plane seam; the router fails a request parked
for that model's respawn with the degradation's message), the
flight-recorder fires a ``degrade`` trigger — one cooldown-debounced
incident bundle — and later deaths of that model are refused.  A model
that stays up past the stability window earns its strike count back.

Metrics: ``fleet_respawns_total{model,outcome}`` with outcome
ok | failed | gave_up | refused.

Counterpart of paddle_tpu/fleet/supervisor.py, copied.
"""
from __future__ import annotations

import itertools
import threading
import time

from ..observability import flightrec as _flightrec
from ..resilience.retry import backoff_delays, degradations

__all__ = ["Supervisor", "DEGRADE_KEY"]

#: Degradation seam: ``fleet.supervisor:<model>`` marks a model whose
#: crash-loop budget is exhausted — the supervisor refuses to respawn
#: it until an operator intervenes (degradations.reset + restart).
DEGRADE_KEY = "fleet.supervisor"


def degrade_key(model):
    return f"{DEGRADE_KEY}:{model}"


class Supervisor:
    """Respawn crashed workers behind the warming discipline.

    Parameters
    ----------
    router : cluster Router / GenerationRouter — ``attach_worker`` and
        the shared ClusterStats live here.
    pool : the pool behind the router; needs the elastic surface
        (``spawn_worker`` + ``add_death_callback``), which both
        ``WorkerPool`` and ``cluster.testing.StaticPool`` provide.
    catalog : {model_id: spawn kwargs} — what ``pool.spawn_worker``
        needs for that model (same shape as the Autoscaler's catalog).
        Models missing from the catalog respawn with the pool default.
    max_respawns : crash budget per model within the stability window;
        the (max_respawns+1)-th crash degrades the model permanently.
    base_delay / max_delay / multiplier / jitter / seed : the
        `backoff_delays` schedule between consecutive respawns of the
        same crash loop (the first respawn is immediate).
    stability_window_s : a model alive this long since its last crash
        resets its strike count — the loop is considered broken.
    clock / sleep : injectable time sources (fake-clock tests).
    """

    def __init__(self, router, pool, catalog=None, max_respawns=5,
                 base_delay=0.5, max_delay=30.0, multiplier=2.0,
                 jitter=0.0, seed=0, stability_window_s=60.0,
                 clock=time.monotonic, sleep=time.sleep):
        self.router = router
        self.pool = pool
        self.last_error = None
        self._catalog = dict(catalog or {})
        self._max_respawns = int(max_respawns)
        self._delays = backoff_delays(
            self._max_respawns + 1, base_delay, max_delay, multiplier,
            jitter, seed)
        self._stability_window_s = stability_window_s
        self._clock = clock
        self._sleep = sleep
        self._lock = threading.Lock()
        self._strikes = {}       # model -> {"n": count, "t": last crash}
        self._pending = []       # (model, rank) crashes awaiting respawn
        self._seq = itertools.count()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread = None
        pool.add_death_callback(self._on_death)

    @property
    def stats(self):
        return self.router.stats_

    # -- death intake ------------------------------------------------------
    def _on_death(self, handle):
        """Pool death callback.  Only CRASHES respawn: an intentional
        removal (retire/close flips ``reaped`` before the callbacks,
        drain flips ``draining``) is the autoscaler's/operator's call
        to shrink, not a failure to heal."""
        if self._stop.is_set():
            return
        if getattr(handle, "reaped", False) or \
                getattr(handle, "draining", False):
            return
        model = (getattr(handle, "model_id", None)
                 or self.router.cfg.default_model)
        with self._lock:
            self._pending.append((model, handle.rank))
        self._wake.set()

    # -- respawn -----------------------------------------------------------
    def run_pending(self):
        """Synchronously drain the crash queue (the deterministic test
        surface; the background thread calls this too).  Returns the
        list of respawn events."""
        events = []
        while True:
            with self._lock:
                if not self._pending:
                    return events
                model, rank = self._pending.pop(0)
            events.append(self._respawn(model, rank))

    def _respawn(self, model, rank):
        key = degrade_key(model)
        if degradations.is_degraded(key):
            # the loop already exhausted its budget — refuse quietly
            self.stats.on_respawn(model, "refused")
            return {"model": model, "rank": rank, "action": "refused"}
        now = self._clock()
        with self._lock:
            st = self._strikes.get(model)
            if st is None or now - st["t"] >= self._stability_window_s:
                st = self._strikes[model] = {"n": 0, "t": now}
            st["n"] += 1
            st["t"] = now
            n = st["n"]
        if n > self._max_respawns:
            # crash loop: budget exhausted — degrade PERMANENTLY and
            # fire the incident trigger (IncidentManager debounces to
            # exactly one bundle per cooldown)
            first = degradations.degrade(
                key, error=self.last_error,
                detail=f"{n - 1} respawns within "
                       f"{self._stability_window_s}s — crash loop, "
                       f"giving up")
            if first:
                _flightrec.trigger(
                    "degrade", detail=key, key=key, model=str(model),
                    respawns=n - 1)
            self.stats.on_respawn(model, "gave_up")
            return {"model": model, "rank": rank, "action": "gave_up",
                    "respawns": n - 1}
        if n > 1:
            # escalating backoff between consecutive loop respawns
            self._sleep(self._delays[min(n - 2, len(self._delays) - 1)])
        label = f"respawn{next(self._seq)}"
        self.stats.on_worker_state(model, label, "warming")
        try:
            h = self.pool.spawn_worker(
                model_id=model, **dict(self._catalog.get(model, {})))
        except Exception as e:  # noqa: BLE001 — the loop must survive
            self.stats.on_worker_state(model, label, None)
            self.last_error = e
            self.stats.on_respawn(model, "failed")
            # a failed bringup IS another strike: re-enter the loop so
            # the next death (or retry) escalates toward the budget
            with self._lock:
                self._pending.append((model, rank))
            self._wake.set()
            return {"model": model, "rank": rank, "action": "failed",
                    "error": str(e)}
        self.stats.on_worker_state(model, label, None)
        self.router.attach_worker(h, model=model)
        self.stats.on_respawn(model, "ok")
        _flightrec.note("respawn", model=str(model), dead_rank=rank,
                        new_rank=h.rank, attempt=n)
        return {"model": model, "rank": rank, "action": "ok",
                "worker": h.rank}

    # -- background loop ---------------------------------------------------
    def _run(self):
        while not self._stop.is_set():
            self._wake.wait(timeout=0.2)
            self._wake.clear()
            try:
                self.run_pending()
            except Exception as e:  # noqa: BLE001 — loop survives
                self.last_error = e

    def start(self):
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="fleet-supervisor", daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout=5.0):
        self._stop.set()
        self._wake.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=timeout)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False
