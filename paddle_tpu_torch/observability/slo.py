"""SLO burn-rate engine — declarative objectives over registry truth.

Dashboards read rates; on-call needs a DECISION: is the error budget
burning fast enough that a human (or the incident pipeline) must look
NOW?  This module evaluates declared objectives as multi-window
burn rates — the SRE alerting discipline:

* an :class:`SloObjective` states a target (``availability``: the share
  of requests that must finish non-shed and non-error; ``latency``: the
  share that must finish under a millisecond bound — a p99 target is
  ``target=0.99``).  The error budget is ``1 - target``.
* the burn rate over a window is ``bad_fraction / budget`` — 1.0 means
  the budget is being consumed exactly at the sustainable rate, 14.4
  means a 30-day budget dies in ~2 days.
* a PAGE needs the burn over BOTH fast windows (default 5m and 1h) at
  or above ``page_burn`` — the long window proves it is not a blip, the
  short window proves it is still happening.  A TICKET uses the slow
  pair (default 30m and 6h) at ``ticket_burn``.  Every window is
  injectable, as is the clock, so tests and the bench drive minutes of
  "time" in milliseconds.

Sources are the registry series the fleet already emits — no new
request-path instrumentation:

* availability reads the cumulative ``cluster_requests_total`` /
  ``cluster_shed_total`` counters; the engine keeps its own bounded
  history of (timestamp, cumulative) samples and differences them per
  window (counters are cumulative; windows need deltas).
* latency reads the registry histogram's stamped reservoir directly
  (``_HistogramSeries.over_threshold``) — the window lives in the
  samples, no history needed.

A page firing increments ``slo_pages_total{objective}`` AND rings the
flight-recorder trigger bus (reason ``slo_burn``), so the
:class:`~.flightrec.IncidentManager` assembles an exemplar-linked
bundle; its cooldown debounces a sustained burn to ONE bundle.
:meth:`SloEngine.burn_state` exposes the last evaluation as an
advisory signal the autoscaler / router admission can read.

Counterpart of paddle_tpu/observability/slo.py, copied.
"""
from __future__ import annotations

import threading
import time

from .monitor import (CLUSTER_REQUEST_LATENCY_MS, CLUSTER_REQUESTS,
                      CLUSTER_SHED, SLO_BURN_RATE, SLO_EVALUATIONS,
                      SLO_PAGES)
from .registry import get_registry

__all__ = ["SloObjective", "SloPolicy", "SloEngine"]

#: Google SRE book defaults: 14.4x burn kills a 30-day budget in ~2
#: days (page); 6x in 5 days (ticket).
PAGE_BURN = 14.4
TICKET_BURN = 6.0
FAST_WINDOWS = (300.0, 3600.0)      # 5m / 1h
SLOW_WINDOWS = (1800.0, 21600.0)    # 30m / 6h


class SloObjective:
    """One declared objective.

    Parameters
    ----------
    name : objective label value (``slo_burn_rate{objective=...}``).
    kind : ``"availability"`` (share of requests not shed/errored) or
        ``"latency"`` (share of requests under ``latency_ms``).
    target : the good-share target, e.g. ``0.999`` availability or
        ``0.99`` for "p99 under the bound".  Budget is ``1 - target``.
    latency_ms : the bound (latency kind only).
    counters : availability override — zero-arg callable returning
        cumulative ``(good, bad)``; None = the cluster counters.
    histogram : latency override — a series name whose stamped
        reservoir to read; None = ``cluster_request_latency_ms``.
    """

    def __init__(self, name, kind, target, latency_ms=None,
                 counters=None, histogram=None):
        if kind not in ("availability", "latency"):
            raise ValueError(f"unknown objective kind {kind!r}")
        if not 0.0 < target < 1.0:
            raise ValueError(f"target must be in (0, 1), got {target}")
        if kind == "latency" and latency_ms is None:
            raise ValueError("latency objective needs latency_ms")
        self.name = str(name)
        self.kind = kind
        self.target = float(target)
        self.budget = 1.0 - self.target
        self.latency_ms = (None if latency_ms is None
                           else float(latency_ms))
        self.counters = counters
        self.histogram = histogram or CLUSTER_REQUEST_LATENCY_MS


class SloPolicy:
    """The policy: objectives plus the window/threshold geometry."""

    def __init__(self, objectives, fast_windows=FAST_WINDOWS,
                 slow_windows=SLOW_WINDOWS, page_burn=PAGE_BURN,
                 ticket_burn=TICKET_BURN):
        self.objectives = list(objectives)
        if not self.objectives:
            raise ValueError("policy needs at least one objective")
        self.fast_windows = tuple(float(w) for w in fast_windows)
        self.slow_windows = tuple(float(w) for w in slow_windows)
        self.page_burn = float(page_burn)
        self.ticket_burn = float(ticket_burn)

    def windows(self):
        """All distinct windows, ascending."""
        return tuple(sorted(set(self.fast_windows + self.slow_windows)))

    @staticmethod
    def default(availability=0.999, latency_ms=None, target=0.99,
                **kwargs):
        """The serving-tier default: one availability objective, plus a
        latency objective when a bound is given."""
        objs = [SloObjective("availability", "availability",
                             availability)]
        if latency_ms is not None:
            objs.append(SloObjective("latency", "latency", target,
                                     latency_ms=latency_ms))
        return SloPolicy(objs, **kwargs)


class SloEngine:
    """Evaluates a :class:`SloPolicy` against a registry.

    ``evaluate()`` is the whole engine: sample sources, compute the
    burn per objective per window, write the ``slo_*`` series, fire
    the trigger bus on page.  Call it from any control loop (the
    scraper cadence is the natural one) or :meth:`start` a modest
    background loop.
    """

    def __init__(self, policy, registry=None, clock=None,
                 fire_trigger=True):
        self.policy = policy
        self._registry = registry or get_registry()
        self._clock = clock or time.monotonic
        self.fire_trigger = fire_trigger
        self._lock = threading.Lock()
        # availability history: objective name -> [(ts, good, bad)],
        # pruned past the longest window (+ one slack sample so a
        # full-window diff always has a baseline)
        self._history: dict = {o.name: [] for o in policy.objectives}
        self._state: dict = {}
        self._g_burn = self._registry.gauge(
            SLO_BURN_RATE,
            "error-budget burn rate per objective per window")
        self._c_pages = self._registry.counter(
            SLO_PAGES, "page-severity burn firings")
        self._c_evals = self._registry.counter(
            SLO_EVALUATIONS, "SLO evaluation passes")
        self._stop = threading.Event()
        self._thread = None

    # -- sources -----------------------------------------------------------
    def _availability_counts(self, obj):
        """Cumulative (good, bad) for an availability objective: every
        request the router finished OK vs failed + shed."""
        if obj.counters is not None:
            good, bad = obj.counters()
            return float(good), float(bad)
        reqs = self._registry.counter(CLUSTER_REQUESTS)
        good = bad = 0.0
        for labels, s in reqs.series():
            outcome = dict(labels).get("outcome", "")
            if outcome == "ok":
                good += s.value()
            else:
                bad += s.value()
        shed = self._registry.counter(CLUSTER_SHED)
        for _, s in shed.series():
            bad += s.value()
        return good, bad

    def _availability_burns(self, obj, now):
        """Per-window burn from the cumulative history: delta against
        the newest sample at least the window old (the earliest sample
        when the history is still shorter than the window)."""
        good, bad = self._availability_counts(obj)
        hist = self._history[obj.name]
        hist.append((now, good, bad))
        horizon = now - max(self.policy.windows())
        while len(hist) > 2 and hist[1][0] <= horizon:
            hist.pop(0)
        burns = {}
        for w in self.policy.windows():
            base = hist[0]
            for sample in hist:
                if sample[0] <= now - w:
                    base = sample
                else:
                    break
            d_good = good - base[1]
            d_bad = bad - base[2]
            total = d_good + d_bad
            frac = (d_bad / total) if total > 0 else 0.0
            burns[w] = frac / obj.budget
        return burns

    def _latency_burns(self, obj, now):
        """Per-window burn from the histogram reservoir: the share of
        windowed samples over the bound, across every series of the
        metric (fleet routers sum)."""
        hist = self._registry.histogram(obj.histogram)
        burns = {}
        for w in self.policy.windows():
            n = over = 0
            for _, s in hist.series():
                sn, so = s.over_threshold(obj.latency_ms, window_s=w,
                                          now=now)
                n += sn
                over += so
            frac = (over / n) if n > 0 else 0.0
            burns[w] = frac / obj.budget
        return burns

    # -- evaluation --------------------------------------------------------
    def evaluate(self, now=None):
        """One pass: returns (and stores) the burn state —
        ``{objective: {"burn": {window: rate}, "page": bool,
        "ticket": bool}}``."""
        now = self._clock() if now is None else now
        pol = self.policy
        with self._lock:
            state = {}
            for obj in pol.objectives:
                burns = (self._availability_burns(obj, now)
                         if obj.kind == "availability"
                         else self._latency_burns(obj, now))
                for w, rate in burns.items():
                    self._g_burn.set(round(rate, 4), objective=obj.name,
                                     window=f"{int(w)}s")
                page = all(burns[w] >= pol.page_burn
                           for w in pol.fast_windows)
                ticket = page or all(burns[w] >= pol.ticket_burn
                                     for w in pol.slow_windows)
                state[obj.name] = {
                    "burn": {f"{int(w)}s": round(r, 4)
                             for w, r in sorted(burns.items())},
                    "page": page,
                    "ticket": ticket,
                }
                if page:
                    self._c_pages.inc(objective=obj.name)
            self._c_evals.inc()
            self._state = state
        for name, st in state.items():
            if st["page"] and self.fire_trigger:
                # IncidentManager's cooldown debounces a sustained
                # burn into one bundle; the trigger itself fires every
                # burning evaluation (slo_pages_total counts them all)
                from . import flightrec

                flightrec.trigger(
                    "slo_burn", detail=name, objective=name,
                    burn=st["burn"])
        return state

    def burn_state(self):
        """The LAST evaluation (empty before the first) — the advisory
        read for the autoscaler / router admission: a page-level burn
        is a reason to scale out or shed harder BEFORE the human
        arrives."""
        with self._lock:
            return {k: dict(v) for k, v in self._state.items()}

    def paging(self):
        """True when any objective's last evaluation was page-level."""
        with self._lock:
            return any(st["page"] for st in self._state.values())

    # -- background loop ---------------------------------------------------
    def start(self, interval_s=5.0):
        if self._thread is not None:
            return self
        self._stop.clear()

        def loop():
            while not self._stop.wait(interval_s):
                try:
                    self.evaluate()
                except Exception:  # noqa: BLE001 — the loop survives
                    pass           # anything a source can throw

        self._thread = threading.Thread(
            target=loop, daemon=True, name="ptl-slo-engine")
        self._thread.start()
        return self

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
