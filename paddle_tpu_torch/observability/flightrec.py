"""Always-on flight recorder: bounded ring + triggered incident bundles.

The registry answers "what are the rates"; the profiler answers "where
did the time go *when someone was watching*".  Neither answers the
on-call question: a worker just died / a seam degraded / p99 blew the
SLO — *what happened in the seconds before*?  This module keeps a
bounded ring buffer of recent spans and events in every process at
near-zero cost (one module-flag check + one GIL-atomic deque append —
no locks, no allocation beyond the tuple), so the answer is always
already recorded when an incident fires.

Three pieces:

* :class:`FlightRecorder` — the ring.  ``tracing.span`` feeds it every
  closed span while :func:`arm`-ed (even with the profiler OFF — the
  ring is the always-on tier, the profiler the opt-in firehose);
  subsystems drop :func:`note` breadcrumbs (admissions, sheds, request
  outcomes, scale events).  :meth:`FlightRecorder.to_chrome_trace`
  renders a dump in the exact shape ``profiler.export_chrome_tracing``
  writes — including ``metadata.perf_origin_unix_us`` — so
  ``tools/trace_merge.py`` puts rings from N processes on one timeline.
* the trigger bus — :func:`trigger` is called at the moments the
  degradation/resilience discipline was built around (worker death,
  ``degradations.degrade`` on any seam, ``fleet.rollout`` abort,
  NaN-skip, SLO shed).  It rings a breadcrumb, bumps
  ``flight_triggers_total{reason}``, and fans out to listeners.  Every
  producer hook is lazy-import + best-effort: telemetry must never
  raise into a serving or training path.
* :class:`IncidentManager` — a trigger listener that assembles an
  on-disk *incident bundle*: the local ring, a ``flight_dump`` RPC to
  every live worker handle, per-process Chrome traces plus the merged
  cross-process timeline, and a fleet registry snapshot.  A cooldown
  debounces trigger storms to one bundle per incident.

Counterpart of paddle_tpu/observability/flightrec.py, copied.
``_load_trace_merge`` loads the repo's ``tools/trace_merge.py`` by
path, as the JAX module does: that tool belongs to neither package
and imports only ``json`` and ``sys``.  The port raises where the
JAX package would degrade a seam, so no trigger fires on a
degradation here.
"""
from __future__ import annotations

import collections
import importlib.util
import json
import os
import threading
import time

from .monitor import FLIGHT_BUNDLES, FLIGHT_TRIGGERS
from .registry import get_registry

__all__ = ["FlightRecorder", "IncidentManager", "get_recorder", "arm",
           "disarm", "armed", "note", "trigger", "add_trigger_listener",
           "remove_trigger_listener", "DEFAULT_RING_SIZE"]

#: default ring capacity (events); at the serving tier's ~4 ring writes
#: per request this holds the last ~1k requests — minutes of context —
#: in a few hundred KB
DEFAULT_RING_SIZE = 4096

#: THE hot-path gate.  ``tracing.span`` reads this module attribute
#: directly: when False (default), armed-path recording costs one
#: global read.  Toggled only by :func:`arm` / :func:`disarm`.
_armed = False


class FlightRecorder:
    """Bounded ring of recent spans and breadcrumb notes.

    Entries are plain tuples appended to a ``deque(maxlen=...)`` —
    GIL-atomic, lock-free, oldest-drop.  Times are
    ``time.perf_counter`` seconds (the profiler's clock); the
    perf->unix offset is stamped at :meth:`dump` time so a ring
    shipped over RPC still lands on the common timeline.
    """

    def __init__(self, ring_size=DEFAULT_RING_SIZE):
        self._ring: collections.deque = collections.deque(
            maxlen=int(ring_size))

    @property
    def ring_size(self):
        return self._ring.maxlen

    def __len__(self):
        return len(self._ring)

    # -- writes (hot path) -------------------------------------------------
    def record_span(self, name, t0, t1, trace_id, span_id,
                    parent_span_id, attrs=None):
        self._ring.append(("span", name, t0, t1, trace_id, span_id,
                           parent_span_id, attrs or None))

    def note(self, kind, fields=None):
        self._ring.append(("note", kind, time.perf_counter(),
                           fields or None))

    def clear(self):
        self._ring.clear()

    # -- reads -------------------------------------------------------------
    def dump(self):
        """JSON-able snapshot of the ring: ship it over RPC, write it
        into a bundle, or feed it to :meth:`to_chrome_trace`."""
        entries = list(self._ring)
        events = []
        for e in entries:
            if e[0] == "span":
                _, name, t0, t1, tid, sid, psid, attrs = e
                ev = {"kind": "span", "name": name, "t0": t0, "t1": t1,
                      "trace_id": tid, "span_id": sid,
                      "parent_span_id": psid}
                if attrs:
                    ev["attrs"] = attrs
            else:
                _, kind, t, fields = e
                ev = {"kind": "note", "note": kind, "t": t}
                if fields:
                    ev["fields"] = fields
            events.append(ev)
        return {
            "pid": os.getpid(),
            "ring_size": self._ring.maxlen,
            "dumped_at_unix": time.time(),
            # same key the profiler stamps: trace_merge aligns on it
            "perf_origin_unix_us": (time.time() - time.perf_counter())
            * 1e6,
            "events": events,
        }

    @staticmethod
    def to_chrome_trace(dump):
        """Render a :meth:`dump` (possibly from ANOTHER process) as a
        Chrome-trace doc in ``profiler.export_chrome_tracing``'s shape —
        span entries as ``X`` events carrying trace/span ids in
        ``args``, notes as instant events — mergeable by
        ``tools/trace_merge.py``."""
        pid = dump.get("pid", 0)
        trace_events = [
            {"name": "process_name", "ph": "M", "pid": pid,
             "args": {"name": f"paddle_tpu flightrec pid {pid}"}},
        ]
        for ev in dump.get("events", []):
            if ev.get("kind") == "span":
                args = {"trace_id": ev.get("trace_id"),
                        "span_id": ev.get("span_id"),
                        "parent_span_id": ev.get("parent_span_id")}
                args.update(ev.get("attrs") or {})
                trace_events.append(
                    {"name": ev.get("name", "?"), "ph": "X", "pid": pid,
                     "tid": 0, "ts": ev["t0"] * 1e6,
                     "dur": (ev["t1"] - ev["t0"]) * 1e6,
                     "cat": "flightrec", "args": args})
            else:
                trace_events.append(
                    {"name": f"note:{ev.get('note', '?')}", "ph": "i",
                     "pid": pid, "tid": 0, "ts": ev["t"] * 1e6,
                     "s": "p", "cat": "flightrec",
                     "args": ev.get("fields") or {}})
        return {"traceEvents": trace_events,
                "metadata": {"pid": pid,
                             "perf_origin_unix_us":
                             dump.get("perf_origin_unix_us")}}


#: the process ring — exists even while disarmed so handles are stable
_recorder = FlightRecorder()


def get_recorder():
    return _recorder


def armed():
    return _armed


def arm(ring_size=None):
    """Turn the ring on (idempotent).  ``ring_size`` resizes, keeping
    the newest entries."""
    global _armed, _recorder
    if ring_size is not None and ring_size != _recorder.ring_size:
        old = list(_recorder._ring)
        _recorder = FlightRecorder(ring_size)
        _recorder._ring.extend(old[-int(ring_size):])
    _armed = True
    return _recorder


def disarm(clear=False):
    global _armed
    _armed = False
    if clear:
        _recorder.clear()


def note(kind, **fields):
    """Breadcrumb the ring (no-op while disarmed; never raises)."""
    if not _armed:
        return
    try:
        _recorder.note(kind, fields or None)
    except Exception:  # noqa: BLE001 — telemetry must never raise out
        pass


# -- trigger bus -----------------------------------------------------------
_listeners: list = []
_listener_lock = threading.Lock()


def add_trigger_listener(fn):
    """Register ``fn(reason, detail, fields)`` to run on every
    :func:`trigger` firing (IncidentManager installs itself here)."""
    with _listener_lock:
        if fn not in _listeners:
            _listeners.append(fn)
    return fn


def remove_trigger_listener(fn):
    with _listener_lock:
        if fn in _listeners:
            _listeners.remove(fn)


def trigger(reason, detail=None, **fields):
    """An incident-class event happened.  Rings a breadcrumb, counts
    ``flight_triggers_total{reason}``, and notifies listeners.  No-op
    while disarmed; never raises into the caller (producers sit on
    serving/training hot paths)."""
    if not _armed:
        return
    try:
        f = dict(fields)
        if detail is not None:
            f["detail"] = str(detail)
        _recorder.note(f"trigger:{reason}", f or None)
        get_registry().counter(
            FLIGHT_TRIGGERS,
            "flight-recorder trigger firings").inc(reason=reason)
    except Exception:  # noqa: BLE001
        pass
    with _listener_lock:
        listeners = list(_listeners)
    for fn in listeners:
        try:
            fn(reason, detail, dict(fields))
        except Exception:  # noqa: BLE001 — one bad listener must not
            pass           # starve the rest (or the caller)


# -- incident bundles ------------------------------------------------------
def _load_trace_merge():
    """``tools/trace_merge.py`` loaded by repo-relative path (tools/ is
    not a package); None when the checkout doesn't carry it — the
    bundle then simply skips the merged trace."""
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    path = os.path.join(repo, "tools", "trace_merge.py")
    if not os.path.exists(path):
        return None
    spec = importlib.util.spec_from_file_location(
        "_paddle_tpu_trace_merge", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class IncidentManager:
    """Trigger listener that assembles on-disk incident bundles.

    Parameters
    ----------
    out_dir : bundles land in ``out_dir/incident-NNNN-<reason>/``.
    handles_fn : zero-arg callable returning the worker handles to fan
        ``flight_dump`` to (duck-typed: ``.call(op)``, optional
        ``.alive``/``.rank``).  None = local ring only.
    scraper : optional TelemetryScraper — its fleet snapshot (worker
        truth + router rows) becomes the bundle's ``registry.json``;
        without one the local process registry is snapshotted.
    cooldown_s : debounce window — a trigger storm (every request of a
        shed wave fires) produces ONE bundle; suppressed firings are
        counted in :attr:`suppressed`.
    """

    def __init__(self, out_dir, handles_fn=None, scraper=None,
                 cooldown_s=30.0, clock=time.monotonic):
        self.out_dir = out_dir
        self.handles_fn = handles_fn
        self.scraper = scraper
        self.cooldown_s = cooldown_s
        self.bundles: list = []
        self.suppressed = 0
        self.last_error = None
        self._clock = clock
        self._last_fire = None
        self._seq = 0
        self._lock = threading.Lock()

    # -- listener lifecycle ------------------------------------------------
    def install(self):
        add_trigger_listener(self._on_trigger)
        return self

    def uninstall(self):
        remove_trigger_listener(self._on_trigger)

    def __enter__(self):
        return self.install()

    def __exit__(self, *exc):
        self.uninstall()
        return False

    def _on_trigger(self, reason, detail, fields):
        with self._lock:
            now = self._clock()
            if (self._last_fire is not None
                    and now - self._last_fire < self.cooldown_s):
                self.suppressed += 1
                return
            self._last_fire = now
        try:
            self.assemble(reason, detail=detail, fields=fields)
        except Exception as e:  # noqa: BLE001 — never raise into the
            self.last_error = e  # trigger path (it sits on hot paths)

    @staticmethod
    def _join_exemplars(snap, dumps):
        """The exemplar -> trace join: every histogram exemplar in the
        bundle's registry snapshot, resolved against the span trace ids
        present in the collected rings.  ``resolved=True`` means the
        bundle's merged Chrome trace CONTAINS the request that landed
        in that bucket — a bad-latency page opens straight onto the
        offending request's timeline."""
        span_tids = set()
        for _, d in dumps:
            for ev in d.get("events", []):
                if (ev.get("kind") == "span"
                        and ev.get("trace_id") is not None):
                    span_tids.add(str(ev["trace_id"]))
        out = []
        for name, entry in (snap.get("metrics") or {}).items():
            for rec in entry.get("series", []):
                for ex in rec.get("exemplars") or []:
                    bound, tid, value, ts = ex
                    out.append({
                        "metric": name,
                        "labels": rec.get("labels") or {},
                        "le": bound,
                        "trace_id": str(tid),
                        "value": value,
                        "ts": ts,
                        "resolved": str(tid) in span_tids,
                    })
        return out

    # -- assembly ----------------------------------------------------------
    def assemble(self, reason, detail=None, fields=None):
        """Collect rings + registry into one bundle dir; returns its
        path.  Dead/unreachable handles are skipped — a bundle from
        the survivors beats no bundle."""
        with self._lock:
            self._seq += 1
            seq = self._seq
        safe = "".join(c if c.isalnum() or c in "-_" else "_"
                       for c in str(reason))[:40] or "unknown"
        bundle = os.path.join(self.out_dir, f"incident-{seq:04d}-{safe}")
        os.makedirs(bundle, exist_ok=True)

        dumps = [("local", _recorder.dump())]
        for h in (self.handles_fn() if self.handles_fn else []):
            if not getattr(h, "alive", True):
                continue
            try:
                rep = h.call("flight_dump")
                d = rep.get("dump") if isinstance(rep, dict) else None
                if d:
                    dumps.append((f"worker{getattr(h, 'rank', '?')}", d))
            except Exception:  # noqa: BLE001 — survivors only
                continue

        trace_paths, ring_files = [], []
        for key, d in dumps:
            ring_path = os.path.join(bundle, f"ring_{key}.json")
            with open(ring_path, "w") as f:
                json.dump(d, f)
            ring_files.append(os.path.basename(ring_path))
            tp = os.path.join(bundle, f"trace_{key}.json")
            with open(tp, "w") as f:
                json.dump(FlightRecorder.to_chrome_trace(d), f)
            trace_paths.append(tp)

        merged_name = cross_ids = None
        tm = _load_trace_merge()
        if tm is not None and trace_paths:
            merged_path = os.path.join(bundle, "trace_merged.json")
            merged = tm.merge_traces(trace_paths, out_path=merged_path)
            merged_name = os.path.basename(merged_path)
            cross_ids = tm.cross_process_trace_ids(merged,
                                                   min_processes=2)

        snap = None
        if self.scraper is not None:
            try:
                self.scraper.scrape()
                snap = self.scraper.fleet_snapshot()
            except Exception:  # noqa: BLE001
                snap = None
        if snap is None:
            snap = get_registry().snapshot()
        with open(os.path.join(bundle, "registry.json"), "w") as f:
            json.dump(snap, f, indent=1, sort_keys=True)

        exemplars = self._join_exemplars(snap, dumps)
        manifest = {
            "reason": reason,
            "detail": (str(detail) if detail is not None else None),
            "fields": fields or {},
            "assembled_at_unix": time.time(),
            "processes": sorted({d.get("pid") for _, d in dumps}),
            "rings": ring_files,
            "merged_trace": merged_name,
            "cross_process_trace_ids": cross_ids,
            "registry": "registry.json",
            "fleet_snapshot": bool(self.scraper is not None),
            "exemplars": exemplars,
        }
        with open(os.path.join(bundle, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1, sort_keys=True)
        self.bundles.append(bundle)
        try:
            get_registry().counter(
                FLIGHT_BUNDLES, "incident bundles assembled").inc()
        except Exception:  # noqa: BLE001
            pass
        return bundle
