"""Process-wide metrics registry: Counter / Gauge / Histogram.

Counterpart of paddle_tpu/observability/registry.py, copied: the JAX
package's module imports no jax, but its package does.

One place every subsystem reports through (parity point: the reference
stack pushes profiler tables and Paddle Serving sidecar metrics through
separate pipes; here serving, generation, training, dataio and
resilience all land on the SAME registry so one snapshot answers "is
the fleet degraded and where did the step time go").

Design:

* a :class:`MetricsRegistry` holds named metrics; each metric holds one
  series per label-set (``labels(server="0")`` style, Prometheus
  semantics).  ``counter``/``gauge``/``histogram`` are get-or-create
  and type-checked, so two subsystems asking for the same name share
  the series rather than shadowing each other.
* everything is thread-safe: the registry dict has its own lock, every
  metric has one lock guarding all of its series.  Mutators are a few
  attribute ops under that lock — cheap enough to leave on in the
  serving request path (the bench `observability_overhead` scenario
  gates the full pipe at < 2% of an uninstrumented train step).
* :class:`Histogram` keeps fixed log-spaced buckets (for Prometheus
  export) plus a bounded round-robin reservoir of raw samples (for
  accurate p50/p95/p99 on long-lived processes) — the same technique
  `serving.stats.LatencyHistogram` proved out; that class now formats
  summaries over series produced here.
* export: :meth:`MetricsRegistry.snapshot` (JSON-able, carries
  ``schema_version``) and :meth:`MetricsRegistry.prometheus_text`
  (text exposition format, scrape-able).

The process-wide default lives at module scope (:func:`get_registry`):
metrics are a process property.
"""
from __future__ import annotations

import bisect
import json
import math
import re
import threading
import time

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "get_registry", "nearest_rank", "DEFAULT_MS_BOUNDS",
           "SNAPSHOT_SCHEMA_VERSION"]

#: registry snapshot schema — bump when keys move (dashboards key on it)
SNAPSHOT_SCHEMA_VERSION = 1

#: 0.1ms .. ~105s in x2 steps — wide enough for a sub-ms CPU fc model
#: and a long generate call (shared with serving's histograms)
DEFAULT_MS_BOUNDS = tuple(0.1 * 2 ** i for i in range(21))

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def _label_key(labels):
    for k in labels:
        if not _LABEL_RE.match(k):
            raise ValueError(f"invalid label name {k!r}")
    # values coerce to str: labels(shard=0) and labels(shard="0") must
    # be ONE series (they render identically in every export), and a
    # mixed-type key set would make the sorted() in series() raise
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def nearest_rank(sorted_samples, p):
    """Nearest-rank percentile over an already-sorted sample list — THE
    selection rule for every percentile in the telemetry stack (series
    reservoirs, registry snapshots, and serving summaries), defined
    once so snapshot-vs-scrape parity cannot drift."""
    n = len(sorted_samples)
    return sorted_samples[min(n - 1, max(0, int(round(
        (p / 100.0) * (n - 1)))))]


def _escape(v):
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace(
        "\n", "\\n")


def _fmt_labels(items, extra=()):
    items = tuple(items) + tuple(extra)
    if not items:
        return ""
    return "{" + ",".join(f'{k}="{_escape(v)}"' for k, v in items) + "}"


class _CounterSeries:
    """One monotonically-increasing value for one label-set."""

    __slots__ = ("_lock", "_value")

    def __init__(self, lock):
        self._lock = lock
        self._value = 0.0

    def inc(self, amount=1):
        if amount < 0:
            raise ValueError(f"counter increment must be >= 0, "
                             f"got {amount}")
        with self._lock:
            # float() strips numpy scalar types, which would otherwise
            # infect the accumulator and break JSON export
            self._value += float(amount)

    def value(self):
        with self._lock:
            return self._value


class _GaugeSeries:
    """One settable value for one label-set."""

    __slots__ = ("_lock", "_value")

    def __init__(self, lock):
        self._lock = lock
        self._value = 0.0

    def set(self, value):
        with self._lock:
            self._value = float(value)

    def inc(self, amount=1):
        with self._lock:
            self._value += float(amount)

    def dec(self, amount=1):
        self.inc(-amount)

    def value(self):
        with self._lock:
            return self._value


class _HistogramSeries:
    """Bucketed counts + bounded raw-sample reservoir for one label-set.

    The reservoir overwrites round-robin once full: a deterministic
    recent-ish window with zero allocation churn (no randomness, so
    tests are reproducible)."""

    __slots__ = ("_lock", "_bounds", "_counts", "_samples", "_stamps",
                 "_max_samples", "_n", "_sum", "_max", "_clock",
                 "_exemplars")

    def __init__(self, lock, bounds, max_samples, clock=None):
        self._lock = lock
        self._bounds = bounds
        self._counts = [0] * (len(bounds) + 1)
        self._samples: list = []
        self._stamps: list = []
        self._max_samples = max_samples
        self._n = 0
        self._sum = 0.0
        self._max = 0.0
        self._clock = clock or time.monotonic
        # bucket index -> (trace_id, value, ts): last exemplar to land
        # in that bucket; bounded by the bucket count, so the whole map
        # costs O(len(bounds)) regardless of traffic
        self._exemplars: dict = {}

    def observe(self, value, exemplar=None):
        value = float(value)
        now = self._clock()
        with self._lock:
            b = bisect.bisect_left(self._bounds, value)
            self._counts[b] += 1
            self._n += 1
            self._sum += value
            self._max = max(self._max, value)
            if exemplar is not None:
                self._exemplars[b] = (str(exemplar), value, now)
            if len(self._samples) < self._max_samples:
                self._samples.append(value)
                self._stamps.append(now)
            else:
                i = self._n % self._max_samples
                self._samples[i] = value
                self._stamps[i] = now

    # -- reads -------------------------------------------------------------
    @property
    def count(self):
        with self._lock:
            return self._n

    @property
    def sum(self):
        with self._lock:
            return self._sum

    def state(self):
        """(n, sum, max, samples-copy): the accumulator state, copied
        under the lock so the O(n log n) percentile sort can run OUTSIDE
        it (a stats poll must never stall the request path)."""
        with self._lock:
            return (self._n, self._sum, self._max, list(self._samples))

    def percentile(self, p, window_s=None, now=None):
        """Nearest-rank percentile over the reservoir.

        ``window_s=None`` (default) reads the full lifetime reservoir —
        the snapshot semantics.  With ``window_s`` set, only samples
        observed within the trailing window count, so a control signal
        (SLO shedding, autoscaler p99) recovers once an incident ages
        out instead of being poisoned by it forever.  ``now`` overrides
        the series clock reading (tests)."""
        if window_s is None:
            _, _, _, samples = self.state()
        else:
            with self._lock:
                pairs = list(zip(self._samples, self._stamps))
            cutoff = (self._clock() if now is None else now) - window_s
            samples = [v for v, ts in pairs if ts >= cutoff]
        if not samples:
            return None
        return nearest_rank(sorted(samples), p)

    def over_threshold(self, threshold, window_s=None, now=None):
        """``(n, n_over)``: reservoir samples observed within the
        trailing window (lifetime, when ``window_s`` is None) and how
        many exceeded ``threshold`` — the latency-SLO burn rate's
        numerator and denominator.  ``now`` overrides the series clock
        reading (tests)."""
        with self._lock:
            pairs = list(zip(self._samples, self._stamps))
        if window_s is not None:
            cutoff = (self._clock() if now is None else now) - window_s
            pairs = [p for p in pairs if p[1] >= cutoff]
        return len(pairs), sum(1 for v, _ in pairs if v > threshold)

    def buckets(self):
        """(upper_bound, count) for non-empty buckets; last bound is
        +inf.  NON-cumulative (the JSON form); the Prometheus exporter
        accumulates."""
        with self._lock:
            out = []
            for i, c in enumerate(self._counts):
                if c:
                    bound = (self._bounds[i] if i < len(self._bounds)
                             else float("inf"))
                    out.append((bound, c))
            return out

    def exemplars(self):
        """[(upper_bound, trace_id, value, ts)] for buckets holding an
        exemplar, in bound order; last bound is +inf.  The retained
        exemplar is the LAST one observed into that bucket, so a page
        off a latency burn names a request from the burn, not one from
        process start."""
        with self._lock:
            items = sorted(self._exemplars.items())
        out = []
        for i, (tid, v, ts) in items:
            bound = (self._bounds[i] if i < len(self._bounds)
                     else float("inf"))
            out.append((bound, tid, v, ts))
        return out

    def cumulative_buckets(self):
        return self.scrape_state()[0]

    def scrape_state(self):
        """(cumulative_buckets, sum, count) copied under ONE lock
        acquisition — a scrape assembled from separate reads could show
        a +Inf bucket total that disagrees with ``_count`` when an
        observe lands between them."""
        with self._lock:
            counts = list(self._counts)
            total = self._sum
            n = self._n
        out, acc = [], 0
        for i, c in enumerate(counts):
            acc += c
            bound = (self._bounds[i] if i < len(self._bounds)
                     else float("inf"))
            out.append((bound, acc))
        return out, total, n


class _Metric:
    """Named metric: a family of series keyed by label-set."""

    kind = None

    def __init__(self, name, help=""):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._series: dict = {}

    def _new_series(self):
        raise NotImplementedError

    def labels(self, **labels):
        key = _label_key(labels)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = self._series[key] = self._new_series()
            return s

    # convenience: unlabeled default series proxies -------------------------
    def _default(self):
        return self.labels()

    def series(self):
        """[(labels_tuple, series)] in stable (sorted) order."""
        with self._lock:
            return sorted(self._series.items())


class Counter(_Metric):
    kind = "counter"

    def _new_series(self):
        return _CounterSeries(self._lock)

    def inc(self, amount=1, **labels):
        (self.labels(**labels) if labels else self._default()).inc(amount)

    def value(self, **labels):
        return (self.labels(**labels) if labels
                else self._default()).value()


class Gauge(_Metric):
    kind = "gauge"

    def _new_series(self):
        return _GaugeSeries(self._lock)

    def set(self, value, **labels):
        (self.labels(**labels) if labels else self._default()).set(value)

    def inc(self, amount=1, **labels):
        (self.labels(**labels) if labels else self._default()).inc(amount)

    def dec(self, amount=1, **labels):
        self.inc(-amount, **labels)

    def value(self, **labels):
        return (self.labels(**labels) if labels
                else self._default()).value()


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help="", bounds=DEFAULT_MS_BOUNDS,
                 max_samples=65536, clock=None):
        super().__init__(name, help)
        self._bounds = tuple(sorted(bounds))
        self._max_samples = max_samples
        self._clock = clock

    def _new_series(self):
        return _HistogramSeries(self._lock, self._bounds,
                                self._max_samples, clock=self._clock)

    def observe(self, value, exemplar=None, **labels):
        """Record ``value``; an optional ``exemplar`` (a trace id)
        is retained per bucket — see :meth:`_HistogramSeries.exemplars`
        — and rides snapshots/exposition so a latency bucket can name
        an actual request that landed in it."""
        (self.labels(**labels) if labels
         else self._default()).observe(value, exemplar=exemplar)

    def percentile(self, p, window_s=None, **labels):
        return (self.labels(**labels) if labels
                else self._default()).percentile(p, window_s=window_s)


class MetricsRegistry:
    """Get-or-create home for every metric in the process."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict = {}

    def _get_or_create(self, cls, name, help, **kwargs):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, **kwargs)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"requested {cls.kind}")
            return m

    def counter(self, name, help=""):
        return self._get_or_create(Counter, name, help)

    def gauge(self, name, help=""):
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name, help="", bounds=None, max_samples=None):
        """Get-or-create.  ``bounds``/``max_samples`` only apply at
        creation; EXPLICITLY passing them for an existing metric with
        different construction raises (a silent mismatch would file
        every sample into the wrong buckets with no error), while
        omitting them always returns the existing metric."""
        m = self._get_or_create(
            Histogram, name, help,
            bounds=(DEFAULT_MS_BOUNDS if bounds is None else bounds),
            max_samples=(65536 if max_samples is None else max_samples))
        if bounds is not None and m._bounds != tuple(sorted(bounds)):
            raise ValueError(
                f"histogram {name!r} already registered with bounds "
                f"{m._bounds}; requested {tuple(sorted(bounds))}")
        if max_samples is not None and m._max_samples != max_samples:
            raise ValueError(
                f"histogram {name!r} already registered with "
                f"max_samples {m._max_samples}; requested {max_samples}")
        return m

    def metrics(self):
        with self._lock:
            return sorted(self._metrics.items())

    def reset(self):
        """Forget every metric (tests only — production metrics live
        for the process; handles held by existing subsystems keep
        working but stop appearing in snapshots)."""
        with self._lock:
            self._metrics.clear()

    # -- export ------------------------------------------------------------
    def snapshot(self):
        """JSON-able dict of every series.  Histogram series carry
        count/sum/max, reservoir percentiles, and non-cumulative
        buckets."""
        out = {"schema_version": SNAPSHOT_SCHEMA_VERSION, "metrics": {}}
        for name, metric in self.metrics():
            entry = {"type": metric.kind, "help": metric.help,
                     "series": []}
            for labels, s in metric.series():
                rec = {"labels": dict(labels)}
                if metric.kind == "histogram":
                    n, total, mx, samples = s.state()
                    rec["count"] = n
                    rec["sum"] = round(total, 6)
                    rec["max"] = round(mx, 6)
                    if samples:
                        srt = sorted(samples)
                        rec["p50"] = round(nearest_rank(srt, 50), 6)
                        rec["p95"] = round(nearest_rank(srt, 95), 6)
                        rec["p99"] = round(nearest_rank(srt, 99), 6)
                    rec["buckets"] = [
                        ["+Inf" if math.isinf(b) else round(b, 6), c]
                        for b, c in s.buckets()]
                    ex = s.exemplars()
                    if ex:
                        rec["exemplars"] = [
                            ["+Inf" if math.isinf(b) else round(b, 6),
                             tid, round(v, 6), round(ts, 6)]
                            for b, tid, v, ts in ex]
                else:
                    rec["value"] = s.value()
                entry["series"].append(rec)
            out["metrics"][name] = entry
        return out

    def dump_json(self, path):
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=1, sort_keys=True)
        return path

    def prometheus_text(self):
        """Prometheus text exposition format (the scrape payload)."""
        lines = []
        for name, metric in self.metrics():
            if metric.help:
                lines.append(f"# HELP {name} {metric.help}")
            lines.append(f"# TYPE {name} {metric.kind}")
            for labels, s in metric.series():
                if metric.kind == "histogram":
                    buckets, total, n = s.scrape_state()
                    ex = {b: (tid, v, ts) for b, tid, v, ts
                          in s.exemplars()}
                    for bound, acc in buckets:
                        le = "+Inf" if math.isinf(bound) else repr(bound)
                        line = (f"{name}_bucket"
                                f"{_fmt_labels(labels, (('le', le),))}"
                                f" {acc}")
                        if bound in ex:
                            # OpenMetrics exemplar suffix: the last
                            # request that landed in this bucket
                            tid, v, ts = ex[bound]
                            line += (f' # {{trace_id="{_escape(tid)}"}}'
                                     f" {v} {ts}")
                        lines.append(line)
                    lines.append(
                        f"{name}_sum{_fmt_labels(labels)} {total}")
                    lines.append(
                        f"{name}_count{_fmt_labels(labels)} {n}")
                else:
                    lines.append(
                        f"{name}{_fmt_labels(labels)} {s.value()}")
        return "\n".join(lines) + "\n"


#: The process-wide registry every subsystem reports through.
_default_registry = MetricsRegistry()


def get_registry():
    return _default_registry
