"""Serving observability: latency histograms, QPS, queue depth, batch
occupancy, padding waste, and compile-cache accounting.

Counterpart of paddle_tpu/serving/stats.py: the same registry series
(names and labels) and the same snapshot keys, with two differences.
``GenerationStats`` also counts the engine's steps (``steps`` /
``steps_total``: unified chunked steps; not a registry series), and the
snapshots carry no ``kernel_degradations`` — the port has no
degradation registry: a kernel launches or raises.
``compiles_*`` count kernel builds or library loads: 0 after warmup
means steady state never compiled.

Parity: the reference deploys Paddle Serving behind its own metrics
sidecar; here the serving path instruments itself through the SAME
pipes the training stack uses — every batch execute and queue wait
lands as a span in the Chrome trace (``observability.tracing`` over
`profiler`), and every counter/histogram is a labeled series on the
process-wide ``observability.MetricsRegistry`` (one scrape endpoint for
serving, generation, training, dataio and resilience).  The per-server
JSON snapshot (`ServingStats.snapshot`) keeps its schema for existing
dashboards/SLO monitors; ``schema_version`` tracks its evolution.

Thread-safety: every mutator takes a lock (the stats lock for
composite fields, the registry's per-metric locks for series);
`observe` is called from the batcher worker and from client threads
(rejections), so the histogram must not assume a single writer.
"""
from __future__ import annotations

import itertools
import json
import threading
import time

from ..observability.monitor import (GENERATION_CACHE_OCCUPANCY,
                                     GENERATION_COMPILES,
                                     GENERATION_DISPATCHES,
                                     GENERATION_INTER_TOKEN_MS,
                                     GENERATION_PREFILL_CHUNKS,
                                     GENERATION_REQUESTS_DONE,
                                     GENERATION_SECONDS, GENERATION_TOKENS,
                                     SERVING_BATCH_EXECUTE_MS,
                                     SERVING_BATCHES, SERVING_COMPILES,
                                     SERVING_ELEMENTS, SERVING_QUEUE_DEPTH,
                                     SERVING_QUEUE_WAIT_MS,
                                     SERVING_REQUEST_LATENCY_MS,
                                     SERVING_REQUESTS, SERVING_ROWS,
                                     SERVING_SLO_VIOLATIONS)
from ..observability.registry import (DEFAULT_MS_BOUNDS, _HistogramSeries,
                                      get_registry, nearest_rank)

__all__ = ["LatencyHistogram", "ServingStats", "GenerationStats",
           "SNAPSHOT_SCHEMA_VERSION"]

#: Snapshot schema: v1 = pre-registry ad-hoc fields; v2 = registry-backed
#: with unified ``*_ms`` / ``*_total`` aliases alongside the v1 keys.
SNAPSHOT_SCHEMA_VERSION = 2

# one label value per stats object, so several servers/engines in one
# process stay distinct series on the shared registry
_server_seq = itertools.count(0)
_engine_seq = itertools.count(0)


class LatencyHistogram:
    """Fixed log-spaced buckets (for export) + a bounded reservoir of raw
    samples (for accurate p50/p95/p99 without holding every request of a
    long-lived server in memory).

    ONE accumulator implementation: this wraps the registry's series
    type (``observability.registry._HistogramSeries``) with a private
    lock, so a standalone histogram (e.g. ``metrics.ServingLatency``)
    and a registry-homed one can never drift in bucket or reservoir
    semantics.  The class also owns the summary FORMAT
    (:meth:`summarize`) ServingStats applies to registry series state.

    Bucket upper bounds are 0.1ms .. ~105s in x2 steps — wide enough for
    both a sub-ms CPU fc model and a long generate call."""

    BOUNDS = DEFAULT_MS_BOUNDS  # ms

    def __init__(self, max_samples=65536):
        self._series = _HistogramSeries(threading.Lock(), self.BOUNDS,
                                        max_samples)

    def observe(self, ms):
        self._series.observe(ms)

    # the shared selection rule, kept under the historical name
    _pick = staticmethod(nearest_rank)

    def percentile(self, p):
        return self._series.percentile(p)

    def state(self):
        """Cheap O(n) copy of the accumulator state, for summarizing
        OUTSIDE the observe lock — the sort must not stall the request
        path."""
        return self._series.state()

    @staticmethod
    def summarize(state):
        n, total, mx, samples = state
        if n == 0:
            return {"count": 0}
        s = sorted(samples)   # one sort for all three percentiles
        return {
            "count": n,
            "mean_ms": round(total / n, 3),
            "p50_ms": round(nearest_rank(s, 50), 3),
            "p95_ms": round(nearest_rank(s, 95), 3),
            "p99_ms": round(nearest_rank(s, 99), 3),
            "max_ms": round(mx, 3),
        }

    def summary(self):
        return self.summarize(self.state())

    def buckets(self):
        """(upper_bound_ms, count) pairs for non-empty buckets; the last
        bound is +inf."""
        return self._series.buckets()


class ServingStats:
    """All counters/gauges for one `InferenceServer`, exported as one
    JSON-able dict.  `slo_ms` (from ServingConfig) adds an SLO violation
    counter over end-to-end latency.

    Storage is labeled series on the process registry (label
    ``server=<n>``): the snapshot below AND a Prometheus scrape of
    ``observability.get_registry()`` report the same numbers."""

    def __init__(self, slo_ms=None, registry=None, server=None):
        reg = registry or get_registry()
        sid = str(next(_server_seq)) if server is None else str(server)
        self.server_id = sid
        lb = {"server": sid}
        self._lock = threading.Lock()
        self._slo_ms = slo_ms
        self.latency = reg.histogram(
            SERVING_REQUEST_LATENCY_MS,
            "end-to-end request latency").labels(**lb)
        self.queue_wait = reg.histogram(
            SERVING_QUEUE_WAIT_MS,
            "enqueue to batch assembly").labels(**lb)
        self.execute = reg.histogram(
            SERVING_BATCH_EXECUTE_MS,
            "per-batch device execute time").labels(**lb)
        req = reg.counter(SERVING_REQUESTS,
                          "requests by outcome")
        self._c_ok = req.labels(outcome="ok", **lb)
        self._c_failed = req.labels(outcome="failed", **lb)
        self._c_timeout = req.labels(outcome="timeout", **lb)
        self._c_rejected = req.labels(outcome="rejected", **lb)
        self._c_slo = reg.counter(
            SERVING_SLO_VIOLATIONS,
            "requests over the configured latency SLO").labels(**lb)
        self._c_batches = reg.counter(
            SERVING_BATCHES, "batches executed").labels(**lb)
        rows = reg.counter(SERVING_ROWS,
                           "batch rows by kind (real vs padded slot)")
        self._c_real_rows = rows.labels(kind="real", **lb)
        self._c_padded_rows = rows.labels(kind="padded", **lb)
        el = reg.counter(SERVING_ELEMENTS,
                         "tensor elements by kind (real vs padded)")
        self._c_real_el = el.labels(kind="real", **lb)
        self._c_padded_el = el.labels(kind="padded", **lb)
        self._g_depth = reg.gauge(
            SERVING_QUEUE_DEPTH, "requests waiting").labels(**lb)
        self._g_compiles = reg.gauge(
            SERVING_COMPILES, "backend compile-cache size").labels(**lb)
        self.compiles_at_warmup = None
        self._t_first = None
        self._t_last = None

    # -- mutators (called cross-thread) ------------------------------------
    def on_reject(self):
        self._c_rejected.inc()

    def on_timeout(self, latency_ms=None):
        """A request expired before (or while) being served.  Timed-out
        requests are the WORST latencies — they must land in the
        histogram and the SLO counter, or a server missing its SLO on
        every request would look healthy."""
        self._c_timeout.inc()
        if latency_ms is not None:
            self.latency.observe(latency_ms)
            if self._slo_ms is not None and latency_ms > self._slo_ms:
                self._c_slo.inc()

    def on_queue_depth(self, depth):
        self._g_depth.set(depth)

    def on_batch(self, real_rows, padded_rows, real_elements,
                 padded_elements, execute_ms):
        self._c_batches.inc()
        self._c_real_rows.inc(real_rows)
        self._c_padded_rows.inc(padded_rows)
        self._c_real_el.inc(real_elements)
        self._c_padded_el.inc(padded_elements)
        self.execute.observe(execute_ms)

    def on_request_done(self, ok, latency_ms, wait_ms):
        now = time.perf_counter()
        (self._c_ok if ok else self._c_failed).inc()
        self.latency.observe(latency_ms)
        self.queue_wait.observe(wait_ms)
        if self._slo_ms is not None and latency_ms > self._slo_ms:
            self._c_slo.inc()
        with self._lock:
            if self._t_first is None:
                self._t_first = now
            self._t_last = now

    def set_compiles(self, total):
        self._g_compiles.set(total)

    def mark_warmup_done(self, compile_count):
        # gauge FIRST: a snapshot racing this call must never read the
        # new compiles_at_warmup against the old gauge (which would
        # yield a negative compiles_after_warmup)
        self._g_compiles.set(compile_count)
        with self._lock:
            self.compiles_at_warmup = compile_count

    # -- export ------------------------------------------------------------
    def snapshot(self):
        # caw BEFORE the gauge (the mirror of mark_warmup_done's write
        # order): compiles_after_warmup can then only ever be >= 0
        with self._lock:
            caw = self.compiles_at_warmup
        # series values are float accumulators; these are integral by
        # construction and were ints in schema v1 — keep them ints
        ok = int(self._c_ok.value())
        failed = int(self._c_failed.value())
        batches = int(self._c_batches.value())
        real_rows = int(self._c_real_rows.value())
        padded_rows = int(self._c_padded_rows.value())
        real_el = int(self._c_real_el.value())
        padded_el = int(self._c_padded_el.value())
        compiles_total = int(self._g_compiles.value())
        with self._lock:
            span = ((self._t_last - self._t_first)
                    if (self._t_first is not None
                        and self._t_last > self._t_first) else None)
        n_done = ok + failed
        # copy histogram state from the series; SORT outside any lock
        # so a stats poll never stalls request completions
        lat = LatencyHistogram.summarize(self.latency.state())
        wait = LatencyHistogram.summarize(self.queue_wait.state())
        execute = LatencyHistogram.summarize(self.execute.state())
        snap = {
            "schema_version": SNAPSHOT_SCHEMA_VERSION,
            "server": self.server_id,
            "requests_ok": ok,
            "requests_failed": failed,
            "requests_timeout": int(self._c_timeout.value()),
            "requests_rejected": int(self._c_rejected.value()),
            "slo_ms": self._slo_ms,
            "slo_violations": int(self._c_slo.value()),
            "qps": (round(n_done / span, 2) if span else None),
            "batches": batches,
            "mean_batch_size": (round(real_rows / batches, 2)
                                if batches else None),
            "batch_occupancy": (round(real_rows / padded_rows, 4)
                                if padded_rows else None),
            "padding_waste": (round(1.0 - real_el / padded_el, 4)
                              if padded_el else None),
            "queue_depth": int(self._g_depth.value()),
            "compiles_total": compiles_total,
            "compiles_at_warmup": caw,
            "compiles_after_warmup": (compiles_total - caw
                                      if caw is not None else None),
            "latency": lat,
            "queue_wait": wait,
            "batch_execute": execute,
        }
        # unified *_total / *_ms aliases (schema v2) — same values, the
        # suffixed names dashboards should key on going forward
        snap.update({
            "requests_ok_total": snap["requests_ok"],
            "requests_failed_total": snap["requests_failed"],
            "requests_timeout_total": snap["requests_timeout"],
            "requests_rejected_total": snap["requests_rejected"],
            "slo_violations_total": snap["slo_violations"],
            "batches_total": snap["batches"],
            "latency_ms": lat,
            "queue_wait_ms": wait,
            "batch_execute_ms": execute,
        })
        return snap

    def dump_json(self, path):
        snap = self.snapshot()
        snap["latency_buckets_ms"] = self.latency.buckets()
        with open(path, "w") as f:
            json.dump(snap, f, indent=1)
        return path


class GenerationStats:
    """Counters/gauges for one `generation.GenerationEngine`: phase-split
    token throughput (prefill amortizes over many tokens per dispatch,
    decode pays one dispatch per token — they must not be averaged
    together), KV-cache page occupancy, and the same compile-cache
    accounting contract as ServingStats (`compiles_after_warmup == 0`
    is the steady-state-never-JITs invariant the bench gates on).

    Like ServingStats, storage is labeled registry series (label
    ``engine=<n>``); the engine itself is single-threaded but a serving
    front-end polls `snapshot()` from other threads."""

    def __init__(self, registry=None, engine=None):
        reg = registry or get_registry()
        eid = str(next(_engine_seq)) if engine is None else str(engine)
        self.engine_id = eid
        lb = {"engine": eid}
        self._lock = threading.Lock()
        tok = reg.counter(GENERATION_TOKENS,
                          "tokens processed, by phase")
        self._c_prefill_tok = tok.labels(phase="prefill", **lb)
        self._c_decode_tok = tok.labels(phase="decode", **lb)
        batches = reg.counter(GENERATION_DISPATCHES,
                              "device dispatches, by phase")
        self._c_prefill_batches = batches.labels(phase="prefill", **lb)
        self._c_decode_steps = batches.labels(phase="decode", **lb)
        secs = reg.counter(GENERATION_SECONDS,
                           "wall seconds in device dispatches, by phase")
        self._c_prefill_s = secs.labels(phase="prefill", **lb)
        self._c_decode_s = secs.labels(phase="decode", **lb)
        self._c_done = reg.counter(
            GENERATION_REQUESTS_DONE,
            "sequences finished").labels(**lb)
        self._c_chunks = reg.counter(
            GENERATION_PREFILL_CHUNKS,
            "prompt chunks fed through the unified step").labels(**lb)
        self._h_itl = reg.histogram(
            GENERATION_INTER_TOKEN_MS,
            "gap between consecutive emitted tokens of one "
            "sequence").labels(**lb)
        self._h_occ = reg.histogram(
            GENERATION_CACHE_OCCUPANCY,
            "KV page-pool occupancy per decode step",
            bounds=tuple(i / 20 for i in range(1, 21))).labels(**lb)
        self._g_compiles = reg.gauge(
            GENERATION_COMPILES,
            "engine jit-cache size").labels(**lb)
        from ..observability.monitor import (GENERATION_PREFIX_COW,
                                             GENERATION_PREFIX_HITS,
                                             GENERATION_PREFIX_LOOKUPS,
                                             GENERATION_PREFIX_PAGES_EVICTED,
                                             GENERATION_PREFIX_PAGES_REUSED,
                                             GENERATION_SPEC_ACCEPT_RATIO,
                                             GENERATION_SPEC_ACCEPTED,
                                             GENERATION_SPEC_DRAFTED)

        self._c_spec_drafted = reg.counter(
            GENERATION_SPEC_DRAFTED,
            "draft tokens proposed to verify windows").labels(**lb)
        self._c_spec_accepted = reg.counter(
            GENERATION_SPEC_ACCEPTED,
            "draft tokens accepted by the rejection rule").labels(**lb)
        self._g_spec_ratio = reg.gauge(
            GENERATION_SPEC_ACCEPT_RATIO,
            "cumulative accepted/drafted ratio").labels(**lb)
        self._c_prefix = {
            "lookups": reg.counter(
                GENERATION_PREFIX_LOOKUPS,
                "prompt admissions that consulted the prefix "
                "index").labels(**lb),
            "hits": reg.counter(
                GENERATION_PREFIX_HITS,
                "admissions that spliced >=1 cached page").labels(**lb),
            "pages_reused": reg.counter(
                GENERATION_PREFIX_PAGES_REUSED,
                "KV pages spliced by reference instead of "
                "prefilled").labels(**lb),
            "pages_evicted": reg.counter(
                GENERATION_PREFIX_PAGES_EVICTED,
                "retained prefix pages evicted under pool "
                "pressure").labels(**lb),
            "cow_copies": reg.counter(
                GENERATION_PREFIX_COW,
                "copy-on-write page copies on divergence").labels(**lb),
        }
        self._prefix_last = dict.fromkeys(self._c_prefix, 0)
        self._steps = 0
        self.compiles_at_warmup = None

    # -- mutators ----------------------------------------------------------
    def on_step(self):
        """One unified (chunked) step ran — the port's step count, which
        per-step launch gates divide by."""
        with self._lock:
            self._steps += 1

    def on_prefill(self, real_tokens, elapsed_s):
        self._c_prefill_tok.inc(int(real_tokens))
        self._c_prefill_batches.inc()
        self._c_prefill_s.inc(float(elapsed_s))

    def on_decode(self, active_seqs, elapsed_s, occupancy):
        self._c_decode_tok.inc(int(active_seqs))
        self._c_decode_steps.inc()
        self._c_decode_s.inc(float(elapsed_s))
        self._h_occ.observe(float(occupancy))

    def on_request_done(self):
        self._c_done.inc()

    def on_prefill_chunks(self, n=1):
        self._c_chunks.inc(int(n))

    def on_spec(self, drafted, accepted):
        """One speculative verify window: ``drafted`` tokens proposed,
        ``accepted`` of them matched the model's own samples.  The
        gauge tracks the cumulative ratio — the live signal for whether
        speculation is paying for its drafting work."""
        self._c_spec_drafted.inc(int(drafted))
        self._c_spec_accepted.inc(int(accepted))
        d = self._c_spec_drafted.value()
        if d > 0:
            self._g_spec_ratio.set(
                self._c_spec_accepted.value() / d)

    def update_prefix(self, counters):
        """Sync the paged cache's monotonic host-side prefix counters
        (``PagedKVCache.prefix_counters()``) into the registry series —
        the engine calls this once per step, so the cache itself stays
        registry-free and the delta bookkeeping lives here."""
        with self._lock:
            for name, series in self._c_prefix.items():
                delta = int(counters.get(name, 0)) - self._prefix_last[name]
                if delta > 0:
                    series.inc(delta)
                    self._prefix_last[name] += delta

    def on_inter_token(self, ms):
        """Gap (ms) between two consecutive tokens EMITTED for one
        sequence — the user-visible streaming latency the chunked
        scheduler exists to protect (a monolithic prefill stalling the
        batch shows up here as a p99 spike)."""
        self._h_itl.observe(float(ms))

    def set_compiles(self, total):
        self._g_compiles.set(total)

    def mark_warmup_done(self, compile_count):
        # same write/read ordering discipline as ServingStats: gauge
        # first, so a racing snapshot never sees a negative
        # compiles_after_warmup
        self._g_compiles.set(compile_count)
        with self._lock:
            self.compiles_at_warmup = compile_count

    # -- export ------------------------------------------------------------
    def ledger_counters(self):
        """Cumulative work counters the worker diffs around one op to
        fill the RPC reply's per-request ledger fields — five counter
        reads, no lock, cheap enough to run per dispatch."""
        return {
            "decode_tokens": int(self._c_decode_tok.value()),
            "spec_drafted": int(self._c_spec_drafted.value()),
            "spec_accepted": int(self._c_spec_accepted.value()),
            "prefill_chunks": int(self._c_chunks.value()),
            "prefix_pages_reused": int(
                self._c_prefix["pages_reused"].value()),
        }

    def snapshot(self):
        with self._lock:
            caw = self.compiles_at_warmup
            steps = self._steps
        prefill_tok = int(self._c_prefill_tok.value())
        prefill_batches = int(self._c_prefill_batches.value())
        prefill_s = self._c_prefill_s.value()
        decode_tok = int(self._c_decode_tok.value())
        decode_steps = int(self._c_decode_steps.value())
        decode_s = self._c_decode_s.value()
        occ_n, occ_sum, occ_max, _ = self._h_occ.state()
        compiles_total = int(self._g_compiles.value())
        itl = LatencyHistogram.summarize(self._h_itl.state())
        spec_drafted = int(self._c_spec_drafted.value())
        spec_accepted = int(self._c_spec_accepted.value())
        pfx = {name: int(series.value())
               for name, series in self._c_prefix.items()}
        snap = {
            "schema_version": SNAPSHOT_SCHEMA_VERSION,
            "engine": self.engine_id,
            "requests_done": int(self._c_done.value()),
            "steps": steps,
            "prefill_tokens": prefill_tok,
            "prefill_batches": prefill_batches,
            "prefill_tokens_per_sec": (
                round(prefill_tok / prefill_s, 2)
                if prefill_s > 0 else None),
            "decode_tokens": decode_tok,
            "decode_steps": decode_steps,
            "decode_tokens_per_sec": (
                round(decode_tok / decode_s, 2)
                if decode_s > 0 else None),
            "mean_decode_batch": (
                round(decode_tok / decode_steps, 2)
                if decode_steps else None),
            "cache_occupancy_mean": (
                round(occ_sum / occ_n, 4) if occ_n else None),
            "cache_occupancy_max": round(occ_max, 4),
            "prefill_chunks": int(self._c_chunks.value()),
            "spec_drafted": spec_drafted,
            "spec_accepted": spec_accepted,
            "spec_accept_ratio": (
                round(spec_accepted / spec_drafted, 4)
                if spec_drafted else None),
            "inter_token": itl,
            "prefix_lookups": pfx["lookups"],
            "prefix_hits": pfx["hits"],
            "prefix_hit_rate": (
                round(pfx["hits"] / pfx["lookups"], 4)
                if pfx["lookups"] else None),
            "prefix_pages_reused": pfx["pages_reused"],
            "prefix_pages_evicted": pfx["pages_evicted"],
            "prefix_cow_copies": pfx["cow_copies"],
            "compiles_total": compiles_total,
            "compiles_at_warmup": caw,
            "compiles_after_warmup": (
                compiles_total - caw if caw is not None else None),
        }
        # unified *_total aliases (schema v2)
        snap.update({
            "requests_done_total": snap["requests_done"],
            "steps_total": snap["steps"],
            "prefill_tokens_total": snap["prefill_tokens"],
            "prefill_batches_total": snap["prefill_batches"],
            "decode_tokens_total": snap["decode_tokens"],
            "decode_steps_total": snap["decode_steps"],
            "prefill_chunks_total": snap["prefill_chunks"],
            "spec_drafted_total": snap["spec_drafted"],
            "spec_accepted_total": snap["spec_accepted"],
            "prefix_lookups_total": snap["prefix_lookups"],
            "prefix_hit_total": snap["prefix_hits"],
            "prefix_pages_reused_total": snap["prefix_pages_reused"],
            "prefix_pages_evicted_total": snap["prefix_pages_evicted"],
            "prefix_cow_total": snap["prefix_cow_copies"],
            "inter_token_ms": itl,
        })
        return snap

    def dump_json(self, path):
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=1)
        return path
