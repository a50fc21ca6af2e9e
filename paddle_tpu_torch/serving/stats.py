"""Serving and generation statistics: latency histograms, throughput,
queue depth, batch occupancy, padding waste and compile accounting.

Counterpart of paddle_tpu/serving/stats.py.  The snapshot keys the
server and the generation engine fill keep their names and meaning;
storage is plain counters under one lock per stats object (the
process-wide metric registry belongs to the observability slice).

``compiles_after_warmup`` counts kernel builds or library loads after
warmup: 0 means steady state never compiled.
"""
from __future__ import annotations

import bisect
import json
import threading
import time

__all__ = ["LatencyHistogram", "ServingStats", "GenerationStats",
           "SNAPSHOT_SCHEMA_VERSION", "nearest_rank"]

SNAPSHOT_SCHEMA_VERSION = 2

#: 0.1ms .. ~105s in x2 steps
DEFAULT_MS_BOUNDS = tuple(0.1 * 2 ** i for i in range(21))


def nearest_rank(sorted_samples, p):
    """Nearest-rank percentile over an already-sorted sample list."""
    n = len(sorted_samples)
    return sorted_samples[min(n - 1, max(0, int(round(
        (p / 100.0) * (n - 1)))))]


class LatencyHistogram:
    """Fixed log-spaced buckets (for export) + a bounded reservoir of raw
    samples (for p50/p95/p99 without holding every request of a
    long-lived server).  The reservoir overwrites round-robin once full.
    Thread-safe."""

    BOUNDS = DEFAULT_MS_BOUNDS  # ms

    def __init__(self, max_samples=65536, bounds=None):
        self._lock = threading.Lock()
        self._bounds = tuple(bounds) if bounds is not None else self.BOUNDS
        self._counts = [0] * (len(self._bounds) + 1)
        self._samples = []
        self._max_samples = max_samples
        self._n = 0
        self._sum = 0.0
        self._max = 0.0

    def observe(self, ms):
        ms = float(ms)
        with self._lock:
            self._counts[bisect.bisect_left(self._bounds, ms)] += 1
            self._n += 1
            self._sum += ms
            self._max = max(self._max, ms)
            if len(self._samples) < self._max_samples:
                self._samples.append(ms)
            else:
                self._samples[self._n % self._max_samples] = ms

    def state(self):
        """(n, sum, max, samples-copy), copied under the lock so the
        percentile sort runs outside it."""
        with self._lock:
            return (self._n, self._sum, self._max, list(self._samples))

    def percentile(self, p):
        _, _, _, samples = self.state()
        return nearest_rank(sorted(samples), p) if samples else None

    @staticmethod
    def summarize(state):
        n, total, mx, samples = state
        if n == 0:
            return {"count": 0}
        s = sorted(samples)
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
        with self._lock:
            counts = list(self._counts)
        bounds = self._bounds + (float("inf"),)
        return [(b, c) for b, c in zip(bounds, counts) if c]


class _Counters:
    """Named float counters and gauges under one lock."""

    def __init__(self, *names):
        self._lock = threading.Lock()
        self._v = dict.fromkeys(names, 0.0)

    def inc(self, name, amount=1):
        with self._lock:
            self._v[name] += float(amount)

    def set(self, name, value):
        with self._lock:
            self._v[name] = float(value)

    def values(self):
        with self._lock:
            return dict(self._v)


class ServingStats:
    """All counters/gauges for one `InferenceServer`, exported as one
    JSON-able dict.  `slo_ms` adds an SLO violation counter over
    end-to-end latency."""

    def __init__(self, slo_ms=None):
        self._slo_ms = slo_ms
        self.latency = LatencyHistogram()
        self.queue_wait = LatencyHistogram()
        self.execute = LatencyHistogram()
        self._c = _Counters(
            "ok", "failed", "timeout", "rejected", "slo", "batches",
            "real_rows", "padded_rows", "real_el", "padded_el", "depth",
            "compiles")
        self._lock = threading.Lock()
        self.compiles_at_warmup = None
        self._t_first = None
        self._t_last = None

    # -- mutators (called cross-thread) ------------------------------------
    def on_reject(self):
        self._c.inc("rejected")

    def on_timeout(self, latency_ms=None):
        """Timed-out requests are the WORST latencies: they land in the
        histogram and the SLO counter."""
        self._c.inc("timeout")
        if latency_ms is not None:
            self.latency.observe(latency_ms)
            if self._slo_ms is not None and latency_ms > self._slo_ms:
                self._c.inc("slo")

    def on_queue_depth(self, depth):
        self._c.set("depth", depth)

    def on_batch(self, real_rows, padded_rows, real_elements,
                 padded_elements, execute_ms):
        self._c.inc("batches")
        self._c.inc("real_rows", real_rows)
        self._c.inc("padded_rows", padded_rows)
        self._c.inc("real_el", real_elements)
        self._c.inc("padded_el", padded_elements)
        self.execute.observe(execute_ms)

    def on_request_done(self, ok, latency_ms, wait_ms):
        now = time.perf_counter()
        self._c.inc("ok" if ok else "failed")
        self.latency.observe(latency_ms)
        self.queue_wait.observe(wait_ms)
        if self._slo_ms is not None and latency_ms > self._slo_ms:
            self._c.inc("slo")
        with self._lock:
            if self._t_first is None:
                self._t_first = now
            self._t_last = now

    def set_compiles(self, total):
        self._c.set("compiles", total)

    def mark_warmup_done(self, compile_count):
        # gauge FIRST: a racing snapshot never reads the new
        # compiles_at_warmup against the old gauge
        self._c.set("compiles", compile_count)
        with self._lock:
            self.compiles_at_warmup = compile_count

    # -- export ------------------------------------------------------------
    def snapshot(self):
        with self._lock:
            caw = self.compiles_at_warmup
            span = ((self._t_last - self._t_first)
                    if (self._t_first is not None
                        and self._t_last > self._t_first) else None)
        c = {k: int(v) for k, v in self._c.values().items()}
        n_done = c["ok"] + c["failed"]
        lat = self.latency.summary()
        wait = self.queue_wait.summary()
        execute = self.execute.summary()
        snap = {
            "schema_version": SNAPSHOT_SCHEMA_VERSION,
            "requests_ok": c["ok"],
            "requests_failed": c["failed"],
            "requests_timeout": c["timeout"],
            "requests_rejected": c["rejected"],
            "slo_ms": self._slo_ms,
            "slo_violations": c["slo"],
            "qps": (round(n_done / span, 2) if span else None),
            "batches": c["batches"],
            "mean_batch_size": (round(c["real_rows"] / c["batches"], 2)
                                if c["batches"] else None),
            "batch_occupancy": (round(c["real_rows"] / c["padded_rows"], 4)
                                if c["padded_rows"] else None),
            "padding_waste": (round(1.0 - c["real_el"] / c["padded_el"], 4)
                              if c["padded_el"] else None),
            "queue_depth": c["depth"],
            "compiles_total": c["compiles"],
            "compiles_at_warmup": caw,
            "compiles_after_warmup": (c["compiles"] - caw
                                      if caw is not None else None),
            "latency": lat,
            "queue_wait": wait,
            "batch_execute": execute,
        }
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


#: the paged cache's prefix counters, as ``prefix_counters()`` names them
_PREFIX_COUNTERS = ("lookups", "hits", "pages_reused", "pages_evicted",
                    "cow_copies")


class GenerationStats:
    """Counters for one generation engine: phase-split token throughput
    (prefill and decode must not be averaged together), unified steps,
    KV page occupancy, inter-token latency, speculative acceptance, the
    prefix cache's reuse and the compile accounting
    (`compiles_after_warmup == 0` is the steady-state contract)."""

    def __init__(self):
        self._c = _Counters(
            "prefill_tok", "prefill_batches", "prefill_s", "decode_tok",
            "decode_steps", "decode_s", "done", "chunks", "steps",
            "spec_drafted", "spec_accepted", "compiles",
            *(f"prefix_{n}" for n in _PREFIX_COUNTERS))
        self._itl = LatencyHistogram()
        self._occ = LatencyHistogram(
            bounds=tuple(i / 20 for i in range(1, 21)))
        self._lock = threading.Lock()
        self.compiles_at_warmup = None

    # -- mutators ----------------------------------------------------------
    def on_step(self):
        self._c.inc("steps")

    def on_prefill(self, real_tokens, elapsed_s):
        self._c.inc("prefill_tok", int(real_tokens))
        self._c.inc("prefill_batches")
        self._c.inc("prefill_s", elapsed_s)

    def on_decode(self, active_seqs, elapsed_s, occupancy):
        self._c.inc("decode_tok", int(active_seqs))
        self._c.inc("decode_steps")
        self._c.inc("decode_s", elapsed_s)
        self._occ.observe(occupancy)

    def on_request_done(self):
        self._c.inc("done")

    def on_prefill_chunks(self, n=1):
        self._c.inc("chunks", int(n))

    def on_inter_token(self, ms):
        """Gap (ms) between two consecutive tokens EMITTED for one
        sequence — the streaming latency chunked scheduling protects."""
        self._itl.observe(ms)

    def on_spec(self, drafted, accepted):
        """One speculative verify window: ``drafted`` tokens proposed,
        ``accepted`` of them matched the model's own samples."""
        self._c.inc("spec_drafted", int(drafted))
        self._c.inc("spec_accepted", int(accepted))

    def update_prefix(self, counters):
        """Take the paged cache's monotonic prefix counters
        (``PagedKVCache.prefix_counters()``); the engine calls this once
        per step."""
        for name in _PREFIX_COUNTERS:
            self._c.set(f"prefix_{name}", counters.get(name, 0))

    def set_compiles(self, total):
        self._c.set("compiles", total)

    def mark_warmup_done(self, compile_count):
        self._c.set("compiles", compile_count)
        with self._lock:
            self.compiles_at_warmup = compile_count

    # -- export ------------------------------------------------------------
    def snapshot(self):
        with self._lock:
            caw = self.compiles_at_warmup
        c = self._c.values()
        prefill_tok, decode_tok = int(c["prefill_tok"]), int(c["decode_tok"])
        decode_steps = int(c["decode_steps"])
        occ_n, occ_sum, occ_max, _ = self._occ.state()
        compiles_total = int(c["compiles"])
        itl = self._itl.summary()
        spec_drafted = int(c["spec_drafted"])
        spec_accepted = int(c["spec_accepted"])
        pfx = {n: int(c[f"prefix_{n}"]) for n in _PREFIX_COUNTERS}
        snap = {
            "schema_version": SNAPSHOT_SCHEMA_VERSION,
            "requests_done": int(c["done"]),
            "steps": int(c["steps"]),
            "prefill_tokens": prefill_tok,
            "prefill_batches": int(c["prefill_batches"]),
            "prefill_tokens_per_sec": (
                round(prefill_tok / c["prefill_s"], 2)
                if c["prefill_s"] > 0 else None),
            "decode_tokens": decode_tok,
            "decode_steps": decode_steps,
            "decode_tokens_per_sec": (
                round(decode_tok / c["decode_s"], 2)
                if c["decode_s"] > 0 else None),
            "mean_decode_batch": (
                round(decode_tok / decode_steps, 2)
                if decode_steps else None),
            "cache_occupancy_mean": (
                round(occ_sum / occ_n, 4) if occ_n else None),
            "cache_occupancy_max": round(occ_max, 4),
            "prefill_chunks": int(c["chunks"]),
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
