"""TrainingMonitor — per-step training telemetry.

One object the training driver (``resilience.ResilientLoop``, or any
hand-rolled executor loop) calls at step boundaries.  Each step it:

* updates registry series (``train_steps_total``, ``train_step_ms``,
  ``train_examples_total``, ``train_loss``, ``train_nan_skips_total``,
  ``train_checkpoint_seconds_total``) so training shares the same
  scrape pipe as serving/generation;
* appends one JSON line to ``jsonl_path`` (when given) — the
  append-only step log a dashboard tails: wall time, examples/sec,
  loss, the executor's cumulative compile count and compile seconds
  (so a step that recompiled is visibly slow FOR THAT REASON),
  checkpoint-save seconds, and the resilience counters (NaN skips,
  retry attempts, kernel degradations).

Cost discipline: the step path does ONLY the registry series updates
(a handful of uncontended lock ops) and one deque append; record
assembly, counter sweeps, ``json.dumps`` and file I/O run on a
background writer thread.  Measured in situ, the synchronous part of
an emit right after a training step (cold caches, XLA runtime threads
still winding down) costs ~10x its microbenchmark time — which is why
the emit path is queue-and-go, and why the bench gates the whole
monitor at < 2% of an uninstrumented step.

The monitor never raises into the training loop: a full disk on the
telemetry file must not kill a healthy run — write failures disable
further writes and are surfaced in :meth:`summary`.  Call
:meth:`close` (or use the context manager) to drain the writer and
flush the file.

Counterpart of paddle_tpu/observability/monitor.py, copied (the metric
names and labels are the JAX package's).  The port's degradation
registry holds control-plane seams only (it never falls back from a
kernel), so ``kernel_degradations_total`` in each record counts the
fleet's and the tuning plane's permanent decisions.
"""
from __future__ import annotations

import collections
import json
import math
import threading
import time

from .registry import get_registry

__all__ = ["TrainingMonitor"]

# executor-side series names (core/executor.py increments these; the
# monitor and dashboards read them — one definition, two sites)
EXECUTOR_COMPILES = "executor_compiles_total"
EXECUTOR_COMPILE_SECONDS = "executor_compile_seconds_total"
# per-device vs global optimizer accumulator footprint (set by the
# executor at lowering time; ZeRO-1 Reduce mode shows per_device ~
# global/dp — read by tools/mem_report.py and the bench gate)
OPTIMIZER_STATE_BYTES = "optimizer_state_bytes"
# GEMM-epilogue chains lowered onto fused groups, labelled by pattern
# (core/fusion.py increments at plan time; bench and tests read it)
FUSED_EPILOGUE_HITS = "fused_epilogue_hits_total"
# block-level epilogue programs lowered, labelled by pattern family:
# attention_epilogue | ffn_chain | residual_norm_boundary
# (core/fusion.py increments at plan time when block patterns are on;
# the fused_epilogue_ablation bench gate requires every family > 0)
FUSED_BLOCK_HITS = "fused_block_hits_total"
# speculative-decoding acceptance accounting, labelled by engine
# (serving/stats.py GenerationStats increments per verify window; the
# ratio gauge is drafted-vs-accepted cumulative — read by bench's
# speculative_decode gate and dashboards)
GENERATION_SPEC_DRAFTED = "generation_spec_drafted_total"
GENERATION_SPEC_ACCEPTED = "generation_spec_accepted_total"
GENERATION_SPEC_ACCEPT_RATIO = "generation_spec_accept_ratio"
# prefix-cache accounting, labelled by engine (serving/stats.py
# GenerationStats syncs these from the paged cache's host counters;
# read by bench's prefix_cache_serving gate, tools/kv_report.py and
# the cluster streaming tests — a decode worker's hit counter is the
# fleet-wide-reuse signal)
GENERATION_PREFIX_LOOKUPS = "generation_prefix_lookups_total"
GENERATION_PREFIX_HITS = "generation_prefix_hit_total"
GENERATION_PREFIX_PAGES_REUSED = "generation_prefix_pages_reused_total"
GENERATION_PREFIX_PAGES_EVICTED = "generation_prefix_pages_evicted_total"
GENERATION_PREFIX_COW = "generation_prefix_cow_total"
# fleet tier (cluster/stats.py ClusterStats writes these; the
# autoscaler policy loop, tools/fleet_report.py and the
# cluster_autoscale bench gate read them):
#   fleet_worker_state{router,model,worker,state} — 1 for the worker's
#     current lifecycle state (warming|warm|draining), 0 otherwise;
#     all-zero rows mean the worker is retired/dead
#   fleet_requests_total{router,model,outcome} — per-model completions
#   fleet_model_qps{router,model} — completions/sec over the model's
#     observed serving span
#   fleet_scale_events_total{router,model,direction,reason} — autoscaler
#     actions
#   fleet_rollouts_total{router,model,outcome} — rolling weight swaps
#   fleet_respawns_total{router,model,outcome} — supervisor respawns
#     after worker deaths (ok|failed|gave_up|refused); gave_up means a
#     crash loop exhausted its backoff budget and the model's
#     fleet.supervisor seam was degraded permanently
FLEET_WORKER_STATE = "fleet_worker_state"
FLEET_REQUESTS = "fleet_requests_total"
FLEET_MODEL_QPS = "fleet_model_qps"
FLEET_SCALE_EVENTS = "fleet_scale_events_total"
FLEET_ROLLOUTS = "fleet_rollouts_total"
FLEET_RESPAWNS = "fleet_respawns_total"
# cluster control-plane series (cluster/stats.py ClusterStats writes
# these; the router admission path, tools/fleet_report.py and the
# cluster benches read them).  Declared here so tools/metric_lint.py
# can hold every reader and writer to ONE spelling.
CLUSTER_QUEUE_DEPTH = "cluster_queue_depth"
CLUSTER_WORKERS_ALIVE = "cluster_workers_alive"
CLUSTER_SHED = "cluster_shed_total"
CLUSTER_REQUESTS = "cluster_requests_total"
CLUSTER_REROUTES = "cluster_reroutes_total"
CLUSTER_STREAM_CHUNKS = "cluster_stream_chunks_total"
CLUSTER_STREAM_FALLBACKS = "cluster_stream_fallbacks_total"
CLUSTER_REQUEST_LATENCY_MS = "cluster_request_latency_ms"
# self-healing serving tier:
#   cluster_hedges_total{router,outcome} — tail-latency hedges by how
#     the duplicate ended: won (finished first), lost (the primary
#     beat it), cancelled (dropped before computing anything)
#   cluster_deadline_expired_total{site} — work rejected because its
#     deadline budget was already spent, by WHERE the budget died:
#     router (expired while queued at the router), worker_queue
#     (expired in flight / in the worker's admission queue),
#     worker_exec (expired waiting for the worker's engine lock).
#     Worker-side increments carry no router label — they land on the
#     worker process's own registry and travel via the telemetry plane.
CLUSTER_HEDGES = "cluster_hedges_total"
CLUSTER_DEADLINE_EXPIRED = "cluster_deadline_expired_total"
# serving tier (serving/stats.py ServingStats)
SERVING_REQUEST_LATENCY_MS = "serving_request_latency_ms"
SERVING_QUEUE_WAIT_MS = "serving_queue_wait_ms"
SERVING_BATCH_EXECUTE_MS = "serving_batch_execute_ms"
SERVING_REQUESTS = "serving_requests_total"
SERVING_SLO_VIOLATIONS = "serving_slo_violations_total"
SERVING_BATCHES = "serving_batches_total"
SERVING_ROWS = "serving_rows_total"
SERVING_ELEMENTS = "serving_elements_total"
SERVING_QUEUE_DEPTH = "serving_queue_depth"
SERVING_COMPILES = "serving_compiles"
# generation tier (serving/stats.py GenerationStats)
GENERATION_TOKENS = "generation_tokens_total"
GENERATION_DISPATCHES = "generation_dispatches_total"
GENERATION_SECONDS = "generation_seconds_total"
GENERATION_REQUESTS_DONE = "generation_requests_done_total"
GENERATION_PREFILL_CHUNKS = "generation_prefill_chunks_total"
GENERATION_INTER_TOKEN_MS = "generation_inter_token_ms"
GENERATION_CACHE_OCCUPANCY = "generation_cache_occupancy"
GENERATION_COMPILES = "generation_compiles"
# fleet telemetry plane (observability/scrape.py TelemetryScraper):
#   telemetry_scrapes_total{outcome} — scrape attempts (ok|error)
#   telemetry_scrape_ms — wall time of one full-fleet scrape pass
#   telemetry_worker_up{worker,role} — 1 while the last scrape of that
#     worker succeeded, 0 once it stopped answering (its cached rows
#     are then served marked stale)
TELEMETRY_SCRAPES = "telemetry_scrapes_total"
TELEMETRY_SCRAPE_MS = "telemetry_scrape_ms"
TELEMETRY_WORKER_UP = "telemetry_worker_up"
# flight recorder (observability/flightrec.py):
#   flight_triggers_total{reason} — trigger firings (worker_death,
#     degrade, nan_skip, slo_shed, ...)
#   flight_bundles_total — incident bundles assembled on disk
FLIGHT_TRIGGERS = "flight_triggers_total"
FLIGHT_BUNDLES = "flight_bundles_total"
# tuning plane (tuning/observe.py, tuning/store.py):
#   autotune_cache_hits_total{kernel,source} — every block-size
#     resolution on a guarded kernel, by where the config came from
#     (env / cache / heuristic); the fleet-rollup of this series is
#     what the autotune daemon harvests
#   autotune_geometry_observed_total{kernel,geometry,dtype,source,
#     config} — live geometries seen by each kernel, with the config
#     that served them (the daemon's search work-list)
#   autotune_configs_pushed_total{kernel} — distributed configs
#     admitted into a worker's TuningStore via tuning_push
#   autotune_configs_rejected_total{kernel,reason} — configs the
#     store refused (unattested / stale / malformed / degraded)
AUTOTUNE_CACHE_HITS = "autotune_cache_hits_total"
AUTOTUNE_GEOMETRY_OBSERVED = "autotune_geometry_observed_total"
AUTOTUNE_CONFIGS_PUSHED = "autotune_configs_pushed_total"
AUTOTUNE_CONFIGS_REJECTED = "autotune_configs_rejected_total"
# request ledger (observability/ledger.py):
#   ledger_records_total{router} — per-request records closed into the
#     ring (one per completed/failed request — the bench asserts count
#     parity against cluster_requests_total)
#   ledger_evicted_total{router} — records the bounded ring overwrote
#     before any tail() read them (sizing signal, not an error)
LEDGER_RECORDS = "ledger_records_total"
LEDGER_EVICTED = "ledger_evicted_total"
# SLO burn-rate engine (observability/slo.py):
#   slo_burn_rate{objective,window} — last evaluated burn rate (budget
#     consumption speed: 1.0 = exactly on budget) per window
#   slo_pages_total{objective} — page-level firings (fast windows both
#     over threshold); each firing also rings the flight-recorder
#     trigger bus, so bundles and pages cannot disagree
#   slo_evaluations_total — evaluation passes run
SLO_BURN_RATE = "slo_burn_rate"
SLO_PAGES = "slo_pages_total"
SLO_EVALUATIONS = "slo_evaluations_total"

# -- request-ledger record schema -------------------------------------------
# THE field spelling for ledger records, declared once (same discipline
# as the metric-name constants above): observability/ledger.py builds
# records with exactly these keys, and tools/metric_lint.py holds every
# ledger-consuming tool under tools/ to this set — a dashboard indexing
# rec["tenants"] (typo) fails the lint instead of reading silent Nones.
LEDGER_FIELDS = (
    "uid",                  # router request uid (ledger primary key)
    "trace_id",             # trace context — joins exemplars and spans
    "tenant",
    "model",
    "worker",               # rank that served the terminal attempt
    "priority",
    "outcome",              # ok | error | shed | timeout | cancelled
    "reroutes",             # attempts beyond the first dispatch
    "hedged",               # 1 if a hedge clone was launched
    "hedge_outcome",        # won | lost | "" (no hedge)
    "t_admit",              # monotonic stamps, seconds
    "t_dispatch",
    "t_first_token",
    "t_done",
    "queue_wait_ms",        # admit -> dispatch
    "service_ms",           # dispatch -> done
    "latency_ms",           # submit -> done (matches cluster stats)
    "deadline_budget_ms",   # budget at admission (0 = no deadline)
    "deadline_consumed_ms",  # budget spent by completion
    "prefix_tokens",        # cached-prefix tokens spliced at prefill
    "prefill_chunks",
    "spec_drafted",         # speculative tokens drafted / accepted
    "spec_accepted",
    "decode_tokens",        # tokens emitted (goodput numerator)
)

# rollup() output schema (per-tenant / per-model aggregation keys) —
# declared here for the same lint reason as LEDGER_FIELDS
LEDGER_ROLLUP_FIELDS = (
    "requests",
    "ok",
    "failed",
    "decode_tokens",
    "goodput_tokens_per_s",  # emitted tokens / span of ledger records
    "service_ms_total",      # TPU-time attribution (sum of service_ms)
    "service_share",         # tenant's share of fleet service_ms
    "hedge_share",           # share of requests that launched a hedge
    "reroute_share",         # share of requests that rerouted
    "span_s",                # wall span the rollup covers
)


class TrainingMonitor:
    """Collects and emits per-step training telemetry.

    Parameters
    ----------
    jsonl_path : append JSON-lines here (None = registry series only).
    registry : a MetricsRegistry for the monitor's own ``train_*``
        series (default: the process registry).  The cross-subsystem
        counters in each record (executor compiles, retries,
        degradations) ALWAYS come from the process registry — that is
        where their producers write.
    run : label value distinguishing concurrent runs in one process.
    flush_every : flush the JSONL file every N records (the writer
        thread also flushes on close; 1 = line buffered).
    """

    def __init__(self, jsonl_path=None, registry=None, run="0",
                 flush_every=20):
        reg = registry or get_registry()
        self._labels = lb = {"run": str(run)}
        self._steps = reg.counter(
            "train_steps_total", "completed training steps").labels(**lb)
        self._step_ms = reg.histogram(
            "train_step_ms", "per-step wall time (ms)").labels(**lb)
        self._examples = reg.counter(
            "train_examples_total", "examples consumed").labels(**lb)
        self._loss = reg.gauge(
            "train_loss", "last finite per-step mean loss").labels(**lb)
        self._nan_skips = reg.counter(
            "train_nan_skips_total",
            "steps skipped by the non-finite loss guard").labels(**lb)
        self._ckpt_n = reg.counter(
            "train_checkpoints_total", "checkpoint saves").labels(**lb)
        self._ckpt_s = reg.counter(
            "train_checkpoint_seconds_total",
            "seconds spent in checkpoint save calls").labels(**lb)
        self._lock = threading.Lock()
        self._path = jsonl_path
        self._flush_every = max(1, int(flush_every))
        self._write_error = None
        self._pending_ckpt_s = 0.0
        self.records_written = 0
        # background writer: the hot path only appends to this deque
        # (GIL-atomic) and the writer owns the file.  maxlen bounds
        # memory if the writer ever stalls or dies (oldest records
        # drop — telemetry must never OOM a training job either)
        self._queue: collections.deque = collections.deque(maxlen=65536)
        self._wake = threading.Event()
        self._stop = False
        self._writer = None
        if jsonl_path is not None:
            self._writer = threading.Thread(
                target=self._writer_loop, daemon=True,
                name=f"ptl-train-monitor-{run}")
            self._writer.start()

    # -- wiring points (training-loop thread) ------------------------------
    @staticmethod
    def _off():
        # the package-level kill switch (observability.set_enabled):
        # checked at the wiring points so disabling really silences
        # the monitor — series updates, queueing and file output alike
        from paddle_tpu_torch import observability

        return not observability.enabled()

    def on_checkpoint(self, step, seconds):
        """A checkpoint save call completed (sync) or was enqueued
        (async) — ``seconds`` is the time the save call occupied the
        step path, which is what step-time telemetry attributes."""
        if self._off():
            return
        self._ckpt_n.inc()
        self._ckpt_s.inc(seconds)
        with self._lock:
            self._pending_ckpt_s += seconds

    def on_nan_skip(self, step):
        if self._off():
            return
        self._nan_skips.inc()
        self._enqueue(step, None, None, 0, True)

    def on_step(self, step, loss=None, wall_s=None, examples=None):
        """A step completed with a finite loss (or no loss fetch)."""
        if self._off():
            return
        self._steps.inc()
        if wall_s is not None:
            self._step_ms.observe(wall_s * 1e3)
        if examples:
            self._examples.inc(examples)
        if loss is not None and math.isfinite(float(loss)):
            # the gauge holds the last FINITE loss (its help text's
            # contract); a NaN here would also poison every JSON
            # snapshot of the registry with an invalid bare-NaN token
            self._loss.set(loss)
        self._enqueue(step, loss, wall_s, examples, False)

    def _enqueue(self, step, loss, wall_s, examples, skipped):
        # a dead writer (write error) must not leave records piling up
        # for the rest of a multi-million-step run
        if self._writer is None or self._write_error is not None:
            return
        with self._lock:
            ckpt_s = self._pending_ckpt_s
            self._pending_ckpt_s = 0.0
        # no wake signal: the writer polls on a short timeout, so the
        # step path pays ONLY this (GIL-atomic) append — waking the
        # writer per step would put its GIL slice right inside the
        # next training step
        self._queue.append((time.time(), step, loss, wall_s, examples,
                            skipped, ckpt_s))

    # -- writer thread -----------------------------------------------------
    @staticmethod
    def _cross_subsystem_counters():
        """Cumulative process-wide counters for the record: compiles
        (executor), retries and degradations (resilience).  Resolved
        per record on the WRITER thread — off the step path, and the
        producers re-resolve too, so the values stay live across a
        test-only registry.reset().  Always the PROCESS registry: that
        is where the producers write, regardless of the monitor's own
        ``registry=``."""
        reg = get_registry()
        compiles = reg.counter(EXECUTOR_COMPILES,
                               "executor program lowerings")
        compile_s = reg.counter(EXECUTOR_COMPILE_SECONDS,
                                "seconds spent lowering programs")
        retries = reg.counter("retry_attempts_total",
                              "backoff retries of transient failures")
        degrades = reg.counter(
            "kernel_degradations_total",
            "fast paths permanently degraded to reference")
        return {
            "compiles_total": int(compiles.value()),
            "compile_seconds_total": round(compile_s.value(), 4),
            "retry_attempts_total": int(sum(
                s.value() for _, s in retries.series())),
            "kernel_degradations_total": int(sum(
                s.value() for _, s in degrades.series())),
        }

    def _record(self, item):
        ts, step, loss, wall_s, examples, skipped, ckpt_s = item
        if loss is not None and not math.isfinite(float(loss)):
            # bare NaN/Infinity is not valid JSON — a strict tailer
            # (jq, JSON.parse) would choke on the whole line
            loss = None
        rec = {
            "ts": round(ts, 3),
            # step None = the trailing checkpoint-flush record close()
            # emits when a final save had no following step
            "step": (int(step) if step is not None else None),
            "loss": (round(float(loss), 6) if loss is not None else None),
            "step_ms": (round(wall_s * 1e3, 3)
                        if wall_s is not None else None),
            # int() strips numpy scalar types (a np.int64 would make
            # json.dumps raise on the writer thread)
            "examples": (int(examples) if examples is not None else None),
            "examples_per_sec": (
                round(examples / wall_s, 2)
                if (examples and wall_s and wall_s > 0) else None),
            "skipped_non_finite": skipped,
            "checkpoint_save_seconds": round(ckpt_s, 4),
            "nan_skips_total": int(self._nan_skips.value()),
        }
        # cumulative counters read at WRITE time: they may run a few
        # steps ahead of the step they are printed next to, never
        # behind (standard async-telemetry semantics)
        rec.update(self._cross_subsystem_counters())
        return rec

    def _writer_loop(self):
        f = None
        try:
            while True:
                self._wake.wait(timeout=0.1)   # poll; set only on close
                while self._queue:
                    rec = self._record(self._queue.popleft())
                    if f is None:
                        f = open(self._path, "a")
                    f.write(json.dumps(rec) + "\n")
                    self.records_written += 1
                    if self.records_written % self._flush_every == 0:
                        f.flush()
                if self._stop and not self._queue:
                    return
        except Exception as e:  # noqa: BLE001 — writer must fail CLOSED
            # telemetry must never kill training, and a dead writer
            # must never be silent: any failure (disk full, an
            # unserializable value reaching json.dumps) disables
            # further writes and surfaces in summary()
            self._write_error = e
        finally:
            if f is not None:
                try:
                    f.close()
                except OSError:
                    pass

    # -- lifecycle ---------------------------------------------------------
    def summary(self):
        return {
            "jsonl_path": self._path,
            "records_written": self.records_written,
            "write_error": (repr(self._write_error)
                            if self._write_error else None),
            "steps_total": self._steps.value(),
            "nan_skips_total": self._nan_skips.value(),
        }

    def close(self, timeout=5.0):
        """Drain the writer queue and close the file (safe to call
        twice; records enqueued after close are dropped).  Checkpoint
        seconds still pending (a final save with no following step)
        flush as one trailing record with ``step: null``."""
        with self._lock:
            has_pending = self._pending_ckpt_s > 0
        if has_pending:
            self._enqueue(None, None, None, None, False)
        self._stop = True
        self._wake.set()
        if self._writer is not None:
            self._writer.join(timeout=timeout)
            self._writer = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
