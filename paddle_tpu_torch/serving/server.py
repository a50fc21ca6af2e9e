"""InferenceServer — dynamic-batching serving front-end.

Counterpart of paddle_tpu/serving/server.py.  Concurrent `infer()` calls
from many client threads coalesce into padded batches drawn from the
configured shape buckets, executed on ONE worker thread (the device
executes serially anyway).

Backends: any object with ``run(feeds) -> [outputs]`` and
``compile_count()`` (e.g. ``generation.GenerationBackend``), or any
``feeds -> [outputs]`` callable (wrapped in `CallableBackend`).  The
in-process ``Predictor`` backend comes with the inference slice.

Tracing, as in the JAX server: ``submit`` captures the client thread's
span context; the batcher worker records each request's
``serving:queue_wait`` in that request's trace and runs the batch under
the first traced request's context in a ``serving:batch_b{B}`` span, so
the engine's step spans nest under it.

Lifecycle::

    server = InferenceServer(backend, ServingConfig(...))
    server.start()           # spawns the batcher worker
    server.warmup()          # runs every bucket shape once
    outs = server.infer({"x": arr})      # thread-safe, blocking
    fut = server.submit({"x": arr})      # or async: fut.result()
    print(server.stats()["latency"])     # p50/p95/p99, QPS, occupancy
    server.close(drain=True)             # finish queued work, then stop
"""
from __future__ import annotations

import threading
import time

import numpy as np

from .. import profiler as _prof
from ..observability import tracing as _tracing
from .batcher import (BadRequestError, InferenceFuture, RequestQueue,
                      RequestTimeoutError, ServerClosedError)
from .buckets import BucketError, ShapeBucketer
from .config import ServingConfig
from .stats import ServingStats

__all__ = ["InferenceServer", "CallableBackend", "input_signature"]


def input_signature(feeds):
    """Distinct-input-signature key for compile accounting: each feed
    keys on (name, shape, dtype) of its numpy array."""
    return tuple((name, np.shape(feeds[name]), str(np.asarray(
        feeds[name]).dtype)) for name in sorted(feeds))


class CallableBackend:
    """Serve through any ``feeds -> [outputs]`` callable.  Compiles are
    not observable inside an opaque callable, so the counter is the
    number of DISTINCT input signatures executed."""

    def __init__(self, fn, input_names=None, input_spec=None):
        self._fn = fn
        self.input_names = list(input_names) if input_names else None
        self._spec = dict(input_spec) if input_spec else None
        self._sigs = set()

    def input_spec(self):
        return self._spec

    def run(self, feeds):
        self._sigs.add(input_signature(feeds))
        out = self._fn(feeds)
        return list(out) if isinstance(out, (list, tuple)) else [out]

    def compile_count(self):
        return len(self._sigs)


def _as_backend(backend):
    if hasattr(backend, "run") and hasattr(backend, "compile_count"):
        return backend
    if callable(backend):
        return CallableBackend(backend)
    raise TypeError(
        f"backend must be a feeds->outputs callable or a Backend object; "
        f"got {type(backend).__name__}")


class InferenceServer:
    def __init__(self, backend, config=None):
        self._backend = _as_backend(backend)
        self._cfg = config or ServingConfig()
        self._bucketer = ShapeBucketer(self._cfg)
        self._stats = ServingStats(slo_ms=self._cfg.slo_ms)
        self._queue = RequestQueue(self._cfg.max_queue_size, self._stats)
        self._worker = None
        self._closed = False
        self._lock = threading.Lock()
        # serializes backend execution between the batcher worker and
        # warmup(): two threads must never be inside a backend at once
        self._exec_lock = threading.Lock()

    @property
    def backend(self):
        return self._backend

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        with self._lock:
            if self._closed:
                raise ServerClosedError("server already closed")
            if self._worker is None:
                self._worker = threading.Thread(
                    target=self._worker_loop, name="ptt-serving-batcher",
                    daemon=True)
                self._worker.start()
        return self

    def warmup(self, example_feeds=None):
        """Execute every (batch bucket x seq bucket) shape once, BEFORE
        traffic.  Shapes come from the backend's input spec; pass
        ``example_feeds`` (one sample per feed) when the spec has
        dynamic non-sequence dims the config cannot resolve."""
        shapes = self._warmup_feed_shapes(example_feeds)
        for sample_shapes in shapes:
            for b in self._cfg.batch_buckets:
                feeds = {
                    name: np.full((b,) + shp,
                                  self._cfg.pad_values.get(name, 0),
                                  dtype=dt)
                    for name, (shp, dt) in sample_shapes.items()}
                with _prof.RecordEvent(f"serving:warmup_b{b}"), \
                        self._exec_lock:
                    self._backend.run(feeds)
        self._stats.mark_warmup_done(self._backend.compile_count())
        return self._backend.compile_count()

    def _warmup_feed_shapes(self, example_feeds):
        """Per seq-bucket variant: {name: (sample_shape, dtype)}.  A
        seq bucket is substituted only into a DYNAMIC seq axis."""
        ax = self._cfg.seq_axis - 1
        if example_feeds is not None:
            base = {n: (tuple(np.asarray(v).shape[1:]),
                        np.asarray(v).dtype, True)
                    for n, v in example_feeds.items()}
        else:
            spec = self._backend.input_spec()
            if spec is None:
                raise ValueError(
                    "this backend exposes no input spec; call "
                    "warmup(example_feeds={name: one_sample_array})")
            base = {}
            for name, (dims, dt) in spec.items():
                if dims is None or any(
                        d is None for i, d in enumerate(dims)
                        if not (i == ax and self._cfg.seq_buckets)):
                    raise ValueError(
                        f"feed '{name}' has dynamic dims {dims} the "
                        f"bucket config cannot resolve; call "
                        f"warmup(example_feeds=...)")
                ragged = (self._cfg.seq_buckets and 0 <= ax < len(dims)
                          and dims[ax] is None)
                base[name] = (dims, dt, ragged)
        if not self._cfg.seq_buckets:
            return [{n: (tuple(s), d) for n, (s, d, _) in base.items()}]
        variants, seen = [], set()
        for sb in self._cfg.seq_buckets:
            v = {}
            for n, (s, d, ragged) in base.items():
                s = list(s)
                if ragged and 0 <= ax < len(s):
                    s[ax] = sb
                v[n] = (tuple(s), d)
            key = tuple(sorted((n, shp) for n, (shp, _) in v.items()))
            if key not in seen:
                seen.add(key)
                variants.append(v)
        return variants

    def close(self, drain=True, timeout=None):
        """Stop accepting requests.  drain=True first lets the worker
        finish everything already queued (bounded by
        ``drain_timeout_s``); drain=False fails queued work with
        ServerClosedError immediately."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        budget = (timeout if timeout is not None
                  else self._cfg.drain_timeout_s)
        deadline = time.monotonic() + budget
        if drain and self._worker is not None:
            while not self._queue.idle():
                if time.monotonic() > deadline:
                    break
                time.sleep(0.005)
        self._queue.close(cancel_pending=True)
        if self._worker is not None:
            self._worker.join(timeout=max(
                deadline - time.monotonic(), 10.0))

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close(drain=exc[0] is None)
        return False

    # -- client API --------------------------------------------------------
    def submit(self, feeds, timeout_ms=None):
        """Enqueue one request; returns an `InferenceFuture`.  Raises
        `QueueFullError`, `BadRequestError` or `ServerClosedError` — all
        BEFORE the request occupies queue space."""
        if self._closed:
            raise ServerClosedError("server is shut down")
        if self._worker is None:
            self.start()
        feeds, rows = self._validate(feeds)
        try:
            key = self._bucketer.group_key(feeds)
            self._bucketer.batch_bucket(rows)   # rejects oversized here
        except BucketError as e:
            raise BadRequestError(str(e)) from e
        timeout_ms = (timeout_ms if timeout_ms is not None
                      else self._cfg.default_timeout_ms)
        deadline = (time.monotonic() + timeout_ms / 1e3
                    if timeout_ms is not None else None)
        req = InferenceFuture(feeds, rows, key, deadline)
        # capture the CLIENT thread's span context: the batcher worker
        # attaches it, so queue wait + batch execute land in the
        # submitting request's trace
        req.trace_ctx = _tracing.current_span()
        self._queue.put(req)
        return req

    def infer(self, feeds, timeout_ms=None):
        """Blocking request: submit + wait.  The timeout covers the
        whole round trip (queueing, batching, execution)."""
        req = self.submit(feeds, timeout_ms=timeout_ms)
        wait_s = ((req.deadline - time.monotonic() + 0.25)
                  if req.deadline is not None else None)
        return req.result(timeout=wait_s)

    def stats(self):
        snap = self._stats.snapshot()
        snap["queue_depth"] = len(self._queue)
        return snap

    def dump_stats(self, path):
        return self._stats.dump_json(path)

    def _validate(self, feeds):
        names = self._backend.input_names
        if names is not None:
            missing = [n for n in names if n not in feeds]
            extra = [n for n in feeds if n not in names]
            if missing or extra:
                raise BadRequestError(
                    f"feed names mismatch: missing {missing}, "
                    f"unexpected {extra} (model feeds: {names})")
        arrs = {n: np.asarray(v) for n, v in feeds.items()}
        rows = None
        for n, a in arrs.items():
            if a.ndim < 1 or a.shape[0] < 1:
                raise BadRequestError(
                    f"feed '{n}' must have a leading batch axis with at "
                    f"least one row, got shape {a.shape}")
            if rows is None:
                rows = a.shape[0]
            elif a.shape[0] != rows:
                raise BadRequestError(
                    f"feeds disagree on batch rows: '{n}' has "
                    f"{a.shape[0]}, another feed has {rows}")
        spec = (self._backend.input_spec()
                if hasattr(self._backend, "input_spec") else None)
        if spec:
            ax = self._cfg.seq_axis - 1
            for n, a in list(arrs.items()):
                declared, want_dt = spec.get(n, (None, None))
                if want_dt is not None and a.dtype != want_dt:
                    arrs[n] = a = a.astype(want_dt, copy=False)
                if declared is None:
                    continue
                if len(a.shape) - 1 != len(declared):
                    raise BadRequestError(
                        f"feed '{n}' has per-sample rank "
                        f"{len(a.shape) - 1}, model declares "
                        f"{len(declared)} dims {declared}")
                for i, (got, want) in enumerate(zip(a.shape[1:],
                                                    declared)):
                    if i == ax and self._cfg.seq_buckets:
                        if want is not None:
                            try:
                                padded = self._bucketer.seq_bucket(got)
                            except BucketError as e:
                                raise BadRequestError(str(e)) from e
                            if padded != want:
                                raise BadRequestError(
                                    f"feed '{n}' (length {got}) pads "
                                    f"to seq bucket {padded} but the "
                                    f"model declares a fixed length "
                                    f"{want}; configure seq_buckets to "
                                    f"end at {want}")
                        continue
                    if want is None:
                        continue   # dynamic axis
                    if got != want:
                        raise BadRequestError(
                            f"feed '{n}' dim {i + 1} is {got}, model "
                            f"declares {want}")
        return arrs, rows

    # -- batcher worker ----------------------------------------------------
    def _worker_loop(self):
        max_rows = self._cfg.max_batch_size
        wait_s = self._cfg.max_batch_wait_ms / 1e3
        while True:
            batch = self._queue.pop_batch(max_rows, wait_s)
            if not batch:
                # [] means closed+drained, or every assembled request
                # expired — exit in the former case, loop in the latter
                if self._closed and self._queue.empty():
                    return
                continue
            try:
                self._run_batch(batch)
            except Exception as e:  # noqa: BLE001 — worker must survive
                # an assembly/splitting bug must not kill the worker and
                # hang every queued client; fail this batch instead
                for req in batch:
                    if not req.done():
                        req.set_error(e)
                        self._stats.on_request_done(
                            False,
                            (time.monotonic() - req.t_enqueue) * 1e3,
                            (req.t_dequeue - req.t_enqueue) * 1e3)
            finally:
                self._queue.mark_idle()

    def _run_batch(self, batch):
        feeds, padded_batch, row_slices, real_el, padded_el = \
            self._bucketer.assemble(batch)
        rows_total = sum(r.rows for r in batch)
        t0 = time.perf_counter()
        # each request's queue wait becomes a span in ITS OWN trace,
        # ending at DEQUEUE (the serving_queue_wait_ms interval); the
        # batch span parents on the oldest traced request.  t_dequeue_pc
        # is CONSUMED so a failed batch re-run through _isolate does not
        # record the same wait twice
        for req in batch:
            if req.t_dequeue_pc is not None:
                _tracing.record_span("serving:queue_wait",
                                     req.t_enqueue_pc,
                                     req.t_dequeue_pc,
                                     ctx=req.trace_ctx)
                req.t_dequeue_pc = None
        seed_ctx = next((r.trace_ctx for r in batch
                         if r.trace_ctx is not None), None)
        try:
            with _tracing.attach(seed_ctx), \
                    _tracing.span(f"serving:batch_b{padded_batch}",
                                  n_requests=len(batch)), \
                    self._exec_lock:
                outs = self._backend.run(feeds)
        except Exception as batch_exc:   # noqa: BLE001 — isolate below
            self._isolate(batch, batch_exc)
            self._stats.set_compiles(self._backend.compile_count())
            return
        exec_ms = (time.perf_counter() - t0) * 1e3
        self._stats.on_batch(rows_total, padded_batch, real_el,
                             padded_el, exec_ms)
        self._stats.set_compiles(self._backend.compile_count())
        per_request = self._bucketer.split_outputs(outs, padded_batch,
                                                   row_slices)
        now = time.monotonic()
        for req, req_outs in zip(batch, per_request):
            if req.expired(now):
                # deadline passed DURING execution: account it as a
                # timeout, not as a success the client never saw
                req.set_error(RequestTimeoutError(
                    "deadline passed while the batch was executing"))
                self._stats.on_timeout((now - req.t_enqueue) * 1e3)
                continue
            req.set_result(req_outs)
            self._stats.on_request_done(
                True, (now - req.t_enqueue) * 1e3,
                (req.t_dequeue - req.t_enqueue) * 1e3)

    def _isolate(self, batch, batch_exc):
        """A batch failed: one bad feed must not poison its batchmates.
        Re-run each request alone; the culprit gets the error, the rest
        get results."""
        if len(batch) == 1:
            req = batch[0]
            req.set_error(batch_exc)
            self._stats.on_request_done(
                False, (time.monotonic() - req.t_enqueue) * 1e3,
                (req.t_dequeue - req.t_enqueue) * 1e3)
            return
        with _prof.RecordEvent("serving:isolate"):
            for req in batch:
                self._run_batch([req])
