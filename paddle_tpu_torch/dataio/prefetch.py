"""Shared background-prefetch iterator.

ONE home for the producer-thread / bounded-queue / sentinel shutdown
protocol used by the DataLoader double buffer, the reader ``buffered``
decorator, and the dataset trainer's threaded feed (parity: the
consumer side of operators/reader/buffered_reader.cc).  The subtle
parts live here exactly once:

* a producer (worker) exception propagates to the consumer WITH its
  original traceback, and delivery never depends on queue space: the
  exception travels in a side box the consumer polls, so a worker that
  dies with the queue full (or empty) surfaces on the consumer's next
  ``next()`` instead of wedging the pipeline.  Items buffered before
  the failure are still delivered first (epochs never silently
  truncate, and never reorder);
* a worker that dies WITHOUT reporting (thread killed, sentinel lost)
  is detected by aliveness polling — again an exception, never a hang;
* a consumer that abandons iteration (break / raise) sets a stop event
  so the producer can't block forever on a full queue;
* the queue drains on exit, releasing any pinned (device) arrays.

Counterpart of paddle_tpu/dataio/prefetch.py, the same protocol and
metrics (``dataio_prefetch_items_total``, ``dataio_prefetch_wait_ms``
and the ``dataio:prefetch_wait`` span) in the port's registry.
"""
from __future__ import annotations

import queue
import threading
import time as _time

_END = object()


def background_iter(source, capacity=4, name="paddle_tpu-prefetch",
                    transform=None):
    """Yield items of the ``source()`` iterable, produced on a background
    thread through a ``capacity``-bounded queue.

    transform: optional callable applied to each item ON THE PRODUCER
    thread (e.g. a non-blocking host-to-device copy, so the copy overlaps
    the consumer's compute).
    """
    from .. import observability as _obs
    from ..observability import tracing as _tracing
    from ..resilience import faults as _faults

    q = queue.Queue(maxsize=capacity)
    stop = threading.Event()
    # the consumer's span context, adopted by the worker thread so
    # producer-side work (source + transform) lands in the same trace
    consumer_ctx = _tracing.current_span()
    # handles resolved unconditionally (get-or-create is cheap); each
    # USE re-checks enabled() so set_enabled() toggles take effect on
    # already-running iterators too (same per-call semantics as
    # TrainingMonitor)
    reg = _obs.get_registry()
    m_items = reg.counter(
        "dataio_prefetch_items_total",
        "items delivered through prefetch queues").labels(name=name)
    m_wait = reg.histogram(
        "dataio_prefetch_wait_ms",
        "consumer time blocked on an empty prefetch queue"
    ).labels(name=name)
    # the error box: written once by the producer, read by the consumer.
    # A plain dict slot is enough — the GIL orders the single write
    # against the reads, and the consumer only acts after q/aliveness
    # signals that the write (if any) has happened.
    box = {"err": None}

    def put(item):
        # bounded put that gives up when the consumer abandoned the
        # iteration — otherwise the thread would leak, pinning up to
        # `capacity` items forever
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def fill():
        # adopt the consumer's trace context: producer-side work
        # (source + transform) joins the trace that consumes it
        with _tracing.attach(consumer_ctx), \
                _tracing.span("dataio:prefetch_worker", queue=name):
            try:
                for i, item in enumerate(source()):
                    # check BEFORE transform: after the consumer
                    # abandons, a late-arriving source item must not be
                    # copied to the device (that would allocate a device
                    # buffer nobody drains)
                    if stop.is_set():
                        return
                    _faults.maybe_fail("dataloader_worker", index=i)
                    if transform is not None:
                        item = transform(item)
                    if not put(item):
                        return
                put(_END)
            except BaseException as e:  # propagate, don't truncate epochs
                box["err"] = e
                # best-effort wake-up for a consumer blocked on an empty
                # queue; if the queue is full this is dropped — the
                # consumer's poll loop finds the box anyway
                try:
                    q.put_nowait(_END)
                except queue.Full:
                    pass

    def raise_worker_error():
        err = box["err"]
        box["err"] = None
        # re-raising the ORIGINAL exception object keeps the producer
        # thread's traceback (the frame inside source/transform that
        # actually failed) attached for the consumer to report
        raise err

    def consume_blocked(blocked_since):
        """Slow path: the queue was empty, so the consumer is STARVED —
        poll the queue, the error box, and worker aliveness until an
        item (or _END) arrives, and meter the blocked interval (a
        ``dataio_prefetch_wait_ms`` observation plus a
        ``dataio:prefetch_wait`` trace span) so input-bound steps are
        attributable in the same view as compute."""
        try:
            while True:
                try:
                    return q.get(timeout=0.1)
                except queue.Empty:
                    pass
                # nothing buffered: any reported error is now next in
                # line; a silently-dead worker is an error too (a bare
                # `q.get()` here is the classic wedge)
                if box["err"] is not None:
                    raise_worker_error()
                if t.is_alive():
                    continue
                # the worker's box/_END write happens-before its thread
                # exit, so one final look at both channels is
                # authoritative: a death between the two checks above
                # must not mask the real error (or a clean _END) with
                # the generic "without reporting"
                if box["err"] is not None:
                    raise_worker_error()
                try:
                    return q.get_nowait()
                except queue.Empty:
                    raise RuntimeError(
                        f"prefetch worker '{name}' died without "
                        f"reporting a result")
        finally:
            now = _time.perf_counter()
            if _obs.enabled():
                m_wait.observe((now - blocked_since) * 1e3)
            _tracing.record_span("dataio:prefetch_wait", blocked_since,
                                 now, queue=name)

    t = threading.Thread(target=fill, daemon=True, name=name)
    t.start()
    try:
        while True:
            try:
                item = q.get_nowait()
            except queue.Empty:
                item = consume_blocked(_time.perf_counter())
            if item is _END:
                if box["err"] is not None:
                    raise_worker_error()
                break
            if _obs.enabled():
                m_items.inc()
            yield item
    finally:
        stop.set()
        # bounded join: the producer only observes `stop` inside put(),
        # so if the SOURCE itself is blocked (e.g. a generator waiting on
        # a socket) an unconditional join would hang the consumer's
        # break/close forever — give it a moment, then abandon the
        # daemon thread

        # join in short slices (bounded ~1s total), draining the queue
        # between slices — a put that was in flight when `stop` was set
        # can slip one item behind any single drain pass.  Sample
        # aliveness BEFORE each drain: a put landing between the drain
        # and the check would otherwise be stranded exactly when the
        # thread exits right after it.
        deadline = _time.monotonic() + 1.0
        while True:
            alive = t.is_alive()
            while not q.empty():  # release pinned items
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            if not alive or _time.monotonic() > deadline:
                break
            t.join(timeout=0.05)
