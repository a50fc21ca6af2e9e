"""Request queue + dynamic batcher core (a copy of
paddle_tpu/serving/batcher.py).

A bounded, thread-safe FIFO of in-flight requests and the coalescing
policy that turns it into padded batches:

- the batch is seeded by the OLDEST queued request; only requests with
  the same group key (dtype + padded per-sample shapes, see buckets.py)
  join it — FIFO order is preserved within a key, and an incompatible
  request never blocks a compatible younger one (head-of-line blocking
  only applies across one assembly round).
- the batcher holds the batch open up to ``max_batch_wait_ms`` waiting
  for more arrivals (the latency/throughput knob), shipping early the
  moment the largest batch bucket is full.
- backpressure: `put` on a full queue raises ``QueueFullError``
  immediately — the caller sheds load instead of building an unbounded
  latency backlog.
- per-request deadlines are enforced here: a request whose deadline
  passes while queued is completed with ``RequestTimeoutError`` and
  never occupies a batch slot.
"""
from __future__ import annotations

import threading
import time

__all__ = ["ServingError", "QueueFullError", "RequestTimeoutError",
           "ServerClosedError", "BadRequestError", "InferenceFuture",
           "RequestQueue"]


class ServingError(RuntimeError):
    """Base class of every serving-path error."""


class QueueFullError(ServingError):
    """Backpressure: the bounded request queue is full; retry later or
    scale out."""


class RequestTimeoutError(ServingError, TimeoutError):
    """The request's deadline passed before a result was produced."""


class ServerClosedError(ServingError):
    """The server is shut down (or shutting down) and accepts no work."""


class BadRequestError(ServingError, ValueError):
    """The request failed validation against the model's input spec."""


class InferenceFuture:
    """Handle returned by ``InferenceServer.submit``: the per-request
    rendezvous between the submitting thread and the batcher worker."""

    __slots__ = ("feeds", "rows", "group_key", "deadline", "t_enqueue",
                 "t_dequeue", "t_enqueue_pc", "t_dequeue_pc",
                 "trace_ctx", "_event", "_outputs", "_error")

    def __init__(self, feeds, rows, group_key, deadline):
        self.feeds = feeds
        self.rows = rows
        self.group_key = group_key
        self.deadline = deadline          # absolute monotonic or None
        self.t_enqueue = time.monotonic()
        self.t_dequeue = None
        # perf_counter twin of t_enqueue (the profiler's clock) so the
        # queue-wait interval can be exported as a trace span, plus the
        # submitting thread's span context — the batcher worker adopts
        # it, so batch execution joins the CLIENT's trace
        self.t_enqueue_pc = time.perf_counter()
        self.t_dequeue_pc = None
        self.trace_ctx = None
        self._event = threading.Event()
        self._outputs = None
        self._error = None

    def done(self):
        return self._event.is_set()

    def result(self, timeout=None):
        """Block for the outputs (list of arrays, request's own rows).
        Raises the request's error — timeout, rejection, backend
        failure — as stored by the batcher."""
        if not self._event.wait(timeout):
            raise RequestTimeoutError(
                f"no result within {timeout}s (request still in flight)")
        if self._error is not None:
            raise self._error
        return self._outputs

    def expired(self, now=None):
        return self.deadline is not None and \
            (now if now is not None else time.monotonic()) > self.deadline

    # -- batcher side ------------------------------------------------------
    def set_result(self, outputs):
        self._outputs = outputs
        self._event.set()

    def set_error(self, exc):
        self._error = exc
        self._event.set()


class RequestQueue:
    """Bounded FIFO with group-aware batch pop (condition-variable based
    so the batcher can sleep precisely until the batching deadline)."""

    def __init__(self, max_size, stats):
        self._items: list = []
        self._max = max_size
        self._stats = stats
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._closed = False
        # a batch is "in flight" from the moment pop_batch hands it out
        # until the worker calls mark_idle() — drain must see the two
        # states under ONE lock (no window where a popped batch is
        # neither queued nor visibly running)
        self._in_flight = False

    def __len__(self):
        with self._lock:
            return len(self._items)

    def put(self, req):
        with self._lock:
            if self._closed:
                raise ServerClosedError(
                    "server is shut down; no new requests accepted")
            if len(self._items) >= self._max:
                self._stats.on_reject()
                raise QueueFullError(
                    f"request queue is full ({self._max} waiting); the "
                    f"server is overloaded — retry with backoff, raise "
                    f"max_queue_size, or add capacity")
            self._items.append(req)
            self._stats.on_queue_depth(len(self._items))
            self._cond.notify_all()

    def _expire_locked(self, now):
        """Complete and drop every queued request whose deadline passed
        (runs under the lock; set_error only flips an Event)."""
        live = []
        for r in self._items:
            if r.expired(now):
                self._stats.on_timeout((now - r.t_enqueue) * 1e3)
                r.set_error(RequestTimeoutError(
                    "request timed out while queued (deadline passed "
                    "before batch assembly)"))
            else:
                live.append(r)
        self._items = live

    def _take_compatible_locked(self, key, rows, cap, batch):
        """Move queued requests matching ``key`` into ``batch`` (FIFO,
        skipping any whose rows would overflow the largest bucket).
        Returns the updated row count."""
        remaining = []
        for r in self._items:
            if rows < cap and r.group_key == key and rows + r.rows <= cap:
                batch.append(r)
                rows += r.rows
            else:
                remaining.append(r)
        self._items = remaining
        return rows

    def pop_batch(self, max_batch_rows, max_wait_s):
        """Block for the next batch: the oldest live request plus every
        compatible request that arrives before the batching deadline or
        the bucket cap is hit.  Returns [] when closed and drained."""
        with self._lock:
            while True:
                self._expire_locked(time.monotonic())
                if self._items:
                    break
                if self._closed:
                    return []
                # block until put()/close() notify — an idle server
                # must not wake its worker on a poll interval
                self._cond.wait()
            first = self._items.pop(0)
            batch = [first]
            rows = first.rows
            key = first.group_key
            rows = self._take_compatible_locked(key, rows,
                                                max_batch_rows, batch)
            deadline = time.monotonic() + max_wait_s
            while rows < max_batch_rows and not self._closed:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(remaining)
                rows = self._take_compatible_locked(key, rows,
                                                    max_batch_rows, batch)
            now = time.monotonic()
            live = []
            for r in batch:
                if r.expired(now):
                    self._stats.on_timeout((now - r.t_enqueue) * 1e3)
                    r.set_error(RequestTimeoutError(
                        "request timed out during batch assembly"))
                else:
                    r.t_dequeue = now
                    # perf_counter twin so the queue-wait trace span
                    # ends where the queue_wait METRIC does (dequeue),
                    # not after batch assembly
                    r.t_dequeue_pc = time.perf_counter()
                    live.append(r)
            self._stats.on_queue_depth(len(self._items))
            if live:
                self._in_flight = True
            return live

    def close(self, cancel_pending):
        """Stop accepting work.  cancel_pending=True also fails whatever
        is still queued (non-drain shutdown)."""
        with self._lock:
            self._closed = True
            if cancel_pending:
                for r in self._items:
                    r.set_error(ServerClosedError(
                        "server shut down before this request ran"))
                self._items = []
            self._cond.notify_all()

    def mark_idle(self):
        """Worker signals the popped batch is fully processed."""
        with self._lock:
            self._in_flight = False
            self._cond.notify_all()

    def idle(self):
        """True iff nothing is queued AND no popped batch is running."""
        with self._lock:
            return not self._items and not self._in_flight

    def empty(self):
        with self._lock:
            return not self._items
