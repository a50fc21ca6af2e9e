"""Nested span tracer layered on :mod:`paddle_tpu_torch.profiler`.

Counterpart of paddle_tpu/observability/tracing.py: the same spans, ids,
``args`` and disabled-path cost.  One mechanism is added: while the
profiler's torch.profiler session runs, a :func:`span` also opens a
``torch.profiler.record_function`` of its name, so Kineto puts the host
span and the CUDA kernels launched inside it on one clock.
:func:`record_span`, written after the fact, stays a host event.

The profiler records flat ``(name, t0, t1)`` host events (the
reference's RecordEvent recorder).  Spans add STRUCTURE on top of the
same event stream: every span gets a process-unique ``span_id``, the
``trace_id`` of its root, and its ``parent_span_id`` — carried in the
event's ``args`` so the Chrome-trace export (``profiler.
export_chrome_tracing``) lets Perfetto link parent/child host spans and
line them up against the Kineto device trace on one timeline.

Propagation is a :mod:`contextvars` variable, so nesting follows the
logical call tree, not the thread: the serving batcher adopts the
submitting client's span context (:func:`attach`) before executing a
batch and the dataio prefetch worker adopts its consumer's — queue
waits and cross-thread work join the trace that caused them instead of
dangling as parentless events.

Cost model: when profiling is off AND the flight recorder is disarmed,
:func:`span` is two flag checks and yields immediately
(``chip_smoke.py`` compares the untraced serving and training steps
with the parent's).  While the flight recorder is armed (:mod:`flightrec`),
closed spans are ALSO appended to its bounded ring — even with the
profiler off, so the last seconds before an incident are always
recorded.  Span ids come from ``itertools.count`` (atomic under the
GIL; no locks on the hot path).
"""
from __future__ import annotations

import contextlib
import contextvars
import itertools
import time
import typing

import torch

from . import flightrec as _flightrec
from .. import profiler as _prof

__all__ = ["SpanContext", "span", "attach", "record_span",
           "current_span", "new_trace", "reseed_ids"]


class SpanContext(typing.NamedTuple):
    trace_id: int
    span_id: int


# process-unique id source; next() on itertools.count is atomic in
# CPython so the request path takes no lock
_ids = itertools.count(1)

_current: contextvars.ContextVar = contextvars.ContextVar(
    "paddle_tpu_torch_span", default=None)


def _new_id():
    return next(_ids)


def current_span():
    """The active :class:`SpanContext` in this (logical) context, or
    None.  Capture it on one thread, :func:`attach` it on another to
    continue the trace across a queue."""
    return _current.get()


def _span_args(ctx, parent, attrs):
    args = {"trace_id": ctx.trace_id, "span_id": ctx.span_id,
            "parent_span_id": parent.span_id if parent else None}
    if attrs:
        args.update(attrs)
    return args


@contextlib.contextmanager
def span(span_name, **attrs):
    """``with span("train:step", step=7):`` — a timed, id-carrying
    scope.  Child spans opened inside (same or attached context)
    reference this span as their parent.  No-op (but still yields) when
    profiling is off.  (The positional is ``span_name`` so any plain
    word — including ``name`` — stays usable as an attr key.)"""
    profiling = _prof.is_profiling()
    armed = _flightrec._armed
    if not profiling and not armed:
        yield None
        return
    parent = _current.get()
    ctx = SpanContext(parent.trace_id if parent else _new_id(),
                      _new_id())
    token = _current.set(ctx)
    scope = None
    if profiling and _prof.device_tracing():
        scope = torch.profiler.record_function(span_name)
        scope.__enter__()
    t0 = time.perf_counter()
    try:
        yield ctx
    finally:
        t1 = time.perf_counter()
        if scope is not None:
            scope.__exit__(None, None, None)
        _current.reset(token)
        if profiling:
            _prof.record(span_name, t0, t1,
                         args=_span_args(ctx, parent, attrs))
        if armed:
            _flightrec._recorder.record_span(
                span_name, t0, t1, ctx.trace_id, ctx.span_id,
                parent.span_id if parent else None, attrs or None)


@contextlib.contextmanager
def attach(ctx):
    """Adopt ``ctx`` (a captured :class:`SpanContext`, or None) as the
    current context — the cross-thread half of propagation.  Spans
    opened under it become children of the capturing thread's span."""
    token = _current.set(ctx)
    try:
        yield ctx
    finally:
        _current.reset(token)


def record_span(span_name, t0, t1, ctx=None, **attrs):
    """Programmatic span over an already-measured [t0, t1] interval
    (``time.perf_counter`` seconds) — the executor's run/lower events
    and the batcher's queue-wait intervals use this.  Parent is ``ctx``
    if given, else the current context."""
    profiling = _prof.is_profiling()
    armed = _flightrec._armed
    if not profiling and not armed:
        return None
    parent = ctx if ctx is not None else _current.get()
    child = SpanContext(parent.trace_id if parent else _new_id(),
                        _new_id())
    if profiling:
        _prof.record(span_name, t0, t1,
                     args=_span_args(child, parent, attrs))
    if armed:
        _flightrec._recorder.record_span(
            span_name, t0, t1, child.trace_id, child.span_id,
            parent.span_id if parent else None, attrs or None)
    return child


def new_trace():
    """A fresh root context (no parent) — for callers that want a trace
    id without an enclosing span (e.g. one per inference request)."""
    tid = _new_id()
    return SpanContext(tid, tid)


def reseed_ids(start=None):
    """Restart the id counter from ``start`` (default: a pid-derived
    offset).  Ids are only process-unique; a cluster worker that ADOPTS
    a router's trace context (:func:`attach`) would otherwise mint span
    ids colliding with the router's in the merged cross-process trace.
    Called once at worker boot, before any span is opened."""
    global _ids
    import os

    if start is None:
        start = (os.getpid() << 24) + 1
    _ids = itertools.count(int(start))
