"""Profiler (parity: python/paddle/fluid/profiler.py:39-253 —
start_profiler/stop_profiler/profiler ctx/reset_profiler — and the C++
RecordEvent host-event recorder, platform/profiler.h:95).

Counterpart of paddle_tpu/profiler.py.  Host-side events (program runs,
compiles, user RecordEvent scopes, observability spans) are recorded
in-process and reported as the reference's aggregated table or exported
as a Chrome trace (tools/timeline.py parity), exactly as in the JAX
package.

The device trace is a ``torch.profiler`` (Kineto) session in place of
the JAX package's ``jax.profiler`` trace.  ``start_profiler`` with a
``tracer_path`` (or env ``PADDLE_TPU_TRACE_DIR``) starts one and
``stop_profiler`` writes its Chrome trace under that directory
(:func:`last_device_trace`).  ``state`` picks its activities: ``"CPU"``
records the host alone, ``"GPU"`` and ``"All"`` add the CUDA activity —
and raise when there is no CUDA device rather than tracing the host
alone.  The session records every thread (the serving batcher's worker
runs the engine).  While it runs, ``observability.tracing.span`` opens a
``torch.profiler.record_function`` of its name and the Executor's
lowering scopes each program op as ``"type:first_output"``, so the host
spans, the op scopes and the CUDA kernels they launched land on one
Kineto timeline.  :func:`trace_ranges`, :func:`trace_kernels` and
:func:`kernels_inside` read such a trace back: which kernels ran inside
which named range.

Events may carry an ``args`` dict (``observability.tracing`` stores
trace/span/parent ids there); the Chrome-trace export forwards it per
event and emits process/thread ``M`` metadata records so Perfetto names
tracks and can link parent/child spans.
"""
from __future__ import annotations

import contextlib
import json
import logging
import os
import threading
import time

__all__ = ["RecordEvent", "start_profiler", "stop_profiler",
           "reset_profiler", "profiler", "cuda_profiler",
           "export_chrome_tracing", "last_device_trace",
           "last_device_profile", "load_device_trace", "trace_ranges",
           "trace_kernels", "kernels_inside"]

_log = logging.getLogger("paddle_tpu_torch.profiler")

_lock = threading.Lock()
_enabled = False
_events: list = []  # (name, start_s, end_s, thread_id, args_or_None)
_thread_names: dict = {}  # thread_id -> thread name (for trace M events)
#: the running torch.profiler session (None when no device trace runs)
#: and the directory its trace goes to (None: kept in memory only)
_device_session = None
_device_trace_dir = None
_last_session = None
_last_trace_path = None
_trace_seq = 0


def _note_thread():
    tid = threading.get_ident()
    # unconditional store: the OS reuses thread ids, so a cached name
    # can go stale; last writer wins (a GIL-atomic dict assignment)
    _thread_names[tid] = threading.current_thread().name
    return tid


class RecordEvent:
    """``with RecordEvent("fwd"):`` — host event scope (parity:
    platform/profiler.h:95; usable whether or not profiling is on)."""

    def __init__(self, name):
        self.name = name
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if _enabled:
            t1 = time.perf_counter()
            tid = _note_thread()
            with _lock:
                _events.append((self.name, self._t0, t1, tid, None))
        return False


def record(name, t0, t1, args=None):
    """Programmatic event insertion (used by the Executor and the span
    tracer; ``args`` lands in the Chrome-trace event verbatim)."""
    if _enabled:
        tid = _note_thread()
        with _lock:
            _events.append((name, t0, t1, tid, args))


def is_profiling():
    return _enabled


def device_tracing():
    """True while a torch.profiler session runs (what the span tracer and
    the lowering's op scopes check before opening a record_function)."""
    return _device_session is not None


def _start_device_session(state, trace_dir):
    global _device_session, _device_trace_dir
    import torch
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if state in ("GPU", "All"):
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"start_profiler(state={state!r}) traces the CUDA activity "
                f"and no CUDA device is available; pass state='CPU' to "
                f"trace the host alone")
        activities.append(ProfilerActivity.CUDA)
    # every thread: the serving batcher's worker runs the engine's steps
    # (by default Kineto records the starting thread alone)
    session = profile(activities=activities,
                      experimental_config=_ExperimentalConfig(
                          profile_all_threads=True))
    session.start()
    _device_session, _device_trace_dir = session, trace_dir


def start_profiler(state="All", tracer_path=None):
    """Parity: profiler.start_profiler(state).  Host events always
    record; ``tracer_path`` (or env PADDLE_TPU_TRACE_DIR) also starts
    the torch.profiler session whose activities ``state`` selects
    ('CPU': the host; 'GPU'/'All': the host and the CUDA kernels, which
    raise without a card)."""
    global _enabled
    if state not in ("CPU", "GPU", "All"):
        raise ValueError("state must be 'CPU', 'GPU' or 'All'")
    tracer_path = tracer_path or os.environ.get("PADDLE_TPU_TRACE_DIR")
    if tracer_path and _device_session is None:  # idempotent re-start
        _start_device_session(state, tracer_path)
    _enabled = True


def _stop_device_session():
    """Stop the running session; write its Chrome trace under its
    directory (when it has one)."""
    global _device_session, _device_trace_dir, _last_session, \
        _last_trace_path, _trace_seq
    session, trace_dir = _device_session, _device_trace_dir
    _device_session = _device_trace_dir = None
    session.stop()
    _last_session = session
    _last_trace_path = None
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        _trace_seq += 1
        path = os.path.join(
            trace_dir, f"paddle_tpu_torch.{os.getpid()}.{_trace_seq}"
            f".pt.trace.json")
        session.export_chrome_trace(path)
        _last_trace_path = path


def last_device_trace():
    """Path of the Kineto Chrome trace the last device session wrote
    (None if it had no directory, or none has stopped yet)."""
    return _last_trace_path


def last_device_profile():
    """The last stopped ``torch.profiler.profile`` session (its
    ``events()`` and ``key_averages()``), or None."""
    return _last_session


def load_device_trace(path=None):
    """The Kineto Chrome trace at ``path`` (default: the last one written)
    as a dict."""
    with open(path or _last_trace_path) as f:
        return json.load(f)


def trace_ranges(doc, name, device=False):
    """Ranges named ``name`` (a span's or an op scope's record_function)
    in a Kineto trace: [(tid, start_us, end_us)].  ``device=False``: the
    host ranges; ``device=True``: their device-side twins, which Kineto
    spans over the kernels launched inside each range while it was the
    thread's innermost range (by CUPTI's external correlation, so on the
    device's own clock).  Kernels the autograd engine launches from its
    own thread (a backward pass) fall in no range of the caller."""
    cat = "gpu_user_annotation" if device else "user_annotation"
    return [(e.get("tid"), e["ts"], e["ts"] + e.get("dur", 0))
            for e in doc["traceEvents"]
            if e.get("cat") == cat and e.get("name") == name]


def trace_kernels(doc):
    """Every CUDA kernel of a Kineto trace: [(name, start_us, end_us)]."""
    return [(e["name"], e["ts"], e["ts"] + e.get("dur", 0))
            for e in doc["traceEvents"] if e.get("cat") == "kernel"]


def kernels_inside(doc, kernel, range_name):
    """(kernels whose name contains ``kernel``, how many of them ran
    inside the device side of a ``range_name`` range — a range with no
    range nested inside it, such as an engine step or a program op's
    scope).

    The device side, not the launch's runtime event: in the second and
    later torch.profiler sessions of one process, torch 2.11's Kineto
    (CUPTI 26) writes the runtime events on another thread id and
    shifted in time against the host ranges, while a range's device
    twin and the kernels share the device clock — and one stream runs
    its kernels in launch order, so a kernel inside a range's device
    span was launched inside the range."""
    ranges = trace_ranges(doc, range_name, device=True)
    found = [k for k in trace_kernels(doc) if kernel in k[0]]
    inside = sum(any(r0 <= t0 and t1 <= r1 for _, r0, r1 in ranges)
                 for _, t0, t1 in found)
    return len(found), inside


def stop_profiler(sorted_key="total", profile_path=None, quiet=False):
    """Parity: profiler.stop_profiler(sorted_key, profile_path): prints
    the aggregated event table; optionally writes a Chrome trace of the
    host events.  A running device session stops here and writes its
    Kineto trace (:func:`last_device_trace`).

    The report always goes through the ``paddle_tpu_torch.profiler``
    logger (INFO); ``quiet=True`` suppresses the parity ``print`` so
    library users can silence the console without losing the return
    value or the log record."""
    global _enabled
    _enabled = False
    if _device_session is not None:
        _stop_device_session()
    report = summary(sorted_key)
    _log.info("%s", report)
    if not quiet:
        print(report)
    if profile_path:
        export_chrome_tracing(profile_path)
    return report


def reset_profiler():
    with _lock:
        _events.clear()


@contextlib.contextmanager
def profiler(state="All", sorted_key="total", profile_path=None,
             quiet=False):
    """``with profiler.profiler('All'):`` (parity: fluid.profiler)."""
    start_profiler(state)
    try:
        yield
    finally:
        stop_profiler(sorted_key, profile_path, quiet=quiet)


@contextlib.contextmanager
def cuda_profiler(output_file=None, output_mode=None, config=None):
    """Parity: fluid.profiler.cuda_profiler.  Runs the CUDA activity of a
    torch.profiler session around the block (raises without a card);
    ``output_file`` (or env PADDLE_TPU_TRACE_DIR) is the directory its
    Kineto trace goes to, else the session stays in memory
    (:func:`last_device_profile`).  ``output_mode`` and ``config`` are
    the nvprof options of the reference and are accepted unused."""
    global _enabled
    del output_mode, config
    trace_dir = output_file or os.environ.get("PADDLE_TPU_TRACE_DIR")
    if _device_session is None:
        _start_device_session("GPU", trace_dir)
    _enabled = True
    try:
        yield
    finally:
        stop_profiler(quiet=True)


def summary(sorted_key="total"):
    """Aggregated table: name, calls, total ms, min/max/avg ms (the
    reference's profiler report format)."""
    with _lock:
        evs = list(_events)
    agg: dict = {}
    for name, t0, t1, _tid, _args in evs:
        ms = (t1 - t0) * 1e3
        a = agg.setdefault(name, [0, 0.0, float("inf"), 0.0])
        a[0] += 1
        a[1] += ms
        a[2] = min(a[2], ms)
        a[3] = max(a[3], ms)
    keyfn = {
        "total": lambda kv: -kv[1][1],
        "calls": lambda kv: -kv[1][0],
        "max": lambda kv: -kv[1][3],
        "min": lambda kv: -kv[1][2],
        "ave": lambda kv: -(kv[1][1] / kv[1][0]),
    }.get(sorted_key, lambda kv: -kv[1][1])
    lines = ["-------------------------     Profiling Report     "
             "-------------------------", "",
             f"{'Event':<40}{'Calls':>8}{'Total(ms)':>12}{'Min(ms)':>10}"
             f"{'Max(ms)':>10}{'Ave(ms)':>10}"]
    for name, (calls, total, mn, mx) in sorted(agg.items(), key=keyfn):
        lines.append(f"{name:<40}{calls:>8}{total:>12.3f}{mn:>10.3f}"
                     f"{mx:>10.3f}{total / calls:>10.3f}")
    return "\n".join(lines)


def export_chrome_tracing(path):
    """Write host events as a chrome://tracing JSON (tools/timeline.py
    parity).  The real process id + ``M`` process/thread metadata events
    name the Perfetto tracks, and span ids (when present) ride in each
    event's ``args`` so parent/child host spans link up next to the
    Kineto device trace."""
    with _lock:
        evs = list(_events)
        tnames = dict(_thread_names)
    pid = os.getpid()
    trace_events = [
        {"name": "process_name", "ph": "M", "pid": pid,
         "args": {"name": "paddle_tpu_torch host"}},
        {"name": "process_sort_index", "ph": "M", "pid": pid,
         "args": {"sort_index": 0}},
    ]
    for tid in sorted({tid for _, _, _, tid, _ in evs}):
        trace_events.append(
            {"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
             "args": {"name": tnames.get(tid, f"thread-{tid}")}})
    for name, t0, t1, tid, args in evs:
        ev = {"name": name, "ph": "X", "pid": pid, "tid": tid,
              "ts": t0 * 1e6, "dur": (t1 - t0) * 1e6, "cat": "host"}
        if args:
            ev["args"] = args
        trace_events.append(ev)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    # event ts are perf_counter microseconds — a PER-PROCESS clock with
    # an arbitrary origin.  Record this process's perf->epoch offset so
    # tools/trace_merge.py can put traces from several processes on one
    # common timeline.  Extra top-level keys are legal in the Chrome
    # trace object format.
    meta = {"pid": pid,
            "perf_origin_unix_us": (time.time() - time.perf_counter())
            * 1e6}
    with open(path, "w") as f:
        json.dump({"traceEvents": trace_events, "metadata": meta}, f)
    return path
