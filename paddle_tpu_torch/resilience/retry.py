"""Retry with jittered exponential backoff, and the control plane's
degradation registry.

Counterpart of paddle_tpu/resilience/retry.py (`TransientError`,
`RetryError`, `backoff_delays`, `retry_call`, `retry`,
`DegradationRegistry`, `degradations`, copied): the cluster control
plane's connect loop retries through :func:`retry_call`.  The jitter
stream is seeded, and both the clock and the sleep function are
injectable, so tests assert the exact backoff schedule against a fake
clock with zero real sleeping.

Only transient failures are retried: :class:`TransientError` is the
marker type (`cluster.rpc.WorkerUnavailable` derives from it).

:class:`DegradationRegistry` records the control plane's permanent
decisions, and only those: a rollout halted by its parity canary
(``fleet.rollout``), a model whose crash loop exhausted its respawn
budget (``fleet.supervisor:<model>``), a tuned config or fusion plan
refused (``tuning.*``).  ``degrade`` takes keys under ``fleet.`` and
``tuning.`` and raises ``ValueError`` on any other: in the JAX package
the registry also switches a failed kernel to its reference path; the
port never does that (a wrapper launches its kernel or raises), and a
degraded tuning key falls back to a plan that still runs the port's
kernels.
"""
from __future__ import annotations

import functools
import random
import threading
import time

__all__ = ["TransientError", "RetryError", "retry", "retry_call",
           "backoff_delays", "DegradationRegistry", "degradations",
           "CONTROL_PLANE_PREFIXES"]

#: the key families ``degrade`` takes: control-plane seams only
CONTROL_PLANE_PREFIXES = ("fleet.", "tuning.")


class TransientError(RuntimeError):
    """A failure worth retrying (network hiccup, storage briefly
    unavailable).  Raisers assert "trying again may work"; permanent
    failures must stay plain RuntimeError/OSError so the retry loop
    fails fast on them."""


class RetryError(RuntimeError):
    """All attempts exhausted (or deadline hit).  ``__cause__`` is the
    last underlying exception."""


def _count(name, help, amount=1, **labels):
    """Increment a series on the process metrics registry.  Lazy import
    (observability must stay import-light from here) and best-effort:
    telemetry must never turn a retried transient into a hard
    failure."""
    try:
        from ..observability.registry import get_registry

        get_registry().counter(name, help).inc(amount, **labels)
    except Exception:  # noqa: BLE001 — metrics are non-load-bearing
        pass


def backoff_delays(max_attempts, base_delay, max_delay, multiplier,
                   jitter, seed):
    """The deterministic delay schedule between attempts (length
    ``max_attempts - 1``).  Exposed so tests can assert timing without
    sleeping: delay_k = min(max_delay, base * multiplier**k), scaled
    down by up to ``jitter`` (seeded uniform) to de-synchronize
    retrying clients."""
    rnd = random.Random(seed)
    out = []
    for k in range(max(0, max_attempts - 1)):
        d = min(max_delay, base_delay * (multiplier ** k))
        if jitter:
            d *= 1.0 - jitter * rnd.random()
        out.append(d)
    return out


def retry_call(fn, *args, max_attempts=4, base_delay=0.05, max_delay=2.0,
               multiplier=2.0, jitter=0.5, deadline=None,
               retry_on=(TransientError,), seed=None, sleep=time.sleep,
               clock=time.monotonic, on_retry=None, op_name=None,
               **kwargs):
    """Call ``fn(*args, **kwargs)``, retrying on ``retry_on`` exceptions
    with jittered exponential backoff.

    ``seed=None`` (the default) draws jitter from OS entropy, so a
    fleet of clients that failed TOGETHER retries APART — pass a seed
    only when a test needs to assert the exact schedule.  ``deadline``
    (seconds, measured on ``clock``) bounds the WHOLE operation: a
    retry whose scheduled sleep would land past the deadline is not
    attempted.  ``op_name`` names the operation in the
    ``retry_attempts_total`` metric label (callers almost always pass
    closures, whose ``__name__`` would merge every operation into one
    useless ``<lambda>`` series).  Non-retryable exceptions propagate
    immediately; exhaustion raises :class:`RetryError` from the last
    transient failure."""
    if max_attempts < 1:
        raise ValueError(f"max_attempts must be >= 1, got {max_attempts}")
    delays = backoff_delays(max_attempts, base_delay, max_delay,
                            multiplier, jitter, seed)
    start = clock()
    last = None
    for attempt in range(max_attempts):
        try:
            return fn(*args, **kwargs)
        except retry_on as e:
            last = e
            if attempt >= max_attempts - 1:
                break
            delay = delays[attempt]
            if deadline is not None and (clock() - start) + delay > deadline:
                break
            if on_retry is not None:
                on_retry(attempt, delay, e)
            _count("retry_attempts_total",
                   "backoff retries of transient failures",
                   op=op_name or getattr(fn, "__name__", str(fn)))
            sleep(delay)
    raise RetryError(
        f"{getattr(fn, '__name__', fn)} failed after "
        f"{(attempt + 1)} attempt(s): {last}") from last


def retry(**policy):
    """Decorator form of :func:`retry_call` (same keyword policy).  The
    wrapped call is closed over BEFORE entering retry_call, so the
    decorated function's own kwargs can never collide with (or be
    hijacked by) policy knob names like ``deadline`` or ``seed``."""

    def deco(fn):
        # resolved at DECORATION time into a local: mutating the shared
        # `policy` dict would let the first-called function claim the
        # op label for every other function this decorator wraps
        op = policy.get("op_name") or getattr(fn, "__name__", None)

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            return retry_call(lambda: fn(*args, **kwargs),
                              **{**policy, "op_name": op})

        return wrapped

    return deco


class DegradationRegistry:
    """Process-wide record of control-plane seams permanently switched
    off (a halted rollout, a crash-looping model, a rejected tuned
    config).

    Keys are stable strings under ``fleet.`` or ``tuning.``
    ("fleet.rollout", "fleet.supervisor:<model>",
    "tuning.distributed_config:<store key>").  ``degrade`` is idempotent
    per key — the first event is recorded with its cause, later ones
    only bump the count.  Thread-safe: the router, the fleet's loops
    and the tuning service may all consult it."""

    def __init__(self):
        self._lock = threading.Lock()
        self._events = {}

    def is_degraded(self, key):
        with self._lock:
            return key in self._events

    def degrade(self, key, error=None, detail=None):
        """Mark ``key`` degraded; returns True the FIRST time (so call
        sites can log/record exactly once).  A key outside the control
        plane's families raises ``ValueError``."""
        if not str(key).startswith(CONTROL_PLANE_PREFIXES):
            raise ValueError(
                f"degradation key {key!r} is not a control-plane seam "
                f"(keys start with {' or '.join(CONTROL_PLANE_PREFIXES)}):"
                f" the port never degrades a kernel to a reference path")
        with self._lock:
            ev = self._events.get(key)
            if ev is not None:
                ev["count"] += 1
                first = False
            else:
                self._events[key] = {
                    "key": key,
                    "error": f"{type(error).__name__}: {error}"
                             if error is not None else None,
                    "detail": detail,
                    "count": 1,
                }
                first = True
        # registry mirror (outside the lock): fleet dashboards scrape
        # degradation the same way they scrape latency
        _count("kernel_degradations_total",
               "fast paths permanently degraded to reference", key=key)
        if first:
            # first degradation of a seam is an incident-class moment:
            # capture the flight rings while the lead-up is still in
            # them.  Lazy + best-effort, same rules as _count.
            try:
                from ..observability import flightrec

                flightrec.trigger("degrade", detail=key, key=key)
            except Exception:  # noqa: BLE001 — telemetry never raises
                pass
        return first

    def events(self):
        """JSON-able snapshot, stable order (for stats export)."""
        with self._lock:
            return [dict(self._events[k]) for k in sorted(self._events)]

    def reset(self, key=None):
        """Forget degradations (tests only — production degradation is
        for the life of the process)."""
        with self._lock:
            if key is None:
                self._events.clear()
            else:
                self._events.pop(key, None)


#: The process-wide registry the fleet and the tuning plane consult.
degradations = DegradationRegistry()
