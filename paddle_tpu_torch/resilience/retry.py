"""Retry with jittered exponential backoff.

Counterpart of paddle_tpu/resilience/retry.py (`TransientError`,
`RetryError`, `backoff_delays`, `retry_call`, `retry`, copied): the
cluster control plane's connect loop retries through
:func:`retry_call`.  The jitter stream is seeded, and both the clock
and the sleep function are injectable, so tests assert the exact
backoff schedule against a fake clock with zero real sleeping.

Only transient failures are retried: :class:`TransientError` is the
marker type (`cluster.rpc.WorkerUnavailable` derives from it).  The
JAX module's ``DegradationRegistry`` is not here: the port never falls
back from a kernel to a reference path.
"""
from __future__ import annotations

import functools
import random
import time

__all__ = ["TransientError", "RetryError", "retry", "retry_call",
           "backoff_delays"]


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
