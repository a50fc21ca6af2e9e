"""Deterministic fault injection for the resilience test surface.

Counterpart of paddle_tpu/resilience/faults.py, copied: the plan, its
sites and its hooks are the JAX module's, so one ``FaultPlan`` reads
the same in both packages.  In the port the cluster tier fires
``cluster_rpc`` and ``slow_worker``; nothing fires ``pallas_kernel``
(a port kernel launches or raises, with no fallback to degrade to),
and the training sites come with the training loop's slice.

A :class:`FaultPlan` is a declarative, seeded schedule of failures.
Arming a plan (``with plan.armed():``) turns selected hook points in
the framework into fault sites; a disarmed process pays one module
attribute read per hook (``_ACTIVE is None``), nothing else.

Sites (all occurrence indices are 0-based per-site call counters):

* ``fs_write``      — `io.save_vars` atomic archive writes and
                      `fs.LocalFS.upload/download` copies: raise
                      :class:`InjectedFault` mid-operation (after the
                      temp file exists, before the atomic rename), the
                      exact crash the temp+rename protocol defends
                      against.
* ``dataloader_worker`` — raise inside the `dataio.prefetch`
                      producer thread at chosen item indices.
* ``pallas_kernel`` — raise inside the Pallas fast paths
                      (`generation/attention.py`, `ops/pallas_ops.py`)
                      so the degradation registry's fallback is
                      provable on any backend.
* ``cluster_rpc``   — raise inside `cluster.rpc` request transport at
                      chosen call indices: the router observes it as a
                      worker loss (the connection "died" mid-request),
                      so re-routing is provable without killing a real
                      process.
* ``slow_worker``   — a LATENCY site (``delays=``, not an exception):
                      `cluster.worker.WorkerServicer.handle` sleeps the
                      configured seconds before dispatching, turning a
                      worker into a straggler — the tail the router's
                      hedging exists to cut.  Armed for a whole worker
                      process via the ``PADDLE_TPU_CHAOS_SLOW_MS`` env
                      var (see ``cluster.worker.main``).
* preemption        — :meth:`maybe_preempt` raises :class:`Preempted`
                      at chosen training steps (checked by
                      `resilience.train_loop.ResilientLoop` at the top
                      of each step — "the scheduler killed us before
                      step k ran").
* NaN loss          — :meth:`corrupt_feed` poisons every float feed of
                      chosen steps with NaN, so the non-finite value
                      flows through the real loss/grad computation
                      (not just a spoofed fetch) and the skip-step
                      guard's rollback is exercised end to end.

Determinism: explicit occurrence/step lists are exact; the optional
per-site ``rates`` draw from ``random.Random(seed)`` streams that are
private per site, so two runs of the same plan inject identically.
"""
from __future__ import annotations

import random
import threading

__all__ = ["InjectedFault", "Preempted", "FaultPlan", "maybe_fail",
           "maybe_delay", "active_plan"]


class InjectedFault(RuntimeError):
    """An artificial failure delivered by an armed FaultPlan."""


class Preempted(Exception):
    """Simulated preemption (the SIGTERM/eviction analog).  Deliberately
    NOT a RuntimeError so generic ``except RuntimeError`` recovery code
    cannot accidentally swallow a kill."""


_ACTIVE = None
_LOCK = threading.Lock()


class FaultPlan:
    """Seeded, declarative fault schedule.

    ``fs_write_failures`` / ``worker_failures`` / ``kernel_failures`` /
    ``rpc_failures``:
    iterables of 0-based call indices at which that site raises.
    ``preempt_steps`` / ``nan_loss_steps``: training step numbers.
    ``rates``: optional {site: probability} for seeded random injection
    on top of the explicit lists.
    ``delays``: optional {site: seconds} for LATENCY sites — the hook
    sleeps instead of raising (``slow_worker`` is the one shipped
    consumer)."""

    def __init__(self, seed=0, fs_write_failures=(), worker_failures=(),
                 kernel_failures=(), rpc_failures=(), preempt_steps=(),
                 nan_loss_steps=(), rates=None, delays=None):
        self.seed = seed
        self._sites = {
            "fs_write": frozenset(fs_write_failures),
            "dataloader_worker": frozenset(worker_failures),
            "pallas_kernel": frozenset(kernel_failures),
            "cluster_rpc": frozenset(rpc_failures),
        }
        self.preempt_steps = frozenset(preempt_steps)
        self.nan_loss_steps = frozenset(nan_loss_steps)
        self._rates = dict(rates or {})
        self._delays = dict(delays or {})
        self._lock = threading.Lock()
        self._calls = {}      # site -> calls observed
        self._fired = {}      # site -> faults delivered
        self._rngs = {}       # site -> private seeded stream

    # -- arming ------------------------------------------------------------
    def armed(self):
        """Context manager installing this plan as the process-wide
        active plan (one at a time; nesting is an error)."""
        plan = self

        class _Armed:
            def __enter__(self):
                global _ACTIVE
                with _LOCK:
                    if _ACTIVE is not None:
                        raise RuntimeError("another FaultPlan is armed")
                    _ACTIVE = plan
                return plan

            def __exit__(self, *exc):
                global _ACTIVE
                with _LOCK:
                    _ACTIVE = None
                return False

        return _Armed()

    def arm(self):
        """Non-context arming for PROCESS-LIFETIME plans (a worker
        process armed at startup has no scope to exit)."""
        global _ACTIVE
        with _LOCK:
            if _ACTIVE is not None:
                raise RuntimeError("another FaultPlan is armed")
            _ACTIVE = self
        return self

    def disarm(self):
        global _ACTIVE
        with _LOCK:
            if _ACTIVE is self:
                _ACTIVE = None

    # -- accounting --------------------------------------------------------
    def calls(self, site):
        with self._lock:
            return self._calls.get(site, 0)

    def fired(self, site):
        with self._lock:
            return self._fired.get(site, 0)

    # -- injection decisions -----------------------------------------------
    def _should_fire(self, site, index):
        if index in self._sites.get(site, ()):
            return True
        rate = self._rates.get(site, 0.0)
        if rate > 0.0:
            # string seed: stable across runs AND accepted on 3.11+
            # (tuple seeding was removed from random.Random)
            rng = self._rngs.setdefault(
                site, random.Random(f"{self.seed}:{site}"))
            return rng.random() < rate
        return False

    def check(self, site, **info):
        """Hook body: count the call and raise if this occurrence is in
        the plan."""
        with self._lock:
            index = self._calls.get(site, 0)
            self._calls[site] = index + 1
            fire = self._should_fire(site, index)
            if fire:
                self._fired[site] = self._fired.get(site, 0) + 1
        if fire:
            where = ", ".join(f"{k}={v}" for k, v in sorted(info.items()))
            raise InjectedFault(
                f"injected fault at site '{site}' occurrence {index}"
                + (f" ({where})" if where else ""))

    def delay_for(self, site):
        """Latency-site hook body: seconds to sleep at this site (0.0
        when the plan configures none); counts calls/fired like
        :meth:`check`."""
        d = float(self._delays.get(site, 0.0))
        with self._lock:
            self._calls[site] = self._calls.get(site, 0) + 1
            if d > 0.0:
                self._fired[site] = self._fired.get(site, 0) + 1
        return d

    def maybe_preempt(self, step):
        if step in self.preempt_steps:
            with self._lock:
                self._fired["preempt"] = self._fired.get("preempt", 0) + 1
            raise Preempted(f"simulated preemption before step {step}")

    def corrupt_feed(self, step, feed):
        """Poison float arrays of this step's feed with NaN (returns a
        new dict; integer feeds pass through untouched)."""
        import numpy as np

        if step not in self.nan_loss_steps:
            return feed
        with self._lock:
            self._fired["nan_loss"] = self._fired.get("nan_loss", 0) + 1
        out = {}
        for name, arr in feed.items():
            a = np.asarray(arr)
            if np.issubdtype(a.dtype, np.floating):
                a = np.full_like(a, np.nan)
            out[name] = a
        return out


def active_plan():
    return _ACTIVE


def maybe_fail(site, **info):
    """Framework-side hook: no-op unless a plan is armed."""
    plan = _ACTIVE
    if plan is not None:
        plan.check(site, **info)


def maybe_delay(site, **info):
    """Framework-side LATENCY hook: sleep the armed plan's configured
    delay for this site (no-op when disarmed or unconfigured)."""
    plan = _ACTIVE
    if plan is not None:
        d = plan.delay_for(site)
        if d > 0.0:
            import time
            time.sleep(d)


def maybe_preempt(step):
    plan = _ACTIVE
    if plan is not None:
        plan.maybe_preempt(step)


def maybe_corrupt_feed(step, feed):
    plan = _ACTIVE
    if plan is None:
        return feed
    return plan.corrupt_feed(step, feed)
