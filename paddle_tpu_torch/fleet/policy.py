"""ScalePolicy — pluggable scale-up/scale-down decision rules.

A policy is a pure-ish object the Autoscaler ticks: it consumes one
model's :class:`ScaleSignals` (queue depth, p99-vs-SLO, in-flight
occupancy, shed rate — the registry signals the router already
scrapes) and returns a :class:`ScaleDecision` (+1 / 0 / -1 workers,
with the reason that lands on ``fleet_scale_events_total``).

The reference implementation, :class:`HysteresisPolicy`, is the
classic watermark loop hardened for a jittery signal:

* separate HIGH and LOW watermarks (hysteresis band — a signal
  hovering at the threshold cannot oscillate the fleet);
* consecutive-tick debounce (``up_ticks`` / ``down_ticks`` ticks in a
  row must agree before acting — one bursty scrape is not a trend);
* cooldown after every action (the fleet needs time to absorb the new
  worker before the signal is trustworthy again);
* hard ``min_workers`` / ``max_workers`` bounds.

The clock is injectable (``clock=time.monotonic``), the same
testability seam as ``resilience.retry.retry_call`` — tests drive the
whole schedule with a fake clock and zero real sleeps.

Counterpart of paddle_tpu/fleet/policy.py, copied (pure Python: the
same decisions step for step on the same clock and signals).
"""
from __future__ import annotations

import dataclasses
import time

__all__ = ["ScaleSignals", "ScaleDecision", "ScalePolicy",
           "HysteresisPolicy"]


@dataclasses.dataclass
class ScaleSignals:
    """One model's load picture for one tick (from
    ``Router.fleet_signals()`` plus the autoscaler's own deltas)."""

    queue_depth: int = 0
    workers: int = 0          # routable (alive, not draining)
    draining: int = 0
    inflight: int = 0
    p99_ms: float = None      # router-observed, None before traffic
    shed_rate: float = 0.0    # sheds since the previous tick
    occupancy: float = None   # inflight / workers unless overridden
    # worker-side truth (TelemetryScraper.worker_signals) — None when
    # no scraper is wired or the workers expose no such series
    kv_occupancy: float = None       # mean KV page-pool occupancy
    prefix_hit_rate: float = None    # prefix-cache hit ratio
    spec_accept_ratio: float = None  # spec-decode accepted/drafted
    # SLO advisory (observability.slo.SloEngine.paging()): True while
    # any objective's error budget burns at page severity — an
    # overload vote even when router-side proxies look calm
    slo_page: bool = False

    def __post_init__(self):
        if self.occupancy is None and self.workers > 0:
            self.occupancy = self.inflight / self.workers


@dataclasses.dataclass
class ScaleDecision:
    """delta: +1 launch, -1 drain, 0 hold; reason lands on the
    ``fleet_scale_events_total`` series when the autoscaler acts."""

    delta: int = 0
    reason: str = "steady"


class ScalePolicy:
    """Base contract: ``decide(signals) -> ScaleDecision``.  Policies
    may keep per-model state (debounce counters, cooldown stamps) —
    the Autoscaler instantiates one policy object per model."""

    def decide(self, signals):
        raise NotImplementedError

    def clone(self):
        """A fresh instance with the same knobs (per-model state must
        not leak across models)."""
        raise NotImplementedError


class HysteresisPolicy(ScalePolicy):
    def __init__(self, min_workers=1, max_workers=4,
                 high_queue_depth=8, low_queue_depth=0,
                 slo_p99_ms=None, shed_is_overload=True,
                 up_ticks=2, down_ticks=5, cooldown_s=10.0,
                 clock=time.monotonic):
        if min_workers < 1:
            raise ValueError("min_workers must be >= 1 (a model with "
                             "zero workers is cold, not scaled-down)")
        if max_workers < min_workers:
            raise ValueError("max_workers < min_workers")
        if low_queue_depth >= high_queue_depth:
            raise ValueError("hysteresis band requires "
                             "low_queue_depth < high_queue_depth")
        self.min_workers = int(min_workers)
        self.max_workers = int(max_workers)
        self.high_queue_depth = int(high_queue_depth)
        self.low_queue_depth = int(low_queue_depth)
        self.slo_p99_ms = slo_p99_ms
        self.shed_is_overload = bool(shed_is_overload)
        self.up_ticks = max(1, int(up_ticks))
        self.down_ticks = max(1, int(down_ticks))
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self._hot = 0       # consecutive overloaded ticks
        self._cold = 0      # consecutive idle ticks
        self._last_action_t = None

    def clone(self):
        return HysteresisPolicy(
            min_workers=self.min_workers, max_workers=self.max_workers,
            high_queue_depth=self.high_queue_depth,
            low_queue_depth=self.low_queue_depth,
            slo_p99_ms=self.slo_p99_ms,
            shed_is_overload=self.shed_is_overload,
            up_ticks=self.up_ticks, down_ticks=self.down_ticks,
            cooldown_s=self.cooldown_s, clock=self._clock)

    # -- classification ----------------------------------------------------
    def _overload_reason(self, s):
        if s.queue_depth >= self.high_queue_depth:
            return f"queue_depth>={self.high_queue_depth}"
        if (self.slo_p99_ms is not None and s.p99_ms is not None
                and s.p99_ms > self.slo_p99_ms and s.queue_depth > 0):
            return f"p99>{self.slo_p99_ms}ms"
        if self.shed_is_overload and s.shed_rate > 0:
            return "shedding"
        if s.slo_page:
            return "slo_burn"
        return None

    def _idle(self, s):
        if s.queue_depth > self.low_queue_depth or s.shed_rate > 0 \
                or s.slo_page:
            return False
        if (self.slo_p99_ms is not None and s.p99_ms is not None
                and s.p99_ms > self.slo_p99_ms):
            return False
        # a fully-occupied fleet is not idle even with an empty queue
        return s.inflight < max(1, s.workers)

    # -- the decision ------------------------------------------------------
    def decide(self, s):
        reason = self._overload_reason(s)
        if reason is not None:
            self._hot += 1
            self._cold = 0
        elif self._idle(s):
            self._cold += 1
            self._hot = 0
        else:
            self._hot = self._cold = 0
        now = self._clock()
        if (self._last_action_t is not None
                and now - self._last_action_t < self.cooldown_s):
            return ScaleDecision(0, "cooldown")
        if self._hot >= self.up_ticks:
            if s.workers + s.draining >= self.max_workers:
                return ScaleDecision(0, "at_max_workers")
            self._hot = 0
            self._last_action_t = now
            return ScaleDecision(+1, reason)
        if self._cold >= self.down_ticks:
            if s.workers <= self.min_workers:
                return ScaleDecision(0, "at_min_workers")
            self._cold = 0
            self._last_action_t = now
            return ScaleDecision(-1, "idle")
        return ScaleDecision(0, "steady")
