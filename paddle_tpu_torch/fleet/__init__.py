"""paddle_tpu_torch.fleet — elastic autoscaling, multi-model multiplexing
and rolling weight swap on top of the cluster tier.

Three pieces, composable but independent:

* :class:`~paddle_tpu_torch.fleet.autoscaler.Autoscaler` — a policy loop
  that reads the router's per-model registry signals each tick and
  launches (``pool.spawn_worker`` → warm → ``router.attach_worker``)
  or drains (``router.drain_worker`` → ``pool.retire``) workers, so
  capacity follows load with zero dropped requests.
* :class:`~paddle_tpu_torch.fleet.policy.ScalePolicy` /
  :class:`~paddle_tpu_torch.fleet.policy.HysteresisPolicy` — pluggable
  decision rules (watermark hysteresis + debounce + cooldown, with an
  injectable clock).
* :class:`~paddle_tpu_torch.fleet.rollout.RollingSwap` — worker-by-worker
  model version rollout behind the router with a parity canary; a
  mismatch aborts with the old version still serving and degrades the
  ``fleet.rollout`` seam permanently.
* :class:`~paddle_tpu_torch.fleet.supervisor.Supervisor` — self-healing: a
  crashed worker respawns (warming-gauge discipline, admission never
  sees cold capacity) with per-model crash-loop backoff; an exhausted
  budget degrades ``fleet.supervisor:<model>`` permanently and fires
  one flight-recorder incident bundle.

Counterpart of paddle_tpu/fleet, copied: the same classes, decisions,
metrics and degradation keys over the port's cluster tier (router,
``WorkerPool`` of engine processes on the card, ``cluster.testing``'s
fakes).  ``SUPERVISOR_DEGRADE_KEY`` and ``ROLLOUT_DEGRADE_KEY`` are
control-plane seams of the port's degradation registry
(``resilience.retry``).
"""
from .autoscaler import Autoscaler
from .policy import (HysteresisPolicy, ScaleDecision, ScalePolicy,
                     ScaleSignals)
from .rollout import DEGRADE_KEY as ROLLOUT_DEGRADE_KEY
from .rollout import RollingSwap, RolloutResult
from .supervisor import DEGRADE_KEY as SUPERVISOR_DEGRADE_KEY
from .supervisor import Supervisor

__all__ = ["Autoscaler", "HysteresisPolicy", "ScaleDecision",
           "ScalePolicy", "ScaleSignals", "RollingSwap",
           "RolloutResult", "ROLLOUT_DEGRADE_KEY", "Supervisor",
           "SUPERVISOR_DEGRADE_KEY"]
