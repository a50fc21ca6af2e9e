"""paddle_tpu_torch.resilience — what of the JAX package's resilience
layer the port has so far: the atomic file-write protocol
(:mod:`.atomic`), which ``observability.export`` uses; retries with
jittered backoff (:mod:`.retry`) and seeded fault injection
(:mod:`.faults`), which the cluster tier uses.  Checkpoints and the
resilient train loop come with their own slice; the port has no
degradation registry (it never falls back).
"""
from __future__ import annotations

from .atomic import atomic_output, fsync_dir  # noqa: F401
from .faults import (FaultPlan, InjectedFault, Preempted,  # noqa: F401
                     active_plan, maybe_delay, maybe_fail)
from .retry import (RetryError, TransientError, backoff_delays,  # noqa: F401
                    retry, retry_call)

__all__ = ["atomic_output", "fsync_dir", "FaultPlan", "InjectedFault",
           "Preempted", "active_plan", "maybe_delay", "maybe_fail",
           "RetryError", "TransientError", "backoff_delays", "retry",
           "retry_call"]
