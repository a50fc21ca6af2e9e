"""paddle_tpu_torch.resilience — the JAX package's resilience layer on
the port: the atomic file-write protocol (:mod:`.atomic`); retries with
jittered backoff (:mod:`.retry`) and seeded fault injection
(:mod:`.faults`); atomic, versioned, checksummed checkpoints
(:mod:`.checkpoint`, :class:`CheckpointManager`) and the auto-resuming,
NaN-guarded train loop (:mod:`.train_loop`, :class:`ResilientLoop`).
The degradation registry (:data:`degradations`) holds the control
plane's permanent decisions only (``fleet.*``, ``tuning.*`` keys): the
port never falls back from a kernel.

``CheckpointManager``, ``CheckpointError``, ``ResilientLoop`` and
``NonFiniteLossError`` resolve lazily, as in the JAX package: the
checkpoint module imports ``io`` and the program IR, which import this
package's ``faults`` and ``atomic`` leaves.
"""
from __future__ import annotations

import importlib

from .atomic import atomic_output, fsync_dir  # noqa: F401
from .faults import (FaultPlan, InjectedFault, Preempted,  # noqa: F401
                     active_plan, maybe_delay, maybe_fail)
from .retry import (DegradationRegistry, RetryError,  # noqa: F401
                    TransientError, backoff_delays, degradations, retry,
                    retry_call)

_LAZY = {
    "CheckpointManager": ".checkpoint",
    "CheckpointError": ".checkpoint",
    "ResilientLoop": ".train_loop",
    "NonFiniteLossError": ".train_loop",
}


def __getattr__(name):
    if name in ("checkpoint", "train_loop"):
        return importlib.import_module(f".{name}", __name__)
    target = _LAZY.get(name)
    if target is not None:
        return getattr(importlib.import_module(target, __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["atomic_output", "fsync_dir", "FaultPlan", "InjectedFault",
           "Preempted", "active_plan", "maybe_delay", "maybe_fail",
           "RetryError", "TransientError", "backoff_delays", "retry",
           "retry_call", "DegradationRegistry", "degradations", "checkpoint", "train_loop", *_LAZY]
