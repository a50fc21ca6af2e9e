"""paddle_tpu_torch.resilience — what of the JAX package's resilience
layer the port has so far: the atomic file-write protocol
(:mod:`.atomic`), which ``observability.export`` uses.  Checkpoints, the
resilient train loop, retries and fault injection come with their own
slices; the port has no degradation registry (it never falls back).
"""
from __future__ import annotations

from .atomic import atomic_output, fsync_dir  # noqa: F401

__all__ = ["atomic_output", "fsync_dir"]
