"""Seed folding shared by the Executor and the parallel layer."""
from __future__ import annotations

__all__ = ["fold_seed"]

_MASK64 = (1 << 64) - 1


def fold_seed(seed: int, data: int) -> int:
    """A new 63-bit seed from (seed, data): splitmix64 of their mix —
    the port's counterpart of ``jax.random.fold_in``.  Deterministic and
    platform-independent, so a step's random ops draw the same streams
    on every run of the same program and seed."""
    z = (seed * 0x9E3779B97F4A7C15 + data + 0x632BE59BD9B4E019) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1
