"""Expert-parallel sharding rules (counterpart of
paddle_tpu/parallel/moe.py; SURVEY.md §7: the ``expert`` mesh axis).

The moe layer stacks per-expert weights with a leading E dim and marks
them with ``.expert_`` in the parameter name; these rules place that dim
on the ``expert`` axis, so each rank stores E/ep experts and ``moe_ffn``
(ops/moe.py) runs only its own."""
from __future__ import annotations

from .mesh import EXPERT_AXIS

__all__ = ["moe_sharding_rules"]


def moe_sharding_rules(axis=EXPERT_AXIS):
    """[(regex, spec tuple)] for CompiledProgram.with_sharding /
    tp_sharding_rules concatenation: expert-stacked params shard dim 0."""
    return [(r"\.expert_", (axis,))]
