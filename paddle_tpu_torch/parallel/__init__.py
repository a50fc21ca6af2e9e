"""Parallel training over process groups (counterpart of
paddle_tpu.parallel): named device meshes over ``torch.distributed``,
placements, pipeline schedules, expert rules and sequence parallelism.

* ``mesh`` — the axis names, ``build_mesh`` over ``init_device_mesh``,
  ``LocalMesh`` (this process alone, no group), the current-mesh
  context, and the placement descriptors ``replicated`` and
  ``batch_sharding`` (``Sharding``) the Executor reads;
* ``pipeline`` — GPipe (``gpipe``, ``gpipe_het``) and 1F1B over a
  ``pipe`` axis, with their microbatch helpers;
* ``moe`` — ``moe_sharding_rules`` for the ``expert`` axis;
* ``ring_attention`` — ring attention and Ulysses.
"""
from .mesh import (  # noqa: F401
    DATA_AXIS,
    EXPERT_AXIS,
    MODEL_AXIS,
    PIPE_AXIS,
    SEQ_AXIS,
    LocalMesh,
    Sharding,
    batch_sharding,
    build_mesh,
    current_mesh,
    replicated,
    set_current_mesh,
    single_device_mesh,
)
from .moe import moe_sharding_rules  # noqa: F401
from .pipeline import (  # noqa: F401
    gpipe,
    gpipe_het,
    merge_microbatches,
    one_f_one_b,
    split_microbatches,
)
from .ring_attention import ring_attention, ulysses_attention  # noqa: F401

__all__ = ["DATA_AXIS", "EXPERT_AXIS", "MODEL_AXIS", "PIPE_AXIS",
           "SEQ_AXIS", "LocalMesh", "Sharding", "batch_sharding",
           "build_mesh", "current_mesh", "replicated",
           "set_current_mesh", "single_device_mesh", "moe_sharding_rules",
           "gpipe", "gpipe_het", "merge_microbatches", "one_f_one_b",
           "split_microbatches", "ring_attention", "ulysses_attention"]
