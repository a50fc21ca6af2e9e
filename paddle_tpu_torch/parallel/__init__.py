"""Parallel training over process groups (counterpart of
paddle_tpu.parallel): named device meshes over ``torch.distributed`` and
sequence parallelism (ring attention, Ulysses).

Ported so far: ``mesh`` (the axis names, ``build_mesh`` over
``init_device_mesh``, the current-mesh context) and ``ring_attention``.
The JAX package's ``NamedSharding`` helpers (``replicated``,
``batch_sharding``), ``pipeline`` and ``moe`` are not ported yet.
"""
from .mesh import (  # noqa: F401
    DATA_AXIS,
    EXPERT_AXIS,
    MODEL_AXIS,
    PIPE_AXIS,
    SEQ_AXIS,
    build_mesh,
    current_mesh,
    set_current_mesh,
    single_device_mesh,
)
from .ring_attention import ring_attention, ulysses_attention  # noqa: F401

__all__ = ["DATA_AXIS", "EXPERT_AXIS", "MODEL_AXIS", "PIPE_AXIS",
           "SEQ_AXIS", "build_mesh", "current_mesh", "set_current_mesh",
           "single_device_mesh", "ring_attention", "ulysses_attention"]
