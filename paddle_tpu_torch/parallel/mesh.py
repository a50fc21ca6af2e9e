"""Device meshes over ``torch.distributed`` (counterpart of
paddle_tpu/parallel/mesh.py, whose ``jax.sharding.Mesh`` axes are the
rings): a ``DeviceMesh`` with named dimensions over the processes of the
default group, one device each, whose per-dimension process groups are
the rings.

Axis conventions (used across parallel/ and models/):
  data   - data parallel (gradients all-reduced over this axis's group)
  model  - tensor/model parallel
  pipe   - pipeline stages
  seq    - sequence/context parallel (ring attention)
  expert - expert parallel (MoE)

The caller starts the process group (``init_process_group`` with its
address, world size and rank): nothing here reads a cluster from the
environment.
"""
from __future__ import annotations

import math

import torch.distributed as dist

from .._device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"
PIPE_AXIS = "pipe"
SEQ_AXIS = "seq"
EXPERT_AXIS = "expert"


def build_mesh(axes: dict[str, int] | None = None, device_type=None):
    """A ``DeviceMesh`` from {axis_name: size} over the default group's
    processes, in rank order.  A -1 size absorbs the remaining processes
    (the reference's automatic place discovery).  ``device_type`` is
    ``cuda`` (NCCL) unless the caller asks for ``cpu`` (gloo)."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("build_mesh needs an initialized default process "
                           "group (torch.distributed.init_process_group)")
    world = dist.get_world_size()
    sizes = dict(axes) if axes else {DATA_AXIS: world}
    wildcard = [k for k, v in sizes.items() if v == -1]
    fixed = math.prod(v for v in sizes.values() if v != -1)
    if wildcard:
        if len(wildcard) > 1:
            raise ValueError("only one mesh axis may be -1")
        sizes[wildcard[0]] = world // max(fixed, 1)
    total = math.prod(sizes.values())
    if total != world:
        raise ValueError(f"mesh {sizes} needs {total} processes, the "
                         f"default group has {world}")
    device_type = resolve_device(device_type).type
    return init_device_mesh(device_type, tuple(sizes.values()),
                            mesh_dim_names=tuple(sizes))


# -- active mesh context ----------------------------------------------------
# Ops that need a named axis's group (ring attention) consult this: the
# counterpart of the reference's process-global NCCL ring registry
# (platform/collective_helper.h:62 NCCLCommContext keyed by ring_id).
_current_mesh = None


def set_current_mesh(mesh):
    """Install ``mesh`` as the active mesh; returns the previous one."""
    global _current_mesh
    prev, _current_mesh = _current_mesh, mesh
    return prev


def current_mesh():
    return _current_mesh


def single_device_mesh(device_type=None):
    """A one-process {data: 1} mesh (the default group must hold one
    process)."""
    return build_mesh({DATA_AXIS: 1}, device_type=device_type)
