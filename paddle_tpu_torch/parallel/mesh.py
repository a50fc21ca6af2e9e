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
environment.  Without a process group, ``LocalMesh`` is the one-rank
mesh of this process (no group, no collective: the JAX package's
one-device mesh).

``Sharding`` is the placement descriptor the Executor reads (the JAX
package's ``NamedSharding``): a mesh and a spec, one entry per leading
dim — ``None`` (whole), an axis name, or a tuple of axis names (major
first) whose ranks split that dim in row-major order.  ``replicated``
and ``batch_sharding`` make the two common ones.  ``groups`` stores a
split dim that packs g equal blocks (a fused qkv projection's [q | k |
v] columns) head-grouped: rank r holds block r of each group, side by
side (``[q_r | k_r | v_r]``), so its shard holds whole heads; ``local``
and ``gather`` convert between that and the whole tensor's order.
"""
from __future__ import annotations

import dataclasses
import math

import torch
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


class LocalMesh:
    """A mesh of this process alone: every axis has size 1 and no group
    (``get_group`` is ``None``, which the collectives take as the
    identity).  What ``CompiledProgram.with_data_parallel()`` runs on
    when no process group is initialized."""

    def __init__(self, axes=None, device_type=None):
        axes = dict(axes or {DATA_AXIS: 1})
        if any(v not in (1, -1) for v in axes.values()):
            raise ValueError(f"a mesh {axes} over more than one process "
                             f"needs an initialized process group")
        self.mesh_dim_names = tuple(axes)
        self.mesh = torch.zeros([1] * len(axes), dtype=torch.int64)
        self.device_type = resolve_device(device_type).type

    def get_group(self, mesh_dim=None):
        return None

    def get_local_rank(self, mesh_dim=None):
        return 0

    def __repr__(self):
        return f"LocalMesh({dict.fromkeys(self.mesh_dim_names, 1)})"


def axis_names(mesh):
    return tuple(mesh.mesh_dim_names or ()) if mesh is not None else ()


def axis_size(mesh, axis):
    """Size of ``axis`` on ``mesh`` (1 for a mesh without it, or None)."""
    names = axis_names(mesh)
    if axis not in names:
        return 1
    return int(mesh.mesh.shape[names.index(axis)])


def axis_rank(mesh, axis):
    """This process's coordinate on ``axis`` (0 without it)."""
    if axis not in axis_names(mesh):
        return 0
    return int(mesh.get_local_rank(axis))


def axis_group(mesh, axis):
    """The process group of ``axis`` (None: no such axis, or no group)."""
    if axis not in axis_names(mesh):
        return None
    return mesh.get_group(axis)


def _axes_of(entry):
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A placement: ``spec[i]`` names the mesh axes that split dim ``i``
    (the dims past the spec are whole)."""

    mesh: object
    spec: tuple = ()
    #: per dim, how many equal blocks the split keeps together (1: none)
    groups: tuple = ()

    @property
    def is_replicated(self):
        return all(not _axes_of(e) for e in self.spec)

    def group_count(self, dim):
        return self.groups[dim] if dim < len(self.groups) else 1

    def without(self, axis):
        """This placement with ``axis`` dropped from every entry: the
        slicing left to do on a value already split over ``axis``."""
        spec = []
        for e in self.spec:
            rest = tuple(a for a in _axes_of(e) if a != axis)
            spec.append(None if not rest else
                        rest[0] if len(rest) == 1 else rest)
        return Sharding(self.mesh, tuple(spec))

    def parts(self, dim):
        return math.prod(axis_size(self.mesh, a)
                         for a in _axes_of(self.spec[dim])) \
            if dim < len(self.spec) else 1

    def index(self, dim):
        """This rank's shard index along ``dim`` (row-major over the
        entry's axes)."""
        idx = 0
        for a in _axes_of(self.spec[dim]) if dim < len(self.spec) else ():
            idx = idx * axis_size(self.mesh, a) + axis_rank(self.mesh, a)
        return idx

    def shard_shape(self, shape):
        shape = list(shape)
        for d in range(min(len(self.spec), len(shape))):
            k = self.parts(d)
            if shape[d] % (k * self.group_count(d)):
                raise ValueError(
                    f"dim {d} of {tuple(shape)} does not split into {k} "
                    f"shards over {_axes_of(self.spec[d])}"
                    + (f" in {self.group_count(d)} groups"
                       if self.group_count(d) > 1 else ""))
            shape[d] //= k
        return tuple(shape)

    def local(self, x):
        """This rank's shard of the full tensor ``x``."""
        self.shard_shape(x.shape)
        for d in range(min(len(self.spec), x.dim())):
            k = self.parts(d)
            if k > 1:
                x = take_block(x, d, k, self.index(d), self.group_count(d))
        return x

    def gather(self, x):
        """The full tensor from this rank's shard ``x`` (an all-gather
        over each splitting axis, innermost first; no autograd)."""
        from ._collectives import gather_along

        for d in range(min(len(self.spec), x.dim())):
            k = 1
            for a in reversed(_axes_of(self.spec[d])):
                if axis_size(self.mesh, a) > 1:
                    x = gather_along(x, axis_group(self.mesh, a), d)
                    k *= axis_size(self.mesh, a)
            if k > 1:
                x = ungroup(x, d, k, self.group_count(d))
        return x


def take_block(x, dim, parts, index, groups=1):
    """Block ``index`` of ``parts`` along ``dim``, taken in each of
    ``groups`` equal groups and the pieces laid side by side."""
    n = x.shape[dim] // (parts * groups)
    if groups == 1:
        return x.narrow(dim, index * n, n)
    shape = tuple(x.shape)
    v = x.reshape(shape[:dim] + (groups, parts, n) + shape[dim + 1:])
    return v.select(dim + 1, index).reshape(
        shape[:dim] + (groups * n,) + shape[dim + 1:])


def ungroup(x, dim, parts, groups=1):
    """The whole tensor's order from the ranks' shards concatenated in
    rank order along ``dim`` (the inverse of ``take_block`` over every
    index)."""
    if groups == 1:
        return x
    shape = tuple(x.shape)
    n = shape[dim] // (parts * groups)
    v = x.reshape(shape[:dim] + (parts, groups, n) + shape[dim + 1:])
    return v.transpose(dim, dim + 1).reshape(shape)


def replicated(mesh):
    """Every rank holds the whole value."""
    return Sharding(mesh, ())


def batch_sharding(mesh, axis=DATA_AXIS):
    """Dim 0 (the batch) split over ``axis`` (an axis name or a tuple of
    them); the other dims whole."""
    return Sharding(mesh, (axis,))
