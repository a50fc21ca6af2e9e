"""Operator registry of the port.

Counterpart of paddle_tpu/core/registry.py.  An op is one compute
function over torch tensors; its gradient comes from one generic
mechanism (core/backward.py emits ``vjp_grad`` ops, core/lowering.py
runs the forward op under autograd and calls ``torch.autograd.grad``),
so there are no per-op grad makers.

An OpDef:
  * ``compute(ctx, inputs, attrs) -> outputs`` where inputs/outputs are
    ``{slot_name: [tensor, ...]}`` dicts (the reference's slot-of-list
    op signature);
  * ``ctx`` is an OpContext: the op's random seed, train/eval mode, its
    attrs and the device that tensors it creates from nothing go to;
  * shape inference is generic: the compute function runs on ``meta``
    tensors at program-build time (see program.py), so every compute
    must take meta tensors without launching anything.

An op the port has not registered still builds into a program; running
it raises NotImplementedError naming the op.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch


@dataclasses.dataclass
class OpContext:
    """Runtime context handed to every op compute function."""

    # int seed of this op for this step (random ops turn it into a
    # torch.Generator or a kernel's Philox key), or None
    rng: Optional[int] = None
    is_test: bool = False
    attrs: dict = dataclasses.field(default_factory=dict)
    # where ops with no tensor input (fill_constant, range, random init)
    # create their outputs; "meta" during shape inference
    device: torch.device = torch.device("cpu")


@dataclasses.dataclass
class OpDef:
    type: str
    compute: Callable  # (ctx, inputs: dict[str, list], attrs: dict) -> dict
    input_slots: tuple = ()
    output_slots: tuple = ()
    needs_rng: bool = False
    # inputs never differentiated (e.g. integer index slots) — advisory
    no_grad_slots: tuple = ()


class OpRegistry:
    def __init__(self):
        self._ops: dict[str, OpDef] = {}

    def register(self, opdef: OpDef):
        if opdef.type in self._ops:
            raise ValueError(f"Op '{opdef.type}' registered twice")
        self._ops[opdef.type] = opdef
        return opdef

    def get(self, op_type: str) -> OpDef:
        opdef = self._ops.get(op_type)
        if opdef is None:
            raise NotImplementedError(
                f"operator '{op_type}' is not ported to paddle_tpu_torch; "
                f"ported: {', '.join(sorted(self._ops))}")
        return opdef

    def has(self, op_type: str) -> bool:
        return op_type in self._ops


REGISTRY = OpRegistry()


def register_op(type: str, inputs: tuple = (), outputs: tuple = ("Out",),
                needs_rng: bool = False, no_grad_slots: tuple = ()):
    """Decorator: register ``fn(ctx, inputs, attrs) -> dict`` as an
    operator."""

    def deco(fn):
        REGISTRY.register(OpDef(
            type=type, compute=fn, input_slots=tuple(inputs),
            output_slots=tuple(outputs), needs_rng=needs_rng,
            no_grad_slots=tuple(no_grad_slots)))
        return fn

    return deco


# ---- small helpers used by op implementations ----------------------------


def single(inputs: dict, slot: str, default=None):
    """Fetch the single tensor bound to a slot (most slots hold one var)."""
    vals = inputs.get(slot) or []
    if not vals:
        return default
    if len(vals) != 1:
        raise ValueError(f"Slot {slot} expected 1 tensor, got {len(vals)}")
    return vals[0]


def out(**kwargs) -> dict:
    """Build an outputs dict from keyword single tensors / lists."""
    return {
        k: (v if isinstance(v, (list, tuple)) else [v])
        for k, v in kwargs.items()
        if v is not None
    }
