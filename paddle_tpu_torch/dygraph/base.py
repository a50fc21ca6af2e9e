"""Dygraph (imperative) mode switch and basics (parity:
python/paddle/fluid/dygraph/base.py — guard :111, to_variable :176,
no_grad; framework.py in_dygraph_mode).

Counterpart of paddle_tpu/dygraph/base.py.  Eager mode runs the same
registered op functions as the Executor, immediately, on torch tensors;
torch's autograd records them (engine.py).  ``guard(place)`` also picks
the device eager tensors live on: the card unless the caller asks for
the CPU (``guard("cpu")`` or ``guard(CPUPlace())``, as the tests do).
"""
from __future__ import annotations

import contextlib

import numpy as np

_in_dygraph: bool = False
_train_mode: bool = True  # analog of the tracer's train/eval switch
#: the device of the innermost guard (None: the card, resolved at use)
_device = None


def enabled() -> bool:
    return _in_dygraph


# framework.py parity alias
def in_dygraph_mode() -> bool:
    return _in_dygraph


def _set_mode(on: bool):
    global _in_dygraph
    _in_dygraph = bool(on)


def train_mode() -> bool:
    return _train_mode


def _set_train_mode(on: bool):
    global _train_mode
    _train_mode = bool(on)


def _resolve(place):
    from .._device import resolve_device

    if place is not None and hasattr(place, "torch_device"):
        return place.torch_device()
    return resolve_device(place)


def current_device():
    """The device eager tensors are created on: the innermost guard's,
    else the card (RuntimeError without one)."""
    global _device
    if _device is None:
        _device = _resolve(None)
    return _device


@contextlib.contextmanager
def guard(place=None):
    """``with dygraph.guard():`` — enable imperative execution (parity:
    dygraph/base.py:111).  ``place``: None (the card; RuntimeError
    without one), a device string or ``torch.device``, or a Place."""
    global _device
    prev, prev_device = _in_dygraph, _device
    _device = _resolve(place)
    _set_mode(True)
    try:
        yield
    finally:
        _set_mode(prev)
        _device = prev_device


@contextlib.contextmanager
def no_grad():
    """Disable recording (parity: dygraph.no_grad): the engine's flag
    and ``torch.no_grad``."""
    import torch

    from . import engine

    prev = engine._grad_enabled
    engine._grad_enabled = False
    try:
        with torch.no_grad():
            yield
    finally:
        engine._grad_enabled = prev


def to_variable(value, name=None, zero_copy=None):
    """numpy / list / VarBase -> VarBase on the guard's device (parity:
    dygraph/base.py:176); float64 becomes float32."""
    from .varbase import VarBase

    if isinstance(value, VarBase):
        return value
    arr = np.asarray(value)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    return VarBase(arr, name=name)
