"""Dtype names and places of the port.

Counterpart of paddle_tpu/core/types.py.  A dtype is a canonical string
name (the one stored in a VarDesc) mapped onto a torch dtype; a Place
names the device an Executor runs on.

The JAX package runs with x64 disabled and narrows ``int64`` to int32 on
the device.  The port keeps ``int64`` as ``torch.int64`` — torch's index
ops want it — and narrows only ``float64`` (float32 is the compute type
of every kernel here).  Programs carry the same names in both packages;
only the runtime dtype of 64-bit integers differs.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["canonical_dtype", "runtime_dtype", "is_floating", "Place",
           "CPUPlace", "CUDAPlace"]

# Canonical dtype names accepted throughout the framework.
_DTYPE_ALIASES = {
    "float32": "float32",
    "fp32": "float32",
    "float": "float32",
    "float64": "float64",
    "fp64": "float64",
    "double": "float64",
    "float16": "float16",
    "fp16": "float16",
    "half": "float16",
    "bfloat16": "bfloat16",
    "bf16": "bfloat16",
    "int8": "int8",
    "uint8": "uint8",
    "int16": "int16",
    "int32": "int32",
    "int": "int32",
    "int64": "int64",
    "long": "int64",
    "bool": "bool",
    "complex64": "complex64",
}

# What each canonical name becomes once it reaches a device tensor.
_RUNTIME_DTYPE = {
    "float32": torch.float32,
    "float64": torch.float32,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "int8": torch.int8,
    "uint8": torch.uint8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "bool": torch.bool,
    "complex64": torch.complex64,
}


def canonical_dtype(dtype) -> str:
    """Normalize a dtype (str / numpy dtype / torch dtype) to the
    canonical name stored in a VarDesc."""
    if isinstance(dtype, torch.dtype):
        name = str(dtype).replace("torch.", "")
    elif isinstance(dtype, str):
        name = dtype
    else:
        try:
            name = np.dtype(dtype).name
        except TypeError:
            name = str(dtype)
    canon = _DTYPE_ALIASES.get(name)
    if canon is None:
        raise ValueError(f"Unsupported dtype: {dtype!r}")
    return canon


def runtime_dtype(name: str) -> torch.dtype:
    """The torch dtype a canonical name has on the device."""
    return _RUNTIME_DTYPE[canonical_dtype(name)]


def is_floating(name: str) -> bool:
    return name in ("float32", "float64", "float16", "bfloat16")


class Place:
    """Device placement descriptor: ``torch_device()`` is where an
    Executor puts feeds, parameters and every op's outputs."""

    def __init__(self, device_id: int = 0):
        self.device_id = device_id

    def torch_device(self) -> torch.device:
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}({self.device_id})"


class CPUPlace(Place):
    def torch_device(self):
        return torch.device("cpu")


class CUDAPlace(Place):
    """One CUDA card; raises when none is visible (no silent CPU)."""

    def torch_device(self):
        from .._device import resolve_device

        return resolve_device(f"cuda:{self.device_id}")
