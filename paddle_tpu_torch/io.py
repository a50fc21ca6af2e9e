"""Carrying weights into the port's scope.

The JAX package's startup program draws its weights with JAX's PRNG,
which the port cannot reproduce; ``load_params`` puts a ``{name:
ndarray}`` dict — for example every persistable of a JAX scope, as
``np.asarray(jax_scope.find_var(n))`` — into a scope of the port, so both
packages train from the same weights.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.types import canonical_dtype, runtime_dtype

__all__ = ["load_params", "persistable_names"]


def persistable_names(program):
    """Names of the persistable variables of ``program``'s blocks:
    parameters, the learning rate, optimizer accumulators."""
    return [v.name for v in program.list_vars() if v.persistable]


def _dtype_matches(declared, got):
    """A 64-bit name may arrive narrowed to 32 bits (the JAX package
    keeps int64 / float64 variables in 32 bits)."""
    return got == declared or (declared, got) in (("int64", "int32"),
                                                  ("float64", "float32"))


def load_params(scope, arrays, device, program=None):
    """Put ``arrays`` ({name: array}) into ``scope`` as tensors on
    ``device``.  With ``program``, every name must be one of its
    persistables with the declared shape and dtype, and every persistable
    must be given: a missing, unknown or mismatched name raises."""
    device = torch.device(device)
    declared = {}
    if program is not None:
        declared = {v.name: v for v in program.list_vars() if v.persistable}
        unknown = sorted(set(arrays) - set(declared))
        missing = sorted(set(declared) - set(arrays))
        if unknown or missing:
            raise KeyError(
                f"load_params: unknown names {unknown}, missing "
                f"persistables {missing}")
    for name, value in arrays.items():
        arr = np.asarray(value)
        var = declared.get(name)
        if var is not None:
            if var.shape is not None and tuple(arr.shape) != tuple(var.shape):
                raise ValueError(
                    f"load_params: '{name}' has shape {arr.shape}, the "
                    f"program declares {tuple(var.shape)}")
            got = canonical_dtype(arr.dtype)
            if var.dtype is not None and not _dtype_matches(var.dtype, got):
                raise TypeError(
                    f"load_params: '{name}' has dtype {got}, the program "
                    f"declares {var.dtype}")
        dtype = runtime_dtype(var.dtype if var is not None and var.dtype
                              else canonical_dtype(arr.dtype))
        scope.set_var(name, torch.tensor(arr, dtype=dtype, device=device))
