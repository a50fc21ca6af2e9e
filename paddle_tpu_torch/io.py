"""Model I/O: persistables save/load, inference-model freeze, and
carrying weights into the port's scope.

Counterpart of paddle_tpu/io.py (parity: python/paddle/fluid/io.py
save_params :336, save_persistables :556, load_persistables :834,
save/load_inference_model :1022/:1226), in the same on-disk format: one
``__params__.npz`` archive per save, written atomically
(``resilience.atomic``), and a JSON program desc (``Program.to_dict``).
A directory written by one package loads into the other.  Values leave
the scope as host copies of its tensors; loads put numpy arrays into the
scope, which the Executor places on its device (and casts to the
program's runtime dtype: the JAX package's 32-bit int64 counters come
back as int64) at the next run.

``load_params`` differs from the JAX package's (there an alias of
``load_persistables``): the JAX startup's weights come from JAX's PRNG,
which the port cannot reproduce, so ``load_params(scope, arrays, device,
program)`` puts a ``{name: ndarray}`` dict — for example every
persistable of a JAX scope — into a scope of the port, so both packages
train from the same weights.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from .core.program import Parameter, Program, Variable, default_main_program
from .core.scope import global_scope
from .core.types import canonical_dtype, runtime_dtype

__all__ = ["save_vars", "save_params", "save_persistables",
           "load_persistables", "save_inference_model",
           "load_inference_model", "load_params", "persistable_names"]

MODEL_FILENAME = "__model__.json"
PARAMS_FILENAME = "__params__.npz"


def _host(val):
    """A scope value as a numpy array on the host (a copy for tensors on
    the card; a view for CPU tensors, which no op writes in place)."""
    if torch.is_tensor(val):
        return val.detach().cpu().numpy()
    return np.asarray(val)


def _collect(program, scope, predicate, host=_host):
    """{name: host(value)} of the program's variables that ``predicate``
    keeps and the scope holds."""
    from .core.spmd import whole_value

    out = {}
    for var in program.list_vars():
        if predicate(var) and scope.has_var(var.name):
            val = scope.find_var(var.name)
            if val is not None:
                # a mesh's shard is gathered whole (every rank saves)
                out[var.name] = host(whole_value(scope, var.name, val))
    return out


def _params_path(dirname, filename):
    """Canonical archive path.  np.savez appends '.npz' to a suffix-less
    filename; normalizing here (used by both save and load) keeps a
    custom ``filename='weights'`` round-trippable."""
    filename = filename or PARAMS_FILENAME
    if not filename.endswith(".npz"):
        filename += ".npz"
    return os.path.join(dirname, filename)


def save_vars(executor, dirname, vars_dict, filename=None):
    """Atomic archive write (temp + fsync + ``os.replace``, see
    ``resilience.atomic``): a crash (or an injected fault) mid-write can
    only lose the new copy, never truncate an existing one."""
    from .resilience import faults as _faults
    from .resilience.atomic import atomic_output

    os.makedirs(dirname, exist_ok=True)
    path = _params_path(dirname, filename)
    with atomic_output(path) as f:
        np.savez(f, **vars_dict)
        f.flush()
        # the fault fires HERE: temp written, target not yet replaced —
        # the exact crash window the protocol defends
        _faults.maybe_fail("fs_write", path=path)


def save_persistables(executor, dirname, main_program=None, filename=None):
    """Save ALL persistables: params + optimizer state + LR counters."""
    program = main_program or default_main_program()
    data = _collect(program, global_scope(), lambda v: v.persistable)
    save_vars(executor, dirname, data, filename)


def save_params(executor, dirname, main_program=None, filename=None):
    program = main_program or default_main_program()
    data = _collect(program, global_scope(),
                    lambda v: isinstance(v, Parameter))
    save_vars(executor, dirname, data, filename)


def load_persistables(executor, dirname, main_program=None, filename=None):
    program = main_program or default_main_program()
    scope = global_scope()
    names = {v.name for v in program.list_vars() if v.persistable}
    with np.load(_params_path(dirname, filename)) as archive:
        have = set(archive.files)
        missing = sorted(names - have)
        if missing:
            extra = sorted(have - names)
            raise KeyError(
                f"checkpoint at '{dirname}' does not match the program: "
                f"missing persistable(s) {missing}"
                + (f"; archive has extra key(s) {extra}" if extra else ""))
        for name in archive.files:
            if name in names:
                scope.set_var(name, archive[name])


def save_inference_model(dirname, feeded_var_names, target_vars, executor,
                         main_program=None, model_filename=None,
                         params_filename=None):
    """Freeze: prune to the fetch targets, mark test mode, save desc +
    params (parity: io.py:1022)."""
    program = main_program or default_main_program()
    target_vars = [t if isinstance(t, Variable)
                   else program.global_block().var(t)
                   for t in (target_vars
                             if isinstance(target_vars, (list, tuple))
                             else [target_vars])]
    pruned = program.clone(for_test=True).prune(target_vars)
    os.makedirs(dirname, exist_ok=True)
    desc = pruned.to_dict()
    desc["feed_names"] = list(feeded_var_names)
    desc["fetch_names"] = [t.name for t in target_vars]
    with open(os.path.join(dirname, model_filename or MODEL_FILENAME),
              "w") as f:
        json.dump(desc, f)
    data = _collect(pruned, global_scope(), lambda v: v.persistable)
    save_vars(executor, dirname, data, params_filename)
    return [t.name for t in target_vars]


def load_inference_model(dirname, executor, model_filename=None,
                         params_filename=None):
    """Returns (program, feed_target_names, fetch_targets) — parity with
    io.py:1226.  The program runs in test mode."""
    with open(os.path.join(dirname, model_filename or MODEL_FILENAME)) as f:
        desc = json.load(f)
    program = Program.from_dict(desc)
    program._is_test = True
    path = _params_path(dirname, params_filename)
    if os.path.exists(path):
        scope = global_scope()
        with np.load(path) as archive:
            for name in archive.files:
                scope.set_var(name, archive[name])
    blk = program.global_block()
    fetch_targets = [blk.var(n) for n in desc["fetch_names"]]
    return program, desc["feed_names"], fetch_targets


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
