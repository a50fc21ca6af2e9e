"""Global flags (parity: the reference's gflags tier —
platform/flags.cc ~40 FLAGS_* settable via env, exposed to Python through
global_value_getter_setter.cc and fluid.set_flags / get_flags).

Flags initialize from the environment (``FLAGS_check_nan_inf=1`` works
exactly like the reference) and can be flipped at runtime.

Counterpart of paddle_tpu/flags.py, the same names, defaults and
coercion.  The port reads two of them: ``FLAGS_check_nan_inf`` (the
lowering scans every floating op output, one host sync per op; the
fusion pass is off) and ``FLAGS_benchmark`` (``Executor.run`` waits for
the card after each run).  The others are kept for API parity."""
from __future__ import annotations

import os

__all__ = ["set_flags", "get_flags"]

_DEFAULTS = {
    # correctness guards (platform/flags.cc:44 FLAGS_check_nan_inf)
    "FLAGS_check_nan_inf": False,
    # profiling/benchmark mode (adds per-run sync; reference FLAGS_benchmark)
    "FLAGS_benchmark": False,
    # verbosity (glog v-level analog)
    "FLAGS_v": 0,
    # eager deletion knob kept for API parity (the caching allocator
    # owns buffer lifetimes)
    "FLAGS_eager_delete_tensor_gb": 0.0,
    # allocator strategy kept for API parity (PyTorch's allocator rules)
    "FLAGS_allocator_strategy": "auto_growth",
    # fraction knob kept for API parity
    "FLAGS_fraction_of_gpu_memory_to_use": 0.92,
}


def _coerce(default, value):
    """Coerce a raw (possibly string) value to the flag's type; shared by
    env pickup and set_flags so the two paths can't diverge."""
    if isinstance(default, bool):
        if isinstance(value, str):
            return value.lower() in ("1", "true", "yes", "on")
        return bool(value)
    return type(default)(value)


def _from_env(name, default):
    raw = os.environ.get(name)
    return default if raw is None else _coerce(default, raw)


_FLAGS = {k: _from_env(k, v) for k, v in _DEFAULTS.items()}


def set_flags(flags: dict):
    """fluid.set_flags parity: {"FLAGS_check_nan_inf": True}.

    Only ``FLAGS_check_nan_inf`` and ``FLAGS_benchmark`` change what the
    port does.  ``FLAGS_v``, ``FLAGS_eager_delete_tensor_gb``,
    ``FLAGS_allocator_strategy`` and ``FLAGS_fraction_of_gpu_memory_to_use``
    are stored and read back by ``get_flags``, but nothing in the port
    reads them: setting one has no effect."""
    for k, v in flags.items():
        if k not in _FLAGS:
            raise KeyError(
                f"unknown flag {k!r}; known: {sorted(_FLAGS)}")
        _FLAGS[k] = _coerce(_DEFAULTS[k], v)


def get_flags(names):
    """fluid.get_flags parity: returns {name: value}."""
    if isinstance(names, str):
        names = [names]
    out = {}
    for k in names:
        if k not in _FLAGS:
            raise KeyError(
                f"unknown flag {k!r}; known: {sorted(_FLAGS)}")
        out[k] = _FLAGS[k]
    return out


def flag(name):
    """Internal fast accessor."""
    return _FLAGS[name]
