"""In-graph learning-rate schedules: a copy of
paddle_tpu/layers/learning_rate_scheduler.py (parity:
python/paddle/fluid/layers/learning_rate_scheduler.py — noam/exponential/
natural_exp/inverse_time/polynomial/piecewise/cosine decay + linear
warmup).

Like the reference, a schedule is a tiny sub-graph computing the LR from a
persistable global step counter that the main program increments every
iteration — so the schedule runs inside the step, as ops on the device
(no host round-trip per step).  The counter is int64 here as in the
program (the JAX package holds it in 32 bits on the device);
io.load_params and checkpoints carry it across either way."""
from __future__ import annotations

import math

import numpy as np

from ..core.program import default_main_program, default_startup_program
from ..initializer import ConstantInitializer
from . import nn, tensor

__all__ = [
    "noam_decay", "exponential_decay", "natural_exp_decay",
    "inverse_time_decay", "polynomial_decay", "piecewise_decay",
    "cosine_decay", "linear_lr_warmup",
]

_COUNTER_NAME = "@LR_DECAY_COUNTER@"


def _decay_step_counter(begin=0):
    """Persistable int64 scalar stepped by +1 each run of the main program
    (parity: layers/learning_rate_scheduler.py _decay_step_counter /
    autoincreased_step_counter: initialized to begin-1, incremented before
    any read, so the first executed step reads ``begin``).  int64 because a
    float32 counter stops incrementing at 2^24 steps."""
    main = default_main_program().global_block()
    startup = default_startup_program().global_block()
    existing = main.vars.get(_COUNTER_NAME)
    if existing is not None:
        return existing
    v = main.create_var(name=_COUNTER_NAME, shape=[], dtype="int64",
                        persistable=True, stop_gradient=True)
    sv = startup.create_var(name=_COUNTER_NAME, shape=[], dtype="int64",
                            persistable=True, stop_gradient=True)
    ConstantInitializer(float(begin) - 1.0).append_op(sv, startup)
    main.append_op(type="increment", inputs={"X": [v.name]},
                   outputs={"Out": [v.name]}, attrs={"step": 1.0})
    return v


def _step_f(begin=0):
    """Float view of the step counter for schedule arithmetic."""
    return tensor.cast(_decay_step_counter(begin), "float32")


def _f(value):
    return tensor.fill_constant([], "float32", float(value))


def noam_decay(d_model, warmup_steps, learning_rate=1.0):
    """lr = learning_rate * d_model^-0.5 * min(step^-0.5, step*warmup^-1.5)."""
    step = _step_f(begin=1)  # reference noam counts from 1
    a = step ** -0.5
    b = step * float(warmup_steps) ** -1.5
    min_ab = nn.elementwise_min(a, b)
    return min_ab * (float(learning_rate) * float(d_model) ** -0.5)


def exponential_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    step = _step_f()
    ratio = step / float(decay_steps)
    if staircase:
        ratio = nn.floor(ratio)
    return float(learning_rate) * (float(decay_rate) ** ratio)


def natural_exp_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    step = _step_f()
    ratio = step / float(decay_steps)
    if staircase:
        ratio = nn.floor(ratio)
    return float(learning_rate) * nn.exp(ratio * -float(decay_rate))


def inverse_time_decay(learning_rate, decay_steps, decay_rate,
                       staircase=False):
    step = _step_f()
    ratio = step / float(decay_steps)
    if staircase:
        ratio = nn.floor(ratio)
    return _f(learning_rate) / (ratio * float(decay_rate) + 1.0)


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=0.0001,
                     power=1.0, cycle=False):
    step = _step_f()
    if cycle:
        div = nn.ceil(step / float(decay_steps))
        # keep div >= 1 even at step 0 (reference zero_var special case)
        div = nn.elementwise_max(div, _f(1.0))
        decay = div * float(decay_steps)
    else:
        decay = _f(decay_steps)
        step = nn.elementwise_min(step, decay)
    frac = (1.0 - step / decay) ** float(power)
    return (float(learning_rate) - float(end_learning_rate)) * frac \
        + float(end_learning_rate)


def piecewise_decay(boundaries, values):
    """values[i] while step < boundaries[i]; index = #boundaries crossed."""
    assert len(values) == len(boundaries) + 1
    step = _step_f()
    bnd = tensor.assign(np.asarray(boundaries, np.float32))
    vals = tensor.assign(np.asarray(values, np.float32))
    crossed = tensor.cast(step >= bnd, "float32")
    idx = tensor.cast(tensor.reduce_sum(crossed), "int32")
    return tensor.gather(vals, idx)


def cosine_decay(learning_rate, step_each_epoch, epochs):
    """lr = 0.5 * lr * (1 + cos(pi * epoch / epochs))."""
    step = _step_f()
    epoch = nn.floor(step / float(step_each_epoch))
    return (nn.cos(epoch * (math.pi / float(epochs))) + 1.0) \
        * (0.5 * float(learning_rate))


def linear_lr_warmup(learning_rate, warmup_steps, start_lr, end_lr):
    """Linear ramp start_lr→end_lr for warmup_steps, then the wrapped
    schedule (Variable or float)."""
    step = _step_f()
    if not hasattr(learning_rate, "name"):  # python number → const var
        learning_rate = _f(learning_rate)
    ramp = float(start_lr) + (float(end_lr) - float(start_lr)) \
        * (step / float(warmup_steps))
    in_warmup = tensor.cast(step < _f(warmup_steps), "float32")
    return ramp * in_warmup + learning_rate * (1.0 - in_warmup)
