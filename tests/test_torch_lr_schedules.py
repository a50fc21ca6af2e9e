"""The eight learning-rate schedules of ``layers/learning_rate_scheduler``
against the JAX package's, on the CPU.

Each schedule is built into a program in both packages (the same ops
under the same names: the step counter ``@LR_DECAY_COUNTER@`` is a
persistable stepped by an ``increment`` op inside the program); both run
30 steps and fetch the learning rate and the counter each step.  The
learning rates agree within 1e-6 relative, plus 1e-6 of the schedule's
largest rate for rates near 0 (XLA contracts the polynomial decay's
``1 - step * (1 / decay_steps)`` into a fused multiply-add and ends the
decay at -3e-12 where float32 step by step gives 0); the counters agree
exactly (int64 in the port, 32 bits in the JAX package).
"""
import numpy as np
import pytest

import paddle_tpu as jpt
import paddle_tpu_torch as pt

STEPS = 30
COUNTER = "@LR_DECAY_COUNTER@"

SCHEDULES = {
    "noam": lambda L: L.noam_decay(64, warmup_steps=10, learning_rate=2.0),
    "exponential": lambda L: L.exponential_decay(0.1, 5, 0.5),
    "exponential_staircase": lambda L: L.exponential_decay(
        0.1, 5, 0.5, staircase=True),
    "natural_exp": lambda L: L.natural_exp_decay(0.1, 5, 0.3),
    "natural_exp_staircase": lambda L: L.natural_exp_decay(
        0.1, 5, 0.3, staircase=True),
    "inverse_time": lambda L: L.inverse_time_decay(0.1, 5, 0.5),
    "inverse_time_staircase": lambda L: L.inverse_time_decay(
        0.1, 5, 0.5, staircase=True),
    "polynomial": lambda L: L.polynomial_decay(
        0.1, decay_steps=12, end_learning_rate=0.001, power=2.0),
    "polynomial_cycle": lambda L: L.polynomial_decay(
        0.1, decay_steps=7, end_learning_rate=0.01, cycle=True),
    "piecewise": lambda L: L.piecewise_decay([5, 12, 20],
                                             [0.1, 0.05, 0.01, 0.001]),
    "cosine": lambda L: L.cosine_decay(0.1, step_each_epoch=4, epochs=6),
    "warmup_then_polynomial": lambda L: L.linear_lr_warmup(
        L.polynomial_decay(1e-4, decay_steps=12, end_learning_rate=0.0),
        warmup_steps=4, start_lr=0.0, end_lr=1e-4),
    "warmup_then_constant": lambda L: L.linear_lr_warmup(
        0.05, warmup_steps=6, start_lr=0.01, end_lr=0.05),
}


def _run(P, make, exe, scope):
    main, startup = P.Program(), P.Program()
    with P.program_guard(main, startup), P.unique_name.guard():
        lr = make(P.layers)
    exe.run(startup, scope=scope)
    lrs, counters = [], []
    for _ in range(STEPS):
        got_lr, got_step = exe.run(main, fetch_list=[lr, COUNTER],
                                   scope=scope)
        lrs.append(float(got_lr))
        counters.append(int(got_step))
    return main, np.asarray(lrs, np.float32), counters


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_the_jax_package(name):
    jmain, want, want_steps = _run(jpt, SCHEDULES[name], jpt.Executor(),
                                   jpt.Scope())
    main, got, steps = _run(pt, SCHEDULES[name], pt.Executor(pt.CPUPlace()),
                            pt.Scope())
    assert [(o.type, o.inputs, o.outputs)
            for o in main.global_block().ops] == \
        [(o.type, o.inputs, o.outputs) for o in jmain.global_block().ops]
    assert steps == want_steps
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * float(np.abs(want).max()))


def test_counter_is_persistable_int64_and_starts_at_begin():
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        pt.layers.noam_decay(64, warmup_steps=10)
        pt.layers.exponential_decay(0.1, 5, 0.5)   # shares the counter
    counter = main.global_block().var(COUNTER)
    assert counter.persistable and counter.dtype == "int64"
    assert [o.type for o in main.global_block().ops].count("increment") == 1
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    (step,) = exe.run(main, fetch_list=[COUNTER], scope=scope)
    assert step.dtype == np.int64 and int(step) == 1   # noam counts from 1
