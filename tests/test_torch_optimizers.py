"""The port's optimizers, update ops, regularizers and gradient clips
against the JAX package on the CPU.

* Each of the eleven dense update ops the port added, fed the same
  numpy-seeded state as ``tests/test_optimizer_ops.py`` feeds the JAX
  op, against the JAX op: every output within 1e-6 relative (plus 1e-6
  of the array's largest magnitude, for entries near zero).  ``dpsgd``
  runs at ``sigma`` 0, since its noise is torch's and cannot equal
  ``jax.random``'s; its noise is checked apart: recovered from one
  update of a 40,000-element parameter, mean within 0.02 of 0 and
  standard deviation within 0.02 of 1.
* Every optimizer class converges on the quadratic of
  ``tests/test_optimizer_ops.py`` (its table of steps and ratios).
* An fc regression program with each dense optimizer × {L1Decay,
  L2Decay, clip by value, by norm, by global norm}, five steps from the
  JAX startup's weights in both packages: every loss within 1e-5, every
  persistable (weights and accumulators) within 1e-5 relative after the
  last step, and the accumulator names identical.  The JAX side runs
  with ``jax_disable_jit`` (op by op, no XLA compile per case: the same
  arithmetic, minutes fewer).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as jpt
import paddle_tpu_torch as pt
from paddle_tpu.core.registry import REGISTRY as JREG
from paddle_tpu.core.registry import OpContext as JCtx
from paddle_tpu_torch.core.registry import REGISTRY as PREG
from paddle_tpu_torch.core.registry import OpContext as PCtx

RTOL = 1e-6
PROGRAM_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _jax_op_by_op():
    prev = jax.config.jax_disable_jit
    jax.config.update("jax_disable_jit", True)
    yield
    jax.config.update("jax_disable_jit", prev)


def _state(r, *shape):
    return (r.rand(*shape).astype(np.float32) * 2.0 - 1.0)


LR = np.array([0.01], np.float32)


def _pow(v):
    return np.array(v, np.float32)


# op -> (inputs builder, attrs): the inputs tests/test_optimizer_ops.py
# feeds each JAX op
UPDATES = {
    "momentum": (lambda r: {"Param": _state(r, 3, 2),
                            "Grad": _state(r, 3, 2),
                            "Velocity": _state(r, 3, 2),
                            "LearningRate": LR}, {"mu": 0.9}),
    "momentum_nesterov": (lambda r: {"Param": _state(r, 3, 2),
                                     "Grad": _state(r, 3, 2),
                                     "Velocity": _state(r, 3, 2),
                                     "LearningRate": LR},
                          {"mu": 0.9, "use_nesterov": True}),
    "lars_momentum": (lambda r: {"Param": _state(r, 4, 3),
                                 "Grad": _state(r, 4, 3),
                                 "Velocity": _state(r, 4, 3),
                                 "LearningRate": LR},
                      {"mu": 0.9, "lars_coeff": 0.001,
                       "lars_weight_decay": 0.0005}),
    "adamax": (lambda r: {"Param": _state(r, 3, 2),
                          "Grad": _state(r, 3, 2),
                          "Moment": _state(r, 3, 2),
                          "InfNorm": np.abs(_state(r, 3, 2)) + 0.1,
                          "LearningRate": LR, "Beta1Pow": _pow(0.9 ** 3)},
               {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}),
    "rmsprop": (lambda r: {"Param": _state(r, 3, 2),
                           "Grad": _state(r, 3, 2),
                           "MeanSquare": np.abs(_state(r, 3, 2)),
                           "MeanGrad": _state(r, 3, 2) * 0.1,
                           "Moment": _state(r, 3, 2),
                           "LearningRate": LR},
                {"decay": 0.95, "epsilon": 1e-6, "momentum": 0.5}),
    "rmsprop_centered": (lambda r: {"Param": _state(r, 3, 2),
                                    "Grad": _state(r, 3, 2),
                                    "MeanSquare": np.abs(_state(r, 3, 2))
                                    + 0.5,
                                    "MeanGrad": _state(r, 3, 2) * 0.1,
                                    "Moment": _state(r, 3, 2),
                                    "LearningRate": LR},
                         {"decay": 0.9, "epsilon": 1e-6, "momentum": 0.1,
                          "centered": True}),
    "adadelta": (lambda r: {"Param": _state(r, 3, 2),
                            "Grad": _state(r, 3, 2),
                            "AvgSquaredGrad": np.abs(_state(r, 3, 2)),
                            "AvgSquaredUpdate": np.abs(_state(r, 3, 2))},
                 {"rho": 0.95, "epsilon": 1e-6}),
    "decayed_adagrad": (lambda r: {"Param": _state(r, 3, 2),
                                   "Grad": _state(r, 3, 2),
                                   "Moment": np.abs(_state(r, 3, 2)),
                                   "LearningRate": LR},
                        {"decay": 0.95, "epsilon": 1e-6}),
    "adagrad": (lambda r: {"Param": _state(r, 3, 2),
                           "Grad": _state(r, 3, 2),
                           "Moment": np.abs(_state(r, 3, 2)),
                           "LearningRate": LR}, {"epsilon": 1e-6}),
    "ftrl": (lambda r: {"Param": _state(r, 3, 2), "Grad": _state(r, 3, 2),
                        "SquaredAccumulator": np.abs(_state(r, 3, 2)) + 0.1,
                        "LinearAccumulator": _state(r, 3, 2),
                        "LearningRate": LR},
             {"l1": 0.1, "l2": 0.2, "lr_power": -0.5}),
    "ftrl_power": (lambda r: {"Param": _state(r, 3, 2),
                              "Grad": _state(r, 3, 2),
                              "SquaredAccumulator":
                                  np.abs(_state(r, 3, 2)) + 0.1,
                              "LinearAccumulator": _state(r, 3, 2),
                              "LearningRate": LR},
                   {"l1": 0.0, "l2": 0.0, "lr_power": -0.3}),
    "adamw": (lambda r: {"Param": _state(r, 3, 2), "Grad": _state(r, 3, 2),
                         "Moment1": _state(r, 3, 2),
                         "Moment2": np.abs(_state(r, 3, 2)),
                         "LearningRate": LR, "Beta1Pow": _pow(0.9 ** 2),
                         "Beta2Pow": _pow(0.999 ** 2)},
              {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8,
               "weight_decay": 0.01}),
    "lamb": (lambda r: {"Param": _state(r, 4, 3), "Grad": _state(r, 4, 3),
                        "Moment1": _state(r, 4, 3),
                        "Moment2": np.abs(_state(r, 4, 3)),
                        "LearningRate": LR, "Beta1Pow": _pow(0.9 ** 2),
                        "Beta2Pow": _pow(0.999 ** 2)},
             {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-6,
              "weight_decay": 0.01}),
    "dpsgd": (lambda r: {"Param": _state(r, 3, 2),
                         "Grad": _state(r, 3, 2) * 30.0,
                         "LearningRate": LR},
              {"clip": 1.0, "batch_size": 4.0, "sigma": 0.0}),
}


def _op_type(name):
    return {"momentum_nesterov": "momentum",
            "rmsprop_centered": "rmsprop",
            "ftrl_power": "ftrl"}.get(name, name)


@pytest.mark.parametrize("name", sorted(UPDATES))
def test_update_op_matches_the_jax_op(name):
    build, attrs = UPDATES[name]
    op = _op_type(name)
    ins = build(np.random.RandomState(7))
    want = JREG.get(op).compute(
        JCtx(rng=jax.random.PRNGKey(0), attrs=attrs),
        {k: [jnp.asarray(v)] for k, v in ins.items()}, attrs)
    got = PREG.get(op).compute(
        PCtx(rng=1, attrs=attrs, device=torch.device("cpu")),
        {k: [torch.from_numpy(np.array(v))] for k, v in ins.items()}, attrs)
    assert set(got) == set(want)
    for slot in want:
        w = np.asarray(want[slot][0])
        g = got[slot][0].numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, slot
        np.testing.assert_allclose(g, w, rtol=RTOL,
                                   atol=RTOL * float(np.abs(w).max()),
                                   err_msg=f"{name}:{slot}")


def test_dpsgd_noise_is_standard_normal_scaled():
    """p' = p - lr (g_clipped + sigma clip n / batch): recover n from one
    update and check its mean and spread."""
    r = np.random.RandomState(3)
    p = _state(r, 200, 200)
    g = _state(r, 200, 200) * 1e-4          # norm ~0.01 < clip: no clip
    attrs = {"clip": 2.0, "batch_size": 4.0, "sigma": 1.5}
    lr = np.array([0.1], np.float32)
    out = PREG.get("dpsgd").compute(
        PCtx(rng=1234, attrs=attrs, device=torch.device("cpu")),
        {"Param": [torch.from_numpy(p)], "Grad": [torch.from_numpy(g)],
         "LearningRate": [torch.from_numpy(lr)]}, attrs)
    p_out = out["ParamOut"][0].double().numpy()
    noise = ((p - p_out) / lr[0] - g) * attrs["batch_size"] \
        / (attrs["sigma"] * attrs["clip"])
    assert abs(noise.mean()) < 0.02, noise.mean()
    assert abs(noise.std() - 1.0) < 0.02, noise.std()


# -- the quadratic of tests/test_optimizer_ops.py ---------------------------

_CONVERGENCE = {
    "sgd": (lambda: pt.optimizer.SGD(0.02), 60, 0.05),
    "adam": (lambda: pt.optimizer.Adam(0.2), 60, 0.05),
    "momentum": (lambda: pt.optimizer.Momentum(0.02, momentum=0.9), 60,
                 0.05),
    "momentum_nesterov": (
        lambda: pt.optimizer.Momentum(0.02, momentum=0.9,
                                      use_nesterov=True), 60, 0.05),
    "lars_momentum": (
        lambda: pt.optimizer.LarsMomentum(1.0, momentum=0.9,
                                          lars_coeff=0.05), 120, 0.2),
    "adamax": (lambda: pt.optimizer.Adamax(0.2), 60, 0.05),
    "adamw": (lambda: pt.optimizer.AdamW(0.2, weight_decay=0.001), 60,
              0.05),
    "rmsprop": (lambda: pt.optimizer.RMSProp(0.05), 60, 0.05),
    "rmsprop_centered": (lambda: pt.optimizer.RMSProp(0.05, centered=True),
                         60, 0.05),
    "adadelta": (lambda: pt.optimizer.Adadelta(1.0, epsilon=1e-2), 120,
                 0.2),
    "adagrad": (lambda: pt.optimizer.Adagrad(0.2), 60, 0.05),
    "decayed_adagrad": (lambda: pt.optimizer.DecayedAdagrad(0.05), 60,
                        0.05),
    "ftrl": (lambda: pt.optimizer.Ftrl(0.5), 120, 0.2),
    "dpsgd": (lambda: pt.optimizer.Dpsgd(0.05, clip=100.0, sigma=0.0), 60,
              0.05),
    "lamb": (lambda: pt.optimizer.Lamb(0.05, lamb_weight_decay=0.0), 120,
             0.2),
}


@pytest.mark.parametrize("name", sorted(_CONVERGENCE))
def test_optimizer_converges_on_quadratic(name):
    make, steps, ratio = _CONVERGENCE[name]
    main, startup = pt.Program(), pt.Program()
    startup.random_seed = 7
    with pt.program_guard(main, startup):
        x = pt.layers.data("x", [4, 2], "float32")
        y = pt.layers.fc(x, size=1, bias_attr=False)
        loss = pt.layers.mean(pt.layers.square(y - 3.0))
        make().minimize(loss)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    xv = np.ones((4, 2), np.float32)
    exe.run(startup, scope=scope)
    losses = [float(exe.run(main, feed={"x": xv}, fetch_list=[loss],
                            scope=scope)[0]) for _ in range(steps)]
    assert np.isfinite(losses[-1]), f"{name}: loss diverged"
    assert losses[-1] < ratio * losses[0], (name, losses[0], losses[-1])


# -- the fc program: optimizer x regularization / clip ----------------------

OPTIMIZERS = {
    "SGD": dict(learning_rate=0.05),
    "Momentum": dict(learning_rate=0.05, momentum=0.9),
    "LarsMomentum": dict(learning_rate=0.5, momentum=0.9, lars_coeff=0.01),
    "Adam": dict(learning_rate=0.01),
    "AdamW": dict(learning_rate=0.01, weight_decay=0.02),
    "Lamb": dict(learning_rate=0.01, lamb_weight_decay=0.01),
    "Adagrad": dict(learning_rate=0.05),
    "DecayedAdagrad": dict(learning_rate=0.05),
    "Adadelta": dict(learning_rate=1.0, epsilon=1e-2),
    "RMSProp": dict(learning_rate=0.01, momentum=0.5, centered=True),
    "Adamax": dict(learning_rate=0.01),
    "Ftrl": dict(learning_rate=0.1, l1=0.01, l2=0.01),
    "Dpsgd": dict(learning_rate=0.05, clip=1.0, sigma=0.0),
}


def _extras(P, kind):
    return {"l1": dict(regularization=P.regularizer.L1Decay(1e-2)),
            "l2": dict(regularization=P.regularizer.L2Decay(1e-1)),
            "value": dict(grad_clip=P.clip.GradientClipByValue(0.05)),
            "norm": dict(grad_clip=P.clip.GradientClipByNorm(0.1)),
            "global_norm": dict(
                grad_clip=P.clip.GradientClipByGlobalNorm(0.1))}[kind]


def _fc_program(P, opt_name, kind):
    main, startup = P.Program(), P.Program()
    startup.random_seed = 5
    with P.program_guard(main, startup), P.unique_name.guard():
        x = P.data("x", [8, 6])
        y = P.data("y", [8, 1])
        h = P.layers.fc(x, 8, act="relu")
        pred = P.layers.fc(h, 1)
        loss = P.layers.mean(P.layers.square_error_cost(pred, y))
        opt = getattr(P.optimizer, opt_name)(**OPTIMIZERS[opt_name],
                                             **_extras(P, kind))
        opt.minimize(loss)
    return main, startup, loss, opt


def _feed(step):
    r = np.random.RandomState(50 + step)
    return {"x": r.rand(8, 6).astype(np.float32) * 2 - 1,
            "y": r.rand(8, 1).astype(np.float32)}


STEPS = 5


@pytest.mark.parametrize("kind", ["l1", "l2", "value", "norm",
                                  "global_norm"])
@pytest.mark.parametrize("opt_name", sorted(OPTIMIZERS))
def test_fc_program_matches_the_jax_package(opt_name, kind):
    jmain, jstartup, jloss, jopt = _fc_program(jpt, opt_name, kind)
    jscope, jexe = jpt.Scope(), jpt.Executor()
    with jpt.scope_guard(jscope):
        jexe.run(jstartup)
        weights = {v.name: np.asarray(jscope.find_var(v.name))
                   for v in jmain.list_vars() if v.persistable}
        jlosses = [float(jexe.run(jmain, feed=_feed(s),
                                  fetch_list=[jloss])[0])
                   for s in range(STEPS)]
        jstate = {n: np.asarray(jscope.find_var(n)) for n in weights}

    main, _, loss, opt = _fc_program(pt, opt_name, kind)
    assert opt.accumulator_specs() == jopt.accumulator_specs()
    scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    pt.io.load_params(scope, weights, "cpu", program=main)
    losses = [float(exe.run(main, feed=_feed(s), fetch_list=[loss],
                            scope=scope)[0]) for s in range(STEPS)]
    np.testing.assert_allclose(losses, jlosses, rtol=0, atol=PROGRAM_TOL)
    for name, want in jstate.items():
        got = scope.find_var(name).numpy()
        np.testing.assert_allclose(
            got, want, rtol=PROGRAM_TOL,
            atol=PROGRAM_TOL * float(np.abs(want).max()), err_msg=name)


def test_state_dict_is_dygraph_only():
    opt = pt.optimizer.Adam(0.1)
    with pytest.raises(RuntimeError, match="dygraph-only"):
        opt.state_dict()
    with pytest.raises(RuntimeError, match="dygraph-only"):
        opt.set_state_dict({})


def test_current_lr_and_set_lr():
    main, startup, loss, opt = _fc_program(pt, "SGD", "l2")
    assert opt.current_lr is opt._global_learning_rate()
    scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    opt.set_lr(0.25, scope=scope)
    (lr,) = exe.run(main, feed=_feed(0), fetch_list=[opt.current_lr],
                    scope=scope)
    assert lr == np.float32(0.25)


def test_sparse_and_lazy_paths_raise():
    """The sparse and lazy paths, once refused, now take the JAX
    package's ops: an ``is_sparse`` table under ``Adam(lazy_mode=True)``
    builds the same program (``lookup_table_sparse_grad``, a lazy
    ``adam_sparse``), and two steps from the same weights give the same
    losses and state within 1e-5; only Momentum-like optimizers refuse
    the SelectedRows gradient, with the JAX package's ValueError."""
    def build(P, opt):
        main, startup = P.Program(), P.Program()
        startup.random_seed = 5
        with P.program_guard(main, startup), P.unique_name.guard():
            ids = P.data("ids", [6, 1], "int64")
            y = P.data("y", [6, 3])
            emb = P.layers.embedding(ids, (20, 3), is_sparse=True)
            loss = P.layers.mean(P.layers.square_error_cost(emb, y))
            opt(P).minimize(loss)
        return main, startup, loss

    lazy = lambda P: P.optimizer.Adam(0.1, lazy_mode=True)  # noqa: E731
    jmain, jstartup, jloss = build(jpt, lazy)
    main, _, loss = build(pt, lazy)
    types = [o.type for o in main.global_block().ops]
    assert types == [o.type for o in jmain.global_block().ops]
    assert "lookup_table_sparse_grad" in types
    assert [o.attrs["lazy_mode"] for o in main.global_block().ops
            if o.type == "adam_sparse"] == [True]
    r = np.random.RandomState(1)
    feed = {"ids": r.randint(0, 20, (6, 1)).astype(np.int64),
            "y": r.rand(6, 3).astype(np.float32)}
    jscope, jexe = jpt.Scope(), jpt.Executor()
    with jpt.scope_guard(jscope):
        jexe.run(jstartup)
        init = {v.name: np.asarray(jscope.find_var(v.name))
                for v in jmain.list_vars() if v.persistable}
        want = [float(jexe.run(jmain, feed=feed, fetch_list=[jloss])[0])
                for _ in range(2)]
        jstate = {n: np.asarray(jscope.find_var(n)) for n in init}
    scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    pt.io.load_params(scope, init, "cpu", program=main)
    got = [float(exe.run(main, feed=feed, fetch_list=[loss],
                         scope=scope)[0]) for _ in range(2)]
    np.testing.assert_allclose(got, want, rtol=PROGRAM_TOL)
    for n, w in jstate.items():
        np.testing.assert_allclose(scope.find_var(n).numpy(), w,
                                   rtol=PROGRAM_TOL, atol=1e-6, err_msg=n)
    for P in (jpt, pt):
        with pytest.raises(ValueError, match="SelectedRows"):
            build(P, lambda P: P.optimizer.Momentum(0.1, 0.9))
