"""The port's Program IR, backward and Executor against the JAX package,
on the CPU: a small fc -> gelu -> fc -> mean program built by both, the
JAX startup's weights carried across with ``io.load_params``, then the
forward, every ``@GRAD`` and five steps of SGD or Adam updates compared.

Tolerance: rtol 1e-5 / atol 1e-6 — float32 on both sides over a few
hundred terms (XLA and torch sum in other orders).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as pt

TOL = dict(rtol=1e-5, atol=1e-6)
STEPS = 5


def _build(pkg, opt):
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = 11
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.data("x", [None, 6])
        h = pkg.layers.fc(x, 12, act="gelu")
        y = pkg.layers.fc(h, 3)
        loss = pkg.layers.mean(y)
        optimizer = (pkg.optimizer.SGD(0.1) if opt == "sgd"
                     else pkg.optimizer.Adam(0.05))
        _, params_grads = optimizer.minimize(loss)
    fetch = [loss.name, h.name, y.name] + [g.name for _, g in params_grads]
    return main, startup, fetch


def _params(main):
    return [v.name for v in main.list_vars() if v.persistable]


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_fc_program_matches_the_jax_package(opt):
    feed = {"x": np.random.RandomState(0).randn(5, 6).astype(np.float32)}
    jmain, jstart, jfetch = _build(jpt, opt)
    main, _, fetch = _build(pt, opt)
    assert fetch == jfetch
    assert [(o.type, o.inputs, o.outputs) for o in main.global_block().ops] \
        == [(o.type, o.inputs, o.outputs) for o in jmain.global_block().ops]

    jscope = jpt.Scope()
    jexe = jpt.Executor()
    with jpt.scope_guard(jscope):
        jexe.run(jstart)
    weights = {n: np.asarray(jscope.find_var(n)) for n in _params(jmain)}
    scope = pt.Scope()
    pt.io.load_params(scope, weights, "cpu", program=main)
    exe = pt.Executor(pt.CPUPlace())
    for step in range(STEPS):
        with jpt.scope_guard(jscope):
            want = jexe.run(jmain, feed=feed, fetch_list=jfetch)
        got = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
        for name, g, w in zip(fetch, got, want):
            np.testing.assert_allclose(g, w, err_msg=f"{name} step {step}",
                                       **TOL)
    for n in _params(main):   # parameters and accumulators after 5 steps
        np.testing.assert_allclose(scope.find_var(n).numpy(),
                                   np.asarray(jscope.find_var(n)),
                                   err_msg=n, **TOL)


def test_meta_shape_inference_rediscovers_dynamic_dims():
    with pt.new_program_scope():
        x = pt.data("x", [None, 7, 6])
        h = pt.layers.fc(x, 5, num_flatten_dims=2, act="gelu")
        s = pt.layers.reduce_sum(h, dim=[2])
        t = pt.layers.transpose(pt.layers.unsqueeze(s, [1]), [1, 0, 2])
        ids = pt.data("ids", [None, 7, 1], "int64")
        emb = pt.layers.embedding(ids, (50, 4))
        ne = pt.layers.not_equal(ids, -1)
        assert h.shape == (-1, 7, 5) and h.dtype == "float32"
        assert s.shape == (-1, 7)
        assert t.shape == (1, -1, 7)
        assert emb.shape == (-1, 7, 4)
        assert ne.shape == (-1, 7, 1) and ne.dtype == "bool"


def test_unported_op_builds_and_raises_at_run_time():
    with pt.new_program_scope():
        x = pt.data("x", [None, 4])
        block = pt.default_main_program().global_block()
        out = block.create_var(name="y")
        block.append_op(type="group_norm", inputs={"X": [x.name]},
                        outputs={"Y": [out.name]}, attrs={})
        assert out.shape is None          # built, no shape inferred
        exe = pt.Executor(pt.CPUPlace())
        with pytest.raises(NotImplementedError, match="'group_norm'"):
            exe.run(feed={"x": np.zeros((2, 4), np.float32)},
                    fetch_list=[out])


def test_executor_checks_feeds_and_the_scope():
    with pt.new_program_scope():
        x = pt.data("x", [None, 4])
        y = pt.layers.fc(x, 2)
        exe = pt.Executor(pt.CPUPlace())
        with pytest.raises(ValueError, match=r"\(2, 5\).*\(-1, 4\)"):
            exe.run(feed={"x": np.zeros((2, 5), np.float32)},
                    fetch_list=[y])
        with pytest.raises(RuntimeError, match="not initialized"):
            exe.run(feed={"x": np.zeros((2, 4), np.float32)},
                    fetch_list=[y])
        exe.run(pt.default_startup_program())
        (got,) = exe.run(feed={"x": np.ones((3, 4), np.float32)},
                         fetch_list=[y])
        assert got.shape == (3, 2)
        assert exe.compiles_after_first_step == 0


def test_load_params_checks_names_shapes_and_dtypes():
    with pt.new_program_scope():
        x = pt.data("x", [None, 4])
        pt.layers.fc(x, 2)
        main = pt.default_main_program()
        names = _params(main)
        good = {"fc_0.w_0": np.zeros((4, 2), np.float32),
                "fc_0.w_1": np.zeros((2,), np.float32)}
        assert sorted(good) == sorted(names)
        scope = pt.Scope()
        pt.io.load_params(scope, good, "cpu", program=main)
        assert torch.equal(scope.find_var("fc_0.w_1"), torch.zeros(2))
        with pytest.raises(KeyError, match="missing"):
            pt.io.load_params(scope, {"fc_0.w_0": good["fc_0.w_0"]}, "cpu",
                              program=main)
        with pytest.raises(KeyError, match="unknown"):
            pt.io.load_params(scope, {**good, "nope": np.zeros(1)}, "cpu",
                              program=main)
        with pytest.raises(ValueError, match="shape"):
            pt.io.load_params(scope, {**good, "fc_0.w_1": np.zeros(3)},
                              "cpu", program=main)
        with pytest.raises(TypeError, match="dtype"):
            pt.io.load_params(
                scope, {**good, "fc_0.w_1": np.zeros(2, np.int32)}, "cpu",
                program=main)
