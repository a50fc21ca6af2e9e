"""Control flow (While, cond, Switch, StaticRNN) in the port against the
JAX package, on the CPU: one case for each test of
``tests/test_control_flow.py``, plus a While nested in a StaticRNN,
per-trip dropout masks and the fusion plan of a program with a block op.

Each case builds the same program in both packages (under
``program_guard`` + ``unique_name.guard``, so names match), and the
descs must be equal block for block and op for op (int64 variables read
as int32, as ``narrowed`` does).  The JAX startup's persistables are
carried into the port with ``io.load_params``; then the same feeds run
through both Executors.  Tolerances: floats within 1e-6 absolute, ints
and bools exact, gradients (``@GRAD`` fetches) within 1e-5 relative
norm, the StaticRNN training losses within 2e-3 (``_PARITY_TOL``,
``__graft_entry__.py:26``).  Each case also holds the port to the JAX
test's own expected values.

The JAX package's ``test_while_max_iters_under_recompute`` trains a
bounded While under RecomputeOptimizer; its port case trains the same
program from the same weights, losses within 1e-5 relative.
"""
import numpy as np
import pytest

import paddle_tpu as jpt
import paddle_tpu_torch as pt
from paddle_tpu.core import fusion as jfusion
from paddle_tpu_torch.core import fusion
from test_torch_fusion import _describe
from test_torch_tensor_math_ops import narrowed

FLOAT_ATOL = 1e-6
GRAD_RTOL = 1e-5
PARITY_TOL = 2e-3


# -- the programs (each takes the package and returns its fetch vars) --------

def while_sum(P):
    L = P.layers
    i = L.fill_constant(shape=[1], dtype="int64", value=0)
    n = L.fill_constant(shape=[1], dtype="int64", value=10)
    s = L.fill_constant(shape=[1], dtype="int64", value=0)
    c = L.less_than(i, n)
    w = L.While(c)
    with w.block():
        L.assign(s + i, s)
        L.increment(i, value=1, in_place=True)
        L.less_than(i, n, cond=c)
    return [s, i]


MATRIX_X0 = np.eye(3, dtype=np.float32)
MATRIX_W = (0.1 * np.arange(9).reshape(3, 3)).astype(np.float32)


def matrix_power(P):
    L = P.layers
    x = L.assign(MATRIX_X0)
    wvar = L.assign(MATRIX_W)
    i = L.fill_constant([1], "int64", 0)
    n = L.fill_constant([1], "int64", 3)
    c = L.less_than(i, n)
    loop = L.While(c)
    with loop.block():
        L.assign(x + L.matmul(x, wvar), x)
        L.increment(i)
        L.less_than(i, n, cond=c)
    return [x]


def cond_branches(P):
    L = P.layers
    x = P.data("x", shape=[4], dtype="float32")
    zero = L.fill_constant([1], "float32", 0.0)
    pred = L.greater_than(L.reduce_sum(x), zero)
    return [L.cond(pred, lambda: x * 2.0, lambda: x - 10.0)]


def cond_gradient(P):
    L = P.layers
    x = P.data("x", shape=[3], dtype="float32", stop_gradient=False)
    zero = L.fill_constant([1], "float32", 0.0)
    pred = L.greater_than(L.reduce_sum(x), zero)
    y = L.cond(pred, lambda: x * 3.0, lambda: x * 5.0)
    (gx,) = P.gradients(L.reduce_sum(y), [x])
    return [y, gx]


def switch_piecewise(P):
    L = P.layers
    step = P.data("step", shape=[1], dtype="float32")
    lr = L.fill_constant([1], "float32", 0.0)
    b1 = L.fill_constant([1], "float32", 5.0)
    b2 = L.fill_constant([1], "float32", 10.0)
    with L.Switch() as sw:
        with sw.case(L.less_than(step, b1)):
            L.assign(L.fill_constant([1], "float32", 0.1), lr)
        with sw.case(L.less_than(step, b2)):
            L.assign(L.fill_constant([1], "float32", 0.05), lr)
        with sw.default():
            L.assign(L.fill_constant([1], "float32", 0.01), lr)
    return [lr]


RNN_T, RNN_B, RNN_D, RNN_H = 5, 2, 3, 6


def static_rnn_cumsum(P):
    L = P.layers
    x = P.data("x", shape=[RNN_T, RNN_B, RNN_D], dtype="float32")
    h0 = L.fill_constant([RNN_B, RNN_D], "float32", 0.0)
    rnn = L.StaticRNN()
    with rnn.step():
        x_t = rnn.step_input(x)
        h = rnn.memory(init=h0)
        nh = x_t + h
        rnn.update_memory(h, nh)
        rnn.step_output(nh)
    return [rnn()]


def static_rnn_trains(P):
    L = P.layers
    x = P.data("x", shape=[4, 2, 3], dtype="float32")
    h0 = L.fill_constant([2, RNN_H], "float32", 0.0)
    rnn = L.StaticRNN()
    with rnn.step():
        x_t = rnn.step_input(x)
        h = rnn.memory(init=h0)
        nh = L.fc(L.concat([x_t, h], axis=1), size=RNN_H, act="tanh")
        rnn.update_memory(h, nh)
        rnn.step_output(nh)
    loss = L.mean(rnn())
    P.optimizer.SGD(learning_rate=0.5).minimize(loss)
    return [loss]


def _doubling_loop(P, max_iters, grad=True):
    """s = x * 2^min(n, max_iters) by a bounded While; with ``grad`` its
    gradient too."""
    L = P.layers
    x = P.data("x", shape=[2], dtype="float32", stop_gradient=False)
    nv = P.data("n", shape=[1], dtype="int64")
    s = L.assign(x)
    i = L.fill_constant([1], "int64", 0)
    c = L.less_than(i, nv)
    loop = L.While(c, max_iters=max_iters)
    with loop.block():
        L.assign(s * 2.0, s)
        L.increment(i)
        L.less_than(i, nv, cond=c)
    if not grad:
        return [s]
    (gx,) = P.gradients(L.reduce_sum(s), [x])
    return [s, gx]


def while_max_iters_backward(P):
    return _doubling_loop(P, 5)


def while_truncates_forward(P):
    return _doubling_loop(P, 5, grad=False)


def while_truncates_backward(P):
    return _doubling_loop(P, 5)


def while_nan_safe_backward(P):
    L = P.layers
    x = P.data("x", shape=[1], dtype="float32", stop_gradient=False)
    nv = P.data("n", shape=[1], dtype="float32")
    s = L.assign(x)
    i = L.fill_constant([1], "float32", 0.0)
    c = L.less_than(i, nv)
    loop = L.While(c, max_iters=6)
    with loop.block():
        L.assign(s * (1.0 / (nv - i)), s)
        L.increment(i)
        L.less_than(i, nv, cond=c)
    (gx,) = P.gradients(L.reduce_sum(s), [x])
    return [s, gx]


def cond_outer_write(P):
    L = P.layers
    p = P.data("p", shape=[1], dtype="float32")
    s = L.fill_constant([2], "float32", -1.0)
    pred = L.greater_than(p, 0.5)

    def t_fn():
        L.assign(L.fill_constant([2], "float32", 7.0), s)

    def f_fn():
        L.assign(L.fill_constant([2], "float32", 3.0), s)

    L.cond(pred, t_fn, f_fn)
    return [s]


def while_in_static_rnn(P):
    """A bounded While nested in a StaticRNN step, differentiated."""
    L = P.layers
    x = P.data("x", shape=[3, 2, 4], dtype="float32", stop_gradient=False)
    h0 = L.fill_constant([2, 4], "float32", 0.5)
    rnn = L.StaticRNN()
    with rnn.step():
        x_t = rnn.step_input(x)
        h = rnn.memory(init=h0)
        acc = L.assign(x_t)
        i = L.fill_constant([1], "int64", 0)
        n = L.fill_constant([1], "int64", 2)
        c = L.less_than(i, n)
        loop = L.While(c, max_iters=3)
        with loop.block():
            L.assign(L.tanh(acc * 1.5 + h), acc)
            L.increment(i)
            L.less_than(i, n, cond=c)
        nh = acc + h * 0.5
        rnn.update_memory(h, nh)
        rnn.step_output(nh)
    out = rnn()
    (gx,) = P.gradients(L.reduce_sum(out * out), [x])
    return [out, gx]


def fc_while_fc(P):
    """A fusible fc feeds a bounded While that reads it every trip (a
    block op as an opaque consumer); fc layers before, in and after the
    loop train with SGD."""
    L = P.layers
    x = P.data("x", shape=[4, 8], dtype="float32")
    h = L.fc(x, 16, act="relu")
    s = L.assign(h)
    i = L.fill_constant([1], "int64", 0)
    n = L.fill_constant([1], "int64", 2)
    c = L.less_than(i, n)
    loop = L.While(c, max_iters=3)
    with loop.block():
        L.assign(L.fc(s, 16, act="tanh") + h, s)
        L.increment(i)
        L.less_than(i, n, cond=c)
    loss = L.mean(L.square(L.fc(s, 4)))
    P.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return [loss]


def _rand(shape, seed):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _two(n):
    return {"x": np.array([1.0, 2.0], np.float32),
            "n": np.array([n], np.int64)}


# name -> (program, feeds, check of the port's outputs per feed)
CASES = {
    "while_sum": (while_sum, [{}], lambda f, o: (
        int(o[0][0]) == 45 and int(o[1][0]) == 10)),
    "while_matrix_power": (matrix_power, [{}], lambda f, o: np.allclose(
        o[0], MATRIX_X0 @ np.linalg.matrix_power(np.eye(3) + MATRIX_W, 3),
        rtol=1e-5)),
    "cond_branches": (cond_branches, [
        {"x": np.full((4,), pv, np.float32)} for pv in (1.0, -1.0)],
        lambda f, o: np.allclose(o[0], f["x"] * 2.0 if f["x"].sum() > 0
                                 else f["x"] - 10.0)),
    "cond_gradient": (cond_gradient, [
        {"x": np.ones(3, np.float32)}, {"x": -np.ones(3, np.float32)}],
        lambda f, o: np.allclose(o[1], 3.0 if f["x"].sum() > 0 else 5.0)),
    "switch_piecewise": (switch_piecewise, [
        {"step": np.array([v], np.float32)} for v in (3.0, 7.0, 20.0)],
        lambda f, o: np.allclose(o[0], {3.0: 0.1, 7.0: 0.05, 20.0: 0.01}[
            float(f["step"][0])], rtol=1e-6)),
    "static_rnn_cumsum": (static_rnn_cumsum, [
        {"x": _rand((RNN_T, RNN_B, RNN_D), 0)}],
        lambda f, o: np.allclose(o[0], np.cumsum(f["x"], axis=0),
                                 rtol=1e-5)),
    "while_max_iters_backward": (while_max_iters_backward, [
        _two(n) for n in (0, 3, 5)], lambda f, o: (
            np.allclose(o[0], f["x"] * 2.0 ** f["n"][0])
            and np.allclose(o[1], 2.0 ** f["n"][0]))),
    "while_truncates_forward": (while_truncates_forward, [_two(7)],
                                lambda f, o: np.allclose(o[0], [32., 64.])),
    "while_truncates_backward": (while_truncates_backward, [_two(7)],
                                 lambda f, o: np.allclose(o[0], [32., 64.])
                                 and np.allclose(o[1], 32.0)),
    "while_nan_safe_backward": (while_nan_safe_backward, [
        {"x": np.array([1.0], np.float32), "n": np.array([3.0], np.float32)}],
        lambda f, o: np.isfinite(o[1]).all()
        and np.allclose(o[0], 1.0 / 6.0, rtol=1e-6)
        and np.allclose(o[1], 1.0 / 6.0, rtol=1e-6)),
    "cond_outer_write": (cond_outer_write, [
        {"p": np.array([pv], np.float32)} for pv in (0.0, 1.0)],
        lambda f, o: np.allclose(o[0], 7.0 if f["p"][0] > 0.5 else 3.0)),
    "while_in_static_rnn": (while_in_static_rnn, [
        {"x": _rand((3, 2, 4), 5) - 0.5}], None),
}

#: the training cases: the same feed for every step, losses compared
TRAIN_CASES = {
    "static_rnn_trains": (static_rnn_trains, {"x": _rand((4, 2, 3), 1)}, 8),
    "fc_while_fc": (fc_while_fc, {"x": _rand((4, 8), 2)}, 6),
}


def _build(P, program_fn):
    main, startup = P.Program(), P.Program()
    startup.random_seed = 5
    main.random_seed = 6
    with P.program_guard(main, startup), P.unique_name.guard():
        fetch = program_fn(P)
    return main, startup, fetch


def _jax_run(program_fn, feeds):
    with jpt.new_program_scope():
        main, startup, fetch = _build(jpt, program_fn)
        exe, scope = jpt.Executor(), jpt.Scope()
        with jpt.scope_guard(scope):
            exe.run(startup)
            weights = {v.name: np.asarray(scope.find_var(v.name))
                       for v in main.list_vars() if v.persistable}
            outs = [[np.asarray(v) for v in exe.run(
                main, feed=f, fetch_list=fetch)] for f in feeds]
    return main, weights, outs


def _port_run(program_fn, feeds, weights):
    main, startup, fetch = _build(pt, program_fn)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    pt.io.load_params(scope, weights, "cpu", program=main)
    outs = [exe.run(main, feed=f, fetch_list=fetch, scope=scope)
            for f in feeds]
    return main, fetch, outs


def _rel(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def _compare(fetch, got, want):
    for var, g, w in zip(fetch, got, want):
        g = np.asarray(g)
        w = np.asarray(w)
        assert g.shape == w.shape, var.name
        if g.dtype.kind in "biu":
            np.testing.assert_array_equal(g, w, err_msg=var.name)
        elif var.name.endswith("@GRAD"):
            assert _rel(g, w) <= GRAD_RTOL, (var.name, g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=FLOAT_ATOL,
                                       err_msg=var.name)


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    program_fn, feeds, check = CASES[request.param]
    jmain, weights, want = _jax_run(program_fn, feeds)
    main, fetch, got = _port_run(program_fn, feeds, weights)
    return dict(name=request.param, jmain=jmain, main=main, fetch=fetch,
                feeds=feeds, want=want, got=got, check=check)


def test_programs_are_the_jax_packages(case):
    """Same blocks, ops, slots, attrs and variables in both packages."""
    assert len(case["main"].blocks) > 1
    assert narrowed(case["main"].to_dict()) == narrowed(
        case["jmain"].to_dict())


def test_outputs_match_the_jax_package(case):
    for f, got, want in zip(case["feeds"], case["got"], case["want"]):
        _compare(case["fetch"], got, want)
        if case["check"] is not None:
            assert case["check"](f, got), (case["name"], f, got)


@pytest.mark.parametrize("name", sorted(TRAIN_CASES))
def test_training_through_a_block_op_matches(name):
    """SGD through a StaticRNN (an fc in the recurrence) and through a
    bounded While fed by a fused fc: the loss trajectory within 2e-3 of
    the JAX package's, and it falls."""
    program_fn, feed, steps = TRAIN_CASES[name]
    jmain, weights, want = _jax_run(program_fn, [feed] * steps)
    main, _, got = _port_run(program_fn, [feed] * steps, weights)
    assert narrowed(main.to_dict()) == narrowed(jmain.to_dict())
    got = [float(o[0]) for o in got]
    want = [float(o[0]) for o in want]
    assert max(abs(g - w) for g, w in zip(got, want)) <= PARITY_TOL, (
        got, want)
    assert got[-1] < got[0], got


def test_fusion_plan_with_a_block_op_equals_the_jax_planners():
    """The planner plans block 0 only and treats the While as an opaque
    consumer of its declared inputs: the fc that feeds the loop keeps its
    output (the loop reads it every trip)."""
    plans = []
    for P, planner in ((jpt, jfusion), (pt, fusion)):
        with (jpt.new_program_scope() if P is jpt
              else pt.new_program_scope()):
            main, _, fetch = _build(P, fc_while_fc)
            plans.append(_describe(planner.plan_fusion(
                main, list(main.global_block().ops), ["x"],
                [v.name for v in fetch], block_patterns=True)))
    want, got = plans
    assert got == want
    assert got is not None and got["groups"]
    loop = next(op for op in main.global_block().ops if op.type == "while")
    h = loop.inputs["X"]
    for g in got["groups"]:
        # no group hides an output the loop reads
        assert not set(g["internal"]) & set(h)


def test_unbounded_while_backward_raises():
    for P in (jpt, pt):
        with (jpt.new_program_scope() if P is jpt
              else pt.new_program_scope()):
            L = P.layers
            x = P.data("x", shape=[2], dtype="float32", stop_gradient=False)
            s = L.assign(x)
            i = L.fill_constant([1], "int64", 0)
            n = L.fill_constant([1], "int64", 3)
            c = L.less_than(i, n)
            loop = L.While(c)
            with loop.block():
                L.assign(s * 2.0, s)
                L.increment(i)
                L.less_than(i, n, cond=c)
            with pytest.raises(NotImplementedError,
                               match="max_iters.*StaticRNN"):
                P.gradients(L.reduce_sum(s), [x])


def test_while_rejects_non_bool_condition():
    for P in (jpt, pt):
        with (jpt.new_program_scope() if P is jpt
              else pt.new_program_scope()):
            i = P.layers.fill_constant([1], "int64", 0)
            with pytest.raises(TypeError, match="bool"):
                P.layers.While(i)


def _while_under_recompute(P):
    L = P.layers
    x = P.data("x", shape=[2, 4], dtype="float32")
    nv = P.data("n", shape=[1], dtype="int64")
    s = L.fc(x, size=4, act="tanh")
    i = L.fill_constant([1], "int64", 0)
    c = L.less_than(i, nv)
    loop = L.While(c, max_iters=3)
    with loop.block():
        L.assign(L.fc(s, size=4, act="tanh"), s)
        L.increment(i)
        L.less_than(i, nv, cond=c)
    mid = L.fc(s, size=4, act="relu")
    loss = L.mean(L.square(mid))
    opt = P.optimizer.RecomputeOptimizer(P.optimizer.SGD(0.1))
    opt._set_checkpoints([mid])
    opt.minimize(loss)
    return loss


def test_while_max_iters_under_recompute_waits_for_recompute():
    """The JAX case: a bounded While trains under RecomputeOptimizer (the
    checkpointed forward runs the loop again in the backward); six SGD
    steps from the JAX startup's weights give the JAX package's losses."""
    feed = {"x": np.random.RandomState(7).rand(2, 4).astype(np.float32),
            "n": np.array([2], np.int64)}
    losses, init = [], None
    for P in (jpt, pt):
        main, startup = P.Program(), P.Program()
        startup.random_seed = 3
        with P.program_guard(main, startup), P.unique_name.guard():
            loss = _while_under_recompute(P)
        scope = P.Scope()
        if P is jpt:
            exe = P.Executor()
            with P.scope_guard(scope):
                exe.run(startup)
            init = {v.name: np.asarray(scope.find_var(v.name))
                    for v in main.list_vars() if v.persistable}
        else:
            exe = P.Executor(P.CPUPlace())
            P.io.load_params(scope, init, "cpu", program=main)
        with P.scope_guard(scope):
            losses.append([float(exe.run(main, feed=feed,
                                         fetch_list=[loss])[0])
                           for _ in range(6)])
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5)
    assert losses[1][-1] < losses[1][0], losses[1]


def _dropout_rnn(P):
    L = P.layers
    x = P.data("x", shape=[6, 4, 64], dtype="float32")
    rnn = L.StaticRNN()
    with rnn.step():
        x_t = rnn.step_input(x)
        rnn.step_output(L.dropout(x_t, 0.5, is_test=False,
                                  dropout_implementation="upscale_in_train"))
    return [rnn()]


def _dropout_while(P):
    L = P.layers
    ones = L.fill_constant([4, 64], "float32", 1.0)
    acc = L.fill_constant([4, 64], "float32", 0.0)
    i = L.fill_constant([1], "int64", 0)
    n = L.fill_constant([1], "int64", 4)
    c = L.less_than(i, n)
    loop = L.While(c, max_iters=4)
    with loop.block():
        L.assign(acc + L.dropout(ones, 0.5, is_test=False,
                                 dropout_implementation="upscale_in_train"),
                 acc)
        L.increment(i)
        L.less_than(i, n, cond=c)
    return [acc]


@pytest.mark.parametrize("package", ["jax", "port"])
def test_dropout_draws_a_fresh_mask_every_trip(package):
    """Each StaticRNN step and each While trip folds its index into the
    seed, so dropout's masks differ between trips (bits cannot match
    across the packages; the property must hold in both)."""
    feed = {"x": np.ones((6, 4, 64), np.float32)}
    if package == "jax":
        _, _, (rnn_out,) = _jax_run(_dropout_rnn, [feed])
        _, _, (while_out,) = _jax_run(_dropout_while, [{}])
    else:
        _, _, (rnn_out,) = _port_run(_dropout_rnn, [feed], {})
        _, _, (while_out,) = _port_run(_dropout_while, [{}], {})
    masks = np.asarray(rnn_out[0]) > 0
    for a in range(6):
        assert 0.35 < masks[a].mean() < 0.65
        for b in range(a):
            assert (masks[a] != masks[b]).any(), (a, b)
    # 4 trips of 0 or 2 each: one repeated mask would leave only {0, 8}
    assert len(np.unique(np.asarray(while_out[0]))) > 2
