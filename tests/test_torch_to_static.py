"""The port's dygraph_to_static transpiler against the JAX package's, on
the CPU: the counterpart of each of tests/test_to_static.py's 11 cases.

Each case decorates the same function source with each package's
``to_static`` over that package's layers, builds the program (a tensor
predicate becomes a ``cond`` or ``While`` op; a plain Python one stays
Python), runs it through each package's Executor on the same feeds, and
holds the port's fetches to the JAX package's within 1e-6 and to the
case's closed form.  The program descs the two packages build carry the
same op types in the same order.
"""
import numpy as np
import pytest

import paddle_tpu as jpt
import paddle_tpu_torch as pt

TOL = 1e-6


@pytest.fixture(autouse=True)
def _port_names():
    with pt.unique_name.guard():
        yield


def _run(pkg, build, feeds):
    main, startup = pkg.Program(), pkg.Program()
    scope = pkg.Scope()
    with pkg.scope_guard(scope):
        with pkg.program_guard(main, startup):
            outs = build(pkg)
            fetch = list(outs) if isinstance(outs, (list, tuple)) else [outs]
        exe = pkg.Executor(pkg.CPUPlace()) if pkg is pt else pkg.Executor()
        exe.run(startup)
        vals = exe.run(main, feed=feeds, fetch_list=fetch)
    types = [o.type for b in main.blocks for o in b.ops]
    return [np.asarray(v) for v in vals], types


def _both(build, feeds):
    """(the port's fetches, the JAX package's): op types equal, values
    within TOL."""
    want, jtypes = _run(jpt, build, feeds)
    got, types = _run(pt, build, feeds)
    assert types == jtypes
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)
    return got, types


#: the package the next ``_static`` call transpiles over: the case
#: functions below read it as a global, and ``to_static`` snapshots the
#: globals when it transpiles (a closure over the package could not be
#: transpiled)
P = None


def _static(pkg, fn, **kw):
    global P
    P = pkg
    return pkg.dygraph.to_static(fn, **kw)


# -- the case functions (P: the package being transpiled over) -------------

def _if_tensor(x):
    y = x * 2.0
    if P.layers.reduce_sum(x) > 3.0:
        y = y + 10.0
    else:
        y = y - 10.0
    return y


def _if_python(x, flag):
    if flag:                      # plain Python bool → no cond op
        return x + 1.0
    return x - 1.0


def _while_tensor(x):
    i = P.layers.fill_constant([1], "float32", 0.0)
    s = x
    while P.layers.reduce_sum(i) < 3.0:
        s = s * 2.0
        i = i + 1.0
    return s


def _for_tensor_bound(x, n):
    for i in range(n):
        x = x + 1.0
    return x


def _for_python_bound(x):
    for _ in range(3):            # concrete bound: unrolls via
        x = x * 2.0               # convert_while's Python path
    return x


def _for_doubling(x, n):
    y = x
    for i in range(n):
        y = y * 2.0
    return y


def _nested_if_in_while(x):
    i = P.layers.fill_constant([1], "float32", 0.0)
    while P.layers.reduce_sum(i) < 4.0:
        if P.layers.reduce_sum(i) < 2.0:
            x = x + 1.0
        else:
            x = x + 10.0
        i = i + 1.0
    return x


def _negative_step_python(x):
    s = 0
    for i in range(5, 0, -1):     # plain Python values
        s = s + i
    return x + float(s)


def _negative_step_tensor(x):
    for i in range(4, 0, -1):
        x = x + 1.0
    return x


# -- the 11 cases of tests/test_to_static.py --------------------------------

def test_if_on_tensor_pred_builds_cond():
    for xv in (np.ones((2, 2), np.float32),       # sum=4 > 3 → +10
               np.zeros((2, 2), np.float32)):     # sum=0 → -10
        (got,), types = _both(
            lambda pkg: _static(pkg, _if_tensor)(pkg.data("x", [2, 2])),
            {"x": xv})
        assert "conditional_block" in types
        expect = xv * 2.0 + (10.0 if xv.sum() > 3.0 else -10.0)
        np.testing.assert_allclose(got, expect, rtol=TOL)


def test_if_plain_python_pred_untouched():
    (got,), types = _both(
        lambda pkg: _static(pkg, _if_python)(pkg.data("x2", [2]), True),
        {"x2": np.zeros(2, np.float32)})
    assert "conditional_block" not in types
    np.testing.assert_allclose(got, np.ones(2, np.float32))


def test_while_on_tensor_pred():
    (got,), types = _both(
        lambda pkg: _static(pkg, _while_tensor, max_loop_iters=16)(
            pkg.data("x3", [2])),
        {"x3": np.ones(2, np.float32)})
    assert "while" in types
    np.testing.assert_allclose(got, np.full(2, 8.0, np.float32))  # 2^3


def test_for_range_tensor_bound():
    def build(pkg):
        n = pkg.data("n4", [1], "int64")
        return _static(pkg, _for_tensor_bound, max_loop_iters=8)(
            pkg.data("x4", [2]), pkg.layers.reduce_sum(n))

    (got,), types = _both(build, {"x4": np.zeros(2, np.float32),
                                  "n4": np.array([5], np.int64)})
    assert "while" in types
    np.testing.assert_allclose(got, np.full(2, 5.0, np.float32))


def test_for_range_python_bound_still_python():
    (got,), types = _both(
        lambda pkg: _static(pkg, _for_python_bound)(pkg.data("x5", [2])),
        {"x5": np.ones(2, np.float32)})
    assert "while" not in types
    np.testing.assert_allclose(got, np.full(2, 8.0, np.float32))


def test_gradient_through_bounded_loop():
    """The converted While carries max_iters, so reverse-mode works
    (while_grad parity, operators/controlflow/while_op.cc)."""
    def build(pkg):
        x = pkg.data("x6", [2], stop_gradient=False)
        n = pkg.data("n6", [1], "int64")
        y = _static(pkg, _for_doubling, max_loop_iters=8)(
            x, pkg.layers.reduce_sum(n))
        loss = pkg.layers.reduce_sum(y)
        return [y, pkg.gradients(loss, [x])[0]]

    (y, g), _ = _both(build, {"x6": np.ones(2, np.float32),
                              "n6": np.array([3], np.int64)})
    np.testing.assert_allclose(y, np.full(2, 8.0, np.float32))
    np.testing.assert_allclose(g, np.full(2, 8.0, np.float32))  # d/dx 8x


def test_nested_if_in_while():
    (got,), types = _both(
        lambda pkg: _static(pkg, _nested_if_in_while, max_loop_iters=16)(
            pkg.data("x7", [2])),
        {"x7": np.zeros(2, np.float32)})
    assert "while" in types and "conditional_block" in types
    # steps 0,1: +1 each; steps 2,3: +10 each
    np.testing.assert_allclose(got, np.full(2, 22.0, np.float32))


def _eager_branch(x):
    if float(x.numpy().sum()) > 3.0:
        return x + 10.0
    return x - 10.0


def test_eager_mode_uses_python_control_flow():
    """Under dygraph the same decorated function sees CONCRETE values, so
    control flow runs as plain Python (the reference's ProgramTranslator
    passthrough) — the same answers as the JAX package's eager call."""
    x = np.ones((2, 2), np.float32)
    with jpt.dygraph.guard():
        want = jpt.dygraph.to_static(_eager_branch)(
            jpt.dygraph.to_variable(x)).numpy()
    with pt.dygraph.guard("cpu"):
        out = pt.dygraph.to_static(_eager_branch)(pt.dygraph.to_variable(x))
        np.testing.assert_allclose(out.numpy(),
                                   np.full((2, 2), 11.0, np.float32))
        np.testing.assert_allclose(out.numpy(), want)


def test_for_range_negative_step():
    """Negative-step range must iterate (the desugared while test
    honours the step's sign: range(5, 0, -1) runs 5 times)."""
    (got,), _ = _both(
        lambda pkg: _static(pkg, _negative_step_python)(
            pkg.data("xn", [2])),
        {"xn": np.zeros(2, np.float32)})
    np.testing.assert_allclose(got, np.full(2, 15.0, np.float32))


def test_for_range_negative_step_tensor_body():
    """Negative step with a tensor loop body (graph While path)."""
    (got,), _ = _both(
        lambda pkg: _static(pkg, _negative_step_tensor, max_loop_iters=8)(
            pkg.data("xn2", [2])),
        {"xn2": np.zeros(2, np.float32)})
    np.testing.assert_allclose(got, np.full(2, 4.0, np.float32))


def test_range_zero_step_rejected():
    from paddle_tpu_torch.dygraph.to_static import (convert_range_continues,
                                                    unwrap)

    with pytest.raises(ValueError):
        convert_range_continues(0, 5, 0)
    with pytest.raises(NotImplementedError, match="tensor step"):
        convert_range_continues(0, 5, pt.Program().global_block().create_var(
            name="s", shape=[1], dtype="int64"))
    assert unwrap(pt.dygraph.to_static(_if_python)) is _if_python
