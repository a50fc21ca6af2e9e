"""The port's SelectedRows (sparse embedding) gradients against the JAX
package on the CPU, over the programs and feeds of
``tests/test_sparse_grad.py`` (its AMP cases wait for AMP).

Each program is built in both packages under the same names; the port
starts from the JAX startup's weights (``io.load_params``) and both run
the same feeds.  Tolerances: losses within 1e-6 relative, tables and
accumulators within 1e-5 relative plus 1e-6 absolute (the sparse ops
merge duplicate rows before adding, the JAX ones scatter-add each
duplicate, so roundings differ in the last bits); the fetched gradient
pair (Values, Rows) and the merge ops' outputs within 1e-6.  The port's
sparse runs are also held to its own dense runs, as the JAX tests hold
theirs.
"""
import warnings

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

LOSS_TOL = 1e-6
STATE_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _jax_op_by_op():
    prev = jax.config.jax_disable_jit
    jax.config.update("jax_disable_jit", True)
    yield
    jax.config.update("jax_disable_jit", prev)


def _build(P, is_sparse, vocab=50, dim=4, optimizer=None, batch=6,
           extra_fc=False, padding_idx=None):
    """``tests/test_sparse_grad.py``'s ``_build`` in package ``P``;
    ``optimizer`` is a function of the package."""
    main, startup = P.Program(), P.Program()
    startup.random_seed = 13
    with P.program_guard(main, startup), P.unique_name.guard():
        ids = P.data("ids", [batch, 1], "int64")
        target = P.data("target", [batch, dim])
        emb = P.layers.embedding(
            ids, (vocab, dim), is_sparse=is_sparse, padding_idx=padding_idx,
            param_attr=P.ParamAttr(name="table"))
        if extra_fc:
            emb = P.layers.fc(emb, dim, param_attr=P.ParamAttr(name="fc_w"))
        loss = P.layers.mean(P.layers.square_error_cost(emb, target))
        (optimizer or (lambda P: P.optimizer.SGD(0.5)))(P).minimize(loss)
    return main, startup, loss


def _feeds(batch=6, vocab=50, dim=4, dup=True):
    rng = np.random.RandomState(7)
    ids = rng.randint(0, vocab, (batch, 1)).astype(np.int64)
    if dup:
        ids[1] = ids[0]
    return {"ids": ids, "target": rng.randn(batch, dim).astype(np.float32)}


def _varying_feeds(steps=3, batch=6, vocab=50, dim=4):
    rng = np.random.RandomState(21)
    feeds = []
    for _ in range(steps):
        ids = rng.randint(0, vocab, (batch, 1)).astype(np.int64)
        ids[1] = ids[0]
        feeds.append({"ids": ids,
                      "target": rng.randn(batch, dim).astype(np.float32)})
    return feeds


def _persistables(main):
    return [v.name for v in main.list_vars() if v.persistable]


def _run_jax(main, startup, loss, feeds_list, fetch=()):
    scope, exe = jpt.Scope(), jpt.Executor()
    with jpt.scope_guard(scope):
        exe.run(startup)
        init = {n: np.asarray(scope.find_var(n)) for n in _persistables(main)}
        losses, fetched = [], []
        for f in feeds_list:
            res = exe.run(main, feed=f, fetch_list=[loss, *fetch])
            losses.append(float(np.asarray(res[0])))
            fetched.append([np.asarray(r) for r in res[1:]])
        state = {n: np.asarray(scope.find_var(n)) for n in init}
    return init, losses, fetched, state


def _run_port(main, loss, init, feeds_list, fetch=()):
    scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    pt.io.load_params(scope, init, "cpu", program=main)
    losses, fetched = [], []
    for f in feeds_list:
        res = exe.run(main, feed=f, fetch_list=[loss, *fetch], scope=scope)
        losses.append(float(np.asarray(res[0])))
        fetched.append([np.asarray(r) for r in res[1:]])
    state = {n: scope.find_var(n).numpy() for n in init}
    return losses, fetched, state


def _assert_state(got, want):
    assert sorted(got) == sorted(want)
    for n, w in want.items():
        np.testing.assert_allclose(got[n], w, rtol=STATE_TOL, atol=1e-6,
                                   err_msg=n)


def _both(feeds_list, fetch=(), **kw):
    """Run the program in both packages; returns (jax, port) as
    (losses, fetched, state), plus the initial weights."""
    jmain, jstartup, jloss = _build(jpt, **kw)
    init, jl, jf, js = _run_jax(jmain, jstartup, jloss, feeds_list, fetch)
    main, _, loss = _build(pt, **kw)
    assert ([o.type for o in main.global_block().ops]
            == [o.type for o in jmain.global_block().ops])
    pl, pf, ps = _run_port(main, loss, init, feeds_list, fetch)
    return (jl, jf, js), (pl, pf, ps), init


def test_sparse_grad_var_is_rows_values():
    main, _, _ = _build(pt, is_sparse=True)
    block = main.global_block()
    g = block.var("table@GRAD")
    assert getattr(g, "sparse_rows", None) == "table@GRAD@ROWS"
    assert list(g.shape)[1] == 4 and g.shape[0] is None
    types = [op.type for op in block.ops]
    assert "lookup_table_sparse_grad" in types and "sgd_sparse" in types
    assert not any(op.type == "sgd" and op.inputs["Param"] == ["table"]
                   for op in block.ops)
    jmain, _, _ = _build(jpt, is_sparse=True)
    assert types == [op.type for op in jmain.global_block().ops]


@pytest.mark.parametrize("padding_idx", [None, 3])
def test_rows_and_values_equal_the_jax_arrays(padding_idx):
    feeds = _feeds()
    if padding_idx is not None:
        feeds["ids"][2] = padding_idx
    fetch = ("table@GRAD", "table@GRAD@ROWS")
    (_, jf, _), (_, pf, _), _ = _both([feeds], fetch, is_sparse=True,
                                      padding_idx=padding_idx)
    (jv, jr), (pv, pr) = jf[0], pf[0]
    assert pv.shape == jv.shape == (6, 4)
    np.testing.assert_array_equal(pr, jr)
    np.testing.assert_allclose(pv, jv, rtol=1e-6, atol=1e-7)
    if padding_idx is not None:
        assert (pv[2] == 0).all()


def test_sparse_sgd_matches_dense_and_the_jax_package():
    feeds = [_feeds()] * 3
    (jl, _, js), (pl, _, ps), init = _both(feeds, is_sparse=True)
    np.testing.assert_allclose(pl, jl, rtol=LOSS_TOL)
    _assert_state(ps, js)
    main, _, loss = _build(pt, is_sparse=False)
    dl, _, ds = _run_port(main, loss, init, feeds)
    np.testing.assert_allclose(pl, dl, rtol=LOSS_TOL)
    np.testing.assert_allclose(ps["table"], ds["table"], rtol=STATE_TOL,
                               atol=1e-6)


def test_sparse_adam_default_nonlazy_matches_dense_multistep():
    feeds = _varying_feeds()
    adam = lambda P: P.optimizer.Adam(0.1)  # noqa: E731
    (jl, _, js), (pl, _, ps), init = _both(feeds, is_sparse=True,
                                           optimizer=adam)
    np.testing.assert_allclose(pl, jl, rtol=LOSS_TOL)
    _assert_state(ps, js)
    main, _, loss = _build(pt, is_sparse=False, optimizer=adam)
    dl, _, ds = _run_port(main, loss, init, feeds)
    np.testing.assert_allclose(pl, dl, rtol=LOSS_TOL)
    for n in ds:
        np.testing.assert_allclose(ps[n], ds[n], rtol=STATE_TOL, atol=1e-6,
                                   err_msg=n)


def test_sparse_adam_lazy_mode_touches_only_its_rows():
    feeds = _varying_feeds()
    lazy = lambda P: P.optimizer.Adam(0.1, lazy_mode=True)  # noqa: E731
    (jl, _, js), (pl, _, ps), init = _both(feeds, is_sparse=True,
                                           optimizer=lazy)
    np.testing.assert_allclose(pl, jl, rtol=LOSS_TOL)
    _assert_state(ps, js)
    main, _, _ = _build(pt, is_sparse=True, optimizer=lazy)
    ops = [op for op in main.global_block().ops if op.type == "adam_sparse"]
    assert ops and ops[0].attrs["lazy_mode"] is True
    touched = np.unique(np.concatenate([f["ids"].ravel() for f in feeds]))
    untouched = np.setdiff1d(np.arange(50), touched)
    np.testing.assert_array_equal(ps["table"][untouched],
                                  init["table"][untouched])
    m1 = next(n for n in ps if "_moment1" in n)
    np.testing.assert_array_equal(ps[m1][untouched], 0.0)


def test_sparse_adam_trains_multi_step():
    main, startup, loss = _build(pt, is_sparse=True,
                                 optimizer=lambda P: P.optimizer.Adam(0.05))
    scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    feeds = _feeds()
    losses = [float(exe.run(main, feed=feeds, fetch_list=[loss],
                            scope=scope)[0]) for _ in range(10)]
    assert losses[-1] < 0.5 * losses[0] and np.isfinite(losses).all()


def test_sparse_grad_memory_is_batch_sized():
    """1M-row table: the gradient the step materializes is [batch, dim],
    not [vocab, dim]; it equals the JAX package's."""
    vocab, dim, batch = 1_000_000, 8, 6
    kw = dict(is_sparse=True, vocab=vocab, dim=dim, batch=batch)
    feeds = _feeds(batch=batch, vocab=vocab, dim=dim)
    fetch = ("table@GRAD", "table@GRAD@ROWS")
    (_, jf, _), (_, pf, _), _ = _both([feeds], fetch, **kw)
    gv, rv = pf[0]
    assert gv.shape == (batch, dim) and rv.shape == (batch,)
    assert gv.nbytes < 1024
    np.testing.assert_allclose(gv, jf[0][0], rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(rv, jf[0][1])


def test_sparse_rejects_unsupported_optimizer():
    for P in (jpt, pt):
        with pytest.raises(ValueError, match="SelectedRows"):
            _build(P, is_sparse=True,
                   optimizer=lambda P: P.optimizer.Momentum(0.1, 0.9))


CLIPS = {
    "global_norm_sgd_fc": (lambda P: P.clip.GradientClipByGlobalNorm(0.05),
                           True, "SGD", 0.5),
    "global_norm_adam": (lambda P: P.clip.GradientClipByGlobalNorm(0.05),
                         False, "Adam", 0.1),
    "norm": (lambda P: P.clip.GradientClipByNorm(0.01), False, "SGD", 0.5),
    "value": (lambda P: P.clip.GradientClipByValue(0.001), False, "SGD",
              0.5),
}


@pytest.mark.parametrize("case", sorted(CLIPS))
def test_sparse_clip_matches_dense_and_the_jax_package(case):
    clip, extra_fc, opt, lr = CLIPS[case]

    def optimizer(P):
        return getattr(P.optimizer, opt)(lr, grad_clip=clip(P))

    feeds = [_feeds()] * 3
    (jl, _, js), (pl, _, ps), init = _both(
        feeds, is_sparse=True, extra_fc=extra_fc, optimizer=optimizer)
    np.testing.assert_allclose(pl, jl, rtol=LOSS_TOL)
    _assert_state(ps, js)
    main, _, loss = _build(pt, is_sparse=False, extra_fc=extra_fc,
                           optimizer=optimizer)
    dl, _, ds = _run_port(main, loss, init, feeds)
    np.testing.assert_allclose(pl, dl, rtol=1e-5)
    np.testing.assert_allclose(ps["table"], ds["table"], rtol=1e-4,
                               atol=1e-6)
    smain, _, _ = _build(pt, is_sparse=True, extra_fc=extra_fc,
                         optimizer=optimizer)
    types = [op.type for op in smain.global_block().ops]
    want = {"value": "clip_sparse"}.get(case, "squared_l2_norm_sparse")
    assert want in types


def test_sparse_clip_lazy_adam_padding_never_touches_row0():
    feeds = _feeds()
    assert not (feeds["ids"] == 0).any()

    def optimizer(P):
        return P.optimizer.Adam(0.1, lazy_mode=True,
                                grad_clip=P.clip.GradientClipByValue(0.001))

    (jl, _, js), (pl, _, ps), init = _both([feeds] * 3, is_sparse=True,
                                           optimizer=optimizer)
    np.testing.assert_allclose(pl, jl, rtol=LOSS_TOL)
    _assert_state(ps, js)
    np.testing.assert_array_equal(ps["table"][0], init["table"][0])
    m1 = next(n for n in ps if "_moment1" in n)
    np.testing.assert_array_equal(ps[m1][0], 0.0)


def test_sparse_regularization_densifies_and_matches_dense():
    def optimizer(P):
        return P.optimizer.SGD(0.5,
                               regularization=P.regularizer.L2Decay(0.1))

    feeds = [_feeds()] * 3
    pt.optimizer._densify_sparse_grad._warned.clear()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        main, _, _ = _build(pt, is_sparse=True, optimizer=optimizer)
    assert any("densifies" in str(w.message) for w in caught)
    assert "sparse_to_dense_grad" in [op.type
                                      for op in main.global_block().ops]
    (jl, _, js), (pl, _, ps), init = _both(feeds, is_sparse=True,
                                           optimizer=optimizer)
    np.testing.assert_allclose(pl, jl, rtol=LOSS_TOL)
    _assert_state(ps, js)
    dmain, _, dloss = _build(pt, is_sparse=False, optimizer=optimizer)
    dl, _, ds = _run_port(dmain, dloss, init, feeds)
    np.testing.assert_allclose(pl, dl, rtol=1e-5)
    np.testing.assert_allclose(ps["table"], ds["table"], rtol=1e-4,
                               atol=1e-6)


def _multi_use(P):
    main, startup = P.Program(), P.Program()
    startup.random_seed = 3
    with P.program_guard(main, startup), P.unique_name.guard():
        ids = P.data("ids", [4, 1], "int64")
        ids2 = P.data("ids2", [4, 1], "int64")
        e1 = P.layers.embedding(ids, (20, 4), is_sparse=True,
                                param_attr=P.ParamAttr(name="table"))
        e2 = P.layers.embedding(ids2, (20, 4), is_sparse=True,
                                param_attr=P.ParamAttr(name="table"))
        loss = P.layers.mean(P.layers.elementwise_add(e1, e2))
        P.optimizer.SGD(0.1).minimize(loss)
    return main, startup, loss


def test_multi_use_table_falls_back_to_dense():
    jmain, jstartup, jloss = _multi_use(jpt)
    main, _, loss = _multi_use(pt)
    types = [op.type for op in main.global_block().ops]
    assert "lookup_table_sparse_grad" not in types
    assert types == [op.type for op in jmain.global_block().ops]
    rng = np.random.RandomState(0)
    feeds = {"ids": rng.randint(0, 20, (4, 1)).astype(np.int64),
             "ids2": rng.randint(0, 20, (4, 1)).astype(np.int64)}
    init, jl, _, js = _run_jax(jmain, jstartup, jloss, [feeds])
    pl, _, ps = _run_port(main, loss, init, [feeds])
    np.testing.assert_allclose(pl, jl, rtol=LOSS_TOL)
    _assert_state(ps, js)


@pytest.mark.parametrize("opt", ["SGD", "Adam", "lazy"])
def test_out_of_range_ids_follow_the_forward_rule(opt):
    """An id in [-vocab, 0) wraps and one outside [-vocab, vocab) updates
    no row, in the JAX package and the port; the forward gives NaN rows
    for the latter, so the loss is NaN in both."""
    def optimizer(P):
        if opt == "lazy":
            return P.optimizer.Adam(0.1, lazy_mode=True)
        return getattr(P.optimizer, opt)(0.1)

    feeds = _feeds()
    feeds["ids"][:4, 0] = [-3, 50 + 2, -50 - 4, 7]
    (jl, _, js), (pl, _, ps), init = _both([feeds], is_sparse=True,
                                           optimizer=optimizer)
    assert np.isnan(jl).all() and np.isnan(pl).all()
    _assert_state(ps, js)
    assert np.isfinite(ps["table"]).all()
    changed = np.flatnonzero((ps["table"] != init["table"]).any(1))
    np.testing.assert_array_equal(
        changed, sorted({47, 7} | set(feeds["ids"][4:, 0].tolist())))


def test_sparse_steps_are_bit_reproducible():
    feeds = _varying_feeds()
    lazy = lambda P: P.optimizer.Adam(0.1, lazy_mode=True)  # noqa: E731
    jmain, jstartup, jloss = _build(jpt, is_sparse=True, optimizer=lazy)
    init, _, _, _ = _run_jax(jmain, jstartup, jloss, feeds[:1])
    main, _, loss = _build(pt, is_sparse=True, optimizer=lazy)
    a = _run_port(main, loss, init, feeds)
    b = _run_port(main, loss, init, feeds)
    assert a[0] == b[0]
    for n in a[2]:
        np.testing.assert_array_equal(a[2][n], b[2][n])


# -- the SelectedRows ops, op for op ----------------------------------------

def _op_pair(op_type, inputs, attrs):
    jout = JREG.get(op_type).compute(
        JCtx(rng=None, is_test=False, attrs=attrs),
        {k: [jnp.asarray(v)] for k, v in inputs.items()}, attrs)
    pout = PREG.get(op_type).compute(
        PCtx(rng=None, is_test=False, attrs=attrs, device="cpu"),
        {k: [torch.as_tensor(v)] for k, v in inputs.items()}, attrs)
    return jout, pout


def _rows_case(seed, n=12, vocab=9, dim=3):
    r = np.random.RandomState(seed)
    return (r.randn(n, dim).astype(np.float32),
            r.randint(0, vocab, n).astype(np.int64))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("op_type", ["squared_l2_norm_sparse",
                                     "clip_sparse", "sparse_to_dense_grad",
                                     "get_tensor_from_selected_rows",
                                     "merge_selected_rows"])
def test_selected_rows_ops_match_the_jax_package(op_type, seed):
    v, rows = _rows_case(seed)
    if op_type in ("get_tensor_from_selected_rows", "merge_selected_rows"):
        inputs, attrs = {"X": v}, {}
    else:
        inputs = {"Values": v, "Rows": rows}
        attrs = {"clip_sparse": {"min": -0.5, "max": 0.7, "pad_row": 9},
                 "sparse_to_dense_grad": {"shape": [9, 3]}}.get(op_type, {})
    jout, pout = _op_pair(op_type, inputs, attrs)
    assert sorted(jout) == sorted(pout)
    for slot in jout:
        want = np.asarray(jout[slot][0])
        got = pout[slot][0].numpy()
        assert got.shape == want.shape, slot
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6,
                                   err_msg=slot)


@pytest.mark.parametrize("op_type,lazy", [("sgd_sparse", False),
                                          ("adam_sparse", False),
                                          ("adam_sparse", True)])
def test_sparse_update_ops_match_the_jax_package(op_type, lazy):
    """Each output within 1e-6; the op writes none of its inputs (an
    assign aliases, so GradientMerge's snapshots depend on it)."""
    v, rows = _rows_case(3)
    r = np.random.RandomState(4)
    p = r.randn(9, 3).astype(np.float32)
    inputs = {"Param": p, "Values": v, "Rows": rows,
              "LearningRate": np.array([0.1], np.float32)}
    attrs = {}
    if op_type == "adam_sparse":
        inputs.update(Moment1=r.randn(9, 3).astype(np.float32) * 0.1,
                      Moment2=r.rand(9, 3).astype(np.float32) * 0.1,
                      Beta1Pow=np.array([0.81], np.float32),
                      Beta2Pow=np.array([0.998], np.float32))
        attrs = {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8,
                 "lazy_mode": lazy}
    before = {k: np.array(x, copy=True) for k, x in inputs.items()}
    jout, pout = _op_pair(op_type, inputs, attrs)
    for slot in jout:
        np.testing.assert_allclose(pout[slot][0].numpy(),
                                   np.asarray(jout[slot][0]), rtol=1e-6,
                                   atol=1e-6, err_msg=slot)
    for k, x in inputs.items():
        np.testing.assert_array_equal(x, before[k], err_msg=k)
