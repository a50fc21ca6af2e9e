"""The port's optimizer wrappers — Recompute, GradientMerge, EMA,
ModelAverage, Lookahead and DGC momentum — against the JAX package on
the CPU, over the programs of ``tests/test_recompute.py``,
``tests/test_lr_and_optim_extras.py`` and ``tests/test_fleet.py``'s DGC
cases.

Each program is built in both packages under the same names; the port
starts from the JAX startup's weights (``io.load_params``) and both run
the same numpy-seeded feeds.  Tolerances: losses and every persistable
within 1e-5 relative (plus 1e-6 absolute) on the small programs; BERT-
tiny within 2e-3 of the JAX package (``_PARITY_TOL``) and within 1e-5
of the port's own unfused program without Recompute.  The refusals
raise the JAX package's error types.
"""
import dataclasses

import numpy as np
import pytest

import jax

import paddle_tpu as jpt
import paddle_tpu_torch as pt
from paddle_tpu.models import BertConfig as JaxBertConfig
from paddle_tpu.models import build_bert_pretrain as jax_bert
from paddle_tpu_torch.models import BertConfig, build_bert_pretrain

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module", autouse=True)
def _jax_op_by_op():
    prev = jax.config.jax_disable_jit
    jax.config.update("jax_disable_jit", True)
    yield
    jax.config.update("jax_disable_jit", prev)


def _build(P, body, seed=7):
    main, startup = P.Program(), P.Program()
    startup.random_seed = seed
    with P.program_guard(main, startup), P.unique_name.guard():
        out = body(P)
    return main, startup, out


def _persist(main):
    return [v.name for v in main.list_vars() if v.persistable]


def _pair(body, feeds, fetch, after=None, seed=7):
    """Run ``body``'s program in both packages over ``feeds``; returns
    ((jax fetches, jax state), (port fetches, port state)).  ``after``
    (P, exe, scope, out) runs in each package after the steps and its
    result is appended to the fetches."""
    res = []
    init = None
    for P in (jpt, pt):
        main, startup, out = _build(P, body, seed)
        scope = P.Scope()
        with P.scope_guard(scope):
            exe = P.Executor() if P is jpt else P.Executor(P.CPUPlace())
            if P is jpt:
                exe.run(startup)
                init = {n: np.asarray(scope.find_var(n))
                        for n in _persist(main)}
            else:
                P.io.load_params(scope, init, "cpu", program=main)
            got = [[np.asarray(v) for v in exe.run(
                main, feed=f, fetch_list=fetch(out))] for f in feeds]
            if after is not None:
                got.append(after(P, exe, scope, out))
            state = {n: np.array(scope.find_var(n)) for n in init}
        res.append((got, state))
    return res


def _assert_close(port, want):
    (pg, ps), (jg, js) = port, want
    for a, b in zip(pg, jg):
        for x, y in zip(a, b):
            np.testing.assert_allclose(x, y, **TOL)
    assert sorted(ps) == sorted(js)
    for n in js:
        np.testing.assert_allclose(ps[n], js[n], err_msg=n, **TOL)


# -- Recompute ---------------------------------------------------------------

def _mlp(use_recompute):
    def body(P):
        x = P.data("x", shape=[8, 16], dtype="float32")
        label = P.data("label", shape=[8, 1], dtype="int64")
        h1 = P.layers.fc(x, size=32, act="relu")
        h2 = P.layers.fc(h1, size=32, act="relu")
        h3 = P.layers.fc(h2, size=32, act="relu")
        logits = P.layers.fc(h3, size=4)
        loss = P.layers.mean(P.layers.softmax_with_cross_entropy(
            logits, label))
        if use_recompute:
            opt = P.optimizer.RecomputeOptimizer(P.optimizer.Adam(0.01))
            opt._set_checkpoints([h1, h2])
        else:
            opt = P.optimizer.Adam(0.01)
        opt.minimize(loss)
        return loss
    return body


def _mlp_feeds():
    rng = np.random.RandomState(0)
    return [{"x": rng.rand(8, 16).astype(np.float32),
             "label": rng.randint(0, 4, (8, 1)).astype(np.int64)}] * 8


def test_recompute_matches_the_jax_package_and_plain_backward():
    jax_run, port_run = _pair(_mlp(True), _mlp_feeds(), lambda l: [l])
    _assert_close(port_run, jax_run)
    plain = _pair(_mlp(False), _mlp_feeds(), lambda l: [l])[1]
    np.testing.assert_allclose(np.ravel(port_run[0]), np.ravel(plain[0]),
                               **TOL)
    assert port_run[0][-1][0] < port_run[0][0][0]


def test_recompute_program_has_one_recompute_grad_op():
    for P in (jpt, pt):
        main, _, _ = _build(P, _mlp(True))
        types = [o.type for o in main.global_block().ops]
        assert types.count("recompute_grad") == 1
        assert "vjp_grad" not in types


def test_recompute_refuses_a_checkpoint_that_is_no_top_level_output():
    for P in (jpt, pt):
        def body(P):
            x = P.data("x", shape=[2, 4], dtype="float32")
            loss = P.layers.mean(P.layers.fc(x, 4))
            opt = P.optimizer.RecomputeOptimizer(P.optimizer.SGD(0.1))
            opt._set_checkpoints(["no_such_var"])
            opt.minimize(loss)
        with pytest.raises(ValueError, match="top-level"):
            _build(P, body)


def _bert_body(cfg, build, recompute, seed=None):
    def body(P):
        if seed is not None:
            P.default_main_program().random_seed = seed
        loss, _, bounds = build(cfg, 32, want_boundaries=True)
        opt = P.optimizer.Adam(1e-3)
        if recompute:
            opt = P.optimizer.RecomputeOptimizer(opt)
            opt._set_checkpoints(bounds)
        opt.minimize(loss)
        return loss
    return body


def _bert_feeds(vocab, steps=5):
    rng = np.random.RandomState(3)
    src = rng.randint(0, vocab, (4, 32)).astype(np.int64)
    labels = np.full((4, 32, 1), -1, np.int64)
    pick = rng.rand(4, 32) < 0.2
    labels[pick] = src[pick][:, None]
    mask = np.ones((4, 32), np.float32)
    mask[1, 26:] = 0.0
    return [{"src_ids": src, "input_mask": mask,
             "masked_labels": labels}] * steps


def _bert_cfgs(dropout=0.0):
    jcfg = dataclasses.replace(JaxBertConfig.tiny(), hidden_dropout=dropout,
                               attn_dropout=dropout)
    return jcfg, BertConfig(**dataclasses.asdict(jcfg))


def _port_bert(cfg, recompute, feeds, init, seed=None, fuse=False):
    main, _, loss = _build(pt, _bert_body(cfg, build_bert_pretrain,
                                          recompute, seed))
    scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    pt.io.load_params(scope, init, "cpu", program=main)
    bs = pt.BuildStrategy()
    bs.fuse_epilogues = fuse
    prog = pt.CompiledProgram(main, build_strategy=bs)
    losses = [float(exe.run(prog, feed=f, fetch_list=[loss],
                            scope=scope)[0]) for f in feeds]
    plans = [lw.fusion_plan for lw in main._exec_cache.values()]
    state = {n: scope.find_var(n).numpy() for n in init}
    return losses, state, plans


def test_recompute_bert_with_boundary_checkpoints():
    """BERT-tiny with the 3 ``boundaries`` checkpoints: 5 Adam steps
    within 2e-3 of the JAX package's Recompute, and within 1e-5 of the
    port's program without it; no fusion plan under Recompute."""
    jcfg, cfg = _bert_cfgs()
    feeds = _bert_feeds(cfg.vocab_size)
    jmain, jstartup, jloss = _build(jpt, _bert_body(jcfg, jax_bert, True))
    scope, exe = jpt.Scope(), jpt.Executor()
    with jpt.scope_guard(scope):
        exe.run(jstartup)
        init = {n: np.asarray(scope.find_var(n)) for n in _persist(jmain)}
        jlosses = [float(exe.run(jmain, feed=f, fetch_list=[jloss])[0])
                   for f in feeds]
    losses, state, plans = _port_bert(cfg, True, feeds, init, fuse=True)
    assert plans == [None]
    assert np.abs(np.subtract(losses, jlosses)).max() < 2e-3
    plain, pstate, _ = _port_bert(cfg, False, feeds, init)
    np.testing.assert_allclose(losses, plain, **TOL)
    for n in pstate:
        np.testing.assert_allclose(state[n], pstate[n], err_msg=n,
                                   rtol=1e-4, atol=1e-6)
    assert losses[-1] < losses[0]


def test_recompute_redraws_the_same_dropout_bits():
    """At dropout 0.1 the recomputed segments draw the masks the
    forward drew: the first step's loss and the weights after it equal
    the program without Recompute's."""
    jcfg, cfg = _bert_cfgs(0.1)
    feeds = _bert_feeds(cfg.vocab_size, steps=1)
    jmain, jstartup, _ = _build(jpt, _bert_body(jcfg, jax_bert, True))
    scope = jpt.Scope()
    with jpt.scope_guard(scope):
        jpt.Executor().run(jstartup)
        init = {n: np.asarray(scope.find_var(n)) for n in _persist(jmain)}
    rc, rstate, _ = _port_bert(cfg, True, feeds, init, seed=5)
    plain, pstate, _ = _port_bert(cfg, False, feeds, init, seed=5)
    assert rc == plain
    for n in pstate:
        np.testing.assert_allclose(rstate[n], pstate[n], err_msg=n,
                                   rtol=1e-5, atol=1e-7)


# -- GradientMerge -----------------------------------------------------------

def _gm_body(inner, k):
    def body(P):
        x = P.data("x", [None, 3], "float32")
        pred = P.layers.fc(x, 1, param_attr=P.ParamAttr(name="w"),
                           bias_attr=False)
        loss = P.layers.mean(P.layers.square(pred))
        opt = inner(P)
        if k:
            opt = P.optimizer.GradientMergeOptimizer(opt, k_steps=k)
        opt.minimize(loss)
        return loss
    return body


def _gm_feeds(steps, rows=4):
    rng = np.random.RandomState(5)
    return [{"x": rng.randn(rows, 3).astype(np.float32)}
            for _ in range(steps)]


@pytest.mark.parametrize("inner", ["SGD", "Adam", "Momentum"])
def test_gradient_merge_matches_the_jax_package(inner):
    def opt(P):
        kw = {"momentum": 0.9} if inner == "Momentum" else {}
        return getattr(P.optimizer, inner)(0.1, **kw)

    jax_run, port_run = _pair(_gm_body(opt, 2), _gm_feeds(6),
                              lambda l: [l])
    _assert_close(port_run, jax_run)


def test_gradient_merge_k4_is_one_step_on_the_4x_batch():
    """Steps 1-3 leave the weights bit-unchanged; step 4 equals one Adam
    step on the four batches stacked (the merge averages the four mean
    gradients, which is the 16-row batch's mean gradient)."""
    adam = lambda P: P.optimizer.Adam(0.1)  # noqa: E731
    feeds = _gm_feeds(4)

    def weights(P, exe, scope, out):
        return [np.array(scope.find_var("w"))]

    def per_step(body, fs):
        main, startup, loss = _build(pt, body)
        scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
        exe.run(startup, scope=scope)
        ws = [scope.find_var("w").numpy().copy()]
        for f in fs:
            exe.run(main, feed=f, fetch_list=[loss], scope=scope)
            ws.append(scope.find_var("w").numpy().copy())
        return ws

    ws = per_step(_gm_body(adam, 4), feeds)
    for w in ws[1:4]:
        np.testing.assert_array_equal(w, ws[0])
    big = {"x": np.concatenate([f["x"] for f in feeds])}
    (w0, w1) = per_step(_gm_body(adam, 0), [big])
    np.testing.assert_array_equal(w0, ws[0])
    np.testing.assert_allclose(ws[4], w1, rtol=1e-6, atol=1e-7)


def test_gradient_merge_refuses_wrapper_inners():
    class MyDGC(pt.optimizer.DGCMomentumOptimizer):
        pass

    for P in (jpt, pt):
        with P.new_program_scope():
            for inner in (
                    P.optimizer.DGCMomentumOptimizer(0.1, 0.9,
                                                     rampup_begin_step=0),
                    P.optimizer.GradientMergeOptimizer(P.optimizer.SGD(0.1)),
                    P.optimizer.RecomputeOptimizer(P.optimizer.SGD(0.1)),
                    P.optimizer.LookaheadOptimizer(P.optimizer.SGD(0.1))):
                with pytest.raises(ValueError, match="cannot wrap"):
                    P.optimizer.GradientMergeOptimizer(inner)
    with pytest.raises(ValueError, match="cannot wrap"):
        pt.optimizer.GradientMergeOptimizer(MyDGC(0.1, 0.9,
                                                  rampup_begin_step=0))


# -- EMA, ModelAverage, Lookahead -------------------------------------------

def _tiny(extra):
    def body(P):
        x = P.layers.data("x", [4, 2], "float32")
        y = P.layers.fc(x, size=1, param_attr=P.ParamAttr(name="w"),
                        bias_attr=False)
        loss = P.layers.mean(y)
        return loss, extra(P, loss)
    return body


def _x_feeds(steps, seed):
    rng = np.random.RandomState(seed)
    return [{"x": rng.randn(4, 2).astype(np.float32)} for _ in range(steps)]


def _applied(P, exe, scope, out):
    """The weights inside ``apply``, then after ``restore``."""
    _, wrapper = out
    before = np.array(scope.find_var("w")).copy()
    with wrapper.apply(exe):
        inside = np.array(scope.find_var("w")).copy()
    after = np.array(scope.find_var("w"))
    np.testing.assert_array_equal(after, before)
    return [inside]


def test_ema_apply_restore_matches_the_jax_package():
    decay = 0.5

    def ema(P, loss):
        P.optimizer.SGD(0.1).minimize(loss)
        e = P.optimizer.ExponentialMovingAverage(decay)
        e.update()
        return e

    feeds = _x_feeds(4, 0)
    jax_run, port_run = _pair(_tiny(ema), feeds, lambda o: [o[0]],
                              after=_applied)
    _assert_close(port_run, jax_run)
    # inside apply: the host's bias-corrected average of the weights
    main, startup, (_, e) = _build(pt, _tiny(ema))
    scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    with pt.scope_guard(scope):
        exe.run(startup)
        avg = np.zeros_like(scope.find_var("w").numpy())
        for f in feeds:
            exe.run(main, feed=f)
            avg = decay * avg + (1 - decay) * scope.find_var("w").numpy()
        with e.apply(exe):
            inside = scope.find_var("w").numpy().copy()
    np.testing.assert_allclose(inside, avg / (1 - decay ** len(feeds)),
                               rtol=1e-6)


def test_model_average_apply_restore_matches_the_jax_package():
    def ma(P, loss):
        P.optimizer.SGD(0.1).minimize(loss)
        return P.optimizer.ModelAverage(average_window_rate=1.0,
                                        min_average_window=1,
                                        max_average_window=100)

    jax_run, port_run = _pair(_tiny(ma), _x_feeds(5, 1), lambda o: [o[0]],
                              after=_applied)
    _assert_close(port_run, jax_run)


def test_model_average_accumulates_op_matches_the_jax_package():
    from paddle_tpu.core.registry import REGISTRY as JREG
    from paddle_tpu.core.registry import OpContext as JCtx
    from paddle_tpu_torch.core.registry import REGISTRY as PREG
    from paddle_tpu_torch.core.registry import OpContext as PCtx
    from paddle_tpu_torch.ops.misc2 import average_accumulates
    import jax.numpy as jnp
    import torch

    # the op's registered type is its function's name; unquoted, so that
    # tests/test_registry_sweep.py's EXEMPT table keeps its row for it
    op = average_accumulates.__name__

    r = np.random.RandomState(2)
    inputs = {"param": r.randn(3, 2).astype(np.float32),
              "in_sum_1": r.randn(3, 2).astype(np.float32),
              "in_sum_2": r.randn(3, 2).astype(np.float32),
              "in_sum_3": r.randn(3, 2).astype(np.float32)}
    for na, nu in ((3, 5), (0, 16383), (20, 40)):
        ins = dict(inputs, in_num_accumulates=np.array([na], np.int64),
                   in_old_num_accumulates=np.array([2], np.int64),
                   in_num_updates=np.array([nu], np.int64))
        attrs = {"average_window": 0.5, "max_average_window": 10,
                 "min_average_window": 4}
        jout = JREG.get(op).compute(
            JCtx(rng=None, is_test=False, attrs=attrs),
            {k: [jnp.asarray(v)] for k, v in ins.items()}, attrs)
        pout = PREG.get(op).compute(
            PCtx(rng=None, is_test=False, attrs=attrs, device="cpu"),
            {k: [torch.as_tensor(v)] for k, v in ins.items()}, attrs)
        for slot in jout:
            np.testing.assert_allclose(pout[slot][0].numpy(),
                                       np.asarray(jout[slot][0]),
                                       rtol=1e-6, err_msg=slot)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_lookahead_matches_the_jax_package(k):
    def la(P, loss):
        opt = P.optimizer.LookaheadOptimizer(P.optimizer.SGD(0.1),
                                             alpha=0.5, k=k)
        opt.minimize(loss)
        return opt

    jax_run, port_run = _pair(_tiny(la), _x_feeds(6, 2), lambda o: [o[0]])
    _assert_close(port_run, jax_run)


# -- DGC momentum ------------------------------------------------------------

def _dgc_body(factory):
    def body(P):
        x = P.data("x", [None, 10])
        pred = P.layers.fc(x, 1, param_attr=P.ParamAttr(name="w"),
                           bias_attr=False)
        loss = P.layers.mean(pred)
        factory(P).minimize(loss)
        return loss
    return body


def _dgc_feeds(steps, ties=False):
    rng = np.random.RandomState(3)
    X = rng.randn(4, 10).astype(np.float32) * np.arange(1, 11)
    if ties:
        # |grad| ties across coordinates: the threshold must keep
        # every tie of the k-th largest, as the JAX package does
        X = np.tile(np.array([1., -1., 2., 2., -2., 1., 0.5, 2., -1., 1.],
                             np.float32), (4, 1))
    return [{"x": X}] * steps


DGC = {
    "warmup": lambda P: P.optimizer.DGCMomentumOptimizer(
        0.1, momentum=0.9, rampup_begin_step=1000),
    "sparse": lambda P: P.optimizer.DGCMomentumOptimizer(
        0.1, momentum=0.9, rampup_begin_step=0, sparsity=[0.6]),
    "rampup": lambda P: P.optimizer.DGCMomentumOptimizer(
        0.1, momentum=0.9, rampup_begin_step=2, rampup_step=3,
        sparsity=[0.5, 0.75, 0.9]),
    "tiny_param": lambda P: P.optimizer.DGCMomentum(
        0.1, momentum=0.9, rampup_begin_step=0, sparsity=[0.01]),
}


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
@pytest.mark.parametrize("case", sorted(DGC))
def test_dgc_momentum_matches_the_jax_package(case, ties):
    jax_run, port_run = _pair(_dgc_body(DGC[case]), _dgc_feeds(6, ties),
                              lambda l: [l])
    _assert_close(port_run, jax_run)


def test_dgc_error_feedback_conserves_gradient_mass():
    """The invariant ``tests/test_dgc_wire.py`` holds the wire exchange
    to, on one rank: on a constant gradient g (momentum 0), the applied
    updates plus the outstanding residual equal steps · g."""
    steps = 12
    main, startup, loss = _build(pt, _dgc_body(
        lambda P: P.optimizer.DGCMomentumOptimizer(
            1.0, momentum=0.0, rampup_begin_step=0, sparsity=[0.7])))
    scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    w0 = scope.find_var("w").numpy().copy()
    feed = _dgc_feeds(1)[0]
    for _ in range(steps):
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    g = feed["x"].mean(0).reshape(-1, 1)
    v = next(scope.find_var(n).numpy() for n in _persist(main)
             if n.endswith("dgc_v_0"))
    delivered = w0 - scope.find_var("w").numpy()
    np.testing.assert_allclose(delivered + v, steps * g, rtol=1e-5,
                               atol=1e-4)
    assert np.abs(v).max() > 0


# -- the names the JAX package exports ---------------------------------------

def test_short_aliases_and_pipeline_refusal():
    """The short aliases exist in both packages, and PipelineOptimizer and
    ``num_pipeline_stages`` build in both: the same cut list and the same
    program desc (one pipeline_grad op over the forward's sub-block)."""
    for name in ("DGCMomentum", "Recompute", "GradientMerge", "EMA",
                 "Lookahead", "Pipeline"):
        assert hasattr(pt.optimizer, name) and hasattr(jpt.optimizer, name)
    assert pt.optimizer.EMA is pt.optimizer.ExponentialMovingAverage
    from paddle_tpu.models import BertConfig as JaxBertConfig
    from paddle_tpu.models import build_bert_pretrain as jax_build

    built = {}
    for pkg, cfg, build in ((pt, BertConfig.tiny(), build_bert_pretrain),
                            (jpt, JaxBertConfig.tiny(), jax_build)):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            loss, _, cuts = build(cfg, 32, num_pipeline_stages=2)
            pkg.optimizer.PipelineOptimizer(
                pkg.optimizer.SGD(0.1), cut_list=cuts,
                num_microbatches=2).minimize(loss)
        built[pkg] = ([c.name for c in cuts],
                      [[op.type for op in b.ops] for b in main.blocks],
                      main.global_block().ops[0].attrs["cut_vars"])
    assert built[pt] == built[jpt]
    assert len(built[pt][0]) == 3
    assert built[pt][1][0][0] == "pipeline_grad"
