"""The port's vision ops — conv2d, depthwise_conv2d, conv2d_transpose,
pool2d and batch_norm — against the JAX package's on the CPU, and
batch norm's running statistics through the port's Executor paths.

Op level: numpy-seeded inputs through both ops' compute functions (the
JAX ops are ``lax.conv_general_dilated``, ``reduce_window`` and jnp;
the port's ``F.conv2d``, ``F.max_pool2d``/``F.avg_pool2d`` and
``F.batch_norm``); every output within 1e-5 (absolute and relative),
and the gradient of ``sum(out · c)`` for a seeded cotangent ``c`` with
respect to every floating input (``jax.vjp`` against
``torch.autograd``) within 1e-5.

Program level (port only): the statistics a training step writes are
the same under ``Executor.run``, the dataset trainer's K-step chunk and
``RecomputeOptimizer`` (whose second forward must not write them again),
and a ``clone(for_test=True)`` reads them without writing.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu_torch as pt
from paddle_tpu.core.registry import REGISTRY as JREG
from paddle_tpu.core.registry import OpContext as JCtx
from paddle_tpu_torch.core.registry import REGISTRY as PREG
from paddle_tpu_torch.core.registry import OpContext as PCtx

TOL = dict(rtol=1e-5, atol=1e-5)


def _s(r, *shape):
    return r.randn(*shape).astype(np.float32)


def _conv(r, n=2, c=4, hw=9, o=6, k=3, g=1, bias=False):
    ins = {"Input": _s(r, n, c, hw, hw),
           "Filter": (_s(r, o, c // g, k, k)
                      / np.float32(np.sqrt(c // g * k * k)))}
    if bias:
        ins["Bias"] = _s(r, o)
    return ins


def _bn(r, shape, c):
    return {"X": _s(r, *shape) * 2 + 0.5, "Scale": _s(r, c),
            "Bias": _s(r, c), "Mean": _s(r, c) * 0.1,
            "Variance": (r.rand(c) + 0.5).astype(np.float32)}


#: name -> (op, inputs(r), attrs, is_test)
CASES = {
    "conv_plain": ("conv2d", lambda r: _conv(r), {}, False),
    "conv_bias": ("conv2d", lambda r: _conv(r, bias=True),
                  {"paddings": [1, 1]}, False),
    "conv_stride2_pad": ("conv2d", lambda r: _conv(r, k=7, hw=16),
                         {"strides": [2, 2], "paddings": [3, 3]}, False),
    "conv_rect": ("conv2d", lambda r: _conv(r, hw=10),
                  {"strides": [1, 2], "paddings": [0, 2]}, False),
    "conv_dilated": ("conv2d", lambda r: _conv(r, hw=11),
                     {"dilations": [2, 2], "paddings": [2, 2]}, False),
    "conv_groups": ("conv2d", lambda r: _conv(r, c=8, o=8, g=4, bias=True),
                    {"groups": 4, "paddings": [1, 1]}, False),
    "conv_1x1_stride2": ("conv2d", lambda r: _conv(r, k=1, hw=8),
                         {"strides": [2, 2]}, False),
    "depthwise": ("depthwise_conv2d", lambda r: _conv(r, c=6, o=6, g=6),
                  {"groups": 6, "paddings": [1, 1]}, False),
    "depthwise_default_groups": ("depthwise_conv2d",
                                 lambda r: _conv(r, c=5, o=5, g=5),
                                 {"strides": [2, 2]}, False),
    "depthwise_mult2": ("depthwise_conv2d",
                        lambda r: _conv(r, c=4, o=8, g=4, bias=True),
                        {"groups": 4, "paddings": [1, 1]}, False),
    # the JAX op reads the filter's axis 1 as the input's channels
    "conv_transpose": ("conv2d_transpose", lambda r: {
        "Input": _s(r, 2, 4, 5, 5), "Filter": _s(r, 3, 4, 3, 3) / 6},
        {"strides": [2, 2], "paddings": [1, 1]}, False),
    "conv_transpose_nopad": ("conv2d_transpose", lambda r: {
        "Input": _s(r, 2, 3, 4, 6), "Filter": _s(r, 5, 3, 4, 4) / 6},
        {"strides": [2, 1], "paddings": [0, 0]}, False),
    "conv_transpose_wide_pad": ("conv2d_transpose", lambda r: {
        "Input": _s(r, 1, 2, 4, 4), "Filter": _s(r, 3, 2, 2, 2) / 3},
        {"strides": [1, 1], "paddings": [2, 1]}, False),
    "pool_max": ("pool2d", lambda r: {"X": _s(r, 2, 3, 8, 8)},
                 {"pooling_type": "max", "ksize": [2, 2],
                  "strides": [2, 2]}, False),
    "pool_max_pad": ("pool2d", lambda r: {"X": _s(r, 2, 3, 9, 9)},
                     {"pooling_type": "max", "ksize": [3, 3],
                      "strides": [2, 2], "paddings": [1, 1]}, False),
    "pool_max_negative_pad": ("pool2d",
                              lambda r: {"X": -np.abs(_s(r, 2, 3, 7, 7))},
                              {"pooling_type": "max", "ksize": [3, 3],
                               "strides": [2, 2], "paddings": [1, 1]},
                              False),
    "pool_max_wide_pad": ("pool2d", lambda r: {"X": _s(r, 1, 2, 6, 6)},
                          {"pooling_type": "max", "ksize": [2, 2],
                           "strides": [2, 2], "paddings": [2, 2]}, False),
    "pool_avg": ("pool2d", lambda r: {"X": _s(r, 2, 3, 8, 8)},
                 {"pooling_type": "avg", "ksize": [2, 2],
                  "strides": [2, 2]}, False),
    "pool_avg_exclusive": ("pool2d", lambda r: {"X": _s(r, 2, 3, 9, 9)},
                           {"pooling_type": "avg", "ksize": [3, 3],
                            "strides": [2, 2], "paddings": [1, 1],
                            "exclusive": True}, False),
    "pool_avg_inclusive": ("pool2d", lambda r: {"X": _s(r, 2, 3, 9, 9)},
                           {"pooling_type": "avg", "ksize": [3, 3],
                            "strides": [2, 2], "paddings": [1, 1],
                            "exclusive": False}, False),
    "pool_avg_wide_pad_exclusive": ("pool2d",
                                    lambda r: {"X": _s(r, 1, 2, 6, 6)},
                                    {"pooling_type": "avg",
                                     "ksize": [2, 2], "strides": [1, 1],
                                     "paddings": [2, 2]}, False),
    "pool_global_avg": ("pool2d", lambda r: {"X": _s(r, 2, 5, 7, 7)},
                        {"pooling_type": "avg", "ksize": [7, 7],
                         "global_pooling": True}, False),
    "pool_global_max": ("pool2d", lambda r: {"X": _s(r, 2, 5, 4, 6)},
                        {"pooling_type": "max", "global_pooling": True},
                        False),
    "pool_adaptive_avg": ("pool2d", lambda r: {"X": _s(r, 2, 3, 8, 12)},
                          {"pooling_type": "avg", "ksize": [2, 3],
                           "adaptive": True}, False),
    "pool_adaptive_max": ("pool2d", lambda r: {"X": _s(r, 2, 3, 8, 8)},
                          {"pooling_type": "max", "ksize": [4, 4],
                           "adaptive": True}, False),
    "bn_train_nchw": ("batch_norm", lambda r: _bn(r, (4, 3, 5, 5), 3),
                      {"momentum": 0.9, "epsilon": 1e-5}, False),
    "bn_train_nhwc": ("batch_norm", lambda r: _bn(r, (4, 5, 5, 3), 3),
                      {"momentum": 0.8, "epsilon": 1e-3,
                       "data_layout": "NHWC"}, False),
    "bn_train_2d": ("batch_norm", lambda r: _bn(r, (6, 4), 4),
                    {"momentum": 0.9}, False),
    "bn_test_nchw": ("batch_norm", lambda r: _bn(r, (4, 3, 5, 5), 3),
                     {"momentum": 0.9}, True),
    "bn_test_nhwc": ("batch_norm", lambda r: _bn(r, (4, 5, 5, 3), 3),
                     {"data_layout": "NHWC"}, True),
    "bn_global_stats": ("batch_norm", lambda r: _bn(r, (4, 3, 5, 5), 3),
                        {"use_global_stats": True}, False),
}

#: the differentiable inputs of each op (batch norm's running statistics
#: are persistables nothing differentiates)
DIFF = {"conv2d": ("Input", "Filter", "Bias"),
        "depthwise_conv2d": ("Input", "Filter", "Bias"),
        "conv2d_transpose": ("Input", "Filter"), "pool2d": ("X",),
        "batch_norm": ("X", "Scale", "Bias")}
#: the outputs the gradient checks differentiate
DIFF_OUT = {"batch_norm": "Y", "pool2d": "Out"}


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_matches_the_jax_package(case):
    op_type, make, attrs, is_test = CASES[case]
    r = np.random.RandomState(sorted(CASES).index(case))
    inputs = make(r)
    jins = {k: [jnp.asarray(v)] for k, v in inputs.items()}
    pins = {k: [torch.as_tensor(v)] for k, v in inputs.items()}
    jop, pop = JREG.get(op_type), PREG.get(op_type)
    jctx = JCtx(rng=None, is_test=is_test, attrs=attrs)
    pctx = PCtx(rng=None, is_test=is_test, attrs=attrs, device="cpu")
    jout = jop.compute(jctx, jins, attrs)
    pout = pop.compute(pctx, pins, attrs)
    assert sorted(jout) == sorted(pout)
    for slot in jout:
        want = np.asarray(jout[slot][0])
        got = pout[slot][0].detach().numpy()
        assert got.shape == want.shape, slot
        assert got.dtype == want.dtype, slot
        np.testing.assert_allclose(got, want, err_msg=slot, **TOL)
    out_slot = DIFF_OUT.get(op_type, "Output")
    diff = [s for s in DIFF[op_type] if s in inputs]
    cot = r.randn(*np.asarray(jout[out_slot][0]).shape).astype(np.float32)

    def jf(*xs):
        ins = dict(jins, **{s: [x] for s, x in zip(diff, xs)})
        return jop.compute(jctx, ins, attrs)[out_slot][0]

    _, vjp = jax.vjp(jf, *[jins[s][0] for s in diff])
    jgrads = vjp(jnp.asarray(cot))
    xs = [pins[s][0].clone().requires_grad_() for s in diff]
    y = pop.compute(pctx, dict(pins, **{s: [x] for s, x in zip(diff, xs)}),
                    attrs)[out_slot][0]
    pgrads = torch.autograd.grad(y, xs, torch.as_tensor(cot))
    for s, pg, jg in zip(diff, pgrads, jgrads):
        np.testing.assert_allclose(pg.numpy(), np.asarray(jg), err_msg=s,
                                   **TOL)


def test_batch_norm_statistics_carry_no_graph():
    """Under autograd (a forward op a vjp_grad differentiates) the
    running statistics are plain values: writing them to the scope keeps
    no graph alive."""
    r = np.random.RandomState(0)
    ins = {k: [torch.as_tensor(v).requires_grad_()]
           for k, v in _bn(r, (4, 3, 5, 5), 3).items()}
    outs = PREG.get("batch_norm").compute(
        PCtx(device="cpu"), ins, {"momentum": 0.9})
    assert outs["Y"][0].requires_grad
    for slot in ("MeanOut", "VarianceOut", "SavedMean", "SavedVariance"):
        assert not outs[slot][0].requires_grad, slot


# -- batch norm's state through the port's Executor paths -------------------

def _bn_program(recompute=False):
    main, startup = pt.Program(), pt.Program()
    startup.random_seed = 3
    with pt.program_guard(main, startup), pt.unique_name.guard():
        img = pt.data("img", [None, 192])
        label = pt.data("label", [None, 1], "int64")
        h = pt.layers.conv2d(pt.layers.reshape(img, [-1, 3, 8, 8]), 4, 3,
                             padding=1, bias_attr=False)
        h = pt.layers.batch_norm(h, act="relu")
        ckpt = h
        h = pt.layers.pool2d(h, 2, "max", 2)
        h = pt.layers.batch_norm(pt.layers.conv2d(h, 4, 3, padding=1),
                                 act="relu")
        h = pt.layers.pool2d(h, pool_type="avg", global_pooling=True)
        logits = pt.layers.fc(h, 5)
        loss = pt.layers.mean(pt.layers.softmax_with_cross_entropy(
            logits, label))
        test = main.clone(for_test=True)
        opt = pt.optimizer.Momentum(0.1, 0.9)
        if recompute:
            opt = pt.optimizer.RecomputeOptimizer(opt)
            opt._set_checkpoints([ckpt])
        opt.minimize(loss)
    stats = sorted(v.name for v in main.list_vars()
                   if v.persistable and (".mean" in v.name
                                         or ".var" in v.name))
    return main, startup, test, loss, stats


def _bn_feeds(steps):
    r = np.random.RandomState(11)
    return [{"img": r.randn(4, 192).astype(np.float32),
             "label": r.randint(0, 5, (4, 1)).astype(np.int64)}
            for _ in range(steps)]


def _snapshot(scope, names):
    return {n: np.asarray(scope.find_var(n)).copy() for n in names}


def _run_steps(recompute=False, steps=2):
    main, startup, test, loss, stats = _bn_program(recompute)
    scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    before = _snapshot(scope, stats)
    losses = [float(exe.run(main, feed=f, fetch_list=[loss],
                            scope=scope)[0]) for f in _bn_feeds(steps)]
    return before, _snapshot(scope, stats), losses, (main, test, scope,
                                                     exe, loss, stats)


def test_executor_step_updates_the_running_statistics():
    before, after, losses, (main, *_rest) = _run_steps(steps=1)
    assert all(np.isfinite(losses))
    stats = sorted(before)
    assert len(stats) == 4
    for n in stats:
        assert not np.array_equal(before[n], after[n]), n
    # the first statistics by hand: momentum 0.9 over conv(img)'s batch
    scope = pt.Scope()
    main, startup, _, _, _ = _bn_program()
    exe = pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    w = np.asarray(scope.find_var(next(
        p.name for p in main.global_block().all_parameters()
        if p.shape[0] == 4 and len(p.shape) == 4 and p.shape[1] == 3)))
    conv = torch.nn.functional.conv2d(
        torch.as_tensor(_bn_feeds(1)[0]["img"].reshape(4, 3, 8, 8)),
        torch.as_tensor(w),
        padding=1).numpy()
    mean_name = next(n for n in stats if n.endswith(".mean_0")
                     and n.startswith("batch_norm_0"))
    var_name = mean_name.replace(".mean_0", ".var_0")
    np.testing.assert_allclose(
        after[mean_name], 0.1 * conv.mean(axis=(0, 2, 3)), **TOL)
    np.testing.assert_allclose(
        after[var_name], 0.9 + 0.1 * conv.var(axis=(0, 2, 3)), **TOL)


def test_the_test_clone_reads_the_statistics_without_writing():
    _, after, _, (main, test, scope, exe, loss, stats) = _run_steps()
    feed = _bn_feeds(1)[0]
    (l1,) = exe.run(test, feed=feed, fetch_list=[loss.name], scope=scope)
    (l2,) = exe.run(test, feed=feed, fetch_list=[loss.name], scope=scope)
    np.testing.assert_array_equal(l1, l2)
    for n in stats:
        np.testing.assert_array_equal(np.asarray(scope.find_var(n)),
                                      after[n])


def test_recompute_writes_the_statistics_once():
    _, plain, plain_losses, _ = _run_steps(recompute=False)
    _, rec, rec_losses, _ = _run_steps(recompute=True)
    np.testing.assert_allclose(rec_losses, plain_losses, **TOL)
    for n in plain:
        np.testing.assert_allclose(rec[n], plain[n], err_msg=n, **TOL)


def test_the_dataset_trainer_chunk_carries_the_statistics(tmp_path):
    """K = 2 steps of one chunk write what two Executor.run steps do."""
    from paddle_tpu_torch import native

    _, want, _, _ = _run_steps(steps=2)
    main, startup, _, loss, stats = _bn_program()
    feeds = _bn_feeds(2)
    path = tmp_path / "part-0"
    with open(path, "w") as f:
        for fd in feeds:
            for i in range(4):
                img = fd["img"][i].reshape(-1)
                f.write(f"{img.size} " + " ".join(repr(float(v))
                                                  for v in img))
                f.write(f" 1 {int(fd['label'][i, 0])}\n")
    saved = native._lib, native._tried
    native._lib, native._tried = None, True
    try:
        ds = pt.DatasetFactory().create_dataset("QueueDataset")
        ds.set_batch_size(4)
        block = main.global_block()
        ds.set_use_var([block.var("img"), block.var("label")])
        ds.set_filelist([str(path)])
        ds.set_steps_per_dispatch(2)
        scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
        exe.run(startup, scope=scope)
        with pt.scope_guard(scope):
            exe.train_from_dataset(main, ds, fetch_list=[loss])
    finally:
        native._lib, native._tried = saved
    for n in stats:
        np.testing.assert_allclose(np.asarray(scope.find_var(n)), want[n],
                                   err_msg=n, **TOL)


# -- nets.py against the JAX package's -----------------------------------------

def _nets_program(P, case):
    main, startup = P.Program(), P.Program()
    startup.random_seed = 21
    with P.program_guard(main, startup), P.unique_name.guard():
        if case == "simple_img_conv_pool":
            x = P.data("x", [None, 3, 12, 12])
            out = P.nets.simple_img_conv_pool(
                x, 5, 3, pool_size=2, pool_stride=2, conv_padding=1,
                act="relu")
        elif case == "img_conv_group":
            x = P.data("x", [None, 3, 12, 12])
            out = P.nets.img_conv_group(
                x, [4, 6], pool_size=2, pool_stride=2, conv_act="relu",
                conv_with_batchnorm=[True, False])
        elif case == "glu":
            x = P.data("x", [None, 6, 8])
            out = P.nets.glu(x, dim=-1)
        else:
            x = P.data("x", [None, 5, 16])
            out = P.nets.scaled_dot_product_attention(x, x, x, num_heads=4)
    return main, startup, x, out


@pytest.mark.parametrize("case", ["simple_img_conv_pool", "img_conv_group",
                                  "glu", "scaled_dot_product_attention"])
def test_nets_match_the_jax_package(case):
    import paddle_tpu as jpt

    with jpt.new_program_scope():
        jmain, jstartup, jx, jout = _nets_program(jpt, case)
        r = np.random.RandomState(4)
        feed = {"x": r.randn(*[2] + list(jx.shape[1:])).astype(np.float32)}
        scope = jpt.Scope()
        with jpt.scope_guard(scope):
            exe = jpt.Executor()
            exe.run(jstartup)
            weights = {v.name: np.asarray(scope.find_var(v.name))
                       for v in jmain.list_vars() if v.persistable}
            (want,) = exe.run(jmain, feed=feed, fetch_list=[jout])
    main, _, _, out = _nets_program(pt, case)
    pscope = pt.Scope()
    pt.io.load_params(pscope, weights, "cpu", program=main)
    (got,) = pt.Executor(pt.CPUPlace()).run(main, feed=feed,
                                            fetch_list=[out], scope=pscope)
    assert [op.type for op in main.global_block().ops] == \
        [op.type for op in jmain.global_block().ops]
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_sequence_conv_pool_raises_naming_queue_1_item_6():
    """The sequence ops are ported (Queue 1 item 6.5), so
    ``sequence_conv_pool`` builds; without the lengths Variable it
    raises the JAX package's ValueError naming ``seq_len=``."""
    import paddle_tpu as jpt

    for P in (jpt, pt):
        with P.new_program_scope():
            x = P.data("x", [None, 5, 8])
            with pytest.raises(ValueError, match="requires seq_len="):
                P.nets.sequence_conv_pool(x, 4, 3)
    types = {}
    for P in (jpt, pt):
        with P.new_program_scope():
            x = P.data("x", [None, 5, 8])
            n = P.data("n", [None], "int64")
            y = P.nets.sequence_conv_pool(x, 4, 3, seq_len=n)
            types[P] = [op.type for op in
                        P.default_main_program().global_block().ops]
            assert list(y.shape)[-1] == 4
    assert types[pt] == types[jpt]
