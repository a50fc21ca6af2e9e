"""Pipeline parallelism in the port (``parallel.pipeline`` and
``PipelineOptimizer``) against plain autograd and the JAX package.

In this process: ``gpipe``'s sequential path against the stage loop,
``PipelineOptimizer`` on ``_bert_pipe_case``'s BERT-tiny at pp 2 and 4
(stages in sequence) against the JAX package's unpipelined program on
one device from the same weights (``io.load_params``), heterogeneous
stages, the derived broadcast of a batch-sized shared tensor, and the
JAX lowering's validation errors.

Over four gloo ranks (``torch.multiprocessing``, a ``FileStore`` in
``tmp_path``; the ranks import neither jax nor paddle_tpu), one spawn
running every case once: ``gpipe`` over a 4-rank pipe axis (values and
gradients against the sequential path), ``one_f_one_b`` at S 4 (M 16)
and S 2 (M 8) against plain autograd of the summed loss (the JAX
``test_pipeline.py:308-345`` cases), and ``PipelineOptimizer`` at
``{pipe: 4}`` and ``{data: 2, pipe: 2}``.

Tolerances: schedule values rtol 1e-5 / atol 1e-5 and gradients rtol
1e-4 / atol 1e-5 (the JAX tests'); BERT losses within 2e-3
(``_PARITY_TOL``) of the JAX package, and the pipe-axis runs within
2e-4 relative of the sequential ones (``test_pipeline.py``'s).
"""
import os
import time

import numpy as np
import pytest
import torch

LOSS_TOL = 2e-3
SPAWN_TIMEOUT = 300
VAL_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _stage_mlp(params, act, consts, stage_idx, mb_idx):
    w, b = params
    return torch.tanh(act @ w + b + consts["shift"])


def _mlp_data(S=4, M=4, b=3, d=8, seed=0):
    rng = np.random.RandomState(seed)
    ws = np.stack([rng.randn(d, d).astype(np.float32) * 0.3
                   for _ in range(S)])
    bs = np.stack([rng.randn(d).astype(np.float32) * 0.1 for _ in range(S)])
    x = rng.randn(M, b, d).astype(np.float32)
    hw = rng.randn(d, 1).astype(np.float32) * 0.2
    y = rng.randn(M, b, 1).astype(np.float32)
    return ([torch.from_numpy(ws), torch.from_numpy(bs)],
            torch.from_numpy(x), torch.from_numpy(hw), torch.from_numpy(y))


def _head(hp, act, consts_one, mb_idx):
    return (((act @ hp[0]) - consts_one["y"]) ** 2).sum()


def _plain_1f1b(stacked, x, hw, y):
    """Loss and gradients of the summed microbatch losses by autograd."""
    ws, bs = (t.clone().requires_grad_() for t in stacked)
    h = hw.clone().requires_grad_()
    xx = x.clone().requires_grad_()
    loss = 0.0
    for m in range(x.shape[0]):
        a = xx[m]
        for s in range(ws.shape[0]):
            a = torch.tanh(a @ ws[s] + bs[s] + 0.05)
        loss = loss + (((a @ h) - y[m]) ** 2).sum()
    return [t.detach() for t in (loss, *torch.autograd.grad(
        loss, [ws, bs, h, xx]))]


def _bert(pkg, models, pp, pipelined):
    cfg = models.BertConfig.tiny()
    cfg.num_layers = pp
    cfg.hidden_dropout = cfg.attn_dropout = 0.0
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = 3
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        if pipelined:
            loss, _, cuts = models.build_bert_pretrain(
                cfg, seq_len=16, num_pipeline_stages=pp)
            pkg.optimizer.PipelineOptimizer(
                pkg.optimizer.SGD(0.01), cut_list=cuts,
                num_microbatches=2).minimize(loss)
        else:
            loss, _ = models.build_bert_pretrain(cfg, seq_len=16)
            pkg.optimizer.SGD(0.01).minimize(loss)
    return main, startup, loss, cfg


def _bert_feed(vocab, step):
    """_bert_pipe_case's feed at dp 2: every position labeled, so every
    microbatch holds the same count."""
    rng = np.random.RandomState(1 + step)
    src = rng.randint(0, vocab, (4, 16)).astype(np.int64)
    return {"src_ids": src, "input_mask": np.ones((4, 16), np.float32),
            "masked_labels": src[..., None].copy()}


def _port_bert(wdir, pp, axes=None, steps=2):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import models
    from paddle_tpu_torch.compiler import CompiledProgram
    from paddle_tpu_torch.parallel import build_mesh

    main, _, loss, cfg = _bert(pt, models, pp, True)
    scope = pt.Scope()
    pt.io.load_params(scope, dict(np.load(os.path.join(
        wdir, f"bert{pp}.npz"))), "cpu", program=main)
    exe = pt.Executor(pt.CPUPlace())
    target = main
    if axes is not None:
        target = CompiledProgram(main).with_sharding(
            build_mesh(axes, device_type="cpu"),
            batch_axes=("data",) if "data" in axes else ())
    return [float(exe.run(target, feed=_bert_feed(cfg.vocab_size, s),
                          fetch_list=[loss], scope=scope)[0])
            for s in range(steps)], scope


# -- the ranks (no jax, no paddle_tpu) ----------------------------------------

def _ranks(rank, wdir, out):
    import torch.distributed as dist

    from paddle_tpu_torch.parallel import build_mesh, gpipe, one_f_one_b

    res = {}
    mesh = build_mesh({"pipe": 4}, device_type="cpu")
    stacked, x, _, _ = _mlp_data(S=4, M=6)
    res["gpipe"] = gpipe(_stage_mlp, stacked, x, consts={"shift": 0.05},
                         mesh=mesh).numpy()
    leaves = [p.clone().requires_grad_() for p in stacked]
    out_t = gpipe(_stage_mlp, leaves, x, consts={"shift": 0.05}, mesh=mesh)
    res["gpipe_grad"] = [g.numpy() for g in torch.autograd.grad(
        (out_t ** 2).mean(), leaves)]
    for S, M, axes in ((4, 16, {"pipe": 4}), (2, 8, {"data": 2, "pipe": 2})):
        stacked, x, hw, y = _mlp_data(S=S, M=M, seed=3)
        m = build_mesh(axes, device_type="cpu")
        loss, dp, dhp, dx = one_f_one_b(
            _stage_mlp, stacked, x, _head, [hw], consts_mb={"y": y},
            consts={"shift": 0.05}, mesh=m)
        res[f"1f1b{S}"] = (float(loss), [g.numpy() for g in dp],
                           dhp[0].numpy(), dx.numpy(),
                           int(m.get_local_rank("pipe")))
    res["bert4"] = _port_bert(wdir, 4, {"pipe": 4})[0]
    losses, scope = _port_bert(wdir, 2, {"data": 2, "pipe": 2})
    res["bert2"] = losses
    res["held"] = sorted(n for n in scope.local_var_names()
                         if n.startswith("encoder.layer"))
    torch.save(res, os.path.join(out, f"pipe{rank}.pt"))
    dist.barrier()


def _rank_main(rank, world, wdir, out):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(out, "store"), world),
        rank=rank, world_size=world)
    try:
        _ranks(rank, wdir, out)
    finally:
        dist.destroy_process_group()


def _spawn(world, wdir, out):
    import torch.multiprocessing as mp

    ctx = mp.start_processes(_rank_main, args=(world, wdir, out),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.terminate()
            raise TimeoutError(f"pipeline ranks still running after "
                               f"{SPAWN_TIMEOUT} s")
    return [torch.load(os.path.join(out, f"pipe{r}.pt"), weights_only=False)
            for r in range(world)]


# -- the JAX side (imported lazily: the ranks must not import it) ------------

def _jax_plain(pp, steps=2):
    import paddle_tpu as jpt
    from paddle_tpu import models as jmodels

    main, startup, loss, cfg = _bert(jpt, jmodels, pp, False)
    scope = jpt.Scope()
    exe = jpt.Executor()
    with jpt.scope_guard(scope):
        exe.run(startup)
        weights = {v.name: np.asarray(scope.find_var(v.name))
                   for v in main.list_vars() if v.persistable}
        losses = [float(np.asarray(exe.run(
            main, feed=_bert_feed(cfg.vocab_size, s), fetch_list=[loss])[0]))
            for s in range(steps)]
    return weights, losses


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    wdir = tmp_path_factory.mktemp("pipe_weights")
    ref = {}
    for pp in (2, 4):
        weights, ref[pp] = _jax_plain(pp)
        np.savez(wdir / f"bert{pp}.npz", **weights)
    return str(wdir), ref


@pytest.fixture(scope="module")
def ranks(jax_ref, tmp_path_factory):
    return _spawn(4, jax_ref[0], str(tmp_path_factory.mktemp("pipe_ranks")))


def _loop(stacked, x):
    ws, bs = (t.numpy() for t in stacked)
    out = []
    for m in range(x.shape[0]):
        a = x[m].numpy()
        for s in range(ws.shape[0]):
            a = np.tanh(a @ ws[s] + bs[s] + 0.05)
        out.append(a)
    return np.stack(out)


def test_gpipe_sequential_matches_loop():
    from paddle_tpu_torch.parallel import gpipe

    stacked, x, _, _ = _mlp_data()
    out = gpipe(_stage_mlp, stacked, x, consts={"shift": 0.05}, mesh=None)
    np.testing.assert_allclose(out.numpy(), _loop(stacked, x), **VAL_TOL)


def test_gpipe_over_a_pipe_axis(ranks):
    """Four ranks, one stage each: the outputs on every rank and the
    gradients of a loss of them equal the sequential path's."""
    from paddle_tpu_torch.parallel import gpipe

    stacked, x, _, _ = _mlp_data(S=4, M=6)
    for r in ranks:
        np.testing.assert_allclose(r["gpipe"], _loop(stacked, x), **VAL_TOL)
    leaves = [p.clone().requires_grad_() for p in stacked]
    out = gpipe(_stage_mlp, leaves, x, consts={"shift": 0.05}, mesh=None)
    want = torch.autograd.grad((out ** 2).mean(), leaves)
    for d, r in enumerate(ranks):
        for got, ref in zip(r["gpipe_grad"], want):
            # each rank holds its own stage's gradient
            np.testing.assert_allclose(got[d], ref[d].numpy(), **GRAD_TOL)


@pytest.mark.parametrize("S,M", [(4, 16), (2, 8)])
def test_one_f_one_b_matches_autograd(ranks, S, M):
    stacked, x, hw, y = _mlp_data(S=S, M=M, seed=3)
    loss, dws, dbs, dhw, dx = _plain_1f1b(stacked, x, hw, y)
    for r in ranks:
        got_loss, dp, dhp, gdx, d = r[f"1f1b{S}"]
        np.testing.assert_allclose(got_loss, float(loss), rtol=1e-4)
        np.testing.assert_allclose(dp[0][0], dws[d].numpy(), **GRAD_TOL)
        np.testing.assert_allclose(dp[1][0], dbs[d].numpy(), **GRAD_TOL)
        np.testing.assert_allclose(dhp, dhw.numpy(), **GRAD_TOL)
        np.testing.assert_allclose(gdx, dx.numpy(), **GRAD_TOL)


def test_one_f_one_b_needs_a_pipe_axis():
    from paddle_tpu_torch.parallel import one_f_one_b

    stacked, x, hw, y = _mlp_data(S=2, M=4)
    with pytest.raises(ValueError, match="needs a mesh with the pipeline"):
        one_f_one_b(_stage_mlp, stacked, x, _head, [hw], mesh=None)


@pytest.mark.parametrize("pp", [2, 4])
def test_pipeline_optimizer_matches_jax(jax_ref, pp):
    """Stages in sequence (no pipe axis): the pipelined step's losses
    track the JAX package's unpipelined program."""
    wdir, ref = jax_ref
    got, _ = _port_bert(wdir, pp)
    assert np.max(np.abs(np.subtract(got, ref[pp]))) < LOSS_TOL, (got, ref)


def test_pipeline_optimizer_over_ranks(jax_ref, ranks):
    """{pipe: 4} and {data: 2, pipe: 2}: every rank reports the same loss,
    within 2e-4 of the sequential run and 2e-3 of the JAX package; each
    rank holds only its stage's encoder parameters."""
    wdir, ref = jax_ref
    for pp, key in ((4, "bert4"), (2, "bert2")):
        seq, _ = _port_bert(wdir, pp)
        for r in ranks:
            np.testing.assert_allclose(r[key], seq, rtol=2e-4)
            assert np.max(np.abs(np.subtract(r[key], ref[pp]))) < LOSS_TOL
    for r in ranks:
        layers = {n.split(".")[1] for n in r["held"]}
        assert len(layers) == 1, layers        # pipe 2 of 2 layers


def _het(pkg, pipelined):
    """Two distinct stages: a dense stage over [B, 64], then a
    sequence-shaped FFN with layer_norm over [B, 16, 4]."""
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = 23
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        img = pkg.data("img", [None, 64])
        label = pkg.data("label", [None, 1], "int64")
        c0 = pkg.layers.scale(img, 1.0)
        c1 = pkg.layers.fc(c0, 64, act="relu",
                           param_attr=pkg.ParamAttr(name="dw"))
        y = pkg.layers.reshape(c1, [0, 16, 4])
        y = pkg.layers.fc(y, 16, num_flatten_dims=2, act="gelu",
                          param_attr=pkg.ParamAttr(name="fw1"))
        y = pkg.layers.fc(y, 4, num_flatten_dims=2,
                          param_attr=pkg.ParamAttr(name="fw2"))
        y = pkg.layers.layer_norm(y, begin_norm_axis=2)
        c2 = pkg.layers.reshape(y, [0, 64])
        logits = pkg.layers.fc(c2, 10)
        loss = pkg.layers.mean(
            pkg.layers.softmax_with_cross_entropy(logits, label))
        opt = pkg.optimizer.SGD(0.1)
        if pipelined:
            opt = pkg.optimizer.PipelineOptimizer(
                opt, cut_list=[c0, c1, c2], num_microbatches=2)
        opt.minimize(loss)
    return main, startup, loss


def test_heterogeneous_stages_match_plain():
    import paddle_tpu_torch as pt

    rng = np.random.RandomState(5)
    feeds = [{"img": rng.rand(8, 64).astype(np.float32),
              "label": rng.randint(0, 10, (8, 1)).astype(np.int64)}
             for _ in range(2)]
    runs = {}
    for pipelined in (False, True):
        main, startup, loss = _het(pt, pipelined)
        scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
        exe.run(startup, scope=scope)
        runs[pipelined] = ([float(exe.run(main, feed=f, fetch_list=[loss],
                                          scope=scope)[0]) for f in feeds],
                           scope.find_var("fw1").numpy())
    np.testing.assert_allclose(runs[True][0], runs[False][0], rtol=2e-4)
    np.testing.assert_allclose(runs[True][1], runs[False][1], rtol=1e-3,
                               atol=1e-5)


def test_shared_batch_sized_tensor_broadcasts():
    """A shared [8, 8] tensor whose rows equal the batch is broadcast to
    every microbatch (its leading dim is not the symbolic batch), with
    no warning (``test_pipeline.py``'s TestDerivedBroadcast)."""
    import warnings

    import paddle_tpu_torch as pt

    rng = np.random.RandomState(4)
    code = rng.randn(8, 8).astype(np.float32)
    xv = rng.randn(8, 8).astype(np.float32)
    runs = {}
    for pipelined in (False, True):
        main, startup = pt.Program(), pt.Program()
        startup.random_seed = 13
        with pt.program_guard(main, startup), pt.unique_name.guard():
            x = pt.layers.data("x", [None, 8], "float32")
            codebook = pt.layers.assign(code)
            h0 = pt.layers.assign(x)
            h1 = pt.layers.fc(h0, 8, act="tanh",
                              param_attr=pt.ParamAttr(name="w1"))
            scores = pt.layers.matmul(h1, codebook, transpose_y=True)
            h2 = pt.layers.fc(scores, 8, act="tanh",
                              param_attr=pt.ParamAttr(name="w2"))
            h3 = pt.layers.fc(h2, 8, act="tanh",
                              param_attr=pt.ParamAttr(name="w3"))
            loss = pt.layers.mean(pt.layers.square(h3))
            opt = pt.optimizer.SGD(0.1)
            if pipelined:
                opt = pt.optimizer.PipelineOptimizer(
                    opt, cut_list=[h0, h2, h3], num_microbatches=2)
            opt.minimize(loss)
        scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
        exe.run(startup, scope=scope)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            runs[pipelined] = [float(exe.run(main, feed={"x": xv},
                                             fetch_list=[loss],
                                             scope=scope)[0])
                               for _ in range(3)]
    np.testing.assert_allclose(runs[True], runs[False], rtol=2e-5)


def _pipe_program(cuts_of, **kw):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import BertConfig, build_bert_pretrain

    cfg = BertConfig.tiny()
    cfg.num_layers = 2
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        loss, _, bounds = build_bert_pretrain(cfg, 16, want_boundaries=True)
        opt = pt.optimizer.PipelineOptimizer(
            pt.optimizer.SGD(0.1), cut_list=cuts_of(loss, bounds, main),
            num_microbatches=2, **kw)
        opt.minimize(loss)
    return main, startup, loss, cfg


def _first_run(main, startup, loss, cfg, target=None, fetch=None):
    import paddle_tpu_torch as pt

    scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    feed = _bert_feed(cfg.vocab_size, 0)
    return exe.run(target or main, feed=feed, fetch_list=fetch or [loss],
                   scope=scope)


@pytest.mark.parametrize("cuts,match", [
    (lambda loss, b, m: [b[0], "no_such_var"], "not produced in block"),
    (lambda loss, b, m: [b[1], b[0]], "must be produced in order"),
    (lambda loss, b, m: [b[0], m.global_block().var("input_mask")],
     "not produced in block"),
])
def test_cut_list_validation(cuts, match):
    with pytest.raises(ValueError, match=match):
        _first_run(*_pipe_program(cuts))


def test_cut_list_needs_two_boundaries():
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import BertConfig, build_bert_pretrain

    with pt.program_guard(pt.Program(), pt.Program()), \
            pt.unique_name.guard():
        loss, _ = build_bert_pretrain(BertConfig.tiny(), 16)
        opt = pt.optimizer.PipelineOptimizer(
            pt.optimizer.SGD(0.1), cut_list=[loss], num_microbatches=2)
        with pytest.raises(ValueError, match="at least 2"):
            opt.minimize(loss)


def test_stage_count_must_match_the_pipe_axis():
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.compiler import CompiledProgram
    from paddle_tpu_torch.parallel import LocalMesh

    main, startup, loss, cfg = _pipe_program(
        lambda loss, b, m: [b[0], b[1], b[2]])
    target = CompiledProgram(main).with_sharding(
        LocalMesh({"pipe": 1}, device_type="cpu"), batch_axes=())
    with pytest.raises(ValueError, match="2 stages but mesh axis 'pipe'"):
        _first_run(main, startup, loss, cfg, target=target)


def test_only_the_loss_is_fetchable():
    main, startup, loss, cfg = _pipe_program(
        lambda loss, b, m: [b[0], b[1], b[2]])
    inner = main.blocks[1].ops[0].output_names()
    with pytest.raises(ValueError, match="only the loss"):
        _first_run(main, startup, loss, cfg, fetch=[next(iter(inner))])
