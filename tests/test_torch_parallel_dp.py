"""Data parallelism, ZeRO-1 and sharded parameters in the port's Program
front end (``CompiledProgram.with_data_parallel`` / ``with_sharding``)
against the JAX package's single device.

The JAX dryruns' claim is single == sharded: the JAX package runs each
program on one device in this process (from its own seeded startup); its
startup's weights go to the ranks through ``io.load_params``.  The port
runs in gloo processes (``torch.multiprocessing``, a ``FileStore`` in
``tmp_path``; the ranks import neither jax nor paddle_tpu), fed the
global batch, each keeping its slice.  Two spawns, each running every
case of its fixture once:

* four ranks: ``test_parallel_dp.py``'s fc model (SGD 0.1) and
  ``_dryrun_tp``'s BERT-tiny (hidden 64, 4 heads, Adam 1e-3, a batch of
  8 x 32 with ~15% of the labels masked in, so each rank's count of
  valid labels differs) at ``{data: 4}``; BERT under ZeRO-1
  (``ReduceStrategy.Reduce``) at dp 4; BERT at ``{data: 2, model: 2}``
  under ``tp_sharding_rules``; ``test_zero1_composes_with_tp_rules``'s
  case; ZeRO-1 under a global-norm clip; a count-normalized loss; the
  lowering's collectives; an op outside the row-local classes;
  and a ZeRO-1 checkpoint saved at dp 4 after 3 steps;
* two ranks: fc and BERT at ``{data: 2}``, and the checkpoint resumed at
  dp 2, against the same state handed over in memory.

Tolerances: losses within 2e-3 of the JAX single device
(``_PARITY_TOL``); ZeRO-1 against AllReduce within 1e-5 (only the order
of the sums differs); the count-normalized loss within 1e-6 of its
global value; the checkpoint resume bit-equal.
"""
import os
import time

import numpy as np
import pytest
import torch

LOSS_TOL = 2e-3
ZERO_TOL = 1e-5
COUNT_TOL = 1e-6
STEPS = 3
K, N = 3, 6                       # checkpoint step, total steps
SPAWN_TIMEOUT = 300


# -- programs, built the same way by both packages ---------------------------

def _fc(pkg, adam, clip=False):
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = 7
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.data("x", [None, 16])
        label = pkg.data("label", [None, 1], "int64")
        h = pkg.layers.fc(x, 32, act="relu")
        logits = pkg.layers.fc(h, 4)
        loss = pkg.layers.mean(
            pkg.layers.softmax_with_cross_entropy(logits, label))
        # a global-norm clip small enough to act every step
        (pkg.optimizer.Adam(0.01, grad_clip=(
            pkg.clip.GradientClipByGlobalNorm(0.05) if clip else None))
         if adam else pkg.optimizer.SGD(0.1)).minimize(loss)
    return main, startup, loss


def _bert(pkg, models):
    cfg = models.BertConfig.tiny()
    cfg.num_heads, cfg.hidden_size, cfg.ffn_size = 4, 64, 256
    cfg.hidden_dropout = cfg.attn_dropout = 0.0
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = 7
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        loss, _ = models.build_bert_pretrain(cfg, seq_len=32)
        pkg.optimizer.Adam(1e-3).minimize(loss)
    return main, startup, loss


def _count(pkg):
    """loss = sum(valid * (x . w)) / max(sum(valid), 1): normalized by a
    count that the feed decides."""
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = 7
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.data("x", [None, 4])
        valid = pkg.data("valid", [None, 1])
        row = pkg.layers.fc(x, 1, bias_attr=False)
        total = pkg.layers.reduce_sum(pkg.layers.elementwise_mul(row, valid))
        count = pkg.layers.reduce_sum(valid)
        loss = pkg.layers.elementwise_div(
            total, pkg.layers.elementwise_max(count, 1.0))
    return main, startup, loss


def _feeds():
    rng = np.random.RandomState(0)
    x = rng.rand(64, 16).astype(np.float32)
    fc = {"x": x, "label": ((x.sum(axis=1) > 8).astype(np.int64)[:, None]
                            + (x[:, 0] > 0.5).astype(np.int64)[:, None])}
    src = rng.randint(0, 1000, (8, 32)).astype(np.int64)
    labels = np.where(rng.rand(8, 32, 1) < 0.15, src[..., None],
                      -1).astype(np.int64)
    bert = {"src_ids": src, "input_mask": np.ones((8, 32), np.float32),
            "masked_labels": labels}
    valid = np.zeros((8, 1), np.float32)
    valid[[0, 1, 2, 4]] = 1.0         # counts 2, 1, 1, 0 over four ranks
    count = {"x": rng.randn(8, 4).astype(np.float32), "valid": valid}
    return {"fc": fc, "bert": bert, "count": count}


def _cumsum_feed():
    return np.random.RandomState(3).rand(8, 4).astype(np.float32)


def _zero_feed(step):
    rng = np.random.RandomState(100 + step)
    return {"x": rng.rand(64, 16).astype(np.float32),
            "label": rng.randint(0, 4, (64, 1)).astype(np.int64)}


# -- the ranks (no jax, no paddle_tpu) ----------------------------------------

def _port_program(case):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import models

    return {"fc": lambda: _fc(pt, False), "zfc": lambda: _fc(pt, True),
            "cfc": lambda: _fc(pt, True, clip=True),
            "bert": lambda: _bert(pt, models),
            "count": lambda: _count(pt)}[case]()


def _port_run(wdir, case, axes=None, rules=None, reduce=False, feed=None,
              steps=STEPS):
    """(losses, scope, main, compiled) of ``steps`` steps from the JAX
    startup's weights."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.compiler import BuildStrategy, CompiledProgram
    from paddle_tpu_torch.parallel import build_mesh

    main, _, loss = _port_program(case)
    scope = pt.Scope()
    w = np.load(os.path.join(wdir, f"{case}.npz"))
    pt.io.load_params(scope, dict(w), "cpu", program=main)
    exe = pt.Executor(pt.CPUPlace())
    target = main
    if axes is not None:
        bs = BuildStrategy()
        if reduce:
            bs.reduce_strategy = BuildStrategy.ReduceStrategy.Reduce
        target = CompiledProgram(main, build_strategy=bs).with_sharding(
            build_mesh(axes, device_type="cpu"), param_rules=rules)
    feeds = _feeds()
    losses = []
    for s in range(steps):
        f = feed(s) if callable(feed) else (feed or feeds[case])
        losses.append(float(exe.run(target, feed=f, fetch_list=[loss],
                                    scope=scope)[0]))
    return losses, scope, main, target


def _whole(scope, main):
    from paddle_tpu_torch.core.spmd import whole_value

    return {v.name: whole_value(scope, v.name, scope.find_var(v.name))
            .detach().cpu().numpy().copy()
            for v in main.list_vars()
            if v.persistable and scope.find_var(v.name) is not None}


def _collectives(rank):
    """The lowering's collectives over a 4-rank data group: values and
    gradients."""
    from paddle_tpu_torch.parallel import _collectives as col
    from paddle_tpu_torch.parallel import build_mesh

    g = build_mesh({"data": 4}, device_type="cpu").get_group("data")
    x = torch.full((2, 3), float(rank), requires_grad=True)
    w = torch.arange(24.0).reshape(8, 3)
    y = col.all_gather(x, g, 0)
    (gx,) = torch.autograd.grad((y * w).sum(), [x])
    z = torch.ones(2, requires_grad=True)
    (gz,) = torch.autograd.grad((col.backward_sum(z, g) * (rank + 1)).sum(),
                                [z])
    v = torch.tensor([1.0 + rank], requires_grad=True)
    s = col.forward_sum(v, g)
    (gv,) = torch.autograd.grad((s * 3.0).sum(), [v])
    parts = col.sum_gradients([torch.full((5,), 1.0 + rank),
                               torch.full((2, 2), 2.0)], g, bucket_bytes=8)
    return dict(gather=y.detach().numpy(), gather_grad=gx.numpy(),
                bsum_grad=gz.numpy(), fsum=s.detach().numpy(),
                fsum_grad=gv.numpy(), buckets=[p.numpy() for p in parts])


def _four(rank, wdir, out):
    import torch.distributed as dist

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import tp_sharding_rules
    from paddle_tpu_torch.observability import get_registry
    from paddle_tpu_torch.tools.mem_report import optimizer_state_report

    res = {"fc": _port_run(wdir, "fc", {"data": 4})[0],
           "bert": _port_run(wdir, "bert", {"data": 4})[0],
           "collectives": _collectives(rank)}
    res["zero"] = _port_run(wdir, "bert", {"data": 4}, reduce=True)[0]
    res["zero_report"] = optimizer_state_report(get_registry().snapshot())
    losses, scope, _, _ = _port_run(wdir, "bert", {"data": 2, "model": 2},
                                    rules=tp_sharding_rules())
    res["tp"] = losses
    res["tp_qkv"] = tuple(scope.find_var("encoder.layer0.attn.qkv.w").shape)
    rules = [(r"fc_0\.w_0", (None, "model")), (r"fc_1\.w_0", ("model", None))]
    losses, scope, main, _ = _port_run(wdir, "zfc", {"data": 2, "model": 2},
                                       rules=rules, reduce=True,
                                       feed=_zero_feed)
    m1 = next(v.name for v in main.list_vars()
              if v.name.startswith("fc_0.w_0_moment1"))
    res["zero_tp"] = (losses, tuple(scope.find_var(m1).shape),
                      scope._shardings[m1][0].spec)
    res["count"] = _port_run(wdir, "count", {"data": 4}, steps=1)[0]
    res["clip"] = _port_run(wdir, "cfc", {"data": 4}, reduce=True,
                            feed=_zero_feed)[0]
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        x = pt.data("x", [None, 4])
        s = pt.layers.cumsum(x, axis=0)
    exe = pt.Executor(pt.CPUPlace())
    from paddle_tpu_torch.compiler import CompiledProgram

    res["cumsum"] = exe.run(CompiledProgram(main).with_data_parallel(
        places=[pt.CPUPlace()]), feed={"x": _cumsum_feed()},
        fetch_list=[s], scope=pt.Scope())[0]
    # ZeRO-1 checkpoint at dp 4 after K steps, and the same state whole
    losses, scope, main, target = _port_run(
        wdir, "zfc", {"data": 4}, reduce=True, feed=_zero_feed, steps=K)
    mgr = pt.resilience.CheckpointManager(os.path.join(out, f"ckpt{rank}"),
                                          keep=None)
    mgr.save(K, program=main, scope=scope)
    res["ckpt_state"] = _whole(scope, main)
    res["ckpt_rng"] = main._rng_counter
    torch.save(res, os.path.join(out, f"four{rank}.pt"))
    dist.barrier()


def _resume(wdir, root, axes, in_memory):
    """Steps [K, N) of the ZeRO fc program from the dp-4 state: restored
    from the checkpoint, or handed over in memory."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.compiler import BuildStrategy, CompiledProgram
    from paddle_tpu_torch.parallel import build_mesh

    main, _, loss = _port_program("zfc")
    scope = pt.Scope()
    manifest = None
    if in_memory is None:
        manifest = pt.resilience.CheckpointManager(root, keep=None).restore(
            program=main, scope=scope)
    else:
        state, rng = in_memory
        pt.io.load_params(scope, state, "cpu", program=main)
        main._rng_counter = rng
    exe = pt.Executor(pt.CPUPlace())
    target = main
    if axes is not None:
        bs = BuildStrategy()
        bs.reduce_strategy = BuildStrategy.ReduceStrategy.Reduce
        target = CompiledProgram(main, build_strategy=bs).with_data_parallel(
            build_strategy=bs, mesh=build_mesh(axes, device_type="cpu"))
    for s in range(K, N):
        exe.run(target, feed=_zero_feed(s), fetch_list=[loss], scope=scope)
    return _whole(scope, main), manifest


def _two(rank, wdir, out):
    import torch.distributed as dist

    res = {"fc": _port_run(wdir, "fc", {"data": 2})[0],
           "bert": _port_run(wdir, "bert", {"data": 2})[0]}
    four = torch.load(os.path.join(out, "four0.pt"), weights_only=False)
    res["restored"], res["manifest"] = _resume(
        wdir, os.path.join(out, "ckpt0"), {"data": 2}, None)
    res["handed"], _ = _resume(wdir, None, {"data": 2},
                               (four["ckpt_state"], four["ckpt_rng"]))
    torch.save(res, os.path.join(out, f"two{rank}.pt"))
    dist.barrier()


def _rank_main(rank, world, fn_name, wdir, out):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(out, f"store{world}"),
                                     world), rank=rank, world_size=world)
    try:
        globals()[fn_name](rank, wdir, out)
    finally:
        dist.destroy_process_group()


def spawn(fn_name, world, wdir, out, prefix):
    """Run ``fn_name`` on ``world`` gloo ranks; a rank that hangs fails
    the test after SPAWN_TIMEOUT seconds."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(_rank_main, args=(world, fn_name, wdir, out),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.terminate()
            raise TimeoutError(f"{fn_name} ranks still running after "
                               f"{SPAWN_TIMEOUT} s")
    return [torch.load(os.path.join(out, f"{prefix}{r}.pt"),
                       weights_only=False) for r in range(world)]


# -- the JAX side (imported lazily: the ranks must not import it) ------------

def _jax_run(case, steps=STEPS, feed=None):
    import paddle_tpu as jpt
    from paddle_tpu import models as jmodels

    main, startup, loss = {
        "fc": lambda: _fc(jpt, False), "zfc": lambda: _fc(jpt, True),
        "cfc": lambda: _fc(jpt, True, clip=True),
        "bert": lambda: _bert(jpt, jmodels),
        "count": lambda: _count(jpt)}[case]()
    scope = jpt.Scope()
    exe = jpt.Executor()
    with jpt.scope_guard(scope):
        exe.run(startup)
        weights = {v.name: np.asarray(scope.find_var(v.name))
                   for v in main.list_vars() if v.persistable
                   and scope.find_var(v.name) is not None}
        losses = []
        for s in range(steps):
            f = feed(s) if callable(feed) else (feed or _feeds()[case])
            losses.append(float(np.asarray(exe.run(
                main, feed=f, fetch_list=[loss])[0])))
    return weights, losses


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    wdir = tmp_path_factory.mktemp("weights")
    out = tmp_path_factory.mktemp("ranks")
    ref = {}
    for case, kw in (("fc", {}), ("bert", {}), ("count", {"steps": 1}),
                     ("zfc", {"feed": _zero_feed}),
                     ("cfc", {"feed": _zero_feed})):
        weights, ref[case] = _jax_run(case, **kw)
        np.savez(wdir / f"{case}.npz", **weights)
    four = spawn("_four", 4, str(wdir), str(out), "four")
    two = spawn("_two", 2, str(wdir), str(out), "two")
    return {"ref": ref, "four": four, "two": two, "wdir": str(wdir),
            "out": str(out)}


def _same_on_every_rank(per_rank, key):
    first = per_rank[0][key]
    for r in per_rank[1:]:
        np.testing.assert_array_equal(r[key], first)
    return first


@pytest.mark.parametrize("dp", [2, 4])
@pytest.mark.parametrize("case", ["fc", "bert"])
def test_data_parallel_matches_jax_single_device(ranks, case, dp):
    got = _same_on_every_rank(ranks["four" if dp == 4 else "two"], case)
    ref = ranks["ref"][case]
    assert np.max(np.abs(np.subtract(got, ref))) < LOSS_TOL, (got, ref)


def test_zero1_at_dp4(ranks):
    """ZeRO-1 tracks AllReduce and the JAX single device; each rank holds
    ~1/dp of Adam's state (the dryrun's gate)."""
    got = _same_on_every_rank(ranks["four"], "zero")
    np.testing.assert_allclose(got, ranks["four"][0]["bert"], rtol=0,
                               atol=ZERO_TOL)
    assert np.max(np.abs(np.subtract(got, ranks["ref"]["bert"]))) < LOSS_TOL
    rep = ranks["four"][0]["zero_report"]
    assert rep["dp_degree"] == 4
    assert rep["ratio_vs_ideal"] < 1.5, rep


def test_zero1_clips_the_whole_gradient(ranks):
    """Under ZeRO-1 the global-norm clip reads the summed, whole
    gradients before the sliced update: the clipped run tracks the JAX
    single device, and the clip acts (it leaves the unclipped run)."""
    got = _same_on_every_rank(ranks["four"], "clip")
    assert np.max(np.abs(np.subtract(got, ranks["ref"]["cfc"]))) < LOSS_TOL
    assert np.max(np.abs(np.subtract(got, ranks["ref"]["zfc"]))) > 1e-3


def test_megatron_rules_at_data2_model2(ranks):
    got = _same_on_every_rank(ranks["four"], "tp")
    assert np.max(np.abs(np.subtract(got, ranks["ref"]["bert"]))) < LOSS_TOL
    for r in ranks["four"]:
        assert r["tp_qkv"] == (64, 96)       # [H, 3H] split over model


def test_zero1_composes_with_tp_rules(ranks):
    """An accumulator a rule splits over ``model`` on dim 1 gains ``data``
    on dim 0; the losses still track the JAX single device."""
    losses, shape, spec = ranks["four"][0]["zero_tp"]
    assert np.max(np.abs(np.subtract(losses, ranks["ref"]["zfc"]))) \
        < LOSS_TOL
    assert spec == ("data", "model")
    assert shape == (16 // 2, 32 // 2)


def test_count_normalized_loss_is_global(ranks):
    """The ranks hold 2, 1, 1 and 0 valid rows: the loss divides the
    global sum by the global count, which averaging the ranks' own
    normalized losses would not give."""
    got = _same_on_every_rank(ranks["four"], "count")[0]
    ref = ranks["ref"]["count"][0]
    assert abs(got - ref) < COUNT_TOL
    w = np.load(os.path.join(ranks["wdir"], "count.npz"))
    f = _feeds()["count"]
    rows = (f["x"] @ w["fc_0.w_0"])[:, 0] * f["valid"][:, 0]
    assert abs(rows.sum() / f["valid"].sum() - ref) < COUNT_TOL
    per_rank = [rows[i:i + 2].sum() / max(f["valid"][i:i + 2].sum(), 1.0)
                for i in range(0, 8, 2)]
    assert abs(np.mean(per_rank) - ref) > 1e-3


def test_collectives_of_the_lowering(ranks):
    """all_gather keeps the rank's slice of the cotangent, backward_sum
    sums the cotangents, forward_sum passes its cotangent unscaled, and
    the bucketed sum (one bucket a tensor here) sums each tensor."""
    w = np.arange(24.0).reshape(8, 3)
    for rank, r in enumerate(ranks["four"]):
        c = r["collectives"]
        np.testing.assert_array_equal(
            c["gather"], np.repeat(np.arange(4.0), 2)[:, None] * np.ones(3))
        np.testing.assert_array_equal(c["gather_grad"],
                                      w[2 * rank:2 * rank + 2])
        np.testing.assert_array_equal(c["bsum_grad"], [10.0, 10.0])
        np.testing.assert_array_equal(c["fsum"], [10.0])
        np.testing.assert_array_equal(c["fsum_grad"], [3.0])
        np.testing.assert_array_equal(c["buckets"][0], np.full(5, 10.0))
        np.testing.assert_array_equal(c["buckets"][1], np.full((2, 2), 8.0))


def test_op_outside_row_local_classes_raises(ranks):
    """A cumsum along the batch dim moves rows across ranks: it runs on
    the batch gathered whole and every rank keeps its rows of the
    result, so the fetch is the global batch's cumsum (this program was
    refused before the row movers were ported)."""
    want = np.cumsum(_cumsum_feed(), axis=0)
    for r in ranks["four"]:
        np.testing.assert_allclose(r["cumsum"], want, rtol=1e-6, atol=1e-6)


def test_zero1_checkpoint_resumes_at_dp2(ranks):
    """Saved at dp 4 under ZeRO-1, the checkpoint holds whole arrays and
    resumes at dp 2 bit-equal to the same state handed over in memory."""
    two = ranks["two"]
    layout = two[0]["manifest"]["layout"]
    assert layout["arrays"] == "gathered_full"
    assert any("moment1" in n for n in layout["optimizer_state"])
    for r in two:
        assert set(r["restored"]) == set(r["handed"])
        for n in r["restored"]:
            assert np.array_equal(r["restored"][n], r["handed"][n]), n


def test_zero1_checkpoint_resumes_at_dp1(ranks):
    four = ranks["four"][0]
    restored, _ = _resume(ranks["wdir"], os.path.join(ranks["out"], "ckpt0"),
                          None, None)
    handed, _ = _resume(ranks["wdir"], None, None,
                        (four["ckpt_state"], four["ckpt_rng"]))
    assert set(restored) == set(handed)
    for n in restored:
        assert np.array_equal(restored[n], handed[n]), n
    # and the dp-2 run ends where the dp-1 run does (the sums' order only)
    for n, v in ranks["two"][0]["restored"].items():
        np.testing.assert_allclose(v, restored[n], rtol=1e-5, atol=1e-6)


def test_local_mesh_runs_the_plain_step():
    """Without a process group, ``with_data_parallel()`` is the one-rank
    {data: 1} mesh of this process: the same losses as the plain run."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.compiler import CompiledProgram
    from paddle_tpu_torch.parallel import (LocalMesh, batch_sharding,
                                           replicated)

    feed = _feeds()["fc"]
    runs = {}
    for mode in ("plain", "mesh"):
        main, startup, loss = _fc(pt, True)
        scope = pt.Scope()
        exe = pt.Executor(pt.CPUPlace())
        exe.run(startup, scope=scope)
        target = main
        if mode == "mesh":
            target = CompiledProgram(main).with_data_parallel(
                places=[pt.CPUPlace()])
            assert isinstance(target.mesh, LocalMesh)
            assert target.data_parallel_degree == 1
            assert not target.reduce_mode and not target.is_multiprocess
            rep = replicated(target.mesh)
            bat = batch_sharding(target.mesh)
            assert rep.is_replicated and bat.spec == ("data",)
            assert bat.shard_shape((8, 3)) == (8, 3)
        runs[mode] = [float(exe.run(target, feed=feed, fetch_list=[loss],
                                    scope=scope)[0]) for _ in range(3)]
    assert runs["plain"] == runs["mesh"]


@pytest.mark.parametrize("axes", [("data", "expert"), ("model",)])
def test_batch_axes_beyond_data_are_refused(axes):
    """The gradient sum and the MoE routing run over the data axis alone,
    so ``with_sharding`` refuses any other batch axis (a silent split
    would leave each rank with its part of the gradient); ``data`` and
    no batch axis at all are taken."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.compiler import CompiledProgram
    from paddle_tpu_torch.parallel import LocalMesh

    main, _, _ = _fc(pt, True)
    mesh = LocalMesh({"data": 1, "expert": 1, "model": 1},
                     device_type="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        CompiledProgram(main).with_sharding(mesh, batch_axes=axes)
    for ok in (("data",), ()):
        target = CompiledProgram(main).with_sharding(mesh, batch_axes=ok)
        assert target.batch_axes == ok
