"""The Megatron compute split under ``{model: P}`` (core/spmd.py's
``plan_split``) against the JAX package, whose same mesh and rules go to
XLA's partitioner.

The JAX package runs each program on one device and under its own
``with_sharding`` (the conftest's 8 CPU devices) in this process; its
startup's weights reach the ranks as an npz.  The port runs in gloo
processes (``torch.multiprocessing``, a ``FileStore`` in ``tmp_path``;
the ranks import neither jax nor paddle_tpu), fed the global batch.  Two
spawns, each running every case of its fixture once:

* two ranks at ``{model: 2}``: BERT-tiny (4 heads, hidden 64, FFN 128)
  fused, unfused, and unfused with the unfused attention ops (the head
  split's reshape/transpose), 5 Adam steps at dropout 0, the kernels'
  calls recorded; checkpoints both ways across one rank and two; 3
  steps at dropout 0.1, from the startup and after a run without the
  mesh; NMT-tiny; an op the split does not know;
* four ranks at ``{data: 2, model: 2}``: BERT-tiny fused and unfused,
  and ZeRO-1 stacked on the rules through a checkpoint resume.

Tolerances: losses within 2e-3 of the JAX package (``LOSS_TOL``),
whole parameters within 1e-4 (``PARAM_TOL``), a resume against the run
it continues within 1e-5, replicated parameters bit-equal across model
ranks.
"""
import os
import time

import numpy as np
import pytest
import torch

LOSS_TOL = 2e-3
PARAM_TOL = 1e-4
RESUME_TOL = 1e-5
STEPS = 5
K, N = 3, 5                       # checkpoint step, total steps
NMT_STEPS = 3
SPAWN_TIMEOUT = 300
QKV = "encoder.layer0.attn.qkv.w"
#: variant -> (fusion pass on, cfg.fused_attention)
VARIANTS = {"fused": (True, True), "unfused": (False, True),
            "unfused_heads": (False, False)}


# -- programs, built the same way by both packages ---------------------------

def _bert(pkg, models, fused_attention=True, dropout=0.0):
    cfg = models.BertConfig.tiny()
    cfg.hidden_dropout = cfg.attn_dropout = dropout
    cfg.fused_attention = fused_attention
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = 7
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        loss, _ = models.build_bert_pretrain(cfg, seq_len=32)
        pkg.optimizer.Adam(1e-3).minimize(loss)
    return main, startup, loss


def _nmt(pkg, models):
    cfg = models.NMTConfig.tiny()
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = 7
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        loss, _ = models.build_nmt_train(cfg, 8, 8)
        pkg.optimizer.Adam(1e-3).minimize(loss)
    return main, startup, loss


def _bert_feed(step=0):
    rng = np.random.RandomState(step)
    src = rng.randint(0, 1000, (8, 32)).astype(np.int64)
    labels = np.where(rng.rand(8, 32, 1) < 0.15, src[..., None],
                      -1).astype(np.int64)
    return {"src_ids": src, "input_mask": np.ones((8, 32), np.float32),
            "masked_labels": labels}


def _nmt_feed(step=0):
    rng = np.random.RandomState(50 + step)
    src = rng.randint(2, 96, (4, 8)).astype(np.int64)
    tgt = rng.randint(2, 96, (4, 8)).astype(np.int64)
    mask = np.ones((4, 8), np.float32)
    mask[0, 6:] = 0.0
    return {"src_ids": src, "src_mask": mask, "tgt_ids": tgt,
            "tgt_mask": np.ones((4, 8), np.float32),
            "labels": np.roll(tgt, -1, axis=1)[..., None]}


CASES = {"bert": (lambda pkg, m: _bert(pkg, m), _bert_feed),
         "bert_heads": (lambda pkg, m: _bert(pkg, m, False), _bert_feed),
         "bert_drop": (lambda pkg, m: _bert(pkg, m, True, 0.1), _bert_feed),
         "nmt": (_nmt, _nmt_feed)}


# -- the ranks (no jax, no paddle_tpu) ----------------------------------------

def _port(case, wdir, axes=None, fuse=True, reduce=False, scope=None,
          steps=STEPS, first=0, rules=None, built=None):
    """(losses, scope, main, target, exe) of ``steps`` steps from the
    JAX startup's weights (or ``scope`` as it is), of the case's program
    (or ``built``, its (main, startup, loss) built before)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import models
    from paddle_tpu_torch.compiler import BuildStrategy, CompiledProgram
    from paddle_tpu_torch.parallel import build_mesh

    build, feed = CASES[case]
    main, _, loss = built or build(pt, models)
    if scope is None:
        scope = pt.Scope()
        w = np.load(os.path.join(wdir, f"{case}.npz"))
        pt.io.load_params(scope, dict(w), "cpu", program=main)
    exe = pt.Executor(pt.CPUPlace())
    bs = BuildStrategy()
    bs.fuse_epilogues = fuse
    if reduce:
        bs.reduce_strategy = BuildStrategy.ReduceStrategy.Reduce
    target = CompiledProgram(main, build_strategy=bs)
    if axes is not None:
        if rules is None:
            rules = (models.nmt_tp_sharding_rules() if case == "nmt"
                     else models.tp_sharding_rules())
        target = target.with_sharding(build_mesh(axes, device_type="cpu"),
                                      param_rules=rules)
    losses = [float(exe.run(target, feed=feed(first + s), fetch_list=[loss],
                            scope=scope)[0]) for s in range(steps)]
    return losses, scope, main, target, exe


def _whole(scope, main):
    from paddle_tpu_torch.core.spmd import whole_value

    return {v.name: whole_value(scope, v.name, scope.find_var(v.name))
            .detach().cpu().numpy().copy()
            for v in main.list_vars()
            if v.persistable and scope.find_var(v.name) is not None}


def _mesh_plan(main):
    return next(lw.mesh_plan for lw in main._exec_cache.values()
                if lw.mesh_plan is not None)


class _Calls:
    """Records the kernel wrappers' calls (shapes, head counts)."""

    def __init__(self):
        from paddle_tpu_torch.ops import attention_epilogue as ae
        from paddle_tpu_torch.ops import ffn_chain as fc
        from paddle_tpu_torch.ops import fused_matmul as fm

        self.log = []
        self._undo = []
        for mod, name in ((ae, "fused_qkv_attention"),
                          (fc, "fused_ffn_chain"), (fm, "fused_matmul")):
            fn = getattr(mod, name)
            self._undo.append((mod, name, fn))
            setattr(mod, name, self._wrap(name, fn))

    def _wrap(self, name, fn):
        def call(*args, **kw):
            rec = [name] + [tuple(a.shape) for a in args[:2]]
            if name == "fused_qkv_attention":
                rec.append(int(args[3]))
            elif name == "fused_matmul":
                spec = kw.get("spec", args[7] if len(args) > 7 else None)
                rec.append(spec is not None and spec.act is None
                           and len(args) < 3 and "bias" not in kw)
            self.log.append(tuple(rec))
            return fn(*args, **kw)
        return call

    def close(self):
        for mod, name, fn in self._undo:
            setattr(mod, name, fn)


def _tp_result(losses, scope, main):
    plan = _mesh_plan(main)
    qkv = scope.find_var(QKV)
    return dict(losses=losses, params=_whole(scope, main),
                stats=dict(plan.last_stats), planned=dict(plan.split.planned),
                qkv_local=None if qkv is None else qkv.numpy().copy())


def _two(rank, wdir, out):
    import torch.distributed as dist

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import models

    res = {}
    for variant, (fuse, attn) in VARIANTS.items():
        case = "bert" if attn else "bert_heads"
        calls = _Calls() if variant == "fused" else None
        try:
            losses, scope, main, target, exe = _port(case, wdir,
                                                     {"model": 2}, fuse)
        finally:
            if calls is not None:
                calls.close()
        res[variant] = _tp_result(losses, scope, main)
        if calls is not None:
            res[variant]["calls"] = calls.log
    # fetches and io.save hand back the whole order
    fetched = exe.run(target, feed=_bert_feed(STEPS), fetch_list=[QKV],
                      scope=scope)[0]
    res["fetched_qkv"] = fetched
    save_dir = os.path.join(out, f"save{rank}")
    with pt.scope_guard(scope):
        pt.io.save_persistables(exe, save_dir, main)
    # a {model: 2} checkpoint after K steps, and its continuation
    _, scope, main, _, _ = _port("bert", wdir, {"model": 2}, steps=K)
    pt.resilience.CheckpointManager(os.path.join(out, f"ckpt_tp{rank}"),
                                    keep=None).save(K, program=main,
                                                    scope=scope)
    losses, scope, main, _, _ = _port("bert", wdir, {"model": 2},
                                      scope=scope, steps=N - K, first=K)
    res["tp_continued"] = (losses, _whole(scope, main))
    # the one rank's checkpoint resumed at {model: 2}
    build, _ = CASES["bert"]
    main, _, _ = build(pt, models)
    scope = pt.Scope()
    pt.resilience.CheckpointManager(os.path.join(out, "ckpt_one"),
                                    keep=None).restore(program=main,
                                                       scope=scope)
    losses, scope, main, _, _ = _port("bert", wdir, {"model": 2},
                                      scope=scope, steps=N - K, first=K)
    res["one_resumed"] = (losses, _whole(scope, main))
    # dropout 0.1: the replicated values are one value
    _, scope, main, _, _ = _port("bert_drop", wdir, {"model": 2}, steps=3)
    split = _mesh_plan(main).split.params
    res["drop_replicated"] = {
        p.name: scope.find_var(p.name).detach().numpy().copy()
        for p in main.all_parameters() if p.name not in split}
    res["drop_split"] = sorted(split)
    # a program run alone first draws its own seed on each rank; its
    # first step at {model: 2} agrees the mesh's first rank's
    np.random.seed(rank)
    built = CASES["bert_drop"][0](pt, models)
    _port("bert_drop", wdir, steps=1, built=built)
    res["seed_alone"] = built[0]._auto_seed
    _, scope, main, _, _ = _port("bert_drop", wdir, {"model": 2}, steps=3,
                                 built=built)
    res["seed_meshed"] = main._auto_seed
    res["reseed_replicated"] = {
        p.name: scope.find_var(p.name).detach().numpy().copy()
        for p in main.all_parameters() if p.name not in split}
    losses, scope, main, _, _ = _port("nmt", wdir, {"model": 2},
                                      steps=NMT_STEPS)
    res["nmt"] = _tp_result(losses, scope, main)
    try:
        m2, s2 = pt.Program(), pt.Program()
        with pt.program_guard(m2, s2), pt.unique_name.guard():
            x = pt.data("x", [None, 8])
            h = pt.layers.fc(x, 16)
            y = pt.layers.layer_norm(h, begin_norm_axis=1)
        sc = pt.Scope()
        ex = pt.Executor(pt.CPUPlace())
        ex.run(s2, scope=sc)
        from paddle_tpu_torch.compiler import CompiledProgram
        from paddle_tpu_torch.parallel import build_mesh

        ex.run(CompiledProgram(m2).with_sharding(
            build_mesh({"model": 2}, device_type="cpu"),
            param_rules=[(r"fc_0\.w_0", (None, "model"))]),
            feed={"x": np.ones((4, 8), np.float32)}, fetch_list=[y],
            scope=sc)
        res["refused"] = "ran"
    except NotImplementedError as e:
        res["refused"] = str(e)
    torch.save(res, os.path.join(out, f"two{rank}.pt"))
    dist.barrier()


def _four(rank, wdir, out):
    import torch.distributed as dist

    import paddle_tpu_torch as pt

    res = {}
    for variant in ("fused", "unfused"):
        losses, scope, main, _, _ = _port("bert", wdir,
                                          {"data": 2, "model": 2},
                                          VARIANTS[variant][0])
        res[variant] = _tp_result(losses, scope, main)
    # ZeRO-1 stacked on the rules: a checkpoint after K steps resumed in
    # fresh programs against the run it continues
    axes = {"data": 2, "model": 2}
    _, scope, main, _, _ = _port("bert", wdir, axes, reduce=True, steps=K)
    root = os.path.join(out, f"ckpt_zero{rank}")
    pt.resilience.CheckpointManager(root, keep=None).save(
        K, program=main, scope=scope)
    res["zero_saved"] = _whole(scope, main)
    moment = next(n for n in res["zero_saved"]
                  if n.startswith(QKV + "_moment1"))
    sh = scope._shardings[moment][0]
    res["zero_moment"] = (moment, tuple(scope.find_var(moment).shape),
                          sh.spec, sh.groups)
    losses, scope, main, _, _ = _port("bert", wdir, axes, reduce=True,
                                      scope=scope, steps=N - K, first=K)
    res["zero_continued"] = (losses, _whole(scope, main))
    from paddle_tpu_torch import models

    build, _ = CASES["bert"]
    main, _, _ = build(pt, models)
    scope = pt.Scope()
    pt.resilience.CheckpointManager(root, keep=None).restore(
        program=main, scope=scope)
    losses, scope, main, _, _ = _port("bert", wdir, axes, reduce=True,
                                      scope=scope, steps=N - K, first=K)
    res["zero_resumed"] = (losses, _whole(scope, main))
    torch.save(res, os.path.join(out, f"four{rank}.pt"))
    dist.barrier()


def _rank_main(rank, world, module, fn_name, wdir, out):
    import importlib

    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(out, f"store{world}"),
                                     world), rank=rank, world_size=world)
    try:
        getattr(importlib.import_module(module), fn_name)(rank, wdir, out)
    finally:
        dist.destroy_process_group()


def spawn(fn_name, world, wdir, out, prefix, module=__name__):
    """Run ``module.fn_name`` on ``world`` gloo ranks; a rank that hangs
    fails the test after SPAWN_TIMEOUT seconds."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(_rank_main,
                             args=(world, module, fn_name, wdir, out),
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

def _jax(case, steps, axes=None):
    import paddle_tpu as jpt
    from paddle_tpu import models as jmodels

    build, feed = CASES[case]
    main, startup, loss = build(jpt, jmodels)
    scope = jpt.Scope()
    exe = jpt.Executor()
    target = main
    if axes is not None:
        from paddle_tpu.parallel.mesh import build_mesh

        target = jpt.CompiledProgram(main).with_sharding(
            build_mesh(axes), param_rules=jmodels.tp_sharding_rules(),
            batch_axes=[a for a in axes if a == "data"])
    with jpt.scope_guard(scope):
        exe.run(startup)
        weights = {v.name: np.asarray(scope.find_var(v.name))
                   for v in main.list_vars() if v.persistable
                   and scope.find_var(v.name) is not None}
        losses = [float(np.asarray(exe.run(target, feed=feed(s),
                                           fetch_list=[loss])[0]))
                  for s in range(steps)]
        final = {n: np.asarray(scope.find_var(n)) for n in weights}
    return weights, losses, final


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    wdir = tmp_path_factory.mktemp("weights")
    out = tmp_path_factory.mktemp("ranks")
    ref = {}
    for case, steps in (("bert", STEPS), ("bert_heads", STEPS),
                        ("bert_drop", 3), ("nmt", NMT_STEPS)):
        weights, ref[case], ref[case + "_final"] = _jax(case, steps)
        np.savez(wdir / f"{case}.npz", **weights)
    ref["sharded_model2"] = _jax("bert", STEPS, {"model": 2})[1]
    ref["sharded_data2_model2"] = _jax("bert", STEPS,
                                       {"data": 2, "model": 2})[1]
    # one rank's checkpoint after K steps, and its continuation
    import paddle_tpu_torch as pt

    _, scope, main, _, _ = _port("bert", str(wdir), steps=K)
    pt.resilience.CheckpointManager(str(out / "ckpt_one"), keep=None).save(
        K, program=main, scope=scope)
    ref["one_saved"] = _whole(scope, main)
    losses, scope, main, _, _ = _port("bert", str(wdir), scope=scope,
                                      steps=N - K, first=K)
    ref["one_continued"] = (losses, _whole(scope, main))
    two = spawn("_two", 2, str(wdir), str(out), "two")
    four = spawn("_four", 4, str(wdir), str(out), "four")
    return {"ref": ref, "two": two, "four": four, "wdir": str(wdir),
            "out": str(out)}


def _diff(a, b):
    return float(np.max(np.abs(np.subtract(a, b))))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_model2_matches_the_jax_package(ranks, variant):
    case = "bert" if VARIANTS[variant][1] else "bert_heads"
    ref = ranks["ref"]
    for r in ranks["two"]:
        got = r[variant]
        assert _diff(got["losses"], ref[case]) < LOSS_TOL, \
            (got["losses"], ref[case])
        if case == "bert":
            assert _diff(got["losses"], ref["sharded_model2"]) \
                < LOSS_TOL
        for n, v in ref[case + "_final"].items():
            assert _diff(got["params"][n], v) < PARAM_TOL, n


@pytest.mark.parametrize("variant", ["fused", "unfused"])
def test_data2_model2_matches_the_jax_package(ranks, variant):
    ref = ranks["ref"]
    for r in ranks["four"]:
        got = r[variant]
        assert _diff(got["losses"], ref["bert"]) < LOSS_TOL
        assert _diff(got["losses"], ref["sharded_data2_model2"]) \
            < LOSS_TOL
        for n, v in ref["bert_final"].items():
            assert _diff(got["params"][n], v) < PARAM_TOL, n


def test_the_split_is_real(ranks):
    """Each rank's qkv product reads [64, 96] and its attention runs 2
    heads; the row-parallel products read K/2; the model collectives are
    the planned ones; nothing is gathered whole."""
    cfg_layers = 2
    for r in ranks["two"] + ranks["four"]:
        for variant in ("fused", "unfused"):
            got = r[variant]
            assert got["stats"].get("whole_gathers", 0) == 0
            # a layer: the attention output and the FFN's sums, the two
            # inputs' backward sums; the embedding's sum; the MLM input's
            # and bias's backward sums; the logits' gather
            want = {"forward_sum": 2 * cfg_layers + 1,
                    "backward_sum": 2 * cfg_layers + 2, "all_gather": 1}
            assert got["planned"] == want, got["planned"]
            assert {k: got["stats"].get(k, 0) for k in want} == want, \
                got["stats"]
    calls = ranks["two"][0]["fused"]["calls"]
    qkv = [c for c in calls if c[0] == "fused_qkv_attention"]
    assert len(qkv) == cfg_layers * STEPS
    assert all(c[2] == (64, 96) and c[3] == 2 for c in qkv), qkv
    rows = [c for c in calls if c[0] == "fused_matmul" and c[3]]
    # per layer: the attention output (K 32) and the FFN's down half
    # (F 64), each with its epilogue off
    assert sorted({c[2] for c in rows}) == [(32, 64), (64, 64)], rows
    assert len(rows) == 2 * cfg_layers * STEPS


def test_stored_qkv_is_head_grouped(ranks):
    """Rank r stores [q_r | k_r | v_r] of the whole weight; the fetch
    and io.save hand back the JAX package's column order."""
    from paddle_tpu_torch.parallel.mesh import take_block

    whole = ranks["ref"]["bert_final"][QKV]
    for rank, r in enumerate(ranks["two"]):
        local = r["fused"]["qkv_local"]
        want = take_block(torch.from_numpy(whole.copy()), 1, 2, rank,
                          3).numpy()
        assert local.shape == (64, 96)
        assert _diff(local, want) < PARAM_TOL
        assert _diff(r["fused"]["params"][QKV], whole) < PARAM_TOL
        assert r["fetched_qkv"].shape == (64, 192)
        saved = np.load(os.path.join(ranks["out"], f"save{rank}",
                                     "__params__.npz"))
        np.testing.assert_array_equal(saved[QKV], r["fetched_qkv"])


def test_model2_checkpoint_resumes_at_one_rank(ranks):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import models

    build, _ = CASES["bert"]
    main, _, _ = build(pt, models)
    scope = pt.Scope()
    pt.resilience.CheckpointManager(os.path.join(ranks["out"], "ckpt_tp0"),
                                    keep=None).restore(program=main,
                                                       scope=scope)
    losses, scope, main, _, _ = _port("bert", ranks["wdir"], scope=scope,
                                      steps=N - K, first=K)
    cont_losses, cont = ranks["two"][0]["tp_continued"]
    assert _diff(losses, cont_losses) < RESUME_TOL
    got = _whole(scope, main)
    for n, v in cont.items():
        assert _diff(got[n], v) < RESUME_TOL, n


def test_one_rank_checkpoint_resumes_at_model2(ranks):
    want_losses, want = ranks["ref"]["one_continued"]
    for r in ranks["two"]:
        losses, got = r["one_resumed"]
        assert _diff(losses, want_losses) < RESUME_TOL
        for n, v in want.items():
            assert _diff(got[n], v) < RESUME_TOL, n


def test_zero1_on_the_rules_resumes(ranks):
    """ZeRO-1 stacked on the rules: the qkv moment is split over data on
    dim 0 and head-grouped over model on dim 1, checkpointed whole in
    the JAX order (it tracks the one-rank run's moment), and the resumed
    run continues the saved one."""
    one = ranks["ref"]["one_saved"]
    for r in ranks["four"]:
        name, shape, spec, groups = r["zero_moment"]
        assert shape == (32, 96) and spec == ("data", "model")
        assert groups == (1, 3)
        np.testing.assert_allclose(r["zero_saved"][name], one[name],
                                   rtol=1e-3, atol=1e-8)
        cont_losses, cont = r["zero_continued"]
        losses, got = r["zero_resumed"]
        assert _diff(losses, cont_losses) < RESUME_TOL
        for n, v in cont.items():
            assert _diff(got[n], v) < RESUME_TOL, n


def test_replicated_parameters_agree_bitwise_at_dropout(ranks):
    a, b = (r["drop_replicated"] for r in ranks["two"])
    assert "encoder.layer0.ln1.scale" in a and QKV not in a
    assert ranks["two"][0]["drop_split"] == ranks["two"][1]["drop_split"]
    for n in a:
        np.testing.assert_array_equal(a[n], b[n], err_msg=n)


def test_a_seed_drawn_before_the_mesh_is_agreed(ranks):
    """A program run once without the mesh holds a seed of each rank's
    own; its first step at {model: 2} agrees rank 0's, so the replicated
    parameters stay bit-equal across the model ranks at dropout 0.1."""
    a, b = ranks["two"]
    assert a["seed_alone"] != b["seed_alone"]
    assert a["seed_meshed"] == b["seed_meshed"] == a["seed_alone"]
    assert "encoder.layer0.ln1.scale" in a["reseed_replicated"]
    for n, v in a["reseed_replicated"].items():
        np.testing.assert_array_equal(v, b["reseed_replicated"][n],
                                      err_msg=n)


def test_nmt_model2_matches_the_jax_package(ranks):
    ref = ranks["ref"]
    for r in ranks["two"]:
        got = r["nmt"]
        assert got["stats"].get("whole_gathers", 0) == 0
        assert _diff(got["losses"], ref["nmt"]) < LOSS_TOL
        for n, v in ref["nmt_final"].items():
            assert _diff(got["params"][n], v) < PARAM_TOL, n


def test_an_op_outside_the_split_raises(ranks):
    msg = ranks["two"][0]["refused"]
    assert "layer_norm" in msg and "Queue 1 item 5" in msg, msg
