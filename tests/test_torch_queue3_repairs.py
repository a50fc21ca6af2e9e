"""Two faults of the port against the JAX package, each repaired here.

1. A fused group that two backward passes differentiate
   (``gradients([loss], [x])``, then ``SGD.minimize(loss)``) lowers and
   runs: each pass gets its own gradients from the group's one graph,
   which is kept until the last pass (``core/fusion.py``
   ``run_fused_grad``).  The program runs in both packages from the same
   weights, with ``fuse_epilogues`` on and off: the loss, ``x@GRAD`` and
   the parameters after the step within 1e-6.
2. ``distributed.collectives.cross_process_mean`` returns what
   ``np.mean`` over the gathered stack returns (the JAX package's
   formula): float16 accumulates in float32, integers give float64.  Two
   gloo ranks (``torch.multiprocessing.spawn``, a ``FileStore`` in
   ``tmp_path``) against ``np.mean(np.stack(inputs), 0)``, in dtype and
   value.

The spawned ranks import neither jax nor paddle_tpu; the JAX side is
imported inside its test.
"""
import json
import os

import numpy as np
import pytest
import torch

TOL = 1e-6


# -- 1. a fused group under two backward passes ------------------------------

def _two_pass_program(P):
    x = P.data("x", [32, 64])
    x.stop_gradient = False
    h1 = P.layers.fc(x, 128, act="gelu")
    h2 = P.layers.fc(h1, 64)
    out = P.layers.layer_norm(P.layers.elementwise_add(h2, x))
    loss = P.layers.mean(P.layers.elementwise_mul(out, out))
    (gx,) = P.gradients([loss], [x])
    P.optimizer.SGD(0.5).minimize(loss)
    return loss, gx


def _run(P, fuse, weights=None):
    main, startup = P.Program(), P.Program()
    startup.random_seed = 5
    with P.program_guard(main, startup), P.unique_name.guard():
        loss, gx = _two_pass_program(P)
    params = sorted(p.name for p in main.global_block().all_parameters())
    feed = {"x": np.random.RandomState(0).randn(32, 64).astype(np.float32)}
    scope = P.Scope()
    if P.__name__ == "paddle_tpu":
        exe = P.Executor()
        bs = P.compiler.BuildStrategy()
    else:
        exe = P.Executor(P.CPUPlace())
        bs = P.BuildStrategy()
    bs.fuse_epilogues = fuse
    program = P.CompiledProgram(main, build_strategy=bs)
    with P.scope_guard(scope):
        if weights is None:
            exe.run(startup)
            weights = {v.name: np.asarray(scope.find_var(v.name))
                       for v in main.list_vars() if v.persistable}
        else:
            P.io.load_params(scope, weights, "cpu", program=main)
        fetched = exe.run(program, feed=feed, fetch_list=[loss, gx])
        after = {n: np.asarray(scope.find_var(n)) for n in params}
    plans = [getattr(v, "fusion_plan", None)
             for v in main._exec_cache.values()] if hasattr(
        main, "_exec_cache") else []
    return weights, [np.asarray(f) for f in fetched], after, plans


@pytest.fixture(scope="module")
def jax_two_pass():
    import paddle_tpu as jpt

    out = {}
    for fuse in (True, False):
        with jpt.new_program_scope():
            out[fuse] = _run(jpt, fuse)
    return out


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
def test_a_fused_group_under_two_backward_passes(jax_two_pass, fuse):
    import paddle_tpu_torch as pt

    weights, (jloss, jgx), jafter, _ = jax_two_pass[fuse]
    _, (loss, gx), after, plans = _run(pt, fuse, weights)
    if fuse:
        kinds = [g.pattern for plan in plans if plan is not None
                 for g in plan.groups]
        # one FFN group over both fc layers and the residual layer norm
        assert kinds == ["mul+bias+gelu+mul+bias+residual+layer_norm"]
    np.testing.assert_allclose(loss, jloss, rtol=0, atol=TOL)
    np.testing.assert_allclose(gx, jgx, rtol=0, atol=TOL)
    for n in jafter:
        np.testing.assert_allclose(after[n], jafter[n], rtol=0, atol=TOL,
                                   err_msg=n)


def test_the_default_executor_runs_the_two_pass_program():
    """The plain ``exe.run(main)`` (fusion on by default) gives the
    unfused lowering's answer."""
    import paddle_tpu_torch as pt

    def run(fuse):
        main, startup = pt.Program(), pt.Program()
        startup.random_seed = 5
        with pt.program_guard(main, startup), pt.unique_name.guard():
            loss, gx = _two_pass_program(pt)
        scope = pt.Scope()
        exe = pt.Executor(pt.CPUPlace())
        feed = {"x": np.random.RandomState(1).randn(32, 64)
                .astype(np.float32)}
        with pt.scope_guard(scope):
            exe.run(startup)
            if fuse is None:
                program = main
            else:
                bs = pt.BuildStrategy()
                bs.fuse_epilogues = fuse
                program = pt.CompiledProgram(main, build_strategy=bs)
            return [np.asarray(f) for f in exe.run(
                program, feed=feed, fetch_list=[loss, gx])]

    default, unfused = run(None), run(False)
    for a, b in zip(default, unfused):
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL)


# -- 2. cross_process_mean over two gloo ranks -------------------------------

WORLD = 2
CASES = {
    "float16": ([[60000.0, 1.0]], [[60000.0, 1.0]]),
    "int32": ([1, 2], [2, 3]),
    "float32": ([0.1, -2.5, 3.0], [0.7, 1.25, -3.0]),
}


def _mean_rank(rank, store_path, out_dir):
    import torch.distributed as dist

    from paddle_tpu_torch.distributed.collectives import cross_process_mean

    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD),
                            rank=rank, world_size=WORLD)
    try:
        res = {}
        for dtype, per_rank in CASES.items():
            got = cross_process_mean(np.asarray(per_rank[rank], dtype))
            tgot = cross_process_mean(torch.from_numpy(
                np.asarray(per_rank[rank], dtype)))
            res[dtype] = dict(value=got.tolist(), dtype=str(got.dtype),
                              tvalue=tgot.tolist(), tdtype=str(tgot.dtype))
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def mean_ranks(tmp_path_factory):
    import torch.multiprocessing as mp

    root = tmp_path_factory.mktemp("mean")
    mp.spawn(_mean_rank, args=(str(root / "store"), str(root)),
             nprocs=WORLD, join=True)
    return [json.loads((root / f"rank{r}.json").read_text())
            for r in range(WORLD)]


@pytest.mark.parametrize("dtype", sorted(CASES))
def test_cross_process_mean_is_np_mean_of_the_stack(mean_ranks, dtype):
    want = np.mean(np.stack([np.asarray(v, dtype) for v in CASES[dtype]]),
                   axis=0)
    assert np.all(np.isfinite(want))
    for res in mean_ranks:
        r = res[dtype]
        for value, got_dtype in ((r["value"], r["dtype"]),
                                 (r["tvalue"], r["tdtype"])):
            assert got_dtype == str(want.dtype)
            np.testing.assert_array_equal(np.asarray(value, want.dtype),
                                          want)
