"""The port's dygraph ``DataParallel`` over two gloo ranks on the CPU
against one rank at the global batch — the counterpart of
tests/test_dist_extras.py::test_dygraph_data_parallel_two_ranks (its
per-rank script tests/dist_dygraph_dp.py: Linear(4, 1) from 0.5, SGD(0.1),
5 steps on 8 rows, each rank its half).

The ranks run in ``torch.multiprocessing`` spawns with a ``FileStore`` in
``tmp_path`` (they import neither jax nor paddle_tpu); ``DataParallel``
reads the world from the process group.  Both ranks must end with the
same weights, equal (1e-6) to one rank's run of the global batch in the
test process, to the JAX package's dygraph run of it and to the numpy
full-batch SGD of the JAX test (1e-4, its tolerance), and every rank's
unscaled loss must equal the loss of its half under the shared weights.
"""
import os
import time

import numpy as np
import torch

SPAWN_TIMEOUT = 120.0
STEPS, LR = 5, 0.1
TRUE_W = np.array([[1.0], [-1.0], [0.5], [2.0]], np.float32)


def _data():
    rng = np.random.RandomState(0)
    X = rng.randn(8, 4).astype(np.float32)
    return X, (X @ TRUE_W).astype(np.float32)


def _train(pkg, guard, rows, model_fn):
    """STEPS of pkg's dygraph SGD on X[rows]; returns (losses, w)."""
    X, Y = _data()
    D = pkg.dygraph
    with guard():
        model = model_fn(D)
        model._layers.weight.value = np.full((4, 1), 0.5, np.float32)
        opt = pkg.optimizer.SGD(LR, parameter_list=model.parameters())
        losses = []
        for _ in range(STEPS):
            pred = model(D.to_variable(X[rows]))
            loss = pkg.layers.mean(pkg.layers.square_error_cost(
                pred, D.to_variable(Y[rows])))
            loss = model.scale_loss(loss)
            loss.backward()
            model.apply_collective_grads()
            opt.minimize(loss)
            model.clear_gradients()
            losses.append(float(loss.numpy()) * model.nranks)  # unscaled
        w = model._layers.weight.numpy().ravel().copy()
    return losses, w


def _port_model(D):
    return D.DataParallel(D.nn.Linear(4, 1, bias_attr=False),
                          D.parallel.Env())


def _rank_main(rank, world, out):
    import torch.distributed as dist

    import paddle_tpu_torch as pt

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(out, "store"), world),
        rank=rank, world_size=world)
    try:
        half = 8 // world
        losses, w = _train(pt, lambda: pt.dygraph.guard("cpu"),
                           slice(rank * half, (rank + 1) * half),
                           _port_model)
        torch.save(dict(losses=losses, w=w),
                   os.path.join(out, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _spawn(world, out):
    import torch.multiprocessing as mp

    ctx = mp.start_processes(_rank_main, args=(world, out), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.terminate()
            raise TimeoutError(f"ranks still running after {SPAWN_TIMEOUT}"
                               f" s")
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def test_data_parallel_two_ranks_against_one_rank(tmp_path):
    import paddle_tpu as jpt
    import paddle_tpu_torch as pt

    r0, r1 = _spawn(2, str(tmp_path))
    # identical weights on both ranks after the collective gradients
    np.testing.assert_allclose(r0["w"], r1["w"], rtol=0, atol=1e-6)

    # one rank at the global batch, in this process (no process group:
    # DataParallel's nranks == 1 path)
    one_losses, one_w = _train(pt, lambda: pt.dygraph.guard("cpu"),
                               slice(0, 8), _port_model)
    np.testing.assert_allclose(r0["w"], one_w, rtol=0, atol=1e-6)
    with pt.unique_name.guard():
        jlosses, jw = _train(
            jpt, jpt.dygraph.guard, slice(0, 8),
            lambda D: D.DataParallel(D.nn.Linear(4, 1, bias_attr=False),
                                     D.parallel.Env()))
    np.testing.assert_allclose(one_w, jw, rtol=0, atol=1e-6)
    np.testing.assert_allclose(one_losses, jlosses, rtol=1e-6, atol=1e-6)

    # the JAX test's numpy full-batch SGD
    X, Y = _data()
    w = np.full((4, 1), 0.5, np.float32)
    for _ in range(STEPS):
        w = w - LR * (2 * X.T @ (X @ w - Y) / len(X))
    np.testing.assert_allclose(r0["w"], w.ravel(), rtol=0, atol=1e-4)

    # each rank's first loss is its half's under the shared start
    for r, res in enumerate((r0, r1)):
        half = X[4 * r:4 * (r + 1)] @ np.full((4, 1), 0.5, np.float32)
        want = float(np.mean((half - Y[4 * r:4 * (r + 1)]) ** 2))
        np.testing.assert_allclose(res["losses"][0], want, rtol=1e-5)
