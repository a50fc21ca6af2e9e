"""Sync-BN: ``batch_norm`` in training under a data mesh normalizes by
the global batch's statistics (core/spmd.py), as the JAX package's does
under its partitioner, against the JAX package on one device at the
global batch.

Two gloo ranks at ``{data: 2}`` (``torch.multiprocessing``, a
``FileStore`` in ``tmp_path``; the ranks import neither jax nor
paddle_tpu), fed the global batch of 8, each keeping its 4 rows, one
spawn for the module.  The programs: ``resnet_cifar10(depth=8)`` under
Momentum, and a conv + batch-norm net with the statistics over NCHW and
over NHWC; for each, 3 training steps (losses within 2e-3; the running
statistics after the first, which moved them by the global batch's
statistics under the startup weights, within 1e-5 — later steps add the
drift of training batch-norm nets from random weights, whose gradients
part two f32 runs by more) and ``gradients([loss], [img])`` (the
input's gradient within 1e-4: the statistics' sums owe every rank the
other ranks' share of the cotangent, which an identity backward drops).
"""
import os

import numpy as np
import pytest
import torch

from test_torch_parallel_tp import spawn

LOSS_TOL = 2e-3
STAT_TOL = 1e-5
GRAD_TOL = 1e-4
STEPS = 3
NETS = ("resnet8", "nchw", "nhwc")


def _net(pkg, models, net, train):
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = 11
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        label = pkg.data("label", [None, 1], "int64")
        if net == "resnet8":
            img = pkg.data("img", [None, 3, 32, 32])
            _, loss, _ = models.resnet_cifar10(img, label, depth=8)
        else:
            img = pkg.data("img", [None, 3, 8, 8])
            h = pkg.layers.conv2d(img, 6, 3, padding=1)
            if net == "nhwc":
                h = pkg.layers.transpose(h, [0, 2, 3, 1])
            h = pkg.layers.batch_norm(h, act="relu", data_layout=(
                "NHWC" if net == "nhwc" else "NCHW"))
            logits = pkg.layers.fc(h, 4)
            loss = pkg.layers.mean(
                pkg.layers.softmax_with_cross_entropy(logits, label))
        if train:
            pkg.optimizer.Momentum(0.1, 0.9).minimize(loss)
            grad = None
        else:
            grad = pkg.gradients([loss], [img])[0]
    return main, startup, loss, grad


def _feed(net, step):
    rng = np.random.RandomState(20 + step)
    side = 32 if net == "resnet8" else 8
    img = (rng.randn(8, 3, side, side) * 2.0 + 0.5).astype(np.float32)
    return {"img": img,
            "label": rng.randint(0, 4, (8, 1)).astype(np.int64)}


def _stats(main):
    return sorted(v.name for v in main.list_vars()
                  if v.persistable and (".mean" in v.name or ".var" in v.name
                                        or "_mean" in v.name
                                        or "_variance" in v.name))


def _ranks(rank, wdir, out):
    import torch.distributed as dist

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import models
    from paddle_tpu_torch.compiler import CompiledProgram
    from paddle_tpu_torch.parallel import build_mesh

    res = {}
    for net in NETS:
        for train in (True, False):
            main, _, loss, grad = _net(pt, models, net, train)
            scope = pt.Scope()
            w = np.load(os.path.join(wdir, f"{net}.npz"))
            mine = {v.name for v in main.list_vars() if v.persistable}
            pt.io.load_params(scope, {n: w[n] for n in w.files if n in mine},
                              "cpu", program=main)
            target = CompiledProgram(main).with_sharding(
                build_mesh({"data": 2}, device_type="cpu"))
            exe = pt.Executor(pt.CPUPlace())
            if train:
                losses, stats = [], None
                for s in range(STEPS):
                    losses.append(float(exe.run(
                        target, feed=_feed(net, s), fetch_list=[loss],
                        scope=scope)[0]))
                    stats = stats or {n: scope.find_var(n).numpy().copy()
                                      for n in _stats(main)}
                res[net] = dict(losses=losses, stats=stats)
            else:
                res[net + "_grad"] = exe.run(
                    target, feed=_feed(net, 0), fetch_list=[grad],
                    scope=scope)[0]
    torch.save(res, os.path.join(out, f"bn{rank}.pt"))
    dist.barrier()


def _jax(net):
    import paddle_tpu as jpt
    from paddle_tpu import models as jmodels

    out = {}
    for train in (True, False):
        main, startup, loss, grad = _net(jpt, jmodels, net, train)
        scope = jpt.Scope()
        exe = jpt.Executor()
        with jpt.scope_guard(scope):
            exe.run(startup)
            if train:
                out["weights"] = {
                    v.name: np.asarray(scope.find_var(v.name))
                    for v in main.list_vars() if v.persistable
                    and scope.find_var(v.name) is not None}
                out["losses"] = []
                for s in range(STEPS):
                    out["losses"].append(float(np.asarray(exe.run(
                        main, feed=_feed(net, s), fetch_list=[loss])[0])))
                    out.setdefault("stats", {
                        n: np.asarray(scope.find_var(n)).copy()
                        for n in _stats(main)})
            else:
                for n, v in out["weights"].items():
                    if scope.find_var(n) is not None:
                        scope.set_var(n, v)
                out["grad"] = np.asarray(exe.run(
                    main, feed=_feed(net, 0), fetch_list=[grad])[0])
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    wdir = tmp_path_factory.mktemp("weights")
    out = tmp_path_factory.mktemp("ranks")
    ref = {}
    for net in NETS:
        ref[net] = _jax(net)
        np.savez(wdir / f"{net}.npz", **ref[net]["weights"])
    return {"ref": ref, "ranks": spawn("_ranks", 2, str(wdir), str(out),
                                       "bn", module=__name__)}


def _diff(a, b):
    return float(np.max(np.abs(np.subtract(a, b))))


@pytest.mark.parametrize("net", NETS)
def test_sync_bn_losses_match_the_global_batch(ranks, net):
    ref = ranks["ref"][net]["losses"]
    for r in ranks["ranks"]:
        assert _diff(r[net]["losses"], ref) < LOSS_TOL, \
            (r[net]["losses"], ref)


@pytest.mark.parametrize("net", NETS)
def test_sync_bn_running_statistics_are_global(ranks, net):
    ref = ranks["ref"][net]["stats"]
    assert ref
    for r in ranks["ranks"]:
        assert set(r[net]["stats"]) == set(ref)
        for n, v in ref.items():
            assert _diff(r[net]["stats"][n], v) < STAT_TOL, n
    a, b = (r[net]["stats"] for r in ranks["ranks"])
    for n in a:
        np.testing.assert_array_equal(a[n], b[n], err_msg=n)


@pytest.mark.parametrize("net", NETS)
def test_sync_bn_input_gradient_matches(ranks, net):
    ref = ranks["ref"][net]["grad"]
    assert np.abs(ref).max() > 1e-3
    for r in ranks["ranks"]:
        got = r[net + "_grad"]
        assert got.shape == ref.shape
        assert _diff(got, ref) < GRAD_TOL
