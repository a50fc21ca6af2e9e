"""The fleet's collective mode, the launcher, LocalSGD and the
collectives of the port against the JAX package, on the CPU.

* One process: the collective fleet (CollectiveOptimizer over
  ``with_data_parallel`` on the one-rank ``LocalMesh``) against plain
  training of the same program (bit-equal) and against the JAX
  package's collective fleet from the same weights (losses within
  1e-5); the save APIs write what the JAX package loads.
* Two gloo ranks started by ``python -m paddle_tpu_torch.distributed
  .launch --use_cpu_devices=1``: ``fleet.init`` starts the process
  group from the launcher's variables, both ranks' data-parallel losses
  equal the one-process run's; ``dgc_sparse_allreduce`` equals the JAX
  function on a 2-device CPU mesh; ``cross_process_mean`` is the mean.
* LocalSGD on two ranks through the launcher (chip_smoke.py's phase 16d
  on the CPU): after each sync both ranks hold the mean of their
  pre-sync weights within 1e-6.
* ``allreduce_bandwidth`` at world 1 reports ``min_s`` and no GB/s."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as pt
from paddle_tpu_torch.incubate.fleet.base.role_maker import \
    UserDefinedRoleMaker
from paddle_tpu_torch.incubate.fleet.collective import (DistributedStrategy,
                                                        fleet)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCH_TIMEOUT_S = 240

pytestmark = pytest.mark.multiproc


def _model(pkg):
    x = pkg.data("x", [None, 4])
    y = pkg.data("y", [None, 1])
    h = pkg.layers.fc(x, 8, act="relu", param_attr=pkg.ParamAttr(name="w1"))
    pred = pkg.layers.fc(h, 1, param_attr=pkg.ParamAttr(name="w2"))
    return pkg.layers.mean(pkg.layers.square_error_cost(pred, y))


def _data():
    rng = np.random.RandomState(0)
    X = rng.randn(8, 4).astype(np.float32)
    return X, (X.sum(1, keepdims=True) * 0.3).astype(np.float32)


def _run(pkg, exe, program_fn, weights=None, steps=5):
    """Build with ``program_fn(loss) -> program to run``; returns the
    losses, the startup's persistables and the program."""
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = 42
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        loss = _model(pkg)
        target = program_fn(loss, main)
    scope = pkg.Scope()
    X, Y = _data()
    with pkg.scope_guard(scope):
        exe.run(startup)
        if weights is not None:
            pkg.io.load_params(scope, weights, "cpu", program=main)
        w0 = {v.name: np.array(scope.find_var(v.name)).copy()
              for v in main.list_vars() if v.persistable}
        losses = [float(np.asarray(exe.run(target, feed={"x": X, "y": Y},
                                           fetch_list=[loss])[0]))
                  for _ in range(steps)]
        final = {n: np.array(scope.find_var(n)).copy() for n in w0}
    return losses, w0, final, main, scope


@pytest.fixture
def cpu_rank(monkeypatch):
    """This process as a CPU rank, as the launcher's --use_cpu_devices
    sets it."""
    monkeypatch.setenv("PADDLE_TRAINER_DEVICE", "cpu")


def _port_fleet(loss, main, strategy=None):
    fleet.init(UserDefinedRoleMaker(current_id=0, worker_num=1))
    fleet.distributed_optimizer(pt.optimizer.SGD(0.1),
                                strategy).minimize(loss)
    return fleet.main_program


def _plain(pkg):
    def fn(loss, main):
        pkg.optimizer.SGD(0.1).minimize(loss)
        return main
    return fn


def test_single_process_fleet_is_plain_training_and_the_jax_fleet(
        cpu_rank):
    from paddle_tpu.incubate.fleet.base.role_maker import \
        UserDefinedRoleMaker as JRoleMaker
    from paddle_tpu.incubate.fleet.collective import fleet as jfleet

    def jax_fleet(loss, main):
        jfleet.init(JRoleMaker(current_id=0, worker_num=1))
        jfleet.distributed_optimizer(jpt.optimizer.SGD(0.1)).minimize(loss)
        return jfleet.main_program

    jlosses, w0, _, _, _ = _run(jpt, jpt.Executor(), jax_fleet)
    exe = pt.Executor(pt.CPUPlace())
    plain, _, pfinal, _, _ = _run(pt, exe, _plain(pt), weights=w0)
    losses, _, final, main, _ = _run(pt, exe, _port_fleet, weights=w0)
    assert fleet.is_first_worker() and fleet.worker_num() == 1
    assert fleet.main_program.has_mesh \
        and fleet.main_program.data_parallel_degree == 1
    assert losses == plain
    assert all(np.array_equal(final[n], pfinal[n]) for n in final)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert losses[-1] < 0.5 * losses[0]


def test_strategy_knobs(cpu_rank):
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        loss = _model(pt)
        fleet.init(UserDefinedRoleMaker(worker_num=1))
        s = DistributedStrategy()
        s.use_dgc = True
        with pytest.raises(ValueError, match="DGCMomentumOptimizer"):
            fleet.distributed_optimizer(pt.optimizer.SGD(0.1),
                                        s).minimize(loss)
        s = DistributedStrategy()
        s.forward_recompute = True
        fleet.distributed_optimizer(pt.optimizer.SGD(0.1), s).minimize(loss)
    assert any(op.type == "recompute_grad"
               for op in main.global_block().ops)


def _amp_fleet_program(pkg, fleet_mod):
    """The program a collective fleet builds under ``use_amp``."""
    from importlib import import_module

    maker = import_module(f"{pkg.__name__}.incubate.fleet.base.role_maker")
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        loss = _model(pkg)
        fleet_mod.fleet.init(maker.UserDefinedRoleMaker(worker_num=1))
        s = fleet_mod.DistributedStrategy()
        s.use_amp = True
        s.amp_loss_scaling = 2.0 ** 10
        opt = fleet_mod.fleet.distributed_optimizer(pkg.optimizer.SGD(0.1),
                                                    s)
        opt.minimize(loss)
    return main, startup, loss


def test_use_amp_wraps_the_optimizer(cpu_rank):
    """``use_amp`` decorates the inner optimizer (bfloat16 AMP, the
    strategy's ``amp_loss_scaling`` as its initial scale): the program
    carries the AMP dtype and the same ops and persistables as the JAX
    package's fleet builds (under bfloat16 neither creates the
    loss-scaling variables, which only float16 needs), and it trains."""
    from paddle_tpu.incubate.fleet import collective as jfleet
    from paddle_tpu_torch.incubate.fleet import collective as pfleet

    main, startup, loss = _amp_fleet_program(pt, pfleet)
    jmain, _, _ = _amp_fleet_program(jpt, jfleet)
    assert main._amp_dtype == jmain._amp_dtype == "bfloat16"
    assert [op.type for op in main.global_block().ops] == \
        [op.type for op in jmain.global_block().ops]
    persist = sorted(v.name for v in main.list_vars() if v.persistable)
    assert persist == sorted(v.name for v in jmain.list_vars()
                             if v.persistable)
    assert not any("loss_scaling" in n for n in persist)
    X, Y = _data()
    exe = pt.Executor(pt.CPUPlace())
    with pt.scope_guard(pt.Scope()):
        exe.run(startup)
        losses = [float(exe.run(pfleet.fleet.main_program,
                                feed={"x": X, "y": Y},
                                fetch_list=[loss])[0]) for _ in range(5)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_collective_fleet_defaults_to_the_card(monkeypatch):
    monkeypatch.delenv("PADDLE_TRAINER_DEVICE", raising=False)
    fleet.init(UserDefinedRoleMaker(worker_num=1))
    if torch.cuda.is_available():
        assert fleet.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        fleet.device


def test_save_apis_write_what_the_jax_package_loads(tmp_path, cpu_rank):
    _, _, final, main, scope = _run(pt, pt.Executor(pt.CPUPlace()),
                                    _port_fleet)
    with pt.scope_guard(scope):
        fleet.save_persistables(pt.Executor(pt.CPUPlace()),
                                str(tmp_path / "ckpt"))
        x = main.global_block().var("x")
        fleet.save_inference_model(
            pt.Executor(pt.CPUPlace()), str(tmp_path / "infer"), ["x"],
            [_pred_var(main)])
    assert (tmp_path / "ckpt").exists() and x is not None
    jmain, jstartup = jpt.Program(), jpt.Program()
    with jpt.program_guard(jmain, jstartup), jpt.unique_name.guard():
        jloss = _model(jpt)
        jpt.optimizer.SGD(0.1).minimize(jloss)
    jscope = jpt.Scope()
    with jpt.scope_guard(jscope):
        jpt.io.load_persistables(jpt.Executor(), str(tmp_path / "ckpt"),
                                 jmain)
        for n in ("w1", "w2"):
            np.testing.assert_array_equal(np.asarray(jscope.find_var(n)),
                                          final[n])
        prog, feeds, fetches = jpt.io.load_inference_model(
            str(tmp_path / "infer"), jpt.Executor())
    assert feeds == ["x"] and len(fetches) == 1


def _pred_var(main):
    """The prediction: the other operand of the op that reads ``y``."""
    for op in main.global_block().ops:
        names = [n for ns in op.inputs.values() for n in ns]
        if "y" in names:
            return main.global_block().var(
                next(n for n in names if n != "y"))
    raise AssertionError("no op reads y")


RANK_SCRIPT = r'''
import json, os, sys
import numpy as np
import torch
import paddle_tpu_torch as pt
from paddle_tpu_torch.distributed.collectives import (
    cross_process_mean, dgc_sparse_allreduce)
from paddle_tpu_torch.distributed.launch import trainer_device
from paddle_tpu_torch.incubate.fleet.base.role_maker import \
    PaddleCloudRoleMaker
from paddle_tpu_torch.incubate.fleet.collective import fleet

out_dir = sys.argv[1]
assert trainer_device().type == "cpu" and not torch.cuda.is_available()
fleet.init(PaddleCloudRoleMaker())
rank, n = fleet.worker_index(), fleet.worker_num()
assert torch.distributed.get_backend() == "gloo"
main, startup = pt.Program(), pt.Program()
startup.random_seed = 42
with pt.program_guard(main, startup), pt.unique_name.guard():
    x = pt.data("x", [None, 4])
    y = pt.data("y", [None, 1])
    h = pt.layers.fc(x, 8, act="relu", param_attr=pt.ParamAttr(name="w1"))
    pred = pt.layers.fc(h, 1, param_attr=pt.ParamAttr(name="w2"))
    loss = pt.layers.mean(pt.layers.square_error_cost(pred, y))
    fleet.distributed_optimizer(pt.optimizer.SGD(0.1)).minimize(loss)
exe = pt.Executor(pt.CPUPlace())
exe.run(startup)
w = np.load(os.path.join(out_dir, "weights.npz"))
pt.io.load_params(pt.global_scope(), {k: w[k] for k in w.files}, "cpu",
                  program=main)
rng = np.random.RandomState(0)
X = rng.randn(8, 4).astype(np.float32)
Y = (X.sum(1, keepdims=True) * 0.3).astype(np.float32)
losses = [float(exe.run(fleet.main_program, feed={"x": X, "y": Y},
                        fetch_list=[loss])[0]) for _ in range(5)]
g = np.load(os.path.join(out_dir, "grads.npy"))[rank]
red, res = dgc_sparse_allreduce(torch.from_numpy(g), 3)
mean = cross_process_mean(torch.full((3,), float(rank + 1)))
with open(os.path.join(out_dir, f"rank_{rank}.json"), "w") as f:
    json.dump({"losses": losses, "world": n, "reduced": red.tolist(),
               "residual": res.tolist(), "mean": mean.tolist()}, f)
'''


def _launch(tmp_path, script, *args, nproc=2):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_", "PADDLE_"))}
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    logs = tmp_path / "logs"
    r = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         f"--nproc_per_node={nproc}", "--use_cpu_devices=1",
         f"--log_dir={logs}", str(script), *args],
        env=env, cwd=ROOT, capture_output=True, text=True,
        timeout=LAUNCH_TIMEOUT_S)
    text = "".join(f"\n--- {f.name} ---\n{f.read_text()[-3000:]}"
                   for f in sorted(logs.glob("*"))) if logs.exists() else ""
    assert r.returncode == 0, f"{r.stdout}\n{r.stderr}\n{text}"


def _jax_dgc(grads, k):
    import jax
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    from paddle_tpu.distributed.collectives import dgc_sparse_allreduce

    mesh = Mesh(np.array(jax.devices()[:2]), ("dcn",))

    def body(g):
        red, res = dgc_sparse_allreduce(g[0], k, "dcn")
        return red[None], res[None]

    f = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=P("dcn"),
                              out_specs=(P("dcn"), P("dcn")),
                              check_vma=False))
    red, res = f(grads)
    return np.asarray(red), np.asarray(res)


def test_launcher_two_gloo_ranks_fleet_and_collectives(tmp_path):
    out = tmp_path / "out"
    out.mkdir()
    plain, w0, _, _, _ = _run(pt, pt.Executor(pt.CPUPlace()), _plain(pt))
    np.savez(out / "weights.npz", **w0)
    rng = np.random.RandomState(5)
    grads = rng.randn(2, 10).astype(np.float32)
    grads[1, 2] = grads[1, 7] = 9.0                # a tie: lower index first
    np.save(out / "grads.npy", grads)
    script = tmp_path / "rank.py"
    script.write_text(RANK_SCRIPT)
    _launch(tmp_path, script, str(out))
    ranks = [json.loads((out / f"rank_{r}.json").read_text())
             for r in range(2)]
    assert all(r["world"] == 2 for r in ranks)
    # the global batch over two ranks: the one-process losses
    assert ranks[0]["losses"] == ranks[1]["losses"]
    np.testing.assert_allclose(ranks[0]["losses"], plain, rtol=1e-5)
    jred, jres = _jax_dgc(grads, 3)
    for r in range(2):
        np.testing.assert_array_equal(ranks[r]["reduced"], jred[r])
        np.testing.assert_array_equal(ranks[r]["residual"], jres[r])
        np.testing.assert_array_equal(ranks[r]["mean"], [1.5] * 3)


def test_local_sgd_two_ranks(tmp_path):
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(ROOT)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cs, "PS_LOG_DIR", tmp_path / "logs")
        r = cs.local_sgd_phase(torch.device("cpu"), str(tmp_path))
    assert r["syncs"] == 2 and r["max_err"] <= 1e-6 and r["diverged"]
    assert r["device"] == "cpu"


def test_dgc_and_mean_in_one_process_are_local():
    from paddle_tpu_torch.distributed.collectives import (
        cross_process_mean, dgc_sparse_allreduce)

    g = torch.tensor([[0.5, -3.0], [2.0, -3.0]])
    red, res = dgc_sparse_allreduce(g, 2)
    np.testing.assert_array_equal(red.numpy(), [[0, -3.0], [0, -3.0]])
    np.testing.assert_array_equal(res.numpy(), [[0.5, 0], [2.0, 0]])
    np.testing.assert_array_equal(cross_process_mean(g), g.numpy())


def test_allreduce_bandwidth_at_world_1(tmp_path):
    import torch.distributed as dist

    from paddle_tpu_torch.distributed.allreduce_bench import \
        allreduce_bandwidth

    with pytest.raises(RuntimeError, match="process group"):
        allreduce_bandwidth((1,), device="cpu")
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        res = allreduce_bandwidth((1, 2), reps=2, inner=4, device="cpu")
    finally:
        dist.destroy_process_group()
    assert [r["payload_mb"] for r in res] == [1, 2]
    for r in res:
        assert r["n_devices"] == 1 and r["gbps"] is None
        assert r["min_s"] >= 0 and r["inner_chained"] == 4
        assert set(r) == {"payload_mb", "n_devices", "min_s", "gbps",
                          "reps", "inner_chained", "model"}
