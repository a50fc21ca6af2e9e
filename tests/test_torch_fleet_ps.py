"""The fleet's parameter-server mode in the port against the JAX package,
on the CPU.

* A 1 x 1 sync run of BERT at 2 layers, hidden 128 (4 heads, FFN 256),
  dropout 0, through each package's PS fleet — fleet.init,
  distributed_optimizer(SGD), init_worker, exe.run(fleet.main_program),
  one native pserver each — both through their default fusion pass (the
  JAX Pallas kernels in interpret mode), the JAX startup's weights
  carried into the port with io.load_params: every step's loss within
  1e-5 relative, the parameters the servers hold after the last step
  within 1e-5 relative norm.
* tests/dist_fleet_ps.py's three modes at 2 pservers x 2 trainers,
  through chip_smoke.py's role processes on the CPU (the card's phase
  16b), under the JAX test's criteria (tests/test_fleet_ps.py): the
  losses learn, the two trainers' fc_w agree within 1e-5 (async: taken
  after a barrier, so within 1e-5 too), sync writes the servers'
  snapshot through save_persistables.
* The Executor hands a program with ``custom_run`` the run."""
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as pt
from paddle_tpu.distributed import ps as jps
from paddle_tpu.incubate.fleet.base.role_maker import Role as JRole
from paddle_tpu.incubate.fleet.base.role_maker import \
    UserDefinedRoleMaker as JRoleMaker
from paddle_tpu.incubate.fleet.parameter_server import \
    DistributeTranspilerConfig as JConfig
from paddle_tpu.incubate.fleet.parameter_server import fleet as jfleet
from paddle_tpu.models import BertConfig as JaxBertConfig
from paddle_tpu.models import build_bert_pretrain as jax_build
from paddle_tpu_torch.distributed import ps as tps
from paddle_tpu_torch.distributed.launch import reserve_ports
from paddle_tpu_torch.incubate.fleet.base.role_maker import (
    Role, UserDefinedRoleMaker)
from paddle_tpu_torch.incubate.fleet.parameter_server import (
    DistributeTranspilerConfig, fleet)
from paddle_tpu_torch.models import BertConfig, build_bert_pretrain

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQ, BATCH, STEPS, LR = 32, 8, 3, 0.05

pytestmark = pytest.mark.multiproc


def _batch(vocab):
    rng = np.random.RandomState(3)
    src = rng.randint(0, vocab, (BATCH, SEQ)).astype(np.int64)
    mask = np.ones((BATCH, SEQ), np.float32)
    mask[:3, SEQ - 6:] = 0.0
    labels = np.full((BATCH, SEQ, 1), -1, np.int64)
    pick = rng.rand(BATCH, SEQ) < 0.15
    labels[pick] = src[pick][:, None]
    return {"src_ids": src, "input_mask": mask, "masked_labels": labels}


def _fleet_run(pkg, flt, role_maker, config_cls, build, cfg, ps_mod, exe,
               feed, weights=None):
    """One worker of ``pkg``'s PS fleet against one pserver of
    ``ps_mod`` started with run_server's arguments: STEPS steps; returns
    the losses, the startup's weights and the servers' parameters."""
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = 7
    res = reserve_ports(1)
    port = res.ports[0]
    res.release()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        loss, _ = build(cfg, seq_len=SEQ)
        flt.init(role_maker(server_endpoints=[f"127.0.0.1:{port}"]))
        _, pg = flt.distributed_optimizer(pkg.optimizer.SGD(LR),
                                          config_cls()).minimize(loss)
    plan = flt._plan
    srv = ps_mod.PSServerProcess(port, num_tables=plan.num_tables,
                                 dim=plan.dim, optimizer="sgd",
                                 init_range=0.1, seed=1234, num_workers=1)
    scope = pkg.Scope()
    try:
        with pkg.scope_guard(scope):
            exe.run(startup)
            if weights is not None:
                pkg.io.load_params(scope, weights, "cpu", program=main)
            w0 = {p.name: np.array(scope.find_var(p.name)).copy()
                  for p, _ in pg}
            flt.init_worker()
            losses = [float(np.asarray(exe.run(flt.main_program, feed=feed,
                                               fetch_list=[loss])[0]))
                      for _ in range(STEPS)]
            final = {n: t.pull() for n, t in flt._dense_tables.items()}
            flt.stop_worker()
        stopper = ps_mod.PSClient("127.0.0.1", port)
        stopper.stop_server()
        stopper.close()
        srv.wait(timeout=30)
    finally:
        srv.kill()
    return losses, w0, final


@pytest.fixture(scope="module")
def bert_runs():
    jcfg = dataclasses.replace(JaxBertConfig.tiny(), num_layers=2,
                               hidden_size=128, num_heads=4, ffn_size=256,
                               hidden_dropout=0.0, attn_dropout=0.0)
    cfg = BertConfig(**dataclasses.asdict(jcfg))
    feed = _batch(cfg.vocab_size)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PADDLE_TPU_FUSED_MATMUL_INTERPRET", "1")
        with jpt.new_program_scope():
            jlosses, w0, jfinal = _fleet_run(
                jpt, jfleet, lambda **kw: JRoleMaker(
                    current_id=0, role=JRole.WORKER, worker_num=1, **kw),
                JConfig, jax_build, jcfg, jps, jpt.Executor(), feed)
    losses, _, final = _fleet_run(
        pt, fleet, lambda **kw: UserDefinedRoleMaker(
            current_id=0, role=Role.WORKER, worker_num=1, **kw),
        DistributeTranspilerConfig,
        build_bert_pretrain, cfg, tps, pt.Executor(pt.CPUPlace()), feed,
        weights=w0)
    return dict(jlosses=jlosses, losses=losses, jfinal=jfinal,
                final=final, w0=w0)


def test_bert_through_a_pserver_matches_the_jax_fleet(bert_runs):
    r = bert_runs
    np.testing.assert_allclose(r["losses"], r["jlosses"], rtol=1e-5)
    assert r["losses"][-1] < r["losses"][0]
    assert set(r["final"]) == set(r["jfinal"]) and len(r["final"]) == 30
    num = sum(float(np.sum((r["final"][n].astype(np.float64)
                            - r["jfinal"][n]) ** 2)) for n in r["final"])
    den = sum(float(np.sum(r["jfinal"][n].astype(np.float64) ** 2))
              for n in r["jfinal"])
    assert (num / den) ** 0.5 < 1e-5
    # the servers moved every parameter off the startup's weights
    moved = [n for n in r["final"]
             if not np.array_equal(r["final"][n], r["w0"][n])]
    assert len(moved) > 20


@pytest.fixture(scope="module")
def modes(tmp_path_factory):
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(ROOT)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cs, "PS_LOG_DIR", tmp_path_factory.mktemp("logs"))
        return cs.fleet_modes_phase(torch.device("cpu"),
                                    str(tmp_path_factory.mktemp("modes")))


@pytest.mark.parametrize("mode", ["sync", "async", "geo"])
def test_fleet_ps_two_by_two(modes, mode):
    r = modes[mode]
    for losses in r["losses"]:
        assert np.isfinite(losses).all()
        assert min(losses[-4:]) < 0.7 * max(losses[:2]), losses
    assert r["learn"]
    assert r["w_rel_diff"] <= 1e-5
    assert r["scope_device"] == "cpu"
    if mode == "sync":
        assert r["snapshots"] == ["snapshot.shard0", "snapshot.shard1"]


def test_executor_hands_a_custom_run_program_the_run():
    """A wrapper with ``custom_run`` gets (executor, feed, fetch_list,
    scope, return_numpy) and its return is run's."""
    calls = []

    class Wrapper:
        def custom_run(self, exe, feed, fetch_list, scope, return_numpy):
            calls.append((exe, feed, fetch_list, scope, return_numpy))
            return ["handled"]

    exe = pt.Executor(pt.CPUPlace())
    scope = pt.Scope()
    feed = {"x": np.ones(2, np.float32)}
    assert exe.run(Wrapper(), feed=feed, fetch_list=["y"], scope=scope,
                   return_numpy=False) == ["handled"]
    assert calls == [(exe, feed, ["y"], scope, False)]
    # a plain program still runs the Executor's own path
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        x = pt.data("x", [None, 3])
        y = pt.layers.scale(x, 2.0)
    (got,) = exe.run(main, feed={"x": np.ones((2, 3), np.float32)},
                     fetch_list=[y], scope=scope)
    np.testing.assert_array_equal(got, np.full((2, 3), 2.0, np.float32))


def test_ps_optimizer_refuses_what_the_jax_one_refuses():
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        ids = pt.data("ids", [4, 1], "int64")
        a = pt.layers.embedding(ids, (10, 4), is_sparse=True)
        b = pt.layers.embedding(ids, (10, 8), is_sparse=True)
        loss = pt.layers.mean(pt.layers.elementwise_add(
            pt.layers.reduce_sum(a), pt.layers.reduce_sum(b)))
        fleet.init(UserDefinedRoleMaker(role=Role.WORKER, worker_num=1,
                                        server_endpoints=["127.0.0.1:1"]))
        with pytest.raises(ValueError, match="one dim"):
            fleet.distributed_optimizer(pt.optimizer.SGD(0.1)).minimize(
                loss)
        cfg = DistributeTranspilerConfig()
        cfg.geo_sgd_mode = True
        with pytest.raises(ValueError, match="dense parameters only"):
            fleet.distributed_optimizer(pt.optimizer.SGD(0.1),
                                        cfg).minimize(loss)
