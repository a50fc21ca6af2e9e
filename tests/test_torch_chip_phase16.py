"""chip_smoke.py's phase 16 rehearsed on the CPU at a small width: BERT at
hidden 128 (2 layers, 4 heads, FFN 256) with 8 x 32 feeds through one
pserver process and one, then two, trainer processes (16a); the PS
fleet's three modes at 2 pservers x 2 trainers (16b); the device-cached
embedding at 256 rows over a 5,000-row table, 64 ids a batch (16c); the
collective fleet over a one-rank gloo group (the card's is NCCL) and
LocalSGD on two gloo ranks through the launcher (16d).  Every gate of
the phase holds on the CPU but the launch counts (the plain kernel
versions run here, so they expect none).  Two mutation checks: a PS
table whose pushes never landed fails 16a's update gate, and losses that
do not fall fail 16b's learn gate."""
import dataclasses
import os

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.multiproc


@pytest.fixture(scope="module")
def ps_runs():
    """16a's pserver runs of the rehearsal, by tag ("one", "two")."""
    return {}


@pytest.fixture(scope="module")
def cs(tmp_path_factory, ps_runs):
    with pytest.MonkeyPatch.context() as mp:
        mp.syspath_prepend(ROOT)
        # the collective fleet's rank on the CPU (its default is the card)
        mp.setenv("PADDLE_TRAINER_DEVICE", "cpu")
        import chip_smoke

        mp.setattr(chip_smoke, "TRAIN_BATCH", 8)
        mp.setattr(chip_smoke, "TRAIN_SEQ", 32)
        mp.setattr(chip_smoke, "SPARSE_VOCAB", 5000)
        mp.setattr(chip_smoke, "SPARSE_DIM", 8)
        mp.setattr(chip_smoke, "SPARSE_IDS", 64)
        mp.setattr(chip_smoke, "CACHE_CAPACITY", 256)
        mp.setattr(chip_smoke, "BENCH_SIZES_MB", (1,))
        mp.setattr(chip_smoke, "PS_LOG_DIR",
                   tmp_path_factory.mktemp("phase16"))
        real = chip_smoke._ps_run

        def recording(device, cfg, params, weights, feeds, root, tag):
            ps_runs[tag] = real(device, cfg, params, weights, feeds, root,
                                tag)
            return ps_runs[tag]

        mp.setattr(chip_smoke, "_ps_run", recording)
        yield chip_smoke


@pytest.fixture(scope="module")
def cfg():
    from paddle_tpu_torch.models import BertConfig

    return dataclasses.replace(BertConfig.tiny(), num_layers=2,
                               hidden_size=128, num_heads=4, ffn_size=256)


@pytest.fixture(scope="module")
def report(cs, cfg):
    return cs.ps_phase(torch.device("cpu"), cfg, 12.5)


def test_bert_through_a_pserver(report):
    b = report["bert"]
    assert b["loss_rel_err"] <= 1e-5 and b["param_rel_err"] <= 1e-5
    assert b["two_bit_equal"] and b["two_param_rel_err"] <= 1e-5
    assert len(b["losses"]) == 3 and len(b["two_losses"]) == 2
    assert b["plain_calls"] > 0     # the plain kernel versions run here
    assert set(b["launches"].values()) == {0}
    assert b["rpcs_each_way"] == 30 and b["bytes_each_way"] == \
        b["blocks"] * 64 * 4
    assert set(b["step_split_ms"]) == {"pull", "step", "push"}
    assert b["server_rss_bytes"] > 0
    assert report["phase5_step_ms"] == 12.5


def test_three_modes(report):
    for mode in ("sync", "async", "geo"):
        m = report["modes"][mode]
        assert m["learn"] and m["w_rel_diff"] <= 1e-5
    assert report["modes"]["sync"]["snapshots"]


def test_device_cached_embedding(report):
    c = report["cache"]
    assert c["max_rel_err"] <= 1e-6
    assert len(c["steps"]) == 5 and c["pulls_per_step"] == [1] * 5
    assert c["hit_rate"][0] == 0.0 and max(c["hit_rate"][1:]) > 0
    assert c["cache_bytes"] == 256 * 8 * 4


def test_collective_fleet_and_local_sgd(report):
    c = report["collective"]
    assert c["bit_equal"] and c["params_equal"] == c["params"]
    assert c["backend"] == "gloo" and c["degree"] == 1
    assert [b["gbps"] for b in c["allreduce"]] == [None]
    lsgd = report["local_sgd"]
    assert lsgd["syncs"] == 2 and lsgd["max_err"] <= 1e-6
    assert report["launches"] == dict.fromkeys(
        ("flash_fwd_qkv", "gemm_epilogue", "ffn_chain",
         "flash_bwd_dq_packed", "flash_bwd_dkv_packed"), 0)


def _norm(arrays):
    return float(np.sqrt(sum(float(np.sum(np.asarray(a, np.float64) ** 2))
                             for a in arrays)))


def test_a_table_whose_pushes_never_landed_fails_16a(cs, cfg, report,
                                                     ps_runs, tmp_path,
                                                     monkeypatch):
    """Replay 16a's pserver runs with one table's parameters left at the
    weights the trainers started from, as if the server dropped every
    push to it: the smallest table whose update is over 10 x
    PS_UPDATE_RTOL of the whole update.  At BERT-base's width such a
    table moves the parameters by less than PS_RTOL of ‖θ‖ (3 steps are
    2.7e-4 of it on the card); at this width every table's update is
    larger, so the parameter gate is switched off here to hold the
    update gate alone."""
    dropped = {}

    def replay(device, cfg_, params, weights, feeds, root, tag):
        results, final, rss = ps_runs[tag]
        w0 = np.load(weights)
        upd = {n: final[n] - w0[n] for n in final}
        whole = _norm(upd.values())
        name = min((n for n in final if _norm([upd[n]])
                    > 10 * cs.PS_UPDATE_RTOL * whole),
                   key=lambda n: _norm([upd[n]]))
        dropped[tag] = name
        return results, dict(final, **{name: w0[name]}), rss

    monkeypatch.setattr(cs, "_ps_run", replay)
    monkeypatch.setattr(cs, "PS_RTOL", float("inf"))
    with pytest.raises(AssertionError, match="one trainer: the PS update"):
        cs.bert_ps_phase(torch.device("cpu"), cfg, str(tmp_path))
    assert set(dropped) == {"one", "two"}


def test_losses_that_do_not_fall_fail_16b(cs, report):
    for mode in ("sync", "async", "geo"):
        losses = report["modes"][mode]["losses"]
        assert cs._modes_learn(mode, losses)
        # the server dropped every push: each trainer's loss stays put
        flat = [[r[0]] * len(r) for r in losses]
        assert not cs._modes_learn(mode, flat)
        assert not cs._modes_learn(mode, [r[:-1] + [np.nan]
                                          for r in losses])
