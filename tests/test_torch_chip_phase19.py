"""chip_smoke.py's phase 19 rehearsed on the CPU at a small width: BERT
at hidden 128 (2 layers, 4 heads, FFN 256, vocab 1024) on 8 x 32 feeds,
NMT at d_model 64 (2 + 2 layers, vocab 96) on 4 x 16/16, ResNet-18 on
32 x 32 images (4 a rank, at 19c's rate and its control's), each on two
gloo ranks at {model: 2} (BERT, NMT) or {data: 2} (ResNet) against the
one-rank run of the same program.
Every gate of the phase holds on the CPU but the launch counts (the
plain kernel versions run here, so none are counted)."""
import os

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.multiproc


@pytest.fixture(scope="module")
def cs():
    with pytest.MonkeyPatch.context() as mp:
        # the spawned ranks import chip_smoke by name: keep the root on
        # the path the children inherit
        mp.syspath_prepend(ROOT)
        import chip_smoke

        for name, value in (
                ("TRAIN_BATCH", 8), ("TRAIN_SEQ", 32),
                ("TP_BERT", dict(num_layers=2, hidden_size=128,
                                 num_heads=4, ffn_size=256,
                                 vocab_size=1024)),
                ("TP_NMT", dict(d_model=64, num_heads=4, ffn_size=128,
                                num_encoder_layers=2, num_decoder_layers=2,
                                vocab_size=96)),
                ("TP_NMT_BATCH", 4), ("TP_NMT_LEN", 16),
                ("RESNET_DEPTH", 18), ("RESNET_IMAGE", 32),
                ("RESNET_CLASSES", 10), ("TP_BN_PER_RANK", 4)):
            mp.setattr(chip_smoke, name, value)
        yield chip_smoke


@pytest.fixture(scope="module")
def report(cs):
    return cs.tensor_parallel_phase(torch.device("cpu"))


def test_every_job_runs_on_both_ranks(report, cs):
    assert set(report["jobs"]) == {"bert_fused", "bert_unfused", "nmt_big",
                                   "resnet50", "resnet50_control"}
    for name, j in report["jobs"].items():
        assert len(j["ranks"]) == 2
        steps = {"nmt_big": cs.TP_NMT_STEPS, "resnet50": cs.TP_BN_STEPS,
                 "resnet50_control": cs.TP_BN_STEPS}.get(name, cs.TP_STEPS)
        assert len(j["one_rank"]["losses"]) == steps
        assert j["max_dloss"] < cs.PARITY_LOSS_TOL
    assert report["launches"] == {}


def test_the_split_gates_hold(report, cs):
    for name in ("bert_fused", "bert_unfused", "nmt_big"):
        j = report["jobs"][name]
        for g in j["ranks"]:
            assert g["stats"].get("whole_gathers", 0) == 0
            assert {k: g["stats"].get(k, 0) for k in g["planned"]} == \
                g["planned"]
        assert j["max_dparam"] < cs.TP_PARAM_TOL
        assert j["max_dparam_rel"] < cs.TP_PARAM_REL_TOL, j["worst_param"]
    bert = report["jobs"]["bert_fused"]["ranks"][0]
    assert bert["planned"] == {"forward_sum": 5, "backward_sum": 6,
                               "all_gather": 1}
    assert bert["qkv_shard"] == [128, 192]


def test_sync_bn_gates_hold(report, cs):
    for name in ("resnet50", "resnet50_control"):
        j = report["jobs"][name]
        assert j["max_dstat"] < cs.TP_STAT_TOL
        assert "world1_dloss" in j
        for g in j["ranks"]:
            assert g["planned"] is None and g["qkv_shard"] is None
            assert g["stats"]["batch_stat_sums"] > 0
