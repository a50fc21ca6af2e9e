"""chip_smoke.py's phase 23 rehearsed on the CPU at a small width: the
stacked LSTM at hidden 64 (vocab 512, 8 x 12) over a one-rank gloo group
against its plain steps, then two gloo ranks at {data: 2} running it,
seq2seq at SEQ_SMALL, a 4096-row sparse table under SGD and lazy Adam,
and BERT at hidden 128 (2 layers, vocab 1024, 8 x 32, 4 masked a row)
under bf16 AMP and under fp16 loss scaling with an inf in rank 1's rows,
each against the one-rank run of the same program.
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
                ("LSTM_CLS", dict(vocab=512, emb=64, hid=256, stacked=3,
                                  classes=2, batch=8, seq=12, min_len=2)),
                ("LSTM_WARMUP", 1), ("LSTM_STEPS", 2),
                ("DPS_BERT_CFG", dict(num_layers=2, hidden_size=128,
                                      num_heads=4, ffn_size=256,
                                      vocab_size=1024)),
                ("DPS_BERT", (8, 32, 4)),
                ("SPARSE_VOCAB", 4096), ("SPARSE_DIM", 16),
                ("SPARSE_IDS", 64)):
            mp.setattr(chip_smoke, name, value)
        yield chip_smoke


@pytest.fixture(scope="module")
def plain(cs):
    res = cs.lstm_phase(torch.device("cpu"))
    res["launches_per_step"] = {}
    return res


@pytest.fixture(scope="module")
def report(cs, plain):
    return cs.dp_seq_phase(torch.device("cpu"), plain)


def test_every_job_runs_on_both_ranks(report, cs):
    assert set(report["jobs"]) == {"lstm", "seq2seq", "sparse_sgd",
                                   "sparse_lazy_adam", "bert_bf16",
                                   "bert_f16"}
    for name, j in report["jobs"].items():
        assert len(j["ranks"]) == 2
        assert len(j["one_rank"]["losses"]) == len(j["ranks"][0]["losses"])
    assert report["world1"]["max_dloss"] <= cs.SEQ_LOSS_TOL
    assert report["launches"] == {}


def test_the_parity_gates_hold(report, cs):
    for name in ("lstm", "seq2seq", "sparse_sgd", "sparse_lazy_adam"):
        j = report["jobs"][name]
        assert j["max_dloss"] <= cs.SEQ_LOSS_TOL, name
        assert j["max_dparam"] <= cs.SEQ_PARAM_TOL, name
        assert j["max_dchange_rel"] <= cs.DPS_CHANGE_RTOL, name
    for name in ("bert_bf16", "bert_f16"):
        j = report["jobs"][name]
        assert j["max_dloss"] <= cs.DPS_AMP_LOSS_RTOL, name
        assert j["max_dchange_rel"] <= cs.DPS_AMP_CHANGE_RTOL, name
    for name, j in report["jobs"].items():
        assert j["same_start"], name
    assert cs.dp_seq_failures(report, False) == []


def test_sparse_rows_are_gathered_and_the_scale_halves(report, cs):
    for name in ("sparse_sgd", "sparse_lazy_adam"):
        for g in report["jobs"][name]["ranks"]:
            assert g["stats"]["sparse_row_gathers"] == 1
            assert g["grad_sum"]["tensors"] == 2      # the fc's w and b
    j = report["jobs"]["bert_f16"]
    s0 = cs.DPS_F16["init_loss_scaling"]
    for g in j["ranks"]:
        assert g["scales"][cs.DPS_INF_STEP][0] == s0 / 2


def test_planted_faults_fail_the_gates(cs, plain):
    """paddle_tpu_torch/tools/dps_faults.py: with the gradient sum left
    out of the ranks, or only rank 0's gradients summed, every job fails
    its change gate and 23d its loss gate."""
    from paddle_tpu_torch.tools import dps_faults

    found = dps_faults.run_faults(cs, torch.device("cpu"), plain,
                                  ["no_grad_sum", "half_batch"])
    for fault, (out, failed) in found.items():
        for name, j in out["jobs"].items():
            amp = name.startswith("bert")
            assert j["max_dchange_rel"] > (
                cs.DPS_AMP_CHANGE_RTOL if amp else cs.DPS_CHANGE_RTOL), \
                (fault, name)
            assert f"{name}: a leaf's change parts" in " ".join(failed)
            if amp:
                assert j["max_dloss"] > cs.DPS_AMP_LOSS_RTOL, (fault, name)
