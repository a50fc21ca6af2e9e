"""chip_smoke.py's phase 21 (the sequence and recurrent tier) rehearsed
on the CPU at 21c's width (hidden 64, vocab 512, B 8, T 12): 21a's
seq2seq under Adadelta and the clip with its greedy and beam decoders,
21b's stacked-LSTM classifier and its plan, 21c's card-against-CPU gates
(CPU against CPU here) over both models, the decoders' ids and every
case of the op table.  Every gate of the phase holds on the CPU but the
launch counts (the plain kernel versions run here, so none are
counted)."""
import numpy as np
import pytest
import torch


@pytest.fixture(scope="module")
def cs():
    import chip_smoke

    s2s, cls = chip_smoke._small_models()
    with pytest.MonkeyPatch.context() as mp:
        for name, value in (("S2S", s2s), ("LSTM_CLS", cls),
                            ("S2S_DECODE_LEN", 6), ("S2S_STEPS", 3),
                            ("LSTM_STEPS", 3)):
            mp.setattr(chip_smoke, name, value)
        yield chip_smoke


@pytest.fixture(scope="module")
def report(cs):
    return cs.seq_phase(torch.device("cpu"))


def test_seq2seq_trains_and_decodes(report, cs):
    s = report["seq2seq"]
    assert len(s["losses"]) == cs.S2S_WARMUP + cs.S2S_STEPS
    assert np.isfinite(s["losses"]).all() and s["losses"][-1] < s["losses"][0]
    assert s["plan_groups"] == 0 and s["launches"] == {}
    assert set(s["decode"]) == {"greedy", "beam"}
    assert all(d["decode_step_ms"] > 0 for d in s["decode"].values())


def test_lstm_classifier_plans_its_fcs(report, cs):
    lstm = report["lstm"]
    assert np.isfinite(lstm["losses"]).all()
    # three fcs and the 2-class output: the last replays (N 2 is past
    # the kernel's rule), so three launches a step on the card
    assert lstm["plan"] == {"mul+bias": 4}
    assert lstm["launches_per_step"] == {"gemm_epilogue": 3}
    assert lstm["launches"] == {} and report["launches"] == {}


def test_card_against_cpu_gates(report, cs):
    for what in ("seq2seq", "lstm_classifier"):
        p = report["parity"][what]
        assert len(p["card_losses"]) == cs.SEQ_PARITY_STEPS
        assert p["max_dloss"] <= cs.SEQ_LOSS_TOL
        assert p["max_dparam"] <= cs.SEQ_PARAM_TOL
    assert report["parity"]["seq2seq"]["greedy_ids_equal"]
    assert report["parity"]["seq2seq"]["beam_ids_equal"]
    ops = report["ops"]
    assert set(ops["cases"]) == set(cs.SEQ_OP_CASES)
    assert ops["forward_max"] <= cs.SEQ_OP_FWD_TOL
    assert ops["grad_max"] <= cs.SEQ_OP_GRAD_TOL
