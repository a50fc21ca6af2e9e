"""chip_smoke.py's phase 20 (dygraph) rehearsed on the CPU at a 2-layer
cut: dygraph_bert at hidden 128 (2 heads, FFN 256, vocab 1024) on 8 x
32 feeds — the eager steps and the card-against-CPU parity (both on the
CPU here), save/load_dygraph's bit-equal resume, TracedLayer through
the Executor and a Predictor, the @declarative tensor while, and
DataParallel over a one-rank gloo group.  Every gate of the phase holds
on the CPU but the launch counts (the plain kernel versions run here, so
none are counted)."""
import dataclasses

import numpy as np
import pytest
import torch


@pytest.fixture(scope="module")
def cs():
    import chip_smoke

    with pytest.MonkeyPatch.context() as mp:
        for name, value in (("TRAIN_BATCH", 8), ("TRAIN_SEQ", 32),
                            ("DY_WARMUP", 1), ("DY_STEPS", 2),
                            ("DY_PARITY_BATCH", 4)):
            mp.setattr(chip_smoke, name, value)
        yield chip_smoke


@pytest.fixture(scope="module")
def report(cs):
    from paddle_tpu_torch.models import BertConfig

    cfg = dataclasses.replace(BertConfig.tiny(), hidden_size=128,
                              num_heads=2, ffn_size=256, num_layers=2)
    return cs.dygraph_phase(torch.device("cpu"), cfg)


def test_eager_training(report, cs):
    tr = report["train"]
    assert len(tr["losses"]) == cs.DY_WARMUP + cs.DY_STEPS
    assert np.isfinite(tr["losses"]).all()
    assert tr["launches"] == {} and report["launches"] == {}
    # the forward's dispatch: embeddings, LayerNorm, 2 layers of 12 ops,
    # the tied logits, the loss
    assert 30 <= tr["forward_ops"] <= 60, tr["forward_ops"]
    assert tr["host_us_per_op"] > 0


def test_card_against_cpu_parity(report, cs):
    p = report["parity"]
    assert p["max_dloss"] <= cs.PARITY_LOSS_TOL
    assert p["max_dparam"] <= cs.DY_PARAM_ATOL
    assert len(p["card_losses"]) == cs.DY_PARITY_STEPS


def test_resume_is_bit_equal(report):
    r = report["resume"]
    assert r["loss"] == r["resumed_loss"]
    assert r["params_differ"] == 0 and r["state_differ"] == {}


def test_traced_program_and_predictor(report, cs):
    t = report["traced"]
    assert t["plan_groups"] == [{"attn": 2, "gemm": 2, "ffn_chain": 2}]
    assert t["max_abs_err"] <= cs.DY_TRACE_ATOL
    assert t["predictor_max_abs_err"] <= cs.DY_PREDICTOR_ATOL


def test_declarative_while_and_data_parallel(report, cs):
    s = report["to_static"]
    assert "while" in s["ops"] and s["max_abs_err"] <= cs.DY_LOOP_ATOL
    dp = report["dp"]
    assert dp["nranks"] == 1 and dp["backend"] == "gloo"
    assert dp["loss"] == dp["plain_loss"] and dp["params_differ"] == 0
