"""chip_smoke.py's phase 18 (bf16 and fp16 AMP training) rehearsed on the
CPU at a small width: BERT at hidden 128 (4 heads, FFN 256, 2 layers) in
the places of BERT-large and BERT-base, ResNet-18 on 32 x 32 images of 10
classes, the NMT at d_model 128 (2 + 2 layers).  Every gate of the phase
holds on the CPU but the launch counts (the plain kernel versions run
here, so they expect none) and the peak memory: the lowered plan equals
the planner's, the fp16 scale and counters equal between the two runs
(both on the CPU here) and shrink, then grow, and the first bf16 losses
and trajectories meet 18e's bounds."""
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def report():
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(ROOT)
    from paddle_tpu_torch.models import BertConfig, NMTConfig

    bert = dataclasses.replace(BertConfig.tiny(), hidden_size=128,
                               num_heads=4, ffn_size=256)
    nmt = dataclasses.replace(NMTConfig.tiny(), d_model=128, num_heads=4,
                              ffn_size=256, max_position=32)
    with pytest.MonkeyPatch.context() as mp:
        for name, value in dict(
                AMP_LARGE=(2, 32, 5), AMP_BASE=(4, 32, 5), AMP_WARMUP=1,
                AMP_STEPS=2, AMP_F32_STEPS=1,
                AMP_F16=dict(cs.AMP_F16, batch=2, seq=32, masked=5),
                AMP_MODEL_WARMUP=1, AMP_MODEL_STEPS=1, RESNET_BATCHES=(4,),
                NMT_BATCH=2, NMT_SRC=16, NMT_TGT=16,
                AMP_GATE_BERT=(2, 32, 5),
                AMP_GATE_RESNET=dict(depth=18, image=32, classes=10,
                                     batch=16, lr=1e-3),
                AMP_GATE_NMT=(2, 16, 16)).items():
            mp.setattr(cs, name, value)
        yield cs.amp_phase(torch.device("cpu"), bert, bert, nmt,
                           dict(depth=18, image=32, classes=10))


def test_bert_runs_train_and_plan_as_the_planner(report):
    for key in ("large", "base"):
        r = report[key]
        assert np.isfinite(r["losses"]).all() and r["losses"][-1] < \
            r["losses"][0]
        assert r["plan_groups"] == {"attn": 2, "gemm": 3, "ffn_chain": 2}
        assert set(r["launches"].values()) == {0}
        assert np.isfinite(r["f32_losses"]).all()


def test_fp16_scaling_matches_and_overflows_first(report):
    f = report["f16"]
    assert f["states"] == f["cpu_states"]
    scales = [s[0] for s in f["states"]]
    assert scales[0] < 2.0 ** 24 and max(scales[1:]) > min(scales)


def test_bench_models_train_under_bf16(report):
    m = report["models"]
    assert m["resnet"]["batch"] == 4
    assert np.isfinite(m["resnet"]["losses"]).all()
    assert np.isfinite(m["nmt"]["losses"]).all()


def test_gates_against_the_cpu_and_f32(report):
    assert set(report["gates"]) == {"bert_large_2l", "resnet18",
                                    "nmt_big_2l"}
    for g in report["gates"].values():
        assert g["first_rel"] <= 5e-3 and g["curve_rel"] <= 5e-2
