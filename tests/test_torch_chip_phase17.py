"""chip_smoke.py's phase 17 rehearsed on the CPU at a small width:
ResNet-18 on 32 x 32 images of 10 classes (batches 8 then 4), the NMT
at d_model 128 (4 heads, FFN 256, 2 + 2 layers, vocab 96) at 4 x 16/16
tokens beside one at d_model 64, and the beam decoder (B 2, K 3, 6
steps over 8 source tokens) on the trained weights.  Every gate of the
phase holds on the CPU but the launch counts (the plain kernel versions
run here, so they expect none) and the peak memory (CPU tensors are not
counted).  The constants the card's run gates on are the JAX package's:
NMT_PLAN is the JAX planner's plan of the NMT-big program.

Mutation check: a batch_norm that does not write its running statistics
back fails 17a's statistics gate.
"""
import dataclasses
import os
import sys
from collections import Counter

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def cs():
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(chip_smoke, "RESNET_BATCHES", (8, 4))
        mp.setattr(chip_smoke, "P17_STEPS", 2)
        mp.setattr(chip_smoke, "P17_WARMUP", 1)
        mp.setattr(chip_smoke, "NMT_BATCH", 4)
        mp.setattr(chip_smoke, "NMT_SRC", 16)
        mp.setattr(chip_smoke, "NMT_TGT", 16)
        mp.setattr(chip_smoke, "NMT_PARITY_STEPS", 2)
        mp.setattr(chip_smoke, "NMT_BASE_STEPS", 1)
        mp.setattr(chip_smoke, "BEAM_SRC", 8)
        mp.setattr(chip_smoke, "BEAM_BATCH", 2)
        mp.setattr(chip_smoke, "BEAM_OUT", 6)
        mp.setattr(chip_smoke, "BEAM_K", 3)
        mp.setattr(chip_smoke, "BEAM_RUNS", 1)
        mp.setattr(chip_smoke, "BEAM_GATE_LAYERS", 1)
        yield chip_smoke


RESNET_KW = dict(depth=18, image=32, classes=10)


def _nmt_cfgs():
    from paddle_tpu_torch.models import NMTConfig

    cfg = dataclasses.replace(
        NMTConfig.tiny(), d_model=128, num_heads=4, ffn_size=256,
        max_position=32, dropout=0.1, attn_dropout=0.1)
    base = dataclasses.replace(NMTConfig.tiny(), d_model=64, num_heads=4,
                               ffn_size=128)
    return cfg, base


@pytest.fixture(scope="module")
def report(cs):
    cfg, base = _nmt_cfgs()
    return cs.bench_models_phase(torch.device("cpu"), cfg, base,
                                 RESNET_KW, plan=None)


def test_resnet_gates_hold(report):
    r = report["resnet"]
    assert r["batch"] == 8 and [b["batch"] for b in r["batches"]] == [8]
    assert np.isfinite(r["losses"]).all() and len(r["losses"]) == 3
    p = r["parity"]
    assert p["loss"] <= 2e-3
    assert max(v for k, v in p.items() if k.endswith(("_vs_cpu",
                                                      "_vs_formula"))) \
        <= 1e-3
    assert p["conv1_update_rel_err"] <= 0.15
    assert r["launches"] == {}
    assert r["fwd_gflops_per_image"] > 0 and r["images_per_s"] > 0


def test_nmt_gates_hold(report):
    n = report["nmt"]
    assert np.isfinite(n["losses"]).all()
    assert n["parity"]["max_dloss"] <= 2e-3
    # the width's plan: per layer an attention entry, its norm group, the
    # FFN; the cross-attentions' q and kv projections and their norms
    pats = n["plan"][0]
    assert pats["mul+bias+slice3+attention"] == 4
    assert pats["mul+bias"] == 4
    assert pats["mul+bias+dropout+residual+layer_norm"] == 6
    assert pats["mul+bias+relu+mul+bias+dropout+residual+layer_norm"] == 4
    assert n["launches"] == {} and n["launches_per_step"] == {}
    assert np.isfinite(n["base"]["losses"]).all()


def test_beam_gates_hold(report):
    b = report["beam"]
    assert b["gate"]["ids_equal"] and b["gate"]["score_max_abs_err"] == 0.0
    assert b["run_ms"] > 0 and b["launches"] == {}


def test_card_launch_expectations(cs):
    """What the card's run gates on, from the model's structure: at
    NMT-big (N 1024 past the chain's 768) 54 fused matmuls and no FFN
    chain a step; at NMT-base (N 512) the chain once an FFN."""
    from paddle_tpu_torch.models import NMTConfig

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cs, "NMT_BATCH", 32)
        mp.setattr(cs, "NMT_TGT", 256)
        big = cs.nmt_step_launches(NMTConfig.big(), True)
        base = cs.nmt_step_launches(NMTConfig.base(), True)
    assert big == {"flash_fwd_qkv": 12, "flash_fwd_packed": 6,
                   "flash_bwd_dq_packed": 18, "flash_bwd_dkv_packed": 18,
                   "gemm_epilogue": 54, "ffn_chain": 0}
    assert base == {"flash_fwd_qkv": 12, "flash_fwd_packed": 6,
                    "flash_bwd_dq_packed": 18, "flash_bwd_dkv_packed": 18,
                    "gemm_epilogue": 30, "ffn_chain": 12}


def test_nmt_plan_constant_is_the_jax_planners(cs):
    import paddle_tpu as jpt
    from paddle_tpu.core import fusion as jfusion
    from paddle_tpu.models import NMTConfig as JNMTConfig
    from paddle_tpu.models import build_nmt_train as jbuild

    main, startup = jpt.Program(), jpt.Program()
    with jpt.program_guard(main, startup), jpt.unique_name.guard():
        loss, feeds = jbuild(JNMTConfig.big(), 256, 256)
        jpt.optimizer.Adam(1e-4).minimize(loss)
    plan = jfusion.plan_fusion(main, list(main.global_block().ops),
                               tuple(feeds), [loss.name],
                               block_patterns=True)
    assert dict(Counter(g.pattern for g in plan.groups)) == cs.NMT_PLAN


def test_conv_flops_count_matches_bench(cs):
    """ResNet-50's forward conv+matmul count (bench.py's formula) is the
    known ~4.1 GFLOP an image at 224."""
    main, *_, flops = cs.build_resnet(50, 224, 1000)
    assert 8.1e9 < flops < 8.3e9       # 2 flops a multiply-add


def test_statistics_not_written_back_fail_17a(cs, monkeypatch):
    from paddle_tpu_torch.core.registry import REGISTRY

    opdef = REGISTRY.get("batch_norm")
    real = opdef.compute

    def stale(ctx, inputs, attrs):
        outs = real(ctx, inputs, attrs)
        outs["MeanOut"] = [inputs["Mean"][0].detach()]
        outs["VarianceOut"] = [inputs["Variance"][0].detach()]
        return outs

    monkeypatch.setattr(opdef, "compute", stale)
    with pytest.raises(AssertionError, match="statistics"):
        cs.resnet_phase(torch.device("cpu"), **RESNET_KW)
