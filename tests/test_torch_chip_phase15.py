"""chip_smoke.py's phase 15 rehearsed on the CPU at a small width: BERT at
hidden 128 (4 layers, 4 heads, FFN 256), 8 x 32 feeds, the MoE program
at 64 tokens.  15a runs the data-parallel step over a one-rank gloo
group (the card's is NCCL) against plain steps from the same weights;
15b and 15d's expert axis spawn two gloo ranks; 15c pipelines 4 stages
in sequence; 15d holds the MoE losses against the CPU's (here the same
device, so equal).  Every gate of the phase holds on the CPU but the
launch counts (the plain kernel versions run here, so they expect
none)."""
import dataclasses
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

        mp.setattr(chip_smoke, "TRAIN_BATCH", 8)
        mp.setattr(chip_smoke, "TRAIN_SEQ", 32)
        mp.setattr(chip_smoke, "MOE_TOKENS", 64)
        yield chip_smoke


@pytest.fixture(scope="module")
def cfg():
    from paddle_tpu_torch.models import BertConfig

    return dataclasses.replace(BertConfig.tiny(), num_layers=4,
                               hidden_size=128, num_heads=4, ffn_size=256)


@pytest.fixture(scope="module")
def report(cs, cfg):
    return cs.parallel_phase(torch.device("cpu"), cfg, 12.5)


def test_data_parallel_at_world1_is_the_plain_step(report):
    dp = report["dp"]
    assert dp["degree"] == 1
    assert set(dp["launches"].values()) == {0}
    assert len(dp["losses"]) == 5 and dp["losses"][-1] < dp["losses"][0]
    assert report["phase5_step_ms"] == 12.5


def test_pipeline_gates_hold(report):
    p = report["pipeline"]
    assert p["max_dloss"] < 2e-3
    assert p["launches"] == {} and p["launches_per_step"] == {}
    assert len(p["losses"]) == len(p["unfused_losses"]) == 5


def test_moe_gates_hold(report, cs):
    m = report["moe"]
    assert m["capacity"] == int(2 * 64 / 8 * 2.0)
    assert m["dispatch_bytes"] == 64 * 8 * m["capacity"] * 4
    assert m["max_dloss"] < 2e-3 and len(m["losses"]) == cs.MOE_STEPS


def test_rank_cases_hold(report, cfg):
    cases = report["ranks"]["cases"]
    assert set(cases) == {"data2", "zero1", "model2", "expert2"}
    assert all(c["max_dloss"] < 2e-3 for c in cases.values())
    assert cases["zero1"]["report"]["ratio_vs_ideal"] < 1.5
    assert cases["model2"]["qkv_shard"] == (cfg.hidden_size,
                                            3 * cfg.hidden_size // 2)
    assert cases["expert2"]["w1_shard"] == (4, 768, 3072)


def test_all_labels_batch(cs):
    feed = cs._all_labels_batch(1000, torch.device("cpu"))
    assert bool((feed["input_mask"] == 1).all())
    assert torch.equal(feed["masked_labels"][..., 0], feed["src_ids"])
