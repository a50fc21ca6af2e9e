"""chip_smoke.py's phase 13 rehearsed on the CPU at a small width: BERT-
tiny at hidden 128 (4 heads, FFN 256; the fusion pass plans its
attention, fused-matmul and FFN-chain groups), 8 x 32 tokens with 5
masked positions a row, a 5,000 x 8 sparse table with 64 ids a batch.
Every gate of the phase holds on the CPU but the launch counts (the
plain kernel versions run here, so they expect none) and the peak
memory (CPU tensors are not counted)."""
import dataclasses
import os
import sys

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
        mp.setattr(chip_smoke, "TRAIN_BATCH", 8)
        mp.setattr(chip_smoke, "TRAIN_SEQ", 32)
        mp.setattr(chip_smoke, "MASKED", 5)
        mp.setattr(chip_smoke, "SPARSE_VOCAB", 5000)
        mp.setattr(chip_smoke, "SPARSE_DIM", 8)
        mp.setattr(chip_smoke, "SPARSE_IDS", 64)
        yield chip_smoke


@pytest.fixture(scope="module")
def report(cs):
    from paddle_tpu_torch.models import BertConfig

    cfg = dataclasses.replace(BertConfig.tiny(), hidden_size=128,
                              num_heads=4, ffn_size=256)
    return cs.sparse_recompute_phase(torch.device("cpu"), cfg, 12.5)


def test_masked_head_gates_hold(report):
    m = report["masked"]
    assert m["plan_groups"] == {"attn": 2, "gemm": 3, "ffn_chain": 2}
    assert np.isfinite(m["losses"]).all()
    assert set(m["launches"].values()) == {0}
    assert m["parity"]["blocks"]["max_dloss"] < 2e-3
    assert m["dense_head"]["rel_err"] < 1e-4


def test_recompute_gates_hold(report):
    r = report["recompute"]
    assert r["losses"][0] == r["unfused_losses"][0]
    assert r["max_dloss"] < 2e-3 and r["max_grad_rel_err"] < 1e-3


def test_sparse_gates_hold(report, cs):
    s = report["sparse"]
    for name in ("sgd", "adam"):
        assert s[name]["max_loss_rel_err"] <= cs.SPARSE_RTOL
        assert s[name]["table_rel_err"] <= cs.SPARSE_RTOL
    assert all(s[k]["bit_equal_rerun"] for k in ("sgd", "adam",
                                                 "lazy_adam"))
    assert s["grad_shapes"] == ((64, 8), (64,))
    assert 0 < s["oob"]["rows_changed"] <= s["oob"]["valid_rows"]


def test_wrapper_and_loss_op_gates_hold(report):
    w = report["wrappers"]
    assert w["gradient_merge"]["kept_bits"] == [True] * 3
    assert w["gradient_merge"]["rel_err"] < 1e-4
    assert w["ema"]["restored_bits"] and w["ema"]["rel_err"] <= 1e-6
    assert max(w["programs"].values()) <= 1e-5
    assert max(report["loss_ops"].values()) <= 1e-5
