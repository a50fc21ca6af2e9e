"""chip_smoke.py's phase 14 rehearsed on the CPU at a small width: the
serving LM at BERT-tiny width (initializer_range 0.6, dropout 0), its
logits at [8, 128] exported baked and unbaked and loaded in a fresh
process (14a); the ragged block_rows search, an engine resolving the
searched value from the store, the fusion-plan search at a small FFN and
a per_gemm override (14b); and the fleet over five worker processes of
tiny chunked engines (14c: autoscaler, tuning verbs, rolling swaps,
supervisor).  Every gate of the phase holds on the CPU but the launch
counts (the plain kernel versions run here, so they expect none) and the
timed searches (nothing is timed or written on the CPU: the rehearsal
puts the winner in the store by hand)."""
import dataclasses
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.multiproc


@pytest.fixture(scope="module")
def cs(tmp_path_factory):
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    out = tmp_path_factory.mktemp("p14")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(chip_smoke, "OUT_DIR", Path(out))
        mp.setattr(chip_smoke, "FLEET_LOG_DIR", Path(out) / "phase14")
        mp.setattr(chip_smoke, "TUNE_REPS", 2)
        mp.setattr(chip_smoke, "PLAN_GEOMETRY", (64, 64, 128, 64))
        yield chip_smoke


@pytest.fixture(scope="module")
def report(cs):
    from paddle_tpu_torch.models import BertConfig, lm_random_params
    from paddle_tpu_torch.resilience.retry import degradations

    cfg = dataclasses.replace(BertConfig.tiny(), initializer_range=0.6,
                              hidden_dropout=0.0, attn_dropout=0.0)
    params = lm_random_params(cfg, np.random.RandomState(cs.SEED))
    try:
        yield cs.fleet_tuning_artifact_phase(torch.device("cpu"), None,
                                             params, cfg=cfg, model="tiny")
    finally:
        degradations.reset()


def test_artifact_gates_hold(report, cs):
    ops = report["graph_ops"]
    assert ops == {"flash_kernel_forward_qkv": 2, "fused_matmul_kernel": 2,
                   "ffn_chain_kernel": 2, "flash_kernel_forward": 0}
    child = report["child"]
    for tag in ("baked", "unbaked"):
        assert child[tag]["max_abs_err"] <= cs.ARTIFACT_ATOL
        assert child[tag]["launches"] == {}
        assert child[tag]["finite"]
    assert "belongs to a different export" in child["foreign"]
    assert "does not match" in report["export_refusal"]
    assert not [m for m in child["modules"] if m.startswith(
        ("paddle_tpu_torch.core", "paddle_tpu_torch.layers",
         "paddle_tpu_torch.models"))]
    # the unbaked program holds no weights: the sidecar does
    b = report["bytes"]
    assert b["unbaked"] < b["sidecar"] < b["baked"] + b["sidecar"]


def test_tuning_gates_hold(report, cs):
    t = report["tuning"]
    assert t["device_kind"] == "cpu" and t["geometry"] == "r24h4d16p16"
    assert [c["block_rows"] for c in t["ragged"]["candidates"]] \
        == [8, 4, 2, 1]
    assert all(c["parity"] for c in t["ragged"]["candidates"])
    assert t["engine"]["resolved"] == t["ragged"]["config"]["block_rows"]
    assert t["engine"]["parity"] == 1.0
    assert max(t["plan"]["max_abs_err"].values()) < 1e-4
    assert max(t["override"]["rel_err_by_depth"].values()) \
        <= cs.LOGITS_ROW_RTOL


def test_fleet_gates_hold(report):
    f = report["fleet"]
    assert f["router"]["requests_failed"] == 1       # the parked request
    assert "degraded permanently" in f["parked_failure"]
    assert sorted(f["degradations"]) == ["fleet.rollout",
                                         "fleet.supervisor:default"]
    assert f["rollout_abort"] == "parity canary mismatch"
    assert f["tuning"]["keys"] == ["ragged|cpu|r24h4d16p16|float32"]
    assert f["triggers"].count("degrade") == 2
    for k in ("first_ready_s", "spawn_to_attached_s", "drain_s",
              "swap_s_per_worker", "respawn_s"):
        assert f[k] > 0, k
