"""A bfloat16 KV cache across the cluster's prefill/decode split, and
chip_smoke.py's phase 22 rehearsed on the CPU.

One prefill and one decode worker process (``python -m
paddle_tpu_torch.cluster.worker`` on the CPU, ``tiny_lm_engine`` with
``dtype="bfloat16"``) behind a GenerationRouter give the monolithic
bfloat16 engine's tokens, with the pages streamed chunk by chunk and
with the whole handoff shipped after prefill; the K/V travel as the
cache's 16-bit words (tests/test_torch_kv16.py holds them bit for bit
through the RPC framing).
"""
import os
import sys

import numpy as np
import pytest
import torch

from paddle_tpu_torch.cluster import (ClusterConfig, GenerationRouter,
                                      WorkerPool, WorkerSpec)
from paddle_tpu_torch.cluster.testing import tiny_lm_engine
from paddle_tpu_torch.generation import SamplingParams

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SP = SamplingParams(max_new_tokens=8)
PROMPTS = [[3, 5, 7, 9, 11], [2, 4, 6, 8, 10, 12, 14, 16, 18], [1] * 17,
           [4] * 12]


@pytest.mark.multiproc
def test_bf16_disaggregated_workers_give_the_monolithic_tokens(tmp_path):
    spec = dict(seed=0, max_seq_len=32, device="cpu", dtype="bfloat16")
    mono = tiny_lm_engine(**spec)
    assert mono.cache.k.dtype == torch.bfloat16
    want = [r.tokens for r in mono.generate(PROMPTS, sampling=SP)]
    f32 = [r.tokens for r in tiny_lm_engine(
        seed=0, max_seq_len=32, device="cpu").generate(PROMPTS, sampling=SP)]
    assert want != f32          # the cache's rounding reached the tokens
    pools = []
    try:
        for role in ("prefill", "decode"):
            pools.append(WorkerPool(
                WorkerSpec("paddle_tpu_torch.cluster.testing:"
                           "tiny_lm_engine", spec, role=role), 1,
                log_dir=str(tmp_path / role), ready_timeout_s=60.0))
        for pool in pools:
            pool.wait_ready()
        for stream in (True, False):
            gr = GenerationRouter(*pools, ClusterConfig(
                stream_pages=stream, default_timeout_ms=60_000))
            try:
                got = [r.tokens for r in gr.generate(PROMPTS, sampling=SP)]
            finally:
                gr.close()
            assert got == want, stream
    finally:
        for pool in pools:
            pool.close()
    procs = [h.proc for pool in pools for h in pool.handles()]
    assert procs and all(p.poll() is not None for p in procs)


def test_chip_smoke_phase22_rehearses_on_the_cpu(tmp_path, monkeypatch):
    """Phase 22 at BertConfig.tiny() width on the CPU: the 16-bit plain
    versions within contract_bound of each other (the CPU wrapper is the
    reference), every engine run finishes with float32 parameters, the
    teacher-forced recomputes hold, the bf16 handoff ships half the bytes
    bit for bit, the bf16 artifact reproduces its Predictor; the launch
    gates bind only on the card."""
    import dataclasses

    sys.path.insert(0, ROOT)
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(ROOT)
    from paddle_tpu_torch.models import BertConfig, lm_random_params

    monkeypatch.setenv("PADDLE_TPU_AUTOTUNE_CACHE",
                       str(tmp_path / "autotune.json"))
    for name, value in dict(LONG_SLOTS=6, LONG_PPS=8, LONG_CHUNK=8,
                            LONG_CHUNK_START=64, TUNE_REPS=1, N_PROMPTS=2,
                            KV16_PROMPTS=4, KV16_NEW=8, KV16_TURNS=2,
                            KV16_REF_NEW=8).items():
        monkeypatch.setattr(cs, name, value)
    torch.set_num_threads(2)
    cfg = dataclasses.replace(BertConfig.tiny(), initializer_range=0.6)
    params = lm_random_params(cfg, np.random.RandomState(cs.SEED))
    report, launches = cs.kv16_phase(torch.device("cpu"), cfg, params)
    assert set(launches) == {f"{k}_{s}" for k in (
        "ragged_paged_attention", "paged_decode_attention")
        for s in ("bf16", "f16")}
    for name, r in report["kernels"].items():
        assert r["max_abs_err"] > 0 and all(
            c["bound_share"] <= 1 for c in r["cases"].values())
        assert {"timing", "timing_long"} <= set(r)
    for key in ("float32", "bfloat16", "float16"):
        for sched in ("chunked", "legacy"):
            r = report[f"{key}_{sched}"]
            assert r["compiles_after_warmup"] == 0
            assert len(r["tokens_per_s"]) == 2
    assert report["resolved_block_rows"]["float32"] == 1
    for sched in ("chunked", "legacy"):
        ref = report["reference"][sched]
        assert ref["cpu_worst_gap"] == 0.0
        assert ref["card_worst_gap"] <= cs.KV16_LOGIT_TOL
        assert ref["card_at_max"] >= cs.KV16_AT_MAX
    h = report["handoff"]
    assert h["words_equal"] and h["tokens_equal"]
    assert all(h["round_trip"].values())
    assert 0.49 < h["bytes_ratio"] < 0.52
    for tag in ("baked", "unbaked"):
        assert report["artifact"][tag]["max_abs_err"] == 0.0
