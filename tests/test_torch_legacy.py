"""The port's legacy scheduling against the JAX package's.

Legacy scheduling runs one bucketed prefill per (batch bucket x prompt
length bucket) and a decode step over all slots whose attention reads
the cache through the paged decode attention (the dense cache's is
plain).  Both engines run the same weights (one numpy RandomState) at
BertConfig.tiny() width with initializer_range 0.6, page_size 8,
max_seqs 4, max_seq_len 64 and prefill_seq_buckets (8, 16).  The port
runs on the CPU (``device="cpu"``); the JAX engine runs as its own tests
run it on the CPU.  Six prompts over four slots exercise continuous
batching, both seq buckets and padded batch buckets; the EOS token is
chosen so that requests stop at different steps.

Tolerance: none.  Tokens and finish reasons must be EQUAL (token parity
1.0), greedy and seeded.
"""
import dataclasses
import threading

import numpy as np
import pytest
import torch

from paddle_tpu.generation import GenerationConfig as JGenerationConfig
from paddle_tpu.generation import GenerationEngine as JGenerationEngine
from paddle_tpu.generation import SamplingParams as JSamplingParams
from paddle_tpu.models import BertConfig as JBertConfig
from paddle_tpu.models import lm_random_params as j_lm_random_params
from paddle_tpu_torch import _cuda
from paddle_tpu_torch.generation import (CacheFullError, DenseKVCache,
                                         GenerationBackend, GenerationConfig,
                                         GenerationEngine, SamplingParams)
from paddle_tpu_torch.models import BertConfig
from paddle_tpu_torch.serving import InferenceServer, ServingConfig

torch.set_num_threads(2)

CFG = dataclasses.replace(BertConfig.tiny(), initializer_range=0.6)
JCFG = dataclasses.replace(JBertConfig.tiny(), initializer_range=0.6)
PARAMS = j_lm_random_params(JCFG, np.random.RandomState(0))
GEN = dict(page_size=8, max_seqs=4, max_seq_len=64, seed=7,
           prefill_seq_buckets=(8, 16))
LENGTHS = (3, 12, 9, 16, 5, 7)        # both seq buckets; 6 prompts, 4 slots


def _prompts(seed=1, lengths=LENGTHS):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, CFG.vocab_size, (n,)).tolist() for n in lengths]


def _tokens(results):
    return [(r.tokens, r.finish_reason) for r in results]


def _sampling(eos, sampled):
    knobs = [dict(temperature=0.8, top_k=12, top_p=0.9),
             dict(temperature=1.0), dict(),
             dict(temperature=0.7, top_p=0.5),
             dict(temperature=1.2, top_k=40), dict(temperature=0.9)]
    return [dict(max_new_tokens=n, eos_id=eos, **(k if sampled else {}))
            for n, k in zip((12, 20, 9, 16, 14, 11), knobs)]


def _port(**gen):
    return GenerationEngine(CFG, PARAMS, GenerationConfig(**{**GEN, **gen}),
                            device="cpu")


def _jax(**gen):
    return JGenerationEngine(JCFG, PARAMS,
                             JGenerationConfig(**{**GEN, **gen}))


@pytest.fixture(scope="module")
def eos():
    """An EOS id that the greedy stream of prompt 0 emits mid-way."""
    ref = _port(scheduling="legacy").generate(
        _prompts(), SamplingParams(max_new_tokens=12))
    return ref[0].tokens[5]


@pytest.mark.parametrize("use_paged", [True, False], ids=["paged", "dense"])
@pytest.mark.parametrize("sampled", [False, True],
                         ids=["greedy", "seeded_sampling"])
def test_tokens_equal_the_jax_legacy_engine(eos, use_paged, sampled):
    kw = _sampling(eos, sampled)
    jax_engine = _jax(scheduling="legacy", use_paged=use_paged)
    want = jax_engine.generate(_prompts(),
                               [JSamplingParams(**k) for k in kw])
    port = _port(scheduling="legacy", use_paged=use_paged)
    assert isinstance(port.cache, DenseKVCache) != use_paged
    port.warmup()
    got = port.generate(_prompts(), [SamplingParams(**k) for k in kw])
    assert _tokens(got) == _tokens(want)
    if not sampled:                           # EOS is staggered
        assert {r.finish_reason for r in got} == {"stop", "length"}
    assert len({len(r.tokens) for r in got}) > 2
    snap, jsnap = port.stats.snapshot(), jax_engine.stats.snapshot()
    assert snap["compiles_after_warmup"] == 0
    for key in ("requests_done", "prefill_batches", "prefill_tokens",
                "decode_tokens", "decode_steps"):
        assert snap[key] == jsnap[key], key
    assert port.cache.occupancy() == 0.0 and port.cache.check_invariants()


@pytest.mark.parametrize("sampled", [False, True],
                         ids=["greedy", "seeded_sampling"])
def test_legacy_equals_chunked(eos, sampled):
    """Schedule-invariant sampling: the two schedulers of the port give
    the same tokens for the same requests."""
    kw = [SamplingParams(**k) for k in _sampling(eos, sampled)]
    legacy = _port(scheduling="legacy").generate(_prompts(), kw)
    chunked = _port().generate(_prompts(), kw)
    assert _tokens(legacy) == _tokens(chunked)


def test_tight_pool_queues_and_finishes():
    """A pool smaller than max_seqs full sequences: requests wait for
    pages and decode stalls; every request finishes, the pool drains,
    and the tokens are the JAX legacy engine's."""
    tight = dict(page_size=8, max_seqs=2, max_seq_len=64, num_pages=9,
                 prefill_seq_buckets=(8, 16), scheduling="legacy")
    kw = [dict(max_new_tokens=24)] * len(LENGTHS)
    want = JGenerationEngine(JCFG, PARAMS, JGenerationConfig(**tight)) \
        .generate(_prompts(), [JSamplingParams(**k) for k in kw])
    port = GenerationEngine(CFG, PARAMS, GenerationConfig(**tight),
                            device="cpu")
    got = port.generate(_prompts(), [SamplingParams(**k) for k in kw])
    assert _tokens(got) == _tokens(want)
    assert [len(r.tokens) for r in got] == [24] * len(LENGTHS)
    assert port.cache.occupancy() == 0.0 and port.cache.check_invariants()


def test_legacy_guards_and_abandoned_stream():
    port = _port(scheduling="legacy")
    with pytest.raises(ValueError, match="seq bucket"):
        port.generate([[1] * 17], SamplingParams(max_new_tokens=4))
    with pytest.raises(ValueError, match="empty"):
        list(port.stream([[]]))
    events = port.stream(_prompts(), SamplingParams(max_new_tokens=20))
    for _ in range(9):
        next(events)
    assert port.cache.occupancy() > 0.0
    events.close()
    assert port.cache.occupancy() == 0.0 and port.cache.check_invariants()
    assert port.cache.free_slots() == list(range(GEN["max_seqs"]))
    tiny_pool = GenerationEngine(CFG, PARAMS, GenerationConfig(
        page_size=8, max_seqs=2, max_seq_len=64, num_pages=3,
        scheduling="legacy"), device="cpu")
    with pytest.raises(CacheFullError):
        tiny_pool.generate([[1] * 20], SamplingParams(max_new_tokens=4))


def test_cpu_legacy_engine_never_launches_a_kernel():
    port = _port(scheduling="legacy")
    _cuda.reset_launches()
    port.warmup()
    port.generate(_prompts(lengths=(5, 11)),
                  SamplingParams(max_new_tokens=3))
    assert sum(_cuda.LAUNCHES.values()) == 0
    assert _cuda.library_loads() == 0


def test_server_round_trip_on_a_legacy_engine():
    """GenerationBackend serves a legacy engine behind InferenceServer
    with the same API: concurrent clients get engine.generate's tokens,
    and warmup leaves nothing to build."""
    port = _port(scheduling="legacy")
    prompts = _prompts(seed=5, lengths=(4, 11, 7, 16))
    backend = GenerationBackend(port, max_new_tokens=6)
    server = InferenceServer(backend, ServingConfig(
        batch_buckets=(1, 2, 4), seq_buckets=(8, 16),
        pad_values={"prompt_lens": 1}, max_batch_wait_ms=20)).start()
    answers = [None] * len(prompts)
    try:
        server.warmup()

        def client(i):
            p = np.asarray(prompts[i], np.int32)
            out, n = server.infer({"token_ids": p[None],
                                   "prompt_lens": np.array([p.size],
                                                           np.int32)})
            answers[i] = out[0, :int(n[0])].tolist()

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        stats = server.stats()
    finally:
        server.close()
    direct = port.generate(prompts, SamplingParams(max_new_tokens=6))
    assert answers == [r.tokens for r in direct]
    assert stats["requests_ok"] == len(prompts)
    assert stats["compiles_after_warmup"] == 0
    assert list(backend.stream(prompts[2])) == direct[2].tokens
