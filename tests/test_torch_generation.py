"""The port's chunked generation engine against the JAX package's.

Both engines run the same weights (one numpy RandomState) at
BertConfig.tiny() width with initializer_range 0.6, so greedy decoding
does not collapse to one repeated token.  The port runs on the CPU
(``device="cpu"``, its plain attention); the JAX engine runs as its own
tests run it on the CPU.  Five prompts over four slots exercise
continuous batching; two prompts are longer than one prefill chunk;
the EOS token is chosen so that requests stop at different steps.

Tolerance: none.  Greedy and seeded-sampling tokens and finish reasons
must be EQUAL (token parity 1.0): the sampler draws JAX's bits, and at
this size float32 rounding does not move an argmax.
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
from paddle_tpu_torch.generation import (CacheFullError, GenerationBackend,
                                         GenerationConfig, GenerationEngine,
                                         SamplingParams)
from paddle_tpu_torch.models import BertConfig
from paddle_tpu_torch.serving import (BadRequestError, InferenceServer,
                                      ServingConfig)

torch.set_num_threads(2)

CFG = dataclasses.replace(BertConfig.tiny(), initializer_range=0.6)
JCFG = dataclasses.replace(JBertConfig.tiny(), initializer_range=0.6)
PARAMS = j_lm_random_params(JCFG, np.random.RandomState(0))
GEN = dict(page_size=8, max_seqs=4, max_seq_len=64, seed=7)
LENGTHS = (3, 17, 9, 30, 5)          # 17 and 30 span several chunks of 16


def _prompts(seed=1, lengths=LENGTHS):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, CFG.vocab_size, (n,)).tolist() for n in lengths]


def _tokens(results):
    return [(r.tokens, r.finish_reason) for r in results]


def _sampling(eos, sampled):
    """One SamplingParams per prompt: staggered max_new_tokens, and for
    the seeded case a mix of greedy and nucleus requests."""
    knobs = [dict(temperature=0.8, top_k=12, top_p=0.9),
             dict(temperature=1.0), dict(),
             dict(temperature=0.7, top_p=0.5), dict(temperature=1.2,
                                                    top_k=40)]
    return [dict(max_new_tokens=n, eos_id=eos, **(k if sampled else {}))
            for n, k in zip((12, 20, 9, 16, 14), knobs)]


def _jax_generate(kw, **gen):
    """The JAX chunked engine, fresh so that its request uids start at 0
    as the port engine's do (uids fold into the sampling keys)."""
    engine = JGenerationEngine(JCFG, PARAMS,
                               JGenerationConfig(**GEN, **gen))
    results = engine.generate(_prompts(), [JSamplingParams(**k) for k in kw])
    return results, engine.stats.snapshot()


def _port(**gen):
    return GenerationEngine(CFG, PARAMS, GenerationConfig(**GEN, **gen),
                            device="cpu")


@pytest.fixture(scope="module")
def eos():
    """An EOS id that the greedy stream of prompt 0 emits mid-way, so
    the batch's requests stop at different steps."""
    ref = _port().generate(_prompts(), SamplingParams(max_new_tokens=12))
    return ref[0].tokens[5]


@pytest.mark.parametrize("sampled", [False, True],
                         ids=["greedy", "seeded_sampling"])
def test_tokens_equal_the_jax_chunked_engine(eos, sampled):
    kw = _sampling(eos, sampled)
    want, jax_snap = _jax_generate(kw)
    port = _port()
    port.warmup()
    got = port.generate(_prompts(), [SamplingParams(**k) for k in kw])
    assert _tokens(got) == _tokens(want)
    reasons = {r.finish_reason for r in got}
    assert reasons == {"stop", "length"}          # EOS is staggered
    assert len({len(r.tokens) for r in got}) > 2
    snap = port.stats.snapshot()
    assert snap["compiles_after_warmup"] == 0
    assert snap["requests_done"] == jax_snap["requests_done"] == len(LENGTHS)
    # the port's snapshot keeps the reference engine's keys, plus the
    # count of unified steps (the kernel launches once per layer each)
    assert set(snap) - {"steps", "steps_total"} <= set(jax_snap)


def test_block_rows_and_chunk_size_keep_the_tokens(eos):
    """block_rows 2 and an 8-token chunk change the step's shape and
    schedule, not the tokens (schedule-invariant folded sampling)."""
    kw = _sampling(eos, sampled=True)
    want, _ = _jax_generate(kw)
    port = _port(ragged_block_rows=2, prefill_chunk=8)
    got = port.generate(_prompts(), [SamplingParams(**k) for k in kw])
    assert _tokens(got) == _tokens(want)
    assert port.cache.occupancy() == 0.0 and port.cache.check_invariants()


def test_server_round_trip_equals_generate():
    port = _port()
    prompts = _prompts(seed=5, lengths=(4, 11, 7))
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
    assert list(backend.stream(prompts[1])) == direct[1].tokens


def test_engine_guards():
    with pytest.raises(ValueError, match="max_position"):
        GenerationEngine(CFG, PARAMS, GenerationConfig(
            page_size=8, max_seq_len=256), device="cpu")
    # the JAX engine's configuration checks, ported with it
    for kw, match in ((dict(scheduling="legacy", speculation="ngram"),
                       "chunked"),
                      (dict(scheduling="legacy", prefix_cache=True),
                       "chunked"),
                      (dict(use_paged=False, prefix_cache=True),
                       "use_paged"),
                      (dict(speculation="ngram", spec_k=16), "spec_k"),
                      (dict(speculation="beam"), "speculation"),
                      (dict(prefill_seq_buckets=(8, 128)), "exceed")):
        with pytest.raises(ValueError, match=match):
            GenerationConfig(**GEN, **kw)
    with pytest.raises(ValueError, match="draft_model"):
        GenerationEngine(CFG, PARAMS, GenerationConfig(
            **GEN, speculation="draft"), device="cpu")
    port = _port()
    # the cluster prefill/decode handoff works on the CPU and gives what
    # the JAX engine gives (tests/test_torch_handoff.py holds it fully)
    ref = JGenerationEngine(JCFG, PARAMS, JGenerationConfig(**GEN))
    got, want = port.prefill_detached([1, 2, 3]), ref.prefill_detached(
        [1, 2, 3])
    assert (got[0].last_token, got[1], got[2]) == \
        (want[0].last_token, want[1], want[2])
    assert [r.tokens for r in port.decode_prefilled([got[0]])] == \
        [r.tokens for r in ref.decode_prefilled([want[0]])]
    assert port.stream_open("s", [1, 2, 3]) == ref.stream_open(
        "s", [1, 2, 3]) == 0
    assert port.stream_abort("s") and ref.stream_abort("s")
    with pytest.raises(ValueError, match="empty"):
        list(port.stream([[]]))
    with pytest.raises(ValueError, match="max_seq_len"):
        port.generate([[1] * 60], SamplingParams(max_new_tokens=8))
    tiny_pool = GenerationEngine(CFG, PARAMS, GenerationConfig(
        page_size=8, max_seqs=2, max_seq_len=64, num_pages=3),
        device="cpu")
    with pytest.raises(CacheFullError):
        tiny_pool.generate([[1] * 20], SamplingParams(max_new_tokens=4))


def test_tight_pool_queues_and_finishes():
    """A pool smaller than max_seqs full sequences makes requests wait
    for pages (admission and decode stalls); every request finishes, the
    pool drains, and the tokens are the JAX engine's."""
    tight = dict(page_size=8, max_seqs=2, max_seq_len=64, num_pages=9)
    kw = [dict(max_new_tokens=10)] * len(LENGTHS)
    want = JGenerationEngine(JCFG, PARAMS, JGenerationConfig(**tight)) \
        .generate(_prompts(), [JSamplingParams(**k) for k in kw])
    port = GenerationEngine(CFG, PARAMS, GenerationConfig(**tight),
                            device="cpu")
    got = port.generate(_prompts(), [SamplingParams(**k) for k in kw])
    assert _tokens(got) == _tokens(want)
    assert [len(r.tokens) for r in got] == [10] * len(LENGTHS)
    assert port.cache.occupancy() == 0.0 and port.cache.check_invariants()


def test_abandoned_stream_releases_its_pages():
    port = _port()
    events = port.stream(_prompts(), SamplingParams(max_new_tokens=20))
    for _ in range(7):
        next(events)
    assert port.cache.occupancy() > 0.0
    events.close()
    assert port.cache.occupancy() == 0.0 and port.cache.check_invariants()
    assert port.cache.free_slots() == list(range(GEN["max_seqs"]))


def test_backend_rejects_malformed_prompt_lengths():
    backend = GenerationBackend(_port(), max_new_tokens=2, warmup=False)
    ids = np.ones((2, 5), np.int32)
    for lens in ([0, 3], [6, 1]):
        with pytest.raises(BadRequestError, match="prompt_lens"):
            backend.run({"token_ids": ids,
                         "prompt_lens": np.array(lens, np.int32)})


def test_cpu_engine_never_launches_a_kernel():
    port = _port()
    _cuda.reset_launches()
    port.generate(_prompts(lengths=(5,)), SamplingParams(max_new_tokens=3))
    assert sum(_cuda.LAUNCHES.values()) == 0
    assert _cuda.library_loads() == 0
