"""The port's speculative decoding against the JAX package's.

``speculative_accept`` and the n-gram drafter's proposals must equal the
JAX functions'.  With ``speculation="ngram"`` and with
``speculation="draft"`` (the target's own weights as the draft model,
so drafts are often right: a 1-layer cut of this random model is never
accepted), the port's engine must give the JAX engine's tokens and its own
tokens with ``speculation=None`` (token parity 1.0), greedy and seeded,
at BertConfig.tiny() width with initializer_range 0.6, page_size 8,
max_seqs 4, max_seq_len 64.  The prompts repeat n-grams, so verify
windows are drafted, partly accepted and rolled back; drafted and
accepted counts must equal the JAX engine's.
"""
import dataclasses

import numpy as np
import pytest
import torch

from paddle_tpu.generation import GenerationConfig as JGenerationConfig
from paddle_tpu.generation import GenerationEngine as JGenerationEngine
from paddle_tpu.generation import NgramDrafter as JNgramDrafter
from paddle_tpu.generation import SamplingParams as JSamplingParams
from paddle_tpu.generation import speculative_accept as j_accept
from paddle_tpu.models import BertConfig as JBertConfig
from paddle_tpu.models import lm_random_params as j_lm_random_params
from paddle_tpu_torch.generation import (GenerationConfig, GenerationEngine,
                                         NgramDrafter, SamplingParams,
                                         speculative_accept)
from paddle_tpu_torch.models import BertConfig

torch.set_num_threads(2)

CFG = dataclasses.replace(BertConfig.tiny(), initializer_range=0.6)
JCFG = dataclasses.replace(JBertConfig.tiny(), initializer_range=0.6)
PARAMS = j_lm_random_params(JCFG, np.random.RandomState(0))
GEN = dict(page_size=8, max_seqs=4, max_seq_len=64, seed=7)


def test_speculative_accept_equals_the_reference():
    rng = np.random.RandomState(0)
    cases = [([4, 5, 6], [4, 5, 6, 7]), ([4, 9, 6], [4, 5, 6, 7]),
             ([9], [4, 5]), ([], [3])]
    for _ in range(50):
        k = rng.randint(1, 6)
        model = rng.randint(0, 4, k + 1)
        drafts = np.where(rng.rand(k) < 0.7, model[:k], rng.randint(0, 4, k))
        cases.append((drafts, model))
    for drafts, model in cases:
        n, out = speculative_accept(drafts, model)
        jn, jout = j_accept(drafts, model)
        assert n == jn and out.tolist() == jout.tolist()
        assert out.dtype == jout.dtype
    with pytest.raises(ValueError):
        speculative_accept([1, 2], [1, 2])


def test_ngram_proposals_equal_the_reference():
    rng = np.random.RandomState(1)
    for max_n in (1, 2, 3, 5):
        d, jd = NgramDrafter(max_n=max_n), JNgramDrafter(max_n=max_n)
        for slot in range(3):
            hist = rng.randint(0, 4, rng.randint(1, 30)).tolist()
            d.admit(slot, hist)
            jd.admit(slot, hist)
        for _ in range(40):
            slot, k = rng.randint(4), rng.randint(0, 6)
            assert d.draft(slot, k) == jd.draft(slot, k)
            new = rng.randint(0, 4, rng.randint(1, 4)).tolist()
            d.commit(slot, new)
            jd.commit(slot, new)
        d.release(0)
        assert d.draft(0, 3) == []
    with pytest.raises(ValueError):
        NgramDrafter(max_n=0)


def _prompts():
    """Prompts that repeat short patterns, so suffix n-grams recur."""
    rng = np.random.RandomState(2)
    out = []
    for n, reps in ((3, 4), (5, 3), (2, 7), (4, 2), (6, 3)):
        out.append(np.tile(rng.randint(1, CFG.vocab_size, n), reps).tolist())
    return out


def _sp(sampled):
    return [dict(max_new_tokens=n, **({"temperature": 0.8, "top_k": 20,
                                       "top_p": 0.9} if sampled else {}))
            for n in (12, 20, 9, 16, 14)]


def _jax_engine(**gen):
    draft = gen.pop("draft_model", None)
    return JGenerationEngine(JCFG, PARAMS, JGenerationConfig(**GEN, **gen),
                             draft_model=draft)


def _port(**gen):
    draft = gen.pop("draft_model", None)
    return GenerationEngine(CFG, PARAMS, GenerationConfig(**GEN, **gen),
                            device="cpu", draft_model=draft)


@pytest.mark.parametrize("kind", ["ngram", "draft"])
@pytest.mark.parametrize("sampled", [False, True],
                         ids=["greedy", "seeded_sampling"])
def test_engine_tokens_equal_jax_and_speculation_off(kind, sampled):
    spec = dict(speculation=kind, spec_k=3)
    jspec = dict(spec)
    if kind == "draft":
        spec["draft_model"] = (CFG, PARAMS)
        jspec["draft_model"] = (JCFG, PARAMS)
    jeng = _jax_engine(**jspec)
    want = jeng.generate(_prompts(), [JSamplingParams(**k)
                                      for k in _sp(sampled)])
    port = _port(**spec)
    port.warmup()
    got = port.generate(_prompts(), [SamplingParams(**k)
                                     for k in _sp(sampled)])
    off = _port().generate(_prompts(), [SamplingParams(**k)
                                        for k in _sp(sampled)])
    toks = [(r.tokens, r.finish_reason) for r in got]
    assert toks == [(r.tokens, r.finish_reason) for r in want]
    assert toks == [(r.tokens, r.finish_reason) for r in off]
    snap, jsnap = port.stats.snapshot(), jeng.stats.snapshot()
    for key in ("spec_drafted", "spec_accepted", "decode_tokens",
                "decode_steps"):
        assert snap[key] == jsnap[key], key
    assert snap["spec_drafted"] > 0 and snap["spec_accepted"] > 0
    if kind == "ngram" or sampled:
        assert snap["spec_accepted"] < snap["spec_drafted"]  # rollbacks ran
    assert snap["compiles_after_warmup"] == 0
    assert port.cache.occupancy() == 0.0 and port.cache.check_invariants()


def test_speculation_with_the_dense_cache_and_prefix_cache():
    """Rollback is bookkeeping in the dense cache and deref + COW with
    the prefix cache; both keep plain decoding's tokens."""
    sp = [SamplingParams(**k) for k in _sp(False)]
    want = [r.tokens for r in _port().generate(_prompts(), sp)]
    for extra in (dict(use_paged=False), dict(prefix_cache=True)):
        eng = _port(speculation="ngram", spec_k=4, **extra)
        assert [r.tokens for r in eng.generate(_prompts(), sp)] == want
        assert eng.cache.check_invariants()
