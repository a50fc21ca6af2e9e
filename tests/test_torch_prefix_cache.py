"""The port's prefix cache against the JAX package's.

The allocator is host-side in both packages: the same admit / register /
ensure / truncate / release sequence must splice the same pages, keep
the same page tables, refcounts, retained pages and counters, and pass
the invariant audit after every operation.  Copy-on-write copies pages
in place on the port's device; the copy must hold the shared page's
bits.  The engine with ``prefix_cache=True`` must give the JAX engine's
tokens and its own tokens with the cache off (token parity 1.0), greedy
and seeded, at BertConfig.tiny() width with initializer_range 0.6,
page_size 8, max_seqs 4, max_seq_len 64.
"""
import dataclasses

import numpy as np
import pytest
import torch

from paddle_tpu.generation import GenerationConfig as JGenerationConfig
from paddle_tpu.generation import GenerationEngine as JGenerationEngine
from paddle_tpu.generation import SamplingParams as JSamplingParams
from paddle_tpu.generation.kv_cache import CacheFullError as JCacheFull
from paddle_tpu.generation.kv_cache import PagedKVCache as JCache
from paddle_tpu.generation.kv_cache import _block_keys as j_block_keys
from paddle_tpu.models import BertConfig as JBertConfig
from paddle_tpu.models import lm_random_params as j_lm_random_params
from paddle_tpu_torch.generation import (CacheFullError, GenerationConfig,
                                         GenerationEngine, PagedKVCache,
                                         SamplingParams)
from paddle_tpu_torch.generation.kv_cache import _block_keys
from paddle_tpu_torch.models import BertConfig

torch.set_num_threads(2)

GEOM = dict(num_layers=2, hidden=4, page_size=4, num_pages=16, max_seqs=4,
            max_len=40)


def _both(**geom):
    g = {**GEOM, **geom}
    return JCache(**g, prefix_cache=True), PagedKVCache(
        **g, prefix_cache=True, device="cpu")


def _same_state(j, t):
    np.testing.assert_array_equal(t.page_table, j.page_table)
    np.testing.assert_array_equal(t.seq_lens, j.seq_lens)
    assert t._ref == j._ref
    assert t._retained == j._retained
    assert t._free == j._free
    assert t._index._key_of == j._index._key_of
    assert t.prefix_counters() == j.prefix_counters()
    assert t.free_pages() == j.free_pages()
    assert t.retained_pages() == j.retained_pages()
    assert t.occupancy() == j.occupancy()
    assert t.check_invariants() and j.check_invariants()


@pytest.mark.parametrize("page_size", [1, 4, 16])
def test_block_keys_equal_the_reference(page_size):
    toks = np.random.RandomState(page_size).randint(0, 5000, 64)
    n = 64 // page_size
    assert _block_keys(toks, page_size, n) == j_block_keys(toks, page_size,
                                                           n)
    assert _block_keys(toks.tolist(), page_size, 2) == j_block_keys(
        toks.astype(np.int32), page_size, 2)


def test_scripted_sequence_follows_the_reference():
    """Splice, shared ensure, truncate into a shared block (COW),
    truncate to a block boundary, retention, LRU eviction."""
    j, t = _both(num_pages=12)
    a = np.arange(9)
    b = np.concatenate([np.arange(8), [70, 71, 72]])
    ops = [("admit", 0, 9, a), ("register_prefix", 0, a),
           ("admit", 1, 9, a), ("admit", 2, 11, b),
           ("ensure", 1, 12), ("truncate_to", 1, 5),
           ("truncate_to", 2, 4), ("release", 0),
           ("admit", 0, 9, a), ("register_prefix", 2, b[:4]),
           ("release", 1), ("release", 2), ("release", 0),
           ("admit", 3, 30, np.arange(100, 130)),
           ("admit", 0, 5, a[:5]), ("ensure", 3, 33), ("release", 3),
           ("admit", 1, 9, a), ("release", 1), ("release", 0)]
    for op, *args in ops:
        if op == "admit":
            assert getattr(t, op)(*args[:2], tokens=args[2]) == \
                getattr(j, op)(*args[:2], tokens=args[2]), op
        else:
            assert getattr(t, op)(*args) == getattr(j, op)(*args), op
        _same_state(j, t)
    c = t.prefix_counters()
    assert c["hits"] > 0 and c["cow_copies"] > 0 and c["pages_evicted"] > 0


def test_randomized_sequence_follows_the_reference():
    """A tiny token alphabet makes prefix collisions frequent; both
    allocators must agree after every operation, and the audit holds."""
    rng = np.random.RandomState(1234)
    j, t = _both(num_pages=12)
    live = {}
    for _ in range(300):
        op = rng.randint(5)
        if op == 0:
            free = [s for s in range(4) if s not in live]
            if not free:
                continue
            plen = int(rng.randint(1, 24))
            toks = rng.randint(0, 3, size=plen)
            errs = []
            for c in (j, t):
                try:
                    c.admit(free[0], plen, tokens=toks)
                except (JCacheFull, CacheFullError) as e:
                    errs.append(type(e))
            assert len(errs) in (0, 2)
            if not errs:
                live[free[0]] = (plen, toks)
        elif op == 1 and live:
            slot = list(live)[rng.randint(len(live))]
            assert t.register_prefix(slot, live[slot][1]) == \
                j.register_prefix(slot, live[slot][1])
        elif op == 2 and live:
            slot = list(live)[rng.randint(len(live))]
            n = min(live[slot][0] + int(rng.randint(1, 6)), 39)
            errs = []
            for c in (j, t):
                try:
                    c.ensure(slot, n)
                except (JCacheFull, CacheFullError) as e:
                    errs.append(type(e))
            assert len(errs) in (0, 2)
        elif op == 3 and live:
            slot = list(live)[rng.randint(len(live))]
            n = int(rng.randint(1, live[slot][0] + 1))
            for c in (j, t):
                c.truncate_to(slot, n)
                c.seq_lens[slot] = min(int(c.seq_lens[slot]), n)
            live[slot] = (n, live[slot][1][:n])
        elif op == 4 and live:
            slot = list(live)[rng.randint(len(live))]
            j.release(slot)
            t.release(slot)
            del live[slot]
        _same_state(j, t)
    assert t.prefix_counters()["hits"] > 0


def test_copy_on_write_copies_the_shared_page_in_place():
    t = PagedKVCache(**GEOM, prefix_cache=True, device="cpu")
    toks = np.arange(9)
    t.admit(0, 9, tokens=toks)
    t.k.copy_(torch.randn_like(t.k))
    t.v.copy_(torch.randn_like(t.v))
    t.register_prefix(0, toks)
    assert t.admit(1, 9, tokens=toks) == 8
    shared = t._owned[1][1]
    before_k, before_v = t.k[:, shared].clone(), t.v[:, shared].clone()
    t.truncate_to(1, 5)                   # kept partial tail is shared
    private = t._owned[1][1]
    assert private != shared and t.prefix_counters()["cow_copies"] == 1
    assert torch.equal(t.k[:, private], before_k)
    assert torch.equal(t.v[:, private], before_v)
    assert torch.equal(t.k[:, shared], before_k)
    assert t.check_invariants()


CFG = dataclasses.replace(BertConfig.tiny(), initializer_range=0.6)
JCFG = dataclasses.replace(JBertConfig.tiny(), initializer_range=0.6)
PARAMS = j_lm_random_params(JCFG, np.random.RandomState(0))
GEN = dict(page_size=8, max_seqs=4, max_seq_len=64, seed=7)


def _shared_prefix_prompts():
    """Six prompts sharing a 24-token (three-page) system prompt, one of
    them the system prompt alone, with tails of different lengths."""
    rng = np.random.RandomState(3)
    system = rng.randint(1, CFG.vocab_size, 24).tolist()
    tails = [rng.randint(1, CFG.vocab_size, n).tolist()
             for n in (5, 1, 9, 0, 13, 3)]
    return [system + tail for tail in tails]


@pytest.mark.parametrize("sampled", [False, True],
                         ids=["greedy", "seeded_sampling"])
def test_engine_tokens_equal_jax_and_the_cache_off(sampled):
    sp = (dict(max_new_tokens=10, temperature=0.8, top_k=20, top_p=0.9)
          if sampled else dict(max_new_tokens=10))
    prompts = _shared_prefix_prompts()
    jeng = JGenerationEngine(JCFG, PARAMS, JGenerationConfig(
        **GEN, prefix_cache=True))
    want = jeng.generate(prompts, JSamplingParams(**sp))
    port = GenerationEngine(CFG, PARAMS, GenerationConfig(
        **GEN, prefix_cache=True), device="cpu")
    port.warmup()
    got = port.generate(prompts, SamplingParams(**sp))
    off = GenerationEngine(CFG, PARAMS, GenerationConfig(**GEN),
                           device="cpu").generate(prompts,
                                                  SamplingParams(**sp))
    toks = [r.tokens for r in got]
    assert toks == [r.tokens for r in want]
    assert toks == [r.tokens for r in off]
    snap, jsnap = port.stats.snapshot(), jeng.stats.snapshot()
    for key in ("prefix_lookups", "prefix_hits", "prefix_pages_reused",
                "prefix_pages_evicted", "prefix_cow_copies",
                "prefill_tokens"):
        assert snap[key] == jsnap[key], key
    assert snap["prefix_hits"] > 0 and snap["prefix_pages_reused"] > 0
    assert snap["compiles_after_warmup"] == 0
    assert port.cache.occupancy() == 0.0 and port.cache.check_invariants()
    assert port.cache.retained_pages() > 0
