"""The port's prefill/decode handoff against the JAX package's.

Caches: the paged and the dense cache of both packages take the same
writes, then export the same spans (equal, atol 0), and an import into
either is exported back bit for bit.

Engines: a prefill engine and a decode engine of each package, built
fresh from the same weights (one numpy RandomState; BertConfig.tiny()
width, initializer_range 0.6, as tests/test_torch_generation.py) and
driven through the same calls in the same order, so their request uids
and with them the sampling keys agree.  The port runs on the CPU
(``device="cpu"``, the plain attention); the JAX engine as its own
tests run it on the CPU.  Modes: chunked scheduling with the prefix
cache off and on, and legacy scheduling (its prefill buckets hold every
prompt).

Tolerances.  Tokens, finish reasons, chunk boundaries, cached lengths,
return values and errors: equal.  Exported K/V of the two engines:
max |port - JAX| <= 1e-5 x max |JAX| per array — both compute the
layers in float32 in another summation order, and at this init the K/V
reach ~20, where float32 rounding alone is ~2e-6 per operation (the
observed worst is ~2e-5 absolute, ~1.5e-6 of the array's scale).
"""
import dataclasses

import numpy as np
import pytest
import torch

from paddle_tpu.generation import GenerationConfig as JGenerationConfig
from paddle_tpu.generation import GenerationEngine as JGenerationEngine
from paddle_tpu.generation import SamplingParams as JSamplingParams
from paddle_tpu.generation.kv_cache import DenseKVCache as JDense
from paddle_tpu.generation.kv_cache import PagedKVCache as JPaged
from paddle_tpu.models import BertConfig as JBertConfig
from paddle_tpu.models import lm_random_params as j_lm_random_params
from paddle_tpu_torch.generation import (DenseKVCache, GenerationConfig,
                                         GenerationEngine, PagedKVCache,
                                         PrefillHandoff, SamplingParams)
from paddle_tpu_torch.models import BertConfig

torch.set_num_threads(2)

CFG = dataclasses.replace(BertConfig.tiny(), initializer_range=0.6)
JCFG = dataclasses.replace(JBertConfig.tiny(), initializer_range=0.6)
PARAMS = j_lm_random_params(JCFG, np.random.RandomState(0))
GEN = dict(page_size=8, max_seqs=4, max_seq_len=64, seed=7)
MODES = {"chunked": {}, "chunked_prefix": dict(prefix_cache=True),
         "legacy": dict(scheduling="legacy")}
#: 17 and 30 span several prefill chunks and pages; the last two share
#: their first 16 tokens (two pages) with the second
LENGTHS = (3, 17, 9, 30)
KV_REL_TOL = 1e-5

GEOM = dict(num_layers=2, hidden=16, page_size=4, num_pages=13,
            max_seqs=3, max_len=16)


def _prompts():
    rng = np.random.RandomState(1)
    prompts = [rng.randint(1, CFG.vocab_size, (n,)).tolist()
               for n in LENGTHS]
    tail = rng.randint(1, CFG.vocab_size, (9,)).tolist()
    return prompts + [prompts[1][:16] + tail, prompts[1][:16] + tail[:3]]


def _sampling(sampled):
    knobs = [dict(temperature=0.8, top_k=12, top_p=0.9),
             dict(temperature=1.0), dict(), dict(temperature=0.7, top_p=0.5),
             dict(temperature=1.2, top_k=40), dict(temperature=0.9)]
    return [dict(max_new_tokens=n, **(k if sampled else {}))
            for n, k in zip((12, 20, 9, 16, 14, 10), knobs)]


def _engines(mode):
    """(JAX engine, port engine) of ``mode``, fresh."""
    kw = dict(GEN, **MODES[mode])
    return (JGenerationEngine(JCFG, PARAMS, JGenerationConfig(**kw)),
            GenerationEngine(CFG, PARAMS, GenerationConfig(**kw),
                             device="cpu"))


def _close_kv(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= KV_REL_TOL * float(np.abs(want).max()), err


def _same_handoff(t, j):
    assert isinstance(t, PrefillHandoff)
    assert (t.prompt_len, t.last_token) == (j.prompt_len, j.last_token)
    np.testing.assert_array_equal(t.prompt_tokens, j.prompt_tokens)
    assert (t.kv_k is None) == (j.kv_k is None)
    if j.kv_k is not None:
        _close_kv(t.kv_k, j.kv_k)
        _close_kv(t.kv_v, j.kv_v)


def _raises_alike(jfn, tfn):
    """Both calls raise the same exception type with the same message."""
    with pytest.raises(Exception) as je:
        jfn()
    with pytest.raises(Exception) as te:
        tfn()
    assert type(te.value).__name__ == type(je.value).__name__
    assert str(te.value) == str(je.value)


# ---------------------------------------------------------------------------
# caches


def _caches(kind):
    if kind == "paged":
        return JPaged(**GEOM), PagedKVCache(**GEOM, device="cpu")
    dense = dict(num_layers=2, hidden=16, max_seqs=3, max_len=16)
    return JDense(**dense), DenseKVCache(**dense, device="cpu")


@pytest.mark.parametrize("kind", ["paged", "dense"])
def test_export_span_equals_the_reference(kind):
    """The same prompt writes into both packages' caches (slot 0's
    pages interleaved with slot 1's), then every span — inside one page,
    across page boundaries, empty, the whole prompt — exports equal."""
    j, t = _caches(kind)
    rng = np.random.RandomState(3)
    j.admit(1, 3)
    t.admit(1, 3)
    j.admit(0, 13)
    t.admit(0, 13)
    kb, vb = j.buffers()
    for layer in range(GEOM["num_layers"]):
        k = rng.standard_normal((1, 13, 16)).astype(np.float32)
        v = rng.standard_normal((1, 13, 16)).astype(np.float32)
        rows = j.rows_for([0])
        kb, vb = j.write_prompt(kb, vb, layer, k, v, rows)
        t.write_prompt(layer, torch.from_numpy(k), torch.from_numpy(v),
                       torch.from_numpy(rows))
    j.set_buffers(kb, vb)
    for start, end in ((0, 13), (3, 9), (4, 8), (7, 13), (5, 5), (12, 13)):
        for got, want in zip(t.export_span(0, start, end),
                             j.export_span(0, start, end)):
            assert got.shape == (2, end - start, 16)
            np.testing.assert_array_equal(got, want)
    for got, want in zip(t.export_seq(0, 13), j.export_seq(0, 13)):
        np.testing.assert_array_equal(got, want)
    # a host copy, never a view of the pool
    k0, _ = t.export_seq(0, 13)
    t.import_span(0, 0, k0 + 1, k0 + 1)
    np.testing.assert_array_equal(k0, j.export_seq(0, 13)[0])


@pytest.mark.parametrize("kind", ["paged", "dense"])
def test_import_export_round_trip_is_exact(kind):
    """import_seq then export_seq gives back the same bits, an
    import_span across a page boundary lands where the reference puts
    it (the whole pools agree), and an empty span is a no-op."""
    j, t = _caches(kind)
    rng = np.random.RandomState(4)
    for c in (j, t):
        c.admit(2, 6)
        c.admit(0, 11)
    k = rng.standard_normal((2, 11, 16)).astype(np.float32)
    v = rng.standard_normal((2, 11, 16)).astype(np.float32)
    k[0, 0, 0] = np.float32(-0.0)
    for c in (j, t):
        c.import_seq(0, k, v)
    got_k, got_v = t.export_seq(0, 11)
    assert np.array_equal(got_k.view(np.uint32), k.view(np.uint32))
    assert np.array_equal(got_v.view(np.uint32), v.view(np.uint32))
    part = rng.standard_normal((2, 5, 16)).astype(np.float32)
    for c in (j, t):
        c.import_span(2, 2, part, -part)
        c.import_span(0, 4, part[:, :0], part[:, :0])
    jk, jv = j.buffers()
    np.testing.assert_array_equal(t.k.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(t.v.numpy(), np.asarray(jv))
    for got, want in zip(t.export_span(2, 2, 7), (part, -part)):
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# engines


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "seeded"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_prefill_detached_and_decode_prefilled_match_the_reference(
        mode, sampled):
    """Each prompt's detached prefill gives the JAX engine's first token,
    finish and K/V (the prefix-cache mode hits its cache on the last two
    prompts); a fresh decode engine of each package then decodes the
    handoffs to the same tokens (token parity 1.0), and one request that
    finishes at prefill ships no K/V."""
    jp, tp = _engines(mode)
    jd, td = _engines(mode)
    prompts = _prompts()
    kws = _sampling(sampled)
    kws[2] = dict(kws[2], max_new_tokens=1)
    jh, th = [], []
    for p, kw in zip(prompts, kws):
        (a, a_done, a_why) = jp.prefill_detached(p, JSamplingParams(**kw))
        (b, b_done, b_why) = tp.prefill_detached(p, SamplingParams(**kw))
        assert (b_done, b_why) == (a_done, a_why)
        _same_handoff(b, a)
        if not a_done:
            jh.append(a)
            th.append(b)
    assert len(th) == len(prompts) - 1
    if mode == "chunked_prefix":
        assert tp.cache.prefix_counters() == jp.cache.prefix_counters()
        assert tp.cache.prefix_counters()["hits"] >= 2
    # the decode engine consumes the port's handoffs and the JAX engine
    # its own: each side's own K/V, as two clusters would
    want = jd.decode_prefilled(jh)
    got = td.decode_prefilled(th)
    assert [(r.tokens, r.finish_reason, r.prompt_len) for r in got] == \
        [(r.tokens, r.finish_reason, r.prompt_len) for r in want]
    assert td.cache.check_invariants()
    assert td.cache.free_slots() == list(range(GEN["max_seqs"]))


@pytest.mark.parametrize("mode", sorted(MODES))
def test_prefill_stream_matches_the_reference(mode):
    """Chunk by chunk: the same chunk boundaries and ``final`` dicts,
    the chunks' K/V within the tolerance, and their concatenation equal
    to the detached prefill's export.  Legacy scheduling refuses to
    stream in both packages."""
    jp, tp = _engines(mode)
    prompts = _prompts()
    kws = _sampling(True)
    if mode == "legacy":
        _raises_alike(lambda: list(jp.prefill_stream(prompts[0])),
                      lambda: list(tp.prefill_stream(prompts[0])))
        return
    for p, kw in zip(prompts, kws):
        j_items = list(jp.prefill_stream(p, JSamplingParams(**kw)))
        t_items = list(tp.prefill_stream(p, SamplingParams(**kw)))
        assert [(i["kind"], i.get("start"), i.get("end"))
                for i in t_items] == [(i["kind"], i.get("start"),
                                       i.get("end")) for i in j_items]
        assert t_items[-1] == j_items[-1]
        for a, b in zip(j_items[:-1], t_items[:-1]):
            _close_kv(b["k"], a["k"])
            _close_kv(b["v"], a["v"])
    assert tp.cache.free_slots() == list(range(GEN["max_seqs"]))
    # the stream's chunks put together are the detached prefill's K/V
    p = prompts[3]
    items = list(tp.prefill_stream(p))
    handoff, _, _ = tp.prefill_detached(p)
    ks = np.concatenate([i["k"] for i in items[:-1]], axis=1)
    np.testing.assert_array_equal(ks, handoff.kv_k)
    assert items[-1]["last_token"] == handoff.last_token


@pytest.mark.parametrize("mode", ["chunked", "chunked_prefix"])
def test_stream_verbs_match_the_reference(mode):
    """stream_open / stream_chunk / stream_commit / stream_abort: the
    same return values and the same errors, and a committed stream
    adopted by ``decode_prefilled`` decodes the JAX engine's tokens."""
    jp, tp = _engines(mode)
    jd, td = _engines(mode)
    prompts = _prompts()
    sp = dict(max_new_tokens=10, temperature=0.8, top_k=12)
    # the prefill side, and a second prompt sharing two pages with it
    # (a cache hit on the prefix-cache decode engine)
    src = {}
    for name, p in (("a", prompts[1]), ("b", prompts[4])):
        j_items = list(jp.prefill_stream(p, JSamplingParams(**sp)))
        t_items = list(tp.prefill_stream(p, SamplingParams(**sp)))
        src[name] = (p, j_items, t_items)
    j_handoffs, t_handoffs = [], []
    for name in ("a", "b"):
        p, j_items, t_items = src[name]
        cached = jd.stream_open(name, p, JSamplingParams(**sp))
        assert td.stream_open(name, p, SamplingParams(**sp)) == cached
        _raises_alike(lambda: jd.stream_open(name, p),
                      lambda: td.stream_open(name, p))
        # whole chunks, each forwarded from the start (the overlap with
        # what is resident is dropped), then the final token
        for dst, items in ((jd, j_items), (td, t_items)):
            got = [dst.stream_chunk(name, i["start"], i["k"], i["v"])
                   for i in items[:-1]]
            assert got[-1] == len(p)
        _raises_alike(lambda: jd.stream_chunk(name, len(p) + 1,
                                              j_items[0]["k"],
                                              j_items[0]["v"]),
                      lambda: td.stream_chunk(name, len(p) + 1,
                                              t_items[0]["k"],
                                              t_items[0]["v"]))
        j_handoffs.append(jd.stream_commit(name, j_items[-1]["last_token"]))
        t_handoffs.append(td.stream_commit(name,
                                           t_items[-1]["last_token"]))
        assert t_handoffs[-1].stream == name
        assert td.stream_handoff(name) is t_handoffs[-1]
    if mode == "chunked_prefix":
        assert td.cache.prefix_counters() == jd.cache.prefix_counters()
        assert td.cache.prefix_counters()["hits"] == 1
    want = jd.decode_prefilled(j_handoffs)
    got = td.decode_prefilled(t_handoffs)
    assert [r.tokens for r in got] == [r.tokens for r in want]
    # errors and the leak guard
    p = prompts[0]
    for dst in (jd, td):
        dst.stream_open("c", p)
    k3 = np.zeros((CFG.num_layers, 3, CFG.hidden_size), np.float32)
    k4 = np.zeros((CFG.num_layers, 4, CFG.hidden_size), np.float32)
    for call in (lambda e: e.stream_chunk("c", 2, k3, k3),
                 lambda e: e.stream_chunk("c", 0, k4, k4),
                 lambda e: e.stream_commit("c", 1),
                 lambda e: e.stream_handoff("c"),
                 lambda e: e.stream_chunk("zz", 0, k3, k3),
                 lambda e: e.stream_commit("zz", 1),
                 lambda e: e.decode_prefilled([PrefillHandoff(
                     3, 1, SamplingParams(), stream="zz")])):
        _raises_alike(lambda: call(jd), lambda: call(td))
    assert td.stream_abort("c") == jd.stream_abort("c") is True
    assert td.stream_abort("c") == jd.stream_abort("c") is False
    assert td.cache.free_slots() == jd.cache.free_slots()
    assert td.cache.check_invariants()


def test_handoff_guards_match_the_reference():
    """Bad input to the handoff entry points fails in both packages the
    same way: an empty or too long prompt, streams on a legacy engine,
    K/V that does not cover the prompt, a pool that can never hold it."""
    jp, tp = _engines("chunked")
    jl, tl = _engines("legacy")
    k = np.zeros((CFG.num_layers, 4, CFG.hidden_size), np.float32)
    short = PrefillHandoff(5, 1, SamplingParams(), k, k)
    streamed = PrefillHandoff(5, 1, SamplingParams(), stream="s")
    for jfn, tfn in (
            (lambda: jp.prefill_detached([]),
             lambda: tp.prefill_detached([])),
            (lambda: jp.prefill_detached([1] * 60, JSamplingParams(
                max_new_tokens=8)),
             lambda: tp.prefill_detached([1] * 60, SamplingParams(
                 max_new_tokens=8))),
            (lambda: list(jp.prefill_stream([])),
             lambda: list(tp.prefill_stream([]))),
            (lambda: jl.stream_open("s", [1, 2]),
             lambda: tl.stream_open("s", [1, 2])),
            (lambda: jp.decode_prefilled([short]),
             lambda: tp.decode_prefilled([short])),
            (lambda: jl.decode_prefilled([streamed]),
             lambda: tl.decode_prefilled([streamed])),
            (lambda: jp.decode_prefilled([PrefillHandoff(
                60, 1, JSamplingParams(max_new_tokens=8), k, k)]),
             lambda: tp.decode_prefilled([PrefillHandoff(
                 60, 1, SamplingParams(max_new_tokens=8), k, k)]))):
        _raises_alike(jfn, tfn)
