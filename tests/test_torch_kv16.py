"""The port's 16-bit KV cache (``GenerationConfig.dtype`` "bfloat16" and
"float16") against the JAX package's, on the CPU.

Only the cache is 16-bit: the parameters stay float32, the model computes
in float32, and K/V round to the cache's type as they enter it.  Two
rounding contracts hold for the attention over 16-bit pages, as in the
JAX package (generation/attention.py's module doc):

* the reference (``paged_ref_decode_attention``, ``ragged_ref_attention``,
  the engine's path on the CPU) against the JAX references on the same
  pages: within one unit in the last place of the type (2^-7 relative
  for bfloat16's 8 significant bits, 2^-10 for float16's 11) — both
  round p and the context to the type and sum the float32 products in
  another order, so a context may round to the neighbouring value;
* the plain version on the TPU kernel's contract
  (``paged_flash_plain_decode_attention``, ``ragged_flash_plain_attention``,
  what the CUDA kernels are held against on the card) against the Pallas
  kernels in interpret mode: within ``attention.contract_bound`` — both
  round each p_j to the type, the Pallas kernel relative to a page's
  running maximum and the plain version relative to the row's, so a
  term may part by 2u of p_j |v_j| (u = 2^-8, 2^-11).

Engines at BertConfig.tiny() width (initializer_range 0.6): the port's
tokens equal the JAX engine's (parity 1.0) in chunked and legacy
scheduling, the dense cache, the prefix cache and both speculation modes,
greedy and seeded.  A cache's exported pages are its own words (bfloat16
as raw 16-bit words under the record dtype BF16_WORDS, which names it),
compared as bits with the JAX cache's: within one unit in the last
place where no rounded cache entry fed them (see the test).
"""
import dataclasses
import pickle
import socket
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from paddle_tpu.generation import GenerationConfig as JGenerationConfig
from paddle_tpu.generation import GenerationEngine as JGenerationEngine
from paddle_tpu.generation import SamplingParams as JSamplingParams
from paddle_tpu.generation import attention as ja
from paddle_tpu.generation import ragged_attention as jr
from paddle_tpu.models import BertConfig as JBertConfig
from paddle_tpu.models import lm_random_params as j_lm_random_params
from paddle_tpu_torch.cluster.rpc import recv_msg, send_msg
from paddle_tpu_torch.generation import (DenseKVCache, DraftModelDrafter,
                                         GenerationConfig, GenerationEngine,
                                         PagedKVCache, SamplingParams)
from paddle_tpu_torch.generation import attention as ta
from paddle_tpu_torch.generation import ragged_attention as tr
from paddle_tpu_torch.generation.kv_cache import (BF16_WORDS, kv_from_host,
                                                  kv_to_host)
from paddle_tpu_torch.models import BertConfig

torch.set_num_threads(2)

DTYPES = {"bfloat16": (torch.bfloat16, jnp.bfloat16),
          "float16": (torch.float16, jnp.float16)}
#: one unit in the last place, relative (8 and 11 significant bits)
ULP = {"bfloat16": 2.0 ** -7, "float16": 2.0 ** -10}

CFG = dataclasses.replace(BertConfig.tiny(), initializer_range=0.6)
JCFG = dataclasses.replace(JBertConfig.tiny(), initializer_range=0.6)
PARAMS = j_lm_random_params(JCFG, np.random.RandomState(0))
GEN = dict(page_size=8, max_seqs=4, max_seq_len=64, seed=7)
MODES = {"chunked": {}, "legacy": dict(scheduling="legacy"),
         "legacy_dense": dict(scheduling="legacy", use_paged=False),
         "prefix_cache": dict(prefix_cache=True),
         "ngram": dict(speculation="ngram", spec_k=3),
         "draft": dict(speculation="draft", spec_k=3)}


# ---------------------------------------------------------------------------
# the plain attention of 16-bit pages against the JAX functions


def _pages(dtype, S=5, PS=8, pps=4, nh=4, D=8, seed=0):
    """q float32, K/V pages in ``dtype`` (the same bits in both
    packages), a page table and lengths (0, 1, a page + 1, two pages +
    1, the capacity)."""
    rng = np.random.RandomState(seed)
    H = nh * D
    NP = S * pps + 1
    q = rng.standard_normal((S, H)).astype(np.float32)
    k = rng.standard_normal((NP, PS, H)).astype(np.float32)
    v = rng.standard_normal((NP, PS, H)).astype(np.float32)
    table = rng.permutation(np.arange(1, NP)).reshape(S, pps).astype(
        np.int32)
    lens = np.array([0, 1, PS + 1, 2 * PS + 1, PS * pps], np.int32)
    tdt, jdt = DTYPES[dtype]
    kt, vt = torch.from_numpy(k).to(tdt), torch.from_numpy(v).to(tdt)
    kj, vj = jnp.asarray(k, jdt), jnp.asarray(v, jdt)
    assert np.array_equal(np.asarray(kj).view(np.uint16),
                          kt.view(torch.int16).numpy().view(np.uint16))
    port = (torch.from_numpy(q), kt, vt, torch.from_numpy(table),
            torch.from_numpy(lens), nh)
    jax_ = (jnp.asarray(q), kj, vj, jnp.asarray(table), jnp.asarray(lens),
            nh)
    return port, jax_


def _ragged(args, R=7):
    """The same pages as ragged rows: row r reads slot r % S's table."""
    q, k, v, table, lens, nh = args
    idx = np.arange(R) % table.shape[0]
    rl = np.array([0, 3, 8, 9, 31, 32, 17], np.int32)
    if isinstance(k, torch.Tensor):
        return (q[idx], k, v, table[idx], torch.from_numpy(rl), nh)
    return (q[idx], k, v, table[idx], jnp.asarray(rl), nh)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("kernel", ["decode", "ragged"])
def test_reference_contract_matches_jax(dtype, kernel):
    port, jax_ = _pages(dtype, seed=1)
    if kernel == "decode":
        got = ta.paged_ref_decode_attention(*port).numpy()
        want = np.asarray(ja.paged_ref_decode_attention(*jax_))
    else:
        got = tr.ragged_ref_attention(*_ragged(port)).numpy()
        want = np.asarray(jr.ragged_ref_attention(*_ragged(jax_)))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=ULP[dtype], atol=1e-7)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("kernel", ["decode", "ragged"])
def test_kernel_contract_matches_pallas_interpret(dtype, kernel):
    port, jax_ = _pages(dtype, seed=2)
    if kernel == "decode":
        plain, args = ta.paged_flash_plain_decode_attention, port
        want = np.asarray(ja.paged_flash_decode_attention(
            *jax_, interpret=True))
    else:
        plain, args = tr.ragged_flash_plain_attention, _ragged(port)
        want = np.asarray(jr.ragged_flash_attention(
            *_ragged(jax_), interpret=True))
    got = plain(*args)
    bound = ta.contract_bound(plain, *args).numpy()
    assert got.dtype == torch.float32
    got = got.numpy()
    assert (np.abs(got - want) <= bound).all(), np.abs(got - want).max()
    live = args[4].numpy() > 0
    assert (got[~live] == 0).all() and (want[~live] == 0).all()
    # the kernel's contract does not round the context: it parts from
    # the reference's by about one unit in the type's last place
    ref = (ta.paged_ref_decode_attention if kernel == "decode"
           else tr.ragged_ref_attention)(*args).numpy()
    assert not np.array_equal(got[live], ref[live])
    np.testing.assert_allclose(got[live], ref[live], rtol=2 * ULP[dtype],
                               atol=2 * ULP[dtype])


# ---------------------------------------------------------------------------
# engines


def _prompts():
    """Prompts of several chunks and pages; the last two share two pages
    with the first (prefix hits), the patterns repeat (n-gram drafts)."""
    rng = np.random.RandomState(3)
    head = np.tile(rng.randint(1, CFG.vocab_size, 4), 5).tolist()
    return [head, rng.randint(1, CFG.vocab_size, 9).tolist(),
            head[:16] + [5, 9, 5, 9], head[:16] + [7]]


def _sampling(sampled, cls):
    knobs = [dict(temperature=0.8, top_k=12, top_p=0.9),
             dict(temperature=1.0), dict(temperature=0.7, top_p=0.5),
             dict(temperature=1.2, top_k=40)]
    return [cls(max_new_tokens=n, **(k if sampled else {}))
            for n, k in zip((12, 10, 14, 9), knobs)]


def _engines(dtype, mode):
    kw = dict(GEN, dtype=dtype, **MODES[mode])
    jdraft = tdraft = None
    if mode == "draft":
        jdraft, tdraft = (JCFG, PARAMS), (CFG, PARAMS)
    return (JGenerationEngine(JCFG, PARAMS, JGenerationConfig(**kw),
                              draft_model=jdraft),
            GenerationEngine(CFG, PARAMS, GenerationConfig(**kw),
                             device="cpu", draft_model=tdraft))


@pytest.mark.parametrize("sampled", [False, True],
                         ids=["greedy", "seeded_sampling"])
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_engine_tokens_equal_jax(dtype, mode, sampled):
    jeng, teng = _engines(dtype, mode)
    assert str(jeng.cache.k.dtype) == dtype
    assert teng.cache.k.dtype == DTYPES[dtype][0]
    # the prefix cache publishes a prompt once it is fed: the first
    # prompt goes alone, so the last two hit its pages
    cut = 1 if mode == "prefix_cache" else 0
    teng.warmup()
    for part in (slice(0, cut), slice(cut, None)):
        want = jeng.generate(_prompts()[part],
                             _sampling(sampled, JSamplingParams)[part])
        got = teng.generate(_prompts()[part],
                            _sampling(sampled, SamplingParams)[part])
        for w, g in zip(want, got):
            assert g.tokens == w.tokens
            assert g.finish_reason == w.finish_reason
    if mode == "prefix_cache":
        assert teng.stats.snapshot()["prefix_hits"] > 0
    if mode in ("ngram", "draft"):
        ts, js = teng.stats.snapshot(), jeng.stats.snapshot()
        assert ts["spec_drafted"] == js["spec_drafted"] > 0
        assert ts["spec_accepted"] == js["spec_accepted"]
    assert teng.stats.snapshot()["compiles_after_warmup"] == 0


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_parameters_stay_float32_under_a_16bit_cache(dtype):
    """The engine's and the draft model's parameters stay float32 and
    only their caches take the 16-bit type, as in the JAX engine."""
    tdt = DTYPES[dtype][0]
    eng = GenerationEngine(CFG, PARAMS, GenerationConfig(
        **GEN, dtype=dtype, speculation="draft", spec_k=3), device="cpu",
        draft_model=(CFG, PARAMS))
    drafter = eng._drafter
    for params in (eng.params, drafter.params):
        assert {p.dtype for p in params.values()} == {torch.float32}
    assert eng.cache.k.dtype == eng.cache.v.dtype == tdt
    assert drafter._cache.k.dtype == tdt
    direct = DraftModelDrafter(CFG, PARAMS, max_seqs=2, max_len=32,
                               dtype=tdt, device="cpu")
    assert {p.dtype for p in direct.params.values()} == {torch.float32}
    assert direct._cache.k.dtype == tdt


@pytest.mark.parametrize("bad", ["int8", "float64", "bf16", "half"])
def test_cache_dtype_is_one_of_three(bad):
    with pytest.raises(ValueError) as e:
        GenerationConfig(**GEN, dtype=bad)
    for name in ("float32", "bfloat16", "float16"):
        assert name in str(e.value)


# ---------------------------------------------------------------------------
# the cache's words and the handoff


def _words(a):
    """A 16-bit array's words as int32 (bfloat16 from either package)."""
    return np.asarray(a).view(np.uint16).astype(np.int32)


def _decoded(words, dtype):
    """16-bit words as float64 values, through torch (no ml_dtypes)."""
    t = torch.from_numpy(words.astype(np.uint16).view(np.int16))
    return t.view(DTYPES[dtype][0]).double().numpy()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("mode", ["chunked", "legacy"])
def test_exported_pages_are_the_jax_caches_within_one_ulp(dtype, mode):
    """A detached prefill of each package exports the prompt's K/V: the
    port's words (BF16_WORDS for bfloat16, float16 as itself), compared
    as bits with the JAX cache's.  K/V that no
    rounded cache entry reached — layer 0, and every layer of legacy
    scheduling, whose prefill attends over the prompt's float32 K/V —
    are within one unit in the last place (both packages compute them in
    float32 in another order, so a value near a rounding boundary may
    round the other way).  A deeper layer of chunked scheduling reads
    the rounded cache, where such a flip moves its inputs by a unit in
    the type's last place: its words are within one bfloat16 ulp at the
    array's scale (2^-7 max|K|), and 98.5% of them are equal."""
    jeng, teng = _engines(dtype, mode)
    for p in _prompts()[:3]:
        jh, jdone, _ = jeng.prefill_detached(p, JSamplingParams(
            max_new_tokens=4))
        th, tdone, _ = teng.prefill_detached(p, SamplingParams(
            max_new_tokens=4))
        assert (tdone, th.last_token) == (jdone, jh.last_token)
        for got, want in ((th.kv_k, jh.kv_k), (th.kv_v, jh.kv_v)):
            assert got.dtype == (BF16_WORDS if dtype == "bfloat16"
                                 else np.float16)
            assert got.shape == want.shape and got.itemsize == 2
            gw, jw = _words(got), _words(want)
            exact = slice(None) if mode == "legacy" else slice(0, 1)
            assert np.abs(gw[exact] - jw[exact]).max() <= 1
            assert np.mean(gw == jw) >= 0.985
            g, j = _decoded(gw, dtype), _decoded(jw, dtype)
            assert np.abs(g - j).max() <= 2.0 ** -7 * np.abs(j).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_kv_words_round_trip(dtype):
    t = torch.randn(2, 5, 8).to(getattr(torch, dtype))
    t[0, 0, 0] = -0.0
    words = kv_to_host(t)
    assert words.itemsize == t.element_size()
    back = kv_from_host(words, "cpu", t.dtype)
    bits = torch.int16 if t.element_size() == 2 else torch.int32
    assert torch.equal(back.view(bits), t.view(bits))
    # the words are a copy: the cache is never aliased
    words[...] = 0
    assert not torch.equal(t, torch.zeros_like(t))


def test_kv_words_must_match_their_named_dtype():
    words = kv_to_host(torch.randn(1, 2, 8).bfloat16())
    assert words.dtype == BF16_WORDS and words.dtype.names == ("bfloat16",)
    # bare 16-bit words name no dtype: they are refused, not guessed
    for bare in (words.view(np.uint16), words.view(np.int16),
                 np.zeros((1, 2, 8), np.int8)):
        with pytest.raises(TypeError, match="BF16_WORDS"):
            kv_from_host(bare, "cpu", torch.bfloat16)
    # the name survives slicing, concatenation and pickling
    for moved in (words[:, 1:], np.concatenate([words, words], axis=1),
                  pickle.loads(pickle.dumps(words))):
        assert moved.dtype == BF16_WORDS
    # a float32 cache takes bfloat16 words, widened exactly
    got = kv_from_host(words, "cpu", torch.float32)
    assert got.dtype == torch.float32
    assert torch.equal(got.bfloat16().float(), got)


def _framed(obj):
    """``obj`` through cluster/rpc.py's framing over a socket pair: the
    object that arrives and the frame's bytes."""
    a, b = socket.socketpair()
    try:
        sender = threading.Thread(target=send_msg, args=(a, obj))
        sender.start()
        got = recv_msg(b)
        sender.join()
    finally:
        a.close()
        b.close()
    return got, len(pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL))


@pytest.mark.parametrize("kind", ["paged", "dense"])
def test_bf16_handoff_ships_words_and_decodes_like_the_monolith(kind):
    """A bf16 prefill engine's handoff through the RPC framing arrives
    as the same bf16 words, imported and exported again bit for bit
    (paged and dense caches), in half a float32 handoff's bytes; a bf16
    decode engine continues it to the monolithic bf16 engine's tokens."""
    p = _prompts()[0]
    sp = SamplingParams(max_new_tokens=10)
    frames = {}
    for dtype in ("bfloat16", "float32"):
        pre = GenerationEngine(CFG, PARAMS, GenerationConfig(
            **GEN, dtype=dtype), device="cpu")
        h, done, _ = pre.prefill_detached(p, sp)
        assert not done
        frames[dtype] = (h, *_framed({"handoff": h}))
    h, got, nbytes = frames["bfloat16"]
    got = got["handoff"]
    assert got.kv_k.dtype == BF16_WORDS
    assert np.array_equal(got.kv_k, h.kv_k)
    assert np.array_equal(got.kv_v, h.kv_v)
    assert 0.49 < nbytes / frames["float32"][2] < 0.52
    geo = dict(num_layers=CFG.num_layers, hidden=CFG.hidden_size,
               max_seqs=2, max_len=64, dtype=torch.bfloat16, device="cpu")
    cache = (PagedKVCache(page_size=8, num_pages=17, **geo)
             if kind == "paged" else DenseKVCache(**geo))
    cache.admit(1, 5)
    cache.admit(0, got.prompt_len)
    cache.import_seq(0, got.kv_k, got.kv_v)
    k, v = cache.export_seq(0, got.prompt_len)
    assert np.array_equal(k, got.kv_k) and np.array_equal(v, got.kv_v)
    decode = GenerationEngine(CFG, PARAMS, GenerationConfig(
        **GEN, dtype="bfloat16",
        scheduling="legacy" if kind == "dense" else "chunked",
        use_paged=kind == "paged"), device="cpu")
    tokens = decode.decode_prefilled([got])[0].tokens
    mono = GenerationEngine(CFG, PARAMS, GenerationConfig(
        **GEN, dtype="bfloat16"), device="cpu").generate([p], sp)[0].tokens
    assert tokens == mono


def test_bf16_stream_chunks_name_their_dtype():
    """prefill_stream's chunks carry the cache's words and name their
    dtype; a bf16 decode engine's stream_chunk imports them and decodes
    to the monolithic tokens."""
    p = _prompts()[0]
    sp = SamplingParams(max_new_tokens=8)
    kw = dict(GEN, dtype="bfloat16")
    pre = GenerationEngine(CFG, PARAMS, GenerationConfig(**kw), device="cpu")
    dec = GenerationEngine(CFG, PARAMS, GenerationConfig(**kw), device="cpu")
    assert dec.stream_open("s", p, sp) == 0
    final = None
    for item in pre.prefill_stream(p, sp):
        if item["kind"] != "chunk":
            final = item
            continue
        assert item["k"].dtype == BF16_WORDS
        dec.stream_chunk("s", item["start"], item["k"], item["v"])
    h = dec.stream_commit("s", final["last_token"])
    tokens = dec.decode_prefilled([h])[0].tokens
    mono = GenerationEngine(CFG, PARAMS, GenerationConfig(**kw),
                            device="cpu").generate([p], sp)[0].tokens
    assert tokens == mono


# ---------------------------------------------------------------------------
# the block_rows search and store, keyed by the cache's dtype


def test_ragged_search_probes_16bit_pages_and_stores_by_dtype(tmp_path,
                                                              monkeypatch):
    """The search's probe carries pages in the cache's dtype; a
    searched bfloat16 block_rows is served to a bfloat16 engine and not
    to a float32 one."""
    from paddle_tpu_torch.generation.ragged_attention import \
        resolve_block_rows
    from paddle_tpu_torch.ops import autotune as at
    from paddle_tpu_torch.tuning import TuningStore, make_key, search_geometry

    monkeypatch.setenv("PADDLE_TPU_AUTOTUNE_CACHE",
                       str(tmp_path / "autotune.json"))
    monkeypatch.delenv("PADDLE_TPU_RAGGED_BM", raising=False)
    cpu = torch.device("cpu")
    q, k, v, lens, _, _ = at.ragged_probe(8, 4, 8, 8, 4, cpu,
                                          dtype="bfloat16")
    assert q.dtype == torch.float32 and k.dtype == v.dtype == torch.bfloat16
    r = search_geometry("ragged", "r8h4d8p8", dtype="bfloat16", reps=1,
                        force_time=True, device=cpu)
    assert all(c.get("parity") for c in r["candidates"])
    entry = TuningStore().get(make_key("ragged", "cpu", "r8h4d8p8",
                                       "bfloat16"))
    assert entry["config"] == r["config"]
    assert TuningStore().get(make_key("ragged", "cpu", "r8h4d8p8",
                                      "float32")) is None
    bm = r["config"]["block_rows"]
    assert resolve_block_rows(8, 4, 8, 8, dtype="bfloat16",
                              device=cpu) == bm
    assert resolve_block_rows(8, 4, 8, 8, dtype="float32", device=cpu) == 1


def test_server_over_a_bf16_engine_gives_the_jax_engines_tokens():
    """GenerationBackend and InferenceServer pass the engine through: a
    bf16 engine behind the server answers with the JAX bf16 engine's
    tokens, and nothing loads after warmup."""
    from paddle_tpu_torch.generation import GenerationBackend
    from paddle_tpu_torch.serving import InferenceServer, ServingConfig

    jeng, teng = _engines("bfloat16", "chunked")
    prompts = _prompts()[:3]
    want = jeng.generate(prompts, [JSamplingParams(max_new_tokens=6)] * 3)
    backend = GenerationBackend(teng, max_new_tokens=6)
    server = InferenceServer(backend, ServingConfig(
        batch_buckets=(1, 2, 4), seq_buckets=(16, 32),
        pad_values={"prompt_lens": 1}, max_batch_wait_ms=20)).start()
    try:
        server.warmup()
        answers = []
        for p in prompts:
            p = np.asarray(p, np.int32)
            out, n = server.infer({"token_ids": p[None],
                                   "prompt_lens": np.array([p.size],
                                                           np.int32)})
            answers.append(out[0, :int(n[0])].tolist())
        stats = server.stats()
    finally:
        server.close()
    assert answers == [r.tokens for r in want]
    assert stats["compiles_after_warmup"] == 0
