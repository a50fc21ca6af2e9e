"""GenerationEngine — continuous-batching autoregressive decoding.

Counterpart of paddle_tpu/generation/engine.py.  Two schedulers share
the host-side machinery (``GenerationConfig.scheduling``):

* ``"chunked"`` (default) — every iteration runs ONE step of fixed row
  count R = (max_seqs + prefill-chunk blocks) * block_rows.  A step
  carries an arbitrary mix of DECODE rows (one per live sequence),
  PREFILL-CHUNK rows (the next slice of an admitted prompt) and
  speculative VERIFY WINDOWS; every row writes its K/V into the paged
  cache at its position and attends over keys 0..position of its
  sequence through the unified ragged attention
  (generation/ragged_attention.py) — on the card, one launch of the
  hand-written CUDA kernel per layer.
* ``"legacy"`` — the original split: one PREFILL per (batch bucket x
  prompt-length bucket), whose prompt self-attention is the plain
  causal attention of ops/attention.py, plus a decode-only step over all
  slots whose attention reads the paged cache through the paged decode
  attention (generation/attention.py) — on the card, one launch of its
  hand-written CUDA kernel per layer.

The rest of a step is plain PyTorch: embedding, layer norm, dense layers
with GELU, the tied logits product and sampling.

CONTINUOUS BATCHING: between steps the host admits queued requests into
free slots (pages permitting) and retires finished ones (EOS /
max_new_tokens), recycling their pages.

Sampling randomness is SCHEDULE-INVARIANT and bit-identical to the JAX
engine's: each (request uid, position) folds its own key out of the
root key (sampler.sample_tokens_folded), so both schedulers, and both
packages, draw the same tokens for the same requests.

PREFIX CACHE (``prefix_cache=True``, chunked + paged): admission splices
the indexed pages of a prompt's cached leading blocks and starts prefill
at the first miss; a fully fed prompt publishes its blocks.

SPECULATIVE DECODING (``speculation=``, chunked only): each decoding
sequence may spend leftover chunk blocks on a verify window — its last
token plus up to spec_k drafted tokens (generation/drafter.py) — scored
as ragged rows of the SAME step.  Acceptance is exact prefix matching
(sampler.speculative_accept), so the tokens equal plain decoding's;
rejected tail pages roll back through ``kv_cache.truncate_to``.

OBSERVABILITY, as in the JAX engine: the warmup shapes, every chunked
step (``generation:chunk_step``), legacy prefill group
(``generation:prefill_b{B}x{S}``) and decode step
(``generation:decode_step``) run inside an ``observability.tracing``
span with the JAX engine's args; a finished sequence drops a
``seq_finish`` note in the flight recorder; ``stats`` are the
registry-backed ``GenerationStats``.

PREFILL/DECODE DISAGGREGATION (the cluster tier): ``prefill_detached``
runs one prompt's prefill and exports its K/V as a numpy
``PrefillHandoff``; ``prefill_stream`` yields the K/V chunk by chunk as
each prefill chunk retires; ``stream_open``/``stream_chunk``/
``stream_commit`` import streamed chunks into a pre-admitted slot; and
``decode_prefilled`` decodes handoffs (inline K/V, or a committed
stream adopted by id) through either scheduler.

The engine runs on the card unless it is given ``device="cpu"``; with
no card and no device it raises.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import time

import numpy as np
import torch

from .. import _cuda
from .._device import resolve_device
from ..models.transformer import (lm_embed, lm_layer_finish, lm_layer_qkv,
                                  lm_logits, lm_params_from_numpy)
from ..observability import flightrec as _flightrec
from ..observability import tracing as _tracing
from ..ops.attention import attention_packed
from ..serving.buckets import BucketError, ShapeBucketer
from ..serving.config import ServingConfig
from ..serving.stats import GenerationStats
from .drafter import make_drafter
from .kv_cache import CacheFullError, DenseKVCache, PagedKVCache
from .sampler import (SamplingParams, batch_sampling_arrays, fold_data_for,
                      root_key_data, sample_tokens_folded,
                      speculative_accept)

__all__ = ["GenerationConfig", "GenerationEngine", "GenerationResult",
           "StreamEvent", "PrefillHandoff"]

#: the KV cache's dtypes, by the names jnp.dtype gives them (the
#: parameters and the model's arithmetic stay float32 whatever the cache)
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def _pow2_buckets(lo, hi):
    out = []
    b = lo
    while b < hi:
        out.append(b)
        b *= 2
    out.append(hi)
    return tuple(out)


def _cdiv(a, b):
    return -(-a // b)


@dataclasses.dataclass
class GenerationConfig:
    """Engine knobs.

    - ``page_size``: tokens per KV page.
    - ``num_pages``: page-pool size (page 0 is reserved scratch).  None
      derives the no-contention maximum: every slot can hold a
      max-length sequence.
    - ``max_seqs``: decode slots.
    - ``max_seq_len``: per-sequence capacity (prompt + generated); must
      be a multiple of page_size.
    - ``scheduling``: ``"chunked"`` (the unified step, the default) or
      ``"legacy"`` (bucketed prefill + decode step).
    - ``prefill_chunk``: prompt tokens fed per chunked step (default
      min(16, max_seq_len)).
    - ``ragged_block_rows``: rows per page-table binding in the ragged
      attention (None -> ``resolve_block_rows``: the
      ``PADDLE_TPU_RAGGED_BM`` override, the tuning store, then 1).
    - ``prefill_batch_buckets`` / ``prefill_seq_buckets``: the closed
      prefill shape grid of LEGACY scheduling (ShapeBucketer semantics;
      powers of two up to max_seqs and from page_size up to
      max_seq_len by default).
    - ``use_paged``: the paged cache (False = the dense cache, whose
      attention is plain PyTorch).
    - ``prefix_cache``: the refcounted global prefix cache over the
      paged pool; token-for-token identical to ``False``.  Needs
      ``use_paged=True`` and ``scheduling='chunked'``.
    - ``speculation``: ``None`` (off), ``"ngram"`` (self-drafting) or
      ``"draft"`` (a small draft model: pass
      ``GenerationEngine(draft_model=(cfg, params))``); chunked only,
      token-for-token identical to ``None``.
    - ``spec_k``: max drafted tokens per sequence per step (the verify
      window is spec_k + 1 rows).
    - ``spec_ngram``: longest suffix n-gram the ngram drafter matches.
    - ``reference_attention``: run the plain PyTorch attention instead
      of the CUDA kernels — the parity oracle, never chosen implicitly.
    - ``dtype``: the KV cache's dtype: "float32", "bfloat16" or
      "float16".  The parameters stay float32 and the model computes in
      float32; only K/V are rounded as they enter the cache (the JAX
      engine's rule).
    - ``seed``: sampling root seed (per-token fold keys).
    """

    page_size: int = 16
    num_pages: int = None
    max_seqs: int = 4
    max_seq_len: int = 128
    scheduling: str = "chunked"
    prefill_chunk: int = None
    ragged_block_rows: int = None
    prefill_batch_buckets: tuple = None
    prefill_seq_buckets: tuple = None
    use_paged: bool = True
    prefix_cache: bool = False
    reference_attention: bool = False
    dtype: str = "float32"
    seed: int = 0
    speculation: str = None
    spec_k: int = 4
    spec_ngram: int = 3

    def __post_init__(self):
        if self.max_seq_len % self.page_size:
            raise ValueError(
                f"max_seq_len {self.max_seq_len} must be a multiple of "
                f"page_size {self.page_size}")
        if self.scheduling not in ("chunked", "legacy"):
            raise ValueError(
                f"scheduling must be 'chunked' or 'legacy', got "
                f"{self.scheduling!r}")
        if self.prefill_chunk is None:
            self.prefill_chunk = min(16, self.max_seq_len)
        if self.prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        if self.ragged_block_rows is not None \
                and self.ragged_block_rows < 1:
            raise ValueError("ragged_block_rows must be >= 1")
        if self.num_pages is None:
            self.num_pages = (
                self.max_seqs * (self.max_seq_len // self.page_size) + 1)
        if self.prefill_batch_buckets is None:
            self.prefill_batch_buckets = _pow2_buckets(
                1, max(1, self.max_seqs))
        if self.prefill_seq_buckets is None:
            self.prefill_seq_buckets = _pow2_buckets(
                min(self.page_size, self.max_seq_len), self.max_seq_len)
        if self.speculation is not None:
            if self.speculation not in ("ngram", "draft"):
                raise ValueError(
                    f"speculation must be None, 'ngram' or 'draft', got "
                    f"{self.speculation!r}")
            if self.scheduling != "chunked":
                raise ValueError(
                    "speculation needs scheduling='chunked': verify "
                    "windows are scored as ragged chunk rows of the "
                    "unified step, which legacy scheduling does not have")
            if self.spec_k < 1:
                raise ValueError(f"spec_k must be >= 1, got {self.spec_k}")
            if self.spec_k + 1 > self.prefill_chunk:
                # a window that can NEVER fit the step's chunk rows would
                # silently disable speculation: fail at construction
                raise ValueError(
                    f"spec_k {self.spec_k} needs a {self.spec_k + 1}-row "
                    f"verify window but prefill_chunk is "
                    f"{self.prefill_chunk} rows (shared by all "
                    f"{self.max_seqs} max_seqs slots): lower spec_k or "
                    f"raise prefill_chunk")
            if self.spec_ngram < 1:
                raise ValueError(
                    f"spec_ngram must be >= 1, got {self.spec_ngram}")
        if self.prefix_cache:
            if not self.use_paged:
                raise ValueError(
                    "prefix_cache=True requires use_paged=True: prefix "
                    "reuse splices shared PAGES into new page tables; "
                    "the dense cache has no page indirection to share")
            if self.scheduling != "chunked":
                raise ValueError(
                    "prefix_cache=True requires scheduling='chunked': "
                    "prefill must be able to start mid-prompt at the "
                    "first uncached block, which the bucketed legacy "
                    "prefill grid cannot")
        if max(self.prefill_seq_buckets) > self.max_seq_len:
            # a bucket-padded prompt longer than max_seq_len would index
            # past the page table
            raise ValueError(
                f"prefill_seq_buckets {self.prefill_seq_buckets} exceed "
                f"max_seq_len {self.max_seq_len}")
        if self.dtype not in _DTYPES:
            raise ValueError(
                f"dtype {self.dtype!r}: the KV cache takes one of "
                f"{sorted(_DTYPES)}")


@dataclasses.dataclass
class GenerationResult:
    tokens: list                 # generated ids (includes eos if hit)
    finish_reason: str           # "stop" | "length"
    prompt_len: int


StreamEvent = collections.namedtuple(
    "StreamEvent", ["index", "token", "finished", "finish_reason"])


@dataclasses.dataclass
class PrefillHandoff:
    """The serialized result of a detached prefill — everything a DECODE
    engine needs to continue a sequence another process prefilled: the
    prompt's K/V for every layer as host arrays [L, prompt_len, H]
    (page layout is NOT part of the contract; each side scatters into
    its own cache), the first sampled token, and the sampling params.
    numpy-only so it pickles over the cluster control plane.  The K/V
    arrays are the prefill cache's words (bfloat16 as raw 16-bit words:
    kv_cache.kv_to_host)."""

    prompt_len: int
    last_token: int
    sampling: SamplingParams
    kv_k: np.ndarray = None      # None when the request finished at
    kv_v: np.ndarray = None      # prefill (eos / max_new_tokens == 1)
    # prompt token ids [prompt_len] i32 — lets the DECODE side look up /
    # register the prompt in ITS prefix index, so a system prompt
    # prefilled once becomes a cache hit fleet-wide
    prompt_tokens: np.ndarray = None
    # set when the decode engine ALREADY holds the pages, imported
    # chunk-by-chunk under this stream id (see stream_open/stream_chunk/
    # stream_commit): kv_k/kv_v may then be None and admission adopts
    # the pre-admitted slot instead of importing
    stream: object = None


class _Active:
    """Legacy-scheduler in-flight state (post-prefill decode only)."""

    __slots__ = ("index", "sp", "last_tok", "n_gen", "uid", "last_emit")

    def __init__(self, index, sp, last_tok, uid, last_emit=None):
        self.index = index
        self.sp = sp
        self.last_tok = last_tok
        self.n_gen = 1
        self.uid = uid
        self.last_emit = last_emit


class _ChunkReq:
    """One in-flight request under chunked scheduling: prompt-feed
    progress and decode state (a request is PREFILLING — fed < plen, no
    token sampled yet — or DECODING).  A ``handoff`` (prefilled in
    another engine) starts out decoding."""

    __slots__ = ("index", "prompt", "plen", "sp", "uid", "handoff",
                 "fed", "last_tok", "n_gen", "last_emit")

    def __init__(self, index, prompt, sp, uid, handoff=None):
        self.index = index
        self.sp = sp
        self.uid = uid
        self.handoff = handoff
        self.last_emit = None
        if handoff is None:
            self.prompt = prompt
            self.plen = int(prompt.size)
            self.fed = 0
            self.last_tok = None
            self.n_gen = 0
        else:                    # externally prefilled: decode-only
            self.prompt = None
            self.plen = int(handoff.prompt_len)
            self.fed = self.plen
            self.last_tok = int(handoff.last_token)
            self.n_gen = 1


class GenerationEngine:
    """Continuous-batching decoder over a paged (or dense) KV cache.

    ``model_cfg`` is a models.BertConfig (the lm_* architecture);
    ``params`` the flat "lm.*" dict of numpy arrays or tensors (moved
    to ``device``).  ``device=None`` is the CUDA card and raises when
    there is none.  ``draft_model=(cfg, params)`` is the draft LM of
    ``speculation="draft"``."""

    def __init__(self, model_cfg, params, config=None, device=None,
                 draft_model=None):
        self.cfg = cfg = config or GenerationConfig()
        self.device = resolve_device(device)
        self.model_cfg = model_cfg
        dtype = _DTYPES[cfg.dtype]          # the cache's, not the model's
        self.params = lm_params_from_numpy(params, self.device)
        h = model_cfg.hidden_size
        self._sm_scale = 1.0 / math.sqrt(h // model_cfg.num_heads)
        if cfg.max_seq_len > model_cfg.max_position:
            # a position past the table would index out of range (an
            # assert on the card, where JAX would clamp): fail here
            raise ValueError(
                f"max_seq_len {cfg.max_seq_len} exceeds the model's "
                f"max_position {model_cfg.max_position}")
        cache_cls = PagedKVCache if cfg.use_paged else DenseKVCache
        self.cache = cache_cls(
            num_layers=model_cfg.num_layers, hidden=h,
            page_size=cfg.page_size, num_pages=cfg.num_pages,
            max_seqs=cfg.max_seqs, max_len=cfg.max_seq_len, dtype=dtype,
            device=self.device, prefix_cache=cfg.prefix_cache)
        # in-flight cross-process KV streams (decode side): stream id ->
        # {slot, plen, received, tokens, sampling, ready}
        self._streams = {}
        self._bucketer = ShapeBucketer(ServingConfig(
            batch_buckets=cfg.prefill_batch_buckets,
            seq_buckets=cfg.prefill_seq_buckets))
        self.stats = GenerationStats()
        self._root = torch.as_tensor(
            root_key_data(cfg.seed).astype(np.int64), device=self.device)
        self._uid = 0
        S = cfg.max_seqs
        self._slot_temps = np.zeros(S, np.float32)
        self._slot_tks = np.zeros(S, np.int32)
        self._slot_tps = np.ones(S, np.float32)
        if cfg.scheduling == "chunked" and cfg.ragged_block_rows is None:
            from .ragged_attention import resolve_block_rows

            # the env override, the tuning store, then 1 (as the JAX
            # engine resolves it)
            self._bm = resolve_block_rows(
                S + cfg.prefill_chunk, model_cfg.num_heads,
                h // model_cfg.num_heads, cfg.page_size, dtype=cfg.dtype,
                device=self.device)
        else:
            self._bm = int(cfg.ragged_block_rows or 1)
        self._nb = S + _cdiv(cfg.prefill_chunk, self._bm)  # row blocks
        self._rows = self._nb * self._bm                   # step shape R
        if cfg.speculation == "draft" and draft_model is None:
            raise ValueError(
                "speculation='draft' needs GenerationEngine("
                "draft_model=(cfg, params))")
        self._drafter = None
        if cfg.speculation is not None:
            self._drafter = make_drafter(
                cfg.speculation, spec_ngram=cfg.spec_ngram, max_seqs=S,
                max_len=cfg.max_seq_len, draft_model=draft_model,
                dtype=dtype, device=self.device)
        self._warmed = False

    def _next_uid(self):
        uid = self._uid
        self._uid += 1
        return uid

    def _to_device(self, a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            device=self.device, dtype=dtype)

    def _sampling_tensors(self, fold, temps, tks, tps):
        return (self._to_device(fold.astype(np.int64), torch.int64),
                self._to_device(temps, torch.float32),
                self._to_device(tks, torch.int32),
                self._to_device(tps, torch.float32))

    # -- step bodies -------------------------------------------------------
    def _chunk_fn(self, toks, pos, write_rows, tables, row_lens, fold,
                  temps, tks, tps, greedy_only):
        """R mixed rows (decode + prefill chunk + verify window +
        inactive): toks/pos/row_lens [R] -> next tokens [R].  Each row
        writes its K/V at its position (inactive rows to scratch) and
        attends over keys 0..row_lens-1 of its block's page-table row."""
        cfg, cache, params = self.model_cfg, self.cache, self.params
        with torch.no_grad():
            x = lm_embed(params, cfg, toks, pos)              # [R, H]
            for i in range(cfg.num_layers):
                q, k, v = lm_layer_qkv(params, cfg, i, x)
                cache.write_token(i, k, v, write_rows, pos)
                ctxt = cache.attend_rows(
                    q, i, tables, row_lens, cfg.num_heads, self._sm_scale,
                    block_rows=self._bm,
                    reference=self.cfg.reference_attention)
                x = lm_layer_finish(params, cfg, i, x, ctxt)
            logits = lm_logits(params, cfg, x)                # [R, V]
            return sample_tokens_folded(logits, self._root, fold, temps,
                                        tks, tps, greedy_only=greedy_only)

    def _prefill_fn(self, tokens, lens, rows, fold, temps, tks, tps,
                    greedy_only):
        """Legacy prefill: tokens [B, T] (bucket-padded), lens [B] ->
        the first token of each prompt [B].  Each layer writes the whole
        prompt's K/V into the cache; the prompt self-attention needs no
        cache read (causal over the prompt itself; the pad tail comes
        after every real query)."""
        cfg, cache, params = self.model_cfg, self.cache, self.params
        B, T = tokens.shape
        with torch.no_grad():
            pos = torch.arange(T, device=self.device).expand(B, T)
            x = lm_embed(params, cfg, tokens, pos)            # [B, T, H]
            for i in range(cfg.num_layers):
                q, k, v = lm_layer_qkv(params, cfg, i, x)
                cache.write_prompt(i, k, v, rows)
                ctxt = attention_packed(q, k, v, cfg.num_heads, causal=True,
                                        sm_scale=self._sm_scale)
                x = lm_layer_finish(params, cfg, i, x, ctxt)
            h_last = x[torch.arange(B, device=self.device), lens - 1]
            logits = lm_logits(params, cfg, h_last)           # [B, V]
            return sample_tokens_folded(logits, self._root, fold, temps,
                                        tks, tps, greedy_only=greedy_only)

    def _decode_fn(self, toks, pos, rows, eff_lens, fold, temps, tks, tps,
                   greedy_only):
        """Legacy decode step over ALL slots: toks/pos [S] -> next tokens
        [S].  Attention reads each slot's page list through the paged
        decode attention (the dense cache's is plain PyTorch)."""
        cfg, cache, params = self.model_cfg, self.cache, self.params
        with torch.no_grad():
            x = lm_embed(params, cfg, toks, pos)              # [S, H]
            for i in range(cfg.num_layers):
                q, k, v = lm_layer_qkv(params, cfg, i, x)
                cache.write_token(i, k, v, rows, pos)
                ctxt = cache.attend(
                    q, i, rows, eff_lens, cfg.num_heads, self._sm_scale,
                    reference=self.cfg.reference_attention)
                x = lm_layer_finish(params, cfg, i, x, ctxt)
            logits = lm_logits(params, cfg, x)                # [S, V]
            return sample_tokens_folded(logits, self._root, fold, temps,
                                        tks, tps, greedy_only=greedy_only)

    def _run_chunk(self, toks, pos, write_rows, tables, lens, fold, temps,
                   tks, tps, greedy_only):
        """Ship one chunked step's host arrays to the device, run it, and
        bring the sampled tokens back (the one synchronisation)."""
        i32, i64 = torch.int32, torch.int64
        nxt = self._chunk_fn(
            self._to_device(toks, i64), self._to_device(pos, i64),
            self._to_device(write_rows, i32), self._to_device(tables, i32),
            self._to_device(lens, i32),
            *self._sampling_tensors(fold, temps, tks, tps), greedy_only)
        return nxt.cpu().numpy()

    def _run_prefill(self, tokens, lens, rows, fold, temps, tks, tps,
                     greedy_only):
        i32, i64 = torch.int32, torch.int64
        nxt = self._prefill_fn(
            self._to_device(tokens, i64), self._to_device(lens, i64),
            self._to_device(rows, i32),
            *self._sampling_tensors(fold, temps, tks, tps), greedy_only)
        return nxt.cpu().numpy()

    def _run_decode(self, toks, pos, rows, eff, fold, greedy_only):
        i32, i64 = torch.int32, torch.int64
        nxt = self._decode_fn(
            self._to_device(toks, i64), self._to_device(pos, i64),
            self._to_device(rows, i32), self._to_device(eff, i32),
            *self._sampling_tensors(fold, self._slot_temps, self._slot_tks,
                                    self._slot_tps), greedy_only)
        return nxt.cpu().numpy()

    # -- lifecycle ---------------------------------------------------------
    def warmup(self):
        """Run every step shape the scheduler can emit once against
        scratch storage (writes land in scratch, lengths are 0), so the
        kernel libraries are built and loaded before traffic.  Chunked
        scheduling runs its ONE step shape in both sampling variants
        (verify windows reuse it; a draft model runs its own step once);
        legacy runs every prefill bucket plus the decode step in both
        variants.  Returns the compile count."""
        if self.cfg.scheduling == "chunked":
            R, NB = self._rows, self._nb
            write_rows = self.cache.rows_for([None] * R)
            tables = self.cache.rows_for([None] * NB)
            z = np.zeros(R, np.int32)
            with _tracing.span(f"generation:warmup_chunk_r{R}"):
                for greedy_only in (True, False):
                    self._run_chunk(z, z, write_rows, tables, z,
                                    np.zeros(R, np.uint32),
                                    np.zeros(R, np.float32), z,
                                    np.ones(R, np.float32), greedy_only)
            if self._drafter is not None:
                with _tracing.span("generation:warmup_drafter"):
                    self._drafter.warmup()
        else:
            for sb in self.cfg.prefill_seq_buckets:
                for bb in self.cfg.prefill_batch_buckets:
                    temps, tks, tps = batch_sampling_arrays([], bb)
                    with _tracing.span(f"generation:warmup_b{bb}x{sb}"):
                        for greedy_only in (True, False):
                            self._run_prefill(
                                np.zeros((bb, sb), np.int32),
                                np.ones(bb, np.int32),
                                self.cache.rows_for([None] * bb),
                                np.zeros(bb, np.uint32), temps, tks, tps,
                                greedy_only)
            S = self.cfg.max_seqs
            z = np.zeros(S, np.int32)
            with _tracing.span("generation:warmup_decode"):
                for greedy_only in (True, False):
                    self._run_decode(z, z, self.cache.rows_for([None] * S),
                                     z, np.zeros(S, np.uint32), greedy_only)
        self._warmed = True
        self.stats.mark_warmup_done(self.compile_count())
        return self.compile_count()

    @property
    def warmed(self):
        return self._warmed

    def compile_count(self):
        """Kernel libraries built or loaded by this process (the port's
        only compiles; PyTorch runs the rest, a draft model included,
        eagerly)."""
        return _cuda.library_loads()

    def ledger_counters(self):
        """Cumulative request-ledger work counters (a cheap read — a
        worker diffs these around each op).  Prefix reuse is converted
        from pages to the cached-prefix TOKENS actually spliced."""
        c = self.stats.ledger_counters()
        c["prefix_tokens"] = (c.pop("prefix_pages_reused")
                              * self.cfg.page_size)
        return c

    # -- client API --------------------------------------------------------
    def generate(self, prompts, sampling=None):
        """Run `prompts` (list of int sequences) to completion; returns
        a GenerationResult per prompt, in order."""
        results = [None] * len(prompts)
        toks = [[] for _ in prompts]
        for ev in self.stream(prompts, sampling=sampling):
            toks[ev.index].append(ev.token)
            if ev.finished:
                results[ev.index] = GenerationResult(
                    tokens=toks[ev.index],
                    finish_reason=ev.finish_reason,
                    prompt_len=len(prompts[ev.index]))
        return results

    def stream(self, prompts, sampling=None):
        """Generator of StreamEvent(index, token, finished, reason) —
        tokens surface the step they are decoded, interleaved across
        requests exactly as the continuous batch produces them."""
        if sampling is None:
            sampling = SamplingParams()
        sp_list = (list(sampling) if isinstance(sampling, (list, tuple))
                   else [sampling] * len(prompts))
        if len(sp_list) != len(prompts):
            raise ValueError("sampling list length != prompts length")
        chunked = self.cfg.scheduling == "chunked"
        queue = collections.deque()
        for i, (prompt, sp) in enumerate(zip(prompts, sp_list)):
            p = np.asarray(prompt, np.int32).reshape(-1)
            if p.size < 1:
                raise ValueError(f"prompt {i} is empty")
            if p.size + sp.max_new_tokens > self.cfg.max_seq_len:
                raise ValueError(
                    f"prompt {i}: len {p.size} + max_new_tokens "
                    f"{sp.max_new_tokens} exceeds max_seq_len "
                    f"{self.cfg.max_seq_len}")
            if not chunked:
                # chunked scheduling has no prompt-length grid
                try:
                    self._bucketer.seq_bucket(p.size)
                except BucketError as e:
                    raise ValueError(f"prompt {i}: {e}") from e
            uid = self._next_uid()
            queue.append(_ChunkReq(i, p, sp, uid) if chunked
                         else (i, p, sp, uid))
        if chunked:
            yield from self._run_chunked(queue)
            return
        active = {}
        try:
            while queue or active:
                n_before = len(queue)
                yield from self._admit(queue, active)
                if active:
                    yield from self._decode_step(active)
                elif queue and len(queue) == n_before:
                    raise CacheFullError(
                        f"request with prompt len {queue[0][1].size} can "
                        f"never be admitted: page pool "
                        f"({self.cfg.num_pages} pages of "
                        f"{self.cfg.page_size}) too small")
        finally:
            # an abandoned generator must not leak slots/pages
            for slot in list(active):
                self._finish(slot)
            active.clear()

    # -- prefill/decode disaggregation (cluster tier) ----------------------
    def _check_prompt(self, prompt, sp):
        p = np.asarray(prompt, np.int32).reshape(-1)
        if p.size < 1:
            raise ValueError("prompt is empty")
        if p.size + sp.max_new_tokens > self.cfg.max_seq_len:
            raise ValueError(
                f"prompt len {p.size} + max_new_tokens "
                f"{sp.max_new_tokens} exceeds max_seq_len "
                f"{self.cfg.max_seq_len}")
        return p

    def prefill_detached(self, prompt, sampling=None):
        """Run ONE prompt's prefill and export the result instead of
        decoding it here: returns ``(handoff, done, reason)``.  The slot
        used for the forward is released before returning — a prefill
        worker's cache only ever holds prompts in flight, so its pool
        can stay small while the DECODE pool (which holds sequences for
        their whole generation) scales independently.  Under chunked
        scheduling the prompt feeds through the SAME unified step as
        everything else (no bucketed prefill)."""
        sp = sampling or SamplingParams()
        p = self._check_prompt(prompt, sp)
        chunked = self.cfg.scheduling == "chunked"
        if not chunked:
            try:
                sb = self._bucketer.seq_bucket(p.size)
            except BucketError as e:
                raise ValueError(str(e)) from e
        free = self.cache.free_slots()
        if not free or not self.cache.can_admit(p.size):
            raise CacheFullError(
                f"no slot/pages for a {p.size}-token detached prefill")
        slot = free[0]
        if chunked:
            req = _ChunkReq(0, p, sp, self._next_uid())
            req.fed = self.cache.admit(slot, p.size, tokens=p)
            active, order = {slot: req}, [slot]
            try:
                ev = None
                while slot in active and req.n_gen < 1:
                    for e in self._chunk_step(active, order):
                        ev = e
                return self._detached_result(slot, p, sp, ev)
            finally:
                if slot in active:
                    self._finish(slot)
        self.cache.admit(slot, p.size)
        active = {}
        try:
            ev = list(self._prefill_group(
                [(0, p, sp, slot, self._next_uid())], active, sb))[0]
            return self._detached_result(slot, p, sp, ev)
        finally:
            # _prefill_group released the slot iff the request finished;
            # otherwise it parked it in `active` — hand the pages back
            if slot in active:
                self._finish(slot)

    def _detached_result(self, slot, p, sp, ev):
        if ev.finished:
            return (PrefillHandoff(int(p.size), ev.token, sp,
                                   prompt_tokens=p),
                    True, ev.finish_reason)
        k_seq, v_seq = self.cache.export_seq(slot, int(p.size))
        return (PrefillHandoff(int(p.size), ev.token, sp, k_seq, v_seq,
                               prompt_tokens=p), False, None)

    def prefill_stream(self, prompt, sampling=None):
        """Chunk-granular detached prefill: a generator that yields the
        KV of each prefill chunk AS IT RETIRES from the unified step —
        the producer half of cluster page streaming, overlapping wire
        transfer with the remaining prefill compute.

        Yields ``{"kind": "chunk", "start", "end", "k", "v"}`` items
        ([L, end-start, H] host arrays of the cache's words,
        ``kv_cache.kv_to_host``) covering positions [0, plen),
        then one ``{"kind": "final", "prompt_len", "last_token",
        "done", "finish_reason", "cached_len"}``.  A locally-cached
        prefix is exported from the pool in the first chunk (no
        recompute).  When ``done`` is True the request finished at
        prefill and no KV is shipped (the trailing chunks are elided).
        The slot is released on exhaustion or close, same as
        :meth:`prefill_detached`."""
        sp = sampling or SamplingParams()
        p = self._check_prompt(prompt, sp)
        if self.cfg.scheduling != "chunked":
            raise ValueError(
                "prefill_stream requires scheduling='chunked': chunk "
                "retirement is what the stream yields")
        free = self.cache.free_slots()
        if not free or not self.cache.can_admit(p.size):
            raise CacheFullError(
                f"no slot/pages for a {p.size}-token streamed prefill")
        slot = free[0]
        req = _ChunkReq(0, p, sp, self._next_uid())
        req.fed = cached = self.cache.admit(slot, p.size, tokens=p)
        active, order = {slot: req}, [slot]
        try:
            if cached:
                k_seq, v_seq = self.cache.export_span(slot, 0, cached)
                yield {"kind": "chunk", "start": 0, "end": cached,
                       "k": k_seq, "v": v_seq}
            ev = None
            while slot in active and req.n_gen < 1:
                prev = req.fed
                for e in self._chunk_step(active, order):
                    ev = e
                if slot in active and req.fed > prev:
                    k_seq, v_seq = self.cache.export_span(
                        slot, prev, req.fed)
                    yield {"kind": "chunk", "start": prev,
                           "end": req.fed, "k": k_seq, "v": v_seq}
            yield {"kind": "final", "prompt_len": int(p.size),
                   "last_token": int(ev.token),
                   "done": bool(ev.finished),
                   "finish_reason": ev.finish_reason,
                   "cached_len": int(cached)}
        finally:
            if slot in active:
                self._finish(slot)

    # -- decode-side streamed-page import (cluster tier) -------------------
    def stream_open(self, stream_id, prompt_tokens, sampling=None):
        """Pre-admit a slot for a prompt whose KV will arrive in
        streamed chunks.  The prompt is looked up in THIS pool's prefix
        index first; returns cached_len — the caller may skip shipping
        the already-resident span."""
        if self.cfg.scheduling != "chunked":
            raise ValueError(
                "stream_open requires scheduling='chunked'")
        if stream_id in self._streams:
            raise ValueError(f"KV stream {stream_id!r} already open")
        sp = sampling or SamplingParams()
        p = self._check_prompt(prompt_tokens, sp)
        free = self.cache.free_slots()
        if not free or not self.cache.can_admit(p.size):
            raise CacheFullError(
                f"no slot/pages to pre-admit a {p.size}-token stream")
        slot = free[0]
        cached = self.cache.admit(slot, p.size, tokens=p)
        self._streams[stream_id] = {
            "slot": slot, "plen": int(p.size), "received": int(cached),
            "tokens": p, "sampling": sp, "ready": None}
        if self.cfg.prefix_cache:
            self.stats.update_prefix(self.cache.prefix_counters())
        return int(cached)

    def stream_chunk(self, stream_id, start, k_seq, v_seq):
        """Import one streamed chunk [start, start+T).  Chunks must
        arrive in order but may overlap the already-resident span (the
        overlap is dropped).  Returns positions received so far."""
        info = self._streams.get(stream_id)
        if info is None:
            raise ValueError(f"unknown KV stream {stream_id!r}")
        start = int(start)
        end = start + int(k_seq.shape[1])
        if start > info["received"]:
            raise ValueError(
                f"stream {stream_id!r}: chunk starts at {start} but "
                f"only {info['received']} positions received")
        if end > info["plen"]:
            raise ValueError(
                f"stream {stream_id!r}: chunk ends at {end}, past the "
                f"{info['plen']}-token prompt")
        if end > info["received"]:
            off = info["received"] - start
            self.cache.import_span(info["slot"], info["received"],
                                   k_seq[:, off:], v_seq[:, off:])
            info["received"] = end
        return info["received"]

    def stream_commit(self, stream_id, last_token):
        """Seal a fully-received stream: register its prefix blocks in
        this pool's index and stage a decode-ready handoff that
        ``stream_prefilled`` adopts by stream id."""
        info = self._streams.get(stream_id)
        if info is None:
            raise ValueError(f"unknown KV stream {stream_id!r}")
        if info["received"] < info["plen"]:
            raise ValueError(
                f"stream {stream_id!r} incomplete: {info['received']}/"
                f"{info['plen']} positions received")
        self.cache.register_prefix(info["slot"], info["tokens"])
        info["ready"] = PrefillHandoff(
            info["plen"], int(last_token), info["sampling"],
            prompt_tokens=info["tokens"], stream=stream_id)
        if self.cfg.prefix_cache:
            self.stats.update_prefix(self.cache.prefix_counters())
        return info["ready"]

    def stream_handoff(self, stream_id):
        """The staged decode-ready handoff for a committed stream."""
        info = self._streams.get(stream_id)
        if info is None or info["ready"] is None:
            raise ValueError(
                f"unknown or uncommitted KV stream {stream_id!r}")
        return info["ready"]

    def stream_abort(self, stream_id):
        """Release a stream's pre-admitted slot and partial pages (the
        decode-side leak guard).  Idempotent: an unknown or already
        adopted stream is a no-op."""
        info = self._streams.pop(stream_id, None)
        if info is None:
            return False
        self.cache.release(info["slot"])
        return True

    def stream_prefilled(self, handoffs):
        """Continuous-batching decode over externally prefilled
        sequences: the decode half of the disaggregated pair.  Yields
        StreamEvents exactly like :meth:`stream` (index = position in
        ``handoffs``), but the events cover only the DECODE phase — the
        handoff's ``last_token`` (the prefill worker's first sample) is
        already accounted as generated token #1 and is NOT re-emitted."""
        queue = collections.deque()
        for i, h in enumerate(handoffs):
            if h.prompt_len + h.sampling.max_new_tokens \
                    > self.cfg.max_seq_len:
                raise ValueError(
                    f"handoff {i}: prompt_len {h.prompt_len} + "
                    f"max_new_tokens {h.sampling.max_new_tokens} exceeds "
                    f"max_seq_len {self.cfg.max_seq_len}")
            if h.stream is not None:
                if self.cfg.scheduling != "chunked":
                    raise ValueError(
                        f"handoff {i}: stream adoption requires "
                        f"scheduling='chunked'")
            elif h.kv_k is None or h.kv_k.shape[1] != h.prompt_len:
                raise ValueError(
                    f"handoff {i}: kv arrays must cover the prompt "
                    f"({h.prompt_len} positions)")
            queue.append((i, h))
        if self.cfg.scheduling == "chunked":
            creqs = collections.deque(
                _ChunkReq(i, None, h.sampling, self._next_uid(),
                          handoff=h)
                for i, h in queue)
            yield from self._run_chunked(creqs)
            return
        active = {}
        try:
            while queue or active:
                progressed = False
                while queue:
                    i, h = queue[0]
                    free = self.cache.free_slots()
                    if not free or not self.cache.can_admit(h.prompt_len):
                        break
                    queue.popleft()
                    slot = free[0]
                    self.cache.admit(slot, h.prompt_len)
                    self.cache.import_seq(slot, h.kv_k, h.kv_v)
                    sp = h.sampling
                    self._slot_temps[slot] = sp.temperature
                    self._slot_tks[slot] = sp.top_k
                    self._slot_tps[slot] = sp.top_p
                    active[slot] = _Active(i, sp, int(h.last_token),
                                           self._next_uid())
                    progressed = True
                if active:
                    yield from self._decode_step(active)
                elif queue and not progressed:
                    raise CacheFullError(
                        f"handoff with prompt len {queue[0][1].prompt_len}"
                        f" can never be admitted: page pool too small")
        finally:
            for slot in list(active):
                self._finish(slot)
            active.clear()

    def decode_prefilled(self, handoffs):
        """Drive :meth:`stream_prefilled` to completion; returns one
        ``GenerationResult`` per handoff (tokens INCLUDE the prefill
        worker's first token, so the result equals what the
        single-process engine would have produced)."""
        results = [None] * len(handoffs)
        toks = [[h.last_token] for h in handoffs]
        for ev in self.stream_prefilled(handoffs):
            toks[ev.index].append(ev.token)
            if ev.finished:
                results[ev.index] = GenerationResult(
                    tokens=toks[ev.index], finish_reason=ev.finish_reason,
                    prompt_len=handoffs[ev.index].prompt_len)
        return results

    # -- chunked scheduler internals ---------------------------------------
    def _run_chunked(self, queue):
        """Admit whole requests (pages for the full prompt + 1 token
        reserved up front), then run unified steps until the queue and
        the batch drain."""
        active, order = {}, []
        try:
            while queue or active:
                n_before = len(queue)
                self._admit_chunked(queue, active, order)
                if active:
                    yield from self._chunk_step(active, order)
                elif queue and len(queue) == n_before:
                    raise CacheFullError(
                        f"request with prompt len {queue[0].plen} can "
                        f"never be admitted: page pool "
                        f"({self.cfg.num_pages} pages of "
                        f"{self.cfg.page_size}) too small")
        finally:
            # an abandoned generator must not leak slots/pages
            for slot in list(active):
                self._finish(slot)
            active.clear()
            order.clear()

    def _admit_chunked(self, queue, active, order):
        while queue:
            req = queue[0]
            h = req.handoff
            if h is not None and h.stream is not None:
                # pages already imported chunk-by-chunk under this
                # stream id: adopt the pre-admitted slot, no allocation
                queue.popleft()
                slot = self._adopt_stream(req)
            else:
                free = self.cache.free_slots()
                if not free or not self.cache.can_admit(req.plen):
                    return
                queue.popleft()
                slot = free[0]
                if h is not None:
                    cached = self.cache.admit(slot, req.plen,
                                              tokens=h.prompt_tokens)
                    # cached positions are already resident (spliced
                    # from the prefix index, maybe shared with another
                    # sequence) — import only the rest
                    if cached < req.plen:
                        self.cache.import_span(slot, cached,
                                               h.kv_k[:, cached:],
                                               h.kv_v[:, cached:])
                    self.cache.register_prefix(slot, h.prompt_tokens)
                else:
                    # with the prefix cache, the leading cached blocks
                    # are spliced in and prefill starts at the first miss
                    req.fed = self.cache.admit(slot, req.plen,
                                               tokens=req.prompt)
            if self._drafter is not None:
                # drafter history = prompt + emitted tokens; a handoff
                # without prompt tokens sees only the emitted stream
                # (weaker drafts, same correctness)
                if req.prompt is not None:
                    hist = [int(t) for t in req.prompt]
                elif h is not None and h.prompt_tokens is not None:
                    hist = ([int(t) for t in h.prompt_tokens]
                            + [int(req.last_tok)])
                else:
                    hist = [int(req.last_tok)]
                self._drafter.admit(slot, hist)
            active[slot] = req
            order.append(slot)

    def _adopt_stream(self, req):
        info = self._streams.pop(req.handoff.stream, None)
        if info is None or info.get("ready") is None:
            raise ValueError(
                f"unknown or uncommitted KV stream "
                f"{req.handoff.stream!r}")
        return info["slot"]

    def _chunk_step(self, active, order):
        """ONE unified step: a decode row (or a speculative VERIFY
        WINDOW) per live decoding sequence + prefill-chunk rows for
        admitted prompts still feeding, packed into the fixed R-row
        shape.

        A verify window is rows w_0..w_{W-1} of one sequence — w_0 its
        committed last token, w_1.. the drafter's proposals — laid out
        like a prefill chunk (consecutive positions, ``lens = pos + 1``)
        in the step's tail blocks.  The sample of row j is the model's
        schedule-invariant draw for position p+j+1, so acceptance is
        prefix matching.  Prefill chunks keep priority in the tail
        blocks; windows take the leftovers; a sequence that gets no
        window (no drafts, no blocks, no pages) takes its decode row."""
        S, bm, NB, R = self.cfg.max_seqs, self._bm, self._nb, self._rows
        toks = np.zeros(R, np.int32)
        pos = np.zeros(R, np.int32)
        lens = np.zeros(R, np.int32)
        fold = np.zeros(R, np.uint32)
        temps = np.zeros(R, np.float32)
        tks = np.zeros(R, np.int32)
        tps = np.ones(R, np.float32)
        write_slots = [None] * R     # per-row write routing (None=scratch)
        table_slots = [None] * NB    # per-block attend binding

        def fill(r, slot, st, tok, p):
            toks[r] = tok
            pos[r] = p
            lens[r] = p + 1
            fold[r] = fold_data_for(st.uid, p)
            temps[r] = st.sp.temperature
            tks[r] = st.sp.top_k
            tps[r] = st.sp.top_p
            write_slots[r] = slot

        # prefill chunks into the tail blocks, admission order: the
        # head-of-line prompt fills first, leftovers go to the next
        blk = S
        fed_now = {}                 # slot -> row of its last fed token
        n_chunk_toks = 0
        for slot in order:
            st = active[slot]
            if st.fed >= st.plen or blk >= NB:
                continue
            while blk < NB and st.fed < st.plen:
                base = blk * bm
                n = min(bm, st.plen - st.fed)
                for j in range(n):
                    fill(base + j, slot, st, int(st.prompt[st.fed + j]),
                         st.fed + j)
                table_slots[blk] = slot
                fed_now[slot] = base + n - 1
                st.fed += n
                n_chunk_toks += n
                blk += 1
        decode_rows = []             # (slot, row) plain decode
        spec_wins = []               # (slot, base_row, window tokens)
        for slot in order:
            st = active[slot]
            if st.fed < st.plen or slot in fed_now:
                # still prefilling — or its prompt finished feeding IN
                # THIS step (its first token samples from the chunk's
                # last row); either way no decode row yet
                continue
            p = int(self.cache.seq_lens[slot])
            win = None
            if self._drafter is not None and blk < NB:
                # a window only pays off with >= 1 draft beyond the
                # last-token row; clamp to the request's remaining budget
                # so no row indexes past max_seq_len
                wmax = min(self.cfg.spec_k + 1,
                           st.sp.max_new_tokens - st.n_gen,
                           (NB - blk) * bm)
                if wmax >= 2:
                    drafts = self._drafter.draft(slot, wmax - 1)
                    if drafts:
                        try:
                            self.cache.ensure(slot, p + 1 + len(drafts))
                            win = ([int(st.last_tok)]
                                   + [int(d) for d in drafts])
                        except CacheFullError:
                            win = None   # no pages: plain decode below
            if win is not None:
                base = blk * bm
                for j, w in enumerate(win):
                    fill(base + j, slot, st, w, p + j)
                nblk = _cdiv(len(win), bm)
                for b in range(nblk):
                    table_slots[blk + b] = slot
                blk += nblk
                spec_wins.append((slot, base, win))
                continue
            try:
                self.cache.ensure(slot, p + 1)
            except CacheFullError:
                # oversubscribed pool: this sequence STALLS (keeps its
                # state, skips this step) and retries once a finishing
                # sequence returns pages
                continue
            r = slot * bm            # decode block s <-> slot s
            fill(r, slot, st, st.last_tok, p)
            table_slots[slot] = slot
            decode_rows.append((slot, r))
        if not decode_rows and not fed_now and not spec_wins:
            raise CacheFullError(
                f"decode deadlock: all {len(active)} live sequences "
                f"need a new KV page and the pool is exhausted — "
                f"num_pages={self.cfg.num_pages} cannot sustain "
                f"max_seqs={self.cfg.max_seqs} at these lengths")
        write_rows = self.cache.rows_for(write_slots)
        tables = self.cache.rows_for(table_slots)
        greedy_only = all(st.sp.temperature == 0
                          for st in active.values())
        n_spec_rows = sum(len(w) for _, _, w in spec_wins)
        t0 = time.perf_counter()
        with _tracing.span("generation:chunk_step",
                           decode=len(decode_rows),
                           chunk_tokens=n_chunk_toks,
                           spec_rows=n_spec_rows):
            nxt = self._run_chunk(toks, pos, write_rows, tables, lens, fold,
                                  temps, tks, tps, greedy_only)
        dt = time.perf_counter() - t0
        self.stats.on_step()
        n_rows = len(decode_rows) + n_chunk_toks + n_spec_rows
        # settle EVERY slot's state (release or keep) BEFORE the first
        # yield: an abandoned generator then only sees fully-accounted
        # slots, which the stream's finally-block knows how to release
        now = time.perf_counter()
        events = []
        for slot, last_row in fed_now.items():
            st = active[slot]
            if st.fed < st.plen:
                continue             # prompt still mid-feed, no sample
            # every prompt position now has final KV: publish the full
            # blocks (before any release below, so a request finishing
            # at prefill still leaves its prefix for reuse)
            self.cache.register_prefix(slot, st.prompt)
            tok = int(nxt[last_row])
            st.n_gen = 1
            done, reason = self._is_done(tok, 1, st.sp)
            if done:
                self._retire(active, order, slot)
            else:
                st.last_tok = tok
                st.last_emit = now
                if self._drafter is not None:
                    self._drafter.commit(slot, [tok])
            events.append(StreamEvent(st.index, tok, done, reason))
        n_spec_emitted = 0
        for slot, base, win in spec_wins:
            st = active[slot]
            model = [int(nxt[base + j]) for j in range(len(win))]
            n_acc, emitted = speculative_accept(win[1:], model)
            self.stats.on_spec(len(win) - 1, n_acc)
            first = True
            finished = False
            for tok in emitted:
                tok = int(tok)
                self.cache.advance(slot)
                st.n_gen += 1
                n_spec_emitted += 1
                done, reason = self._is_done(tok, st.n_gen, st.sp)
                if st.last_emit is not None:
                    # the window's tokens materialize together; only the
                    # first paid a step of latency
                    self.stats.on_inter_token(
                        (now - st.last_emit) * 1e3 if first else 0.0)
                st.last_emit = now
                first = False
                events.append(StreamEvent(st.index, tok, done, reason))
                if done:
                    self._retire(active, order, slot)
                    finished = True
                    break
            if not finished:
                st.last_tok = int(emitted[-1])
                self._drafter.commit(slot, [int(t) for t in emitted])
                # rollback: return pages past the committed length (+1
                # headroom for the next write); rejected rows' KV is
                # never read and is overwritten by the next tokens
                self.cache.truncate_to(
                    slot, int(self.cache.seq_lens[slot]) + 1)
        for slot, r in decode_rows:
            st = active[slot]
            self.cache.advance(slot)
            tok = int(nxt[r])
            st.n_gen += 1
            done, reason = self._is_done(tok, st.n_gen, st.sp)
            if st.last_emit is not None:
                self.stats.on_inter_token((now - st.last_emit) * 1e3)
            st.last_emit = now
            if done:
                self._retire(active, order, slot)
            else:
                st.last_tok = tok
                if self._drafter is not None:
                    self._drafter.commit(slot, [tok])
            events.append(StreamEvent(st.index, tok, done, reason))
        if n_chunk_toks:
            self.stats.on_prefill(n_chunk_toks,
                                  dt * n_chunk_toks / n_rows)
            self.stats.on_prefill_chunks(len(fed_now))
        if decode_rows or spec_wins:
            # decode throughput counts EMITTED tokens: a window that
            # lands n_acc + 1 tokens in one step IS the speedup
            self.stats.on_decode(len(decode_rows) + n_spec_emitted,
                                 dt * (len(decode_rows) + n_spec_rows)
                                 / n_rows, self.cache.occupancy())
        self.stats.set_compiles(self.compile_count())
        if self.cfg.prefix_cache:
            self.stats.update_prefix(self.cache.prefix_counters())
        yield from events

    def _retire(self, active, order, slot):
        del active[slot]
        order.remove(slot)
        self._finish(slot)
        self.stats.on_request_done()

    # -- legacy scheduler internals ----------------------------------------
    def _admit(self, queue, active):
        """Move queued requests into free cache slots, grouped into one
        bucketed prefill per run of prompts in the same length bucket.
        Pages/slots are claimed as requests are popped, so each
        can_admit check sees the already-decremented pool."""
        max_b = max(self.cfg.prefill_batch_buckets)
        while queue:
            free = self.cache.free_slots()
            if not free or not self.cache.can_admit(queue[0][1].size):
                return
            sb = self._bucketer.seq_bucket(queue[0][1].size)
            group = []
            while (queue and len(group) < min(max_b, len(free))
                   and self._bucketer.seq_bucket(queue[0][1].size) == sb
                   and self.cache.can_admit(queue[0][1].size)):
                idx, prompt, sp, uid = queue.popleft()
                slot = free[len(group)]
                self.cache.admit(slot, prompt.size)
                group.append((idx, prompt, sp, slot, uid))
            yield from self._prefill_group(group, active, sb)

    def _prefill_group(self, group, active, sb):
        B = len(group)
        Bpad = self._bucketer.batch_bucket(B)
        tokens = np.zeros((Bpad, sb), np.int32)
        lens = np.ones(Bpad, np.int32)
        fold = np.zeros(Bpad, np.uint32)
        slots = [slot for _, _, _, slot, _ in group]
        temps, tks, tps = batch_sampling_arrays(
            [sp for _, _, sp, _, _ in group], Bpad)
        for i, (idx, prompt, sp, slot, uid) in enumerate(group):
            tokens[i, :prompt.size] = prompt
            lens[i] = prompt.size
            fold[i] = fold_data_for(uid, prompt.size - 1)
            self._slot_temps[slot] = sp.temperature
            self._slot_tks[slot] = sp.top_k
            self._slot_tps[slot] = sp.top_p
        rows = self.cache.rows_for(slots + [None] * (Bpad - B))
        greedy_only = all(sp.temperature == 0 for _, _, sp, _, _ in group)
        t0 = time.perf_counter()
        with _tracing.span(f"generation:prefill_b{Bpad}x{sb}",
                           n_prompts=B):
            first = self._run_prefill(tokens, lens, rows, fold, temps, tks,
                                      tps, greedy_only)
        self.stats.on_prefill(int(sum(p.size for _, p, _, _, _ in group)),
                              time.perf_counter() - t0)
        self.stats.set_compiles(self.compile_count())
        # settle every member (release or register in `active`) before
        # the first yield, so an abandoned generator leaks nothing
        now = time.perf_counter()
        events = []
        for i, (idx, prompt, sp, slot, uid) in enumerate(group):
            tok = int(first[i])
            done, reason = self._is_done(tok, 1, sp)
            if done:
                self._finish(slot)
                self.stats.on_request_done()
            else:
                active[slot] = _Active(idx, sp, tok, uid, last_emit=now)
            events.append(StreamEvent(idx, tok, done, reason))
        yield from events

    def _decode_step(self, active):
        S = self.cfg.max_seqs
        toks = np.zeros(S, np.int32)
        pos = np.zeros(S, np.int32)
        eff = np.zeros(S, np.int32)
        fold = np.zeros(S, np.uint32)
        stalled = []
        for slot, st in active.items():
            p = int(self.cache.seq_lens[slot])
            try:
                self.cache.ensure(slot, p + 1)
            except CacheFullError:
                # oversubscribed pool: this sequence STALLS (keeps its
                # state, skips this step) and retries once a finishing
                # sequence returns pages — it must not abort the batch
                stalled.append(slot)
                continue
            toks[slot] = st.last_tok
            pos[slot] = p
            eff[slot] = p + 1
            fold[slot] = fold_data_for(st.uid, p)
        if len(stalled) == len(active):
            raise CacheFullError(
                f"decode deadlock: all {len(active)} live sequences "
                f"need a new KV page and the pool is exhausted — "
                f"num_pages={self.cfg.num_pages} cannot sustain "
                f"max_seqs={self.cfg.max_seqs} at these lengths")
        rows = self.cache.rows_for(None)
        for slot in stalled:
            # no page for this slot's next position: route its (unused)
            # write to scratch so it cannot clobber live KV
            rows[slot] = self.cache.scratch_row()
        greedy_only = not bool(self._slot_temps.any())
        t0 = time.perf_counter()
        with _tracing.span("generation:decode_step",
                           active=len(active) - len(stalled)):
            nxt = self._run_decode(toks, pos, rows, eff, fold, greedy_only)
        self.stats.on_decode(len(active) - len(stalled),
                             time.perf_counter() - t0,
                             self.cache.occupancy())
        self.stats.set_compiles(self.compile_count())
        now = time.perf_counter()
        events = []
        for slot in list(active):
            if slot in stalled:
                continue
            st = active[slot]
            self.cache.advance(slot)
            tok = int(nxt[slot])
            st.n_gen += 1
            done, reason = self._is_done(tok, st.n_gen, st.sp)
            if st.last_emit is not None:
                self.stats.on_inter_token((now - st.last_emit) * 1e3)
            st.last_emit = now
            if done:
                del active[slot]
                self._finish(slot)
                self.stats.on_request_done()
            else:
                st.last_tok = tok
            events.append(StreamEvent(st.index, tok, done, reason))
        yield from events

    @staticmethod
    def _is_done(tok, n_gen, sp):
        if sp.eos_id is not None and tok == sp.eos_id:
            return True, "stop"
        if n_gen >= sp.max_new_tokens:
            return True, "length"
        return False, None

    def _finish(self, slot):
        if self._drafter is not None:
            self._drafter.release(slot)
        self.cache.release(slot)
        _flightrec.note("seq_finish", slot=int(slot),
                        engine=self.stats.engine_id)
        self._slot_temps[slot] = 0.0
        self._slot_tks[slot] = 0
        self._slot_tps[slot] = 1.0
