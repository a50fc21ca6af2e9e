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

The engine runs on the card unless it is given ``device="cpu"``; with
no card and no device it raises.  Not ported: the cluster
prefill/decode handoff (its methods raise NotImplementedError).
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
from .kv_cache import (CacheFullError, DenseKVCache, PagedKVCache,
                       _cluster_handoff)
from .sampler import (SamplingParams, batch_sampling_arrays, fold_data_for,
                      root_key_data, sample_tokens_folded,
                      speculative_accept)

__all__ = ["GenerationConfig", "GenerationEngine", "GenerationResult",
           "StreamEvent"]

_DTYPES = {"float32": torch.float32}


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
      attention (None -> 1).
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
    - ``dtype``: cache and parameter dtype ("float32").
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
            raise NotImplementedError(
                f"dtype {self.dtype!r}: the port runs float32 (bf16 is "
                f"later work)")


@dataclasses.dataclass
class GenerationResult:
    tokens: list                 # generated ids (includes eos if hit)
    finish_reason: str           # "stop" | "length"
    prompt_len: int


StreamEvent = collections.namedtuple(
    "StreamEvent", ["index", "token", "finished", "finish_reason"])


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
    token sampled yet — or DECODING)."""

    __slots__ = ("index", "prompt", "plen", "sp", "uid", "fed",
                 "last_tok", "n_gen", "last_emit")

    def __init__(self, index, prompt, sp, uid):
        self.index = index
        self.prompt = prompt
        self.plen = int(prompt.size)
        self.sp = sp
        self.uid = uid
        self.fed = 0
        self.last_tok = None
        self.n_gen = 0
        self.last_emit = None


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
        dtype = _DTYPES[cfg.dtype]
        self.params = lm_params_from_numpy(params, self.device, dtype)
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
            free = self.cache.free_slots()
            if not free or not self.cache.can_admit(req.plen):
                return
            queue.popleft()
            slot = free[0]
            # with the prefix cache, the leading cached blocks are
            # spliced in and prefill starts at the first miss
            req.fed = self.cache.admit(slot, req.plen, tokens=req.prompt)
            if self._drafter is not None:
                self._drafter.admit(slot, req.prompt)
            active[slot] = req
            order.append(slot)

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


for _name in ("prefill_detached", "prefill_stream", "stream_prefilled",
              "decode_prefilled", "stream_open", "stream_chunk",
              "stream_commit", "stream_handoff", "stream_abort"):
    setattr(GenerationEngine, _name, _cluster_handoff(_name))
