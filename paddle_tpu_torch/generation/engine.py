"""GenerationEngine — continuous-batching autoregressive decoding.

Counterpart of paddle_tpu/generation/engine.py under its default
``scheduling="chunked"``: every iteration runs ONE step of fixed row
count R = (max_seqs + prefill-chunk blocks) * block_rows.  A step
carries an arbitrary mix of DECODE rows (one per live sequence) and
PREFILL-CHUNK rows (the next slice of an admitted prompt); every row
writes its K/V into the paged cache at its position and attends over
keys 0..position of its sequence through the unified ragged attention
(generation/ragged_attention.py) — on the card, one launch of the
hand-written CUDA kernel per layer.  The rest of the step is plain
PyTorch: embedding, layer norm, dense layers with GELU, the tied logits
product and sampling.

CONTINUOUS BATCHING: between steps the host admits queued requests into
free slots (pages permitting) and retires finished ones (EOS /
max_new_tokens), recycling their pages.

Sampling randomness is SCHEDULE-INVARIANT and bit-identical to the JAX
engine's: each (request uid, position) folds its own key out of the
root key (sampler.sample_tokens_folded), so both packages draw the same
tokens for the same requests.

The engine runs on the card unless it is given ``device="cpu"``; with
no card and no device it raises.  Not yet ported (each raises
NotImplementedError): ``scheduling="legacy"``, ``speculation``,
``prefix_cache``, ``draft_model``, and the cluster prefill/decode
handoff.
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
from ..serving.stats import GenerationStats
from .kv_cache import CacheFullError, PagedKVCache
from .sampler import (SamplingParams, fold_data_for, root_key_data,
                      sample_tokens_folded)

__all__ = ["GenerationConfig", "GenerationEngine", "GenerationResult",
           "StreamEvent"]

_DTYPES = {"float32": torch.float32}


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
    - ``scheduling``: ``"chunked"`` (the unified step; ``"legacy"``
      comes with its kernel in a later slice).
    - ``prefill_chunk``: prompt tokens fed per step (default
      min(16, max_seq_len)).
    - ``ragged_block_rows``: rows per page-table binding in the ragged
      attention (None -> 1).
    - ``prefix_cache`` / ``speculation``: not yet ported; must stay off.
    - ``reference_attention``: run the plain PyTorch attention instead
      of the CUDA kernel — the parity oracle, never chosen implicitly.
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
    prefix_cache: bool = False
    speculation: str = None
    reference_attention: bool = False
    dtype: str = "float32"
    seed: int = 0

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


class _ChunkReq:
    """One in-flight request: prompt-feed progress and decode state (a
    request is PREFILLING — fed < plen, no token sampled yet — or
    DECODING)."""

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
    """Continuous-batching decoder over a paged KV cache.

    ``model_cfg`` is a models.BertConfig (the lm_* architecture);
    ``params`` the flat "lm.*" dict of numpy arrays or tensors (moved
    to ``device``).  ``device=None`` is the CUDA card and raises when
    there is none."""

    def __init__(self, model_cfg, params, config=None, device=None,
                 draft_model=None):
        self.cfg = cfg = config or GenerationConfig()
        for what, bad in (("scheduling='legacy'", cfg.scheduling != "chunked"),
                          ("speculation", cfg.speculation is not None),
                          ("prefix_cache", cfg.prefix_cache),
                          ("draft_model", draft_model is not None)):
            if bad:
                raise NotImplementedError(
                    f"{what} is not ported yet (later slice of the "
                    f"PyTorch port)")
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
        self.cache = PagedKVCache(
            num_layers=model_cfg.num_layers, hidden=h,
            page_size=cfg.page_size, num_pages=cfg.num_pages,
            max_seqs=cfg.max_seqs, max_len=cfg.max_seq_len, dtype=dtype,
            device=self.device)
        self.stats = GenerationStats()
        self._root = torch.as_tensor(
            root_key_data(cfg.seed).astype(np.int64), device=self.device)
        self._uid = 0
        S = cfg.max_seqs
        self._bm = int(cfg.ragged_block_rows or 1)
        self._nb = S + _cdiv(cfg.prefill_chunk, self._bm)  # row blocks
        self._rows = self._nb * self._bm                   # step shape R
        self._warmed = False

    def _next_uid(self):
        uid = self._uid
        self._uid += 1
        return uid

    def _to_device(self, a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            device=self.device, dtype=dtype)

    # -- the unified step --------------------------------------------------
    def _chunk_fn(self, toks, pos, write_rows, tables, row_lens, fold,
                  temps, tks, tps, greedy_only):
        """R mixed rows (decode + prefill chunk + inactive):
        toks/pos/row_lens [R] -> next tokens [R].  Each row writes its
        K/V at its position (inactive rows to scratch page 0) and
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

    def _run_step(self, toks, pos, write_rows, tables, lens, fold, temps,
                  tks, tps, greedy_only):
        """Ship one step's host arrays to the device, run it, and bring
        the sampled tokens back (the one synchronisation per step)."""
        i32, i64 = torch.int32, torch.int64
        nxt = self._chunk_fn(
            self._to_device(toks, i64), self._to_device(pos, i64),
            self._to_device(write_rows, i32), self._to_device(tables, i32),
            self._to_device(lens, i32),
            self._to_device(fold.astype(np.int64), i64),
            self._to_device(temps, torch.float32),
            self._to_device(tks, i32),
            self._to_device(tps, torch.float32), greedy_only)
        return nxt.cpu().numpy()

    # -- lifecycle ---------------------------------------------------------
    def warmup(self):
        """Run the ONE step shape once per sampling variant with every
        row inactive (writes land in scratch, lengths are 0), so the
        kernel library is built and loaded before traffic.  Returns the
        compile count."""
        R, NB = self._rows, self._nb
        write_rows = self.cache.rows_for([None] * R)
        tables = self.cache.rows_for([None] * NB)
        z = np.zeros(R, np.int32)
        for greedy_only in (True, False):
            self._run_step(z, z, write_rows, tables, z,
                           np.zeros(R, np.uint32), np.zeros(R, np.float32),
                           z, np.ones(R, np.float32), greedy_only)
        self._warmed = True
        self.stats.mark_warmup_done(self.compile_count())
        return self.compile_count()

    @property
    def warmed(self):
        return self._warmed

    def compile_count(self):
        """Kernel libraries built or loaded by this process (the port's
        only compiles; PyTorch runs the rest eagerly)."""
        return _cuda.library_loads()

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
            queue.append(_ChunkReq(i, p, sp, self._next_uid()))
        yield from self._run_chunked(queue)

    # -- scheduler internals -----------------------------------------------
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
            req.fed = self.cache.admit(slot, req.plen)
            active[slot] = req
            order.append(slot)

    def _chunk_step(self, active, order):
        """ONE unified step: a decode row per live decoding sequence +
        prefill-chunk rows for admitted prompts still feeding, packed
        into the fixed R-row shape."""
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
                    r = base + j
                    toks[r] = int(st.prompt[st.fed + j])
                    pos[r] = st.fed + j
                    lens[r] = st.fed + j + 1
                    fold[r] = fold_data_for(st.uid, st.fed + j)
                    temps[r] = st.sp.temperature
                    tks[r] = st.sp.top_k
                    tps[r] = st.sp.top_p
                    write_slots[r] = slot
                table_slots[blk] = slot
                fed_now[slot] = base + n - 1
                st.fed += n
                n_chunk_toks += n
                blk += 1
        decode_rows = []             # (slot, row)
        for slot in order:
            st = active[slot]
            if st.fed < st.plen or slot in fed_now:
                # still prefilling — or its prompt finished feeding IN
                # THIS step (its first token samples from the chunk's
                # last row); either way no decode row yet
                continue
            p = int(self.cache.seq_lens[slot])
            try:
                self.cache.ensure(slot, p + 1)
            except CacheFullError:
                # oversubscribed pool: this sequence STALLS (keeps its
                # state, skips this step) and retries once a finishing
                # sequence returns pages
                continue
            r = slot * bm            # decode block s <-> slot s
            toks[r] = st.last_tok
            pos[r] = p
            lens[r] = p + 1
            fold[r] = fold_data_for(st.uid, p)
            temps[r] = st.sp.temperature
            tks[r] = st.sp.top_k
            tps[r] = st.sp.top_p
            write_slots[r] = slot
            table_slots[slot] = slot
            decode_rows.append((slot, r))
        if not decode_rows and not fed_now:
            raise CacheFullError(
                f"decode deadlock: all {len(active)} live sequences "
                f"need a new KV page and the pool is exhausted — "
                f"num_pages={self.cfg.num_pages} cannot sustain "
                f"max_seqs={self.cfg.max_seqs} at these lengths")
        write_rows = self.cache.rows_for(write_slots)
        tables = self.cache.rows_for(table_slots)
        greedy_only = all(st.sp.temperature == 0
                          for st in active.values())
        t0 = time.perf_counter()
        nxt = self._run_step(toks, pos, write_rows, tables, lens, fold,
                             temps, tks, tps, greedy_only)
        dt = time.perf_counter() - t0
        self.stats.on_step()
        n_rows = len(decode_rows) + n_chunk_toks
        # settle EVERY slot's state (release or keep) BEFORE the first
        # yield: an abandoned generator then only sees fully-accounted
        # slots, which the stream's finally-block knows how to release
        now = time.perf_counter()
        events = []
        for slot, last_row in fed_now.items():
            st = active[slot]
            if st.fed < st.plen:
                continue             # prompt still mid-feed, no sample
            tok = int(nxt[last_row])
            st.n_gen = 1
            done, reason = self._is_done(tok, 1, st.sp)
            if done:
                del active[slot]
                order.remove(slot)
                self._finish(slot)
                self.stats.on_request_done()
            else:
                st.last_tok = tok
                st.last_emit = now
            events.append(StreamEvent(st.index, tok, done, reason))
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
                del active[slot]
                order.remove(slot)
                self._finish(slot)
                self.stats.on_request_done()
            else:
                st.last_tok = tok
            events.append(StreamEvent(st.index, tok, done, reason))
        if n_chunk_toks:
            self.stats.on_prefill(n_chunk_toks,
                                  dt * n_chunk_toks / n_rows)
            self.stats.on_prefill_chunks(len(fed_now))
        if decode_rows:
            self.stats.on_decode(len(decode_rows),
                                 dt * len(decode_rows) / n_rows,
                                 self.cache.occupancy())
        self.stats.set_compiles(self.compile_count())
        yield from events

    @staticmethod
    def _is_done(tok, n_gen, sp):
        if sp.eos_id is not None and tok == sp.eos_id:
            return True, "stop"
        if n_gen >= sp.max_new_tokens:
            return True, "length"
        return False, None

    def _finish(self, slot):
        self.cache.release(slot)
