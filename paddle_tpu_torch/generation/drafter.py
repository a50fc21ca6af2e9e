"""Draft-token proposers for speculative decoding.

Counterpart of paddle_tpu/generation/drafter.py.  The engine verifies
drafts inside its unified chunked step (the ragged attention scores any
row length), so speculation only adds WHERE candidate tokens come from:

* `NgramDrafter` — self-drafting: match the longest suffix n-gram of the
  sequence's own prompt + emitted tokens against its earlier occurrences
  and propose the continuation.  No weights, no device work.
* `DraftModelDrafter` — a small causal LM (the lm_* architecture of the
  target) rolled forward greedily over its OWN dense KV cache, one
  fixed-shape [max_seqs] step per drafted token.

Protocol: ``admit(slot, tokens)`` registers a sequence's history,
``commit(slot, tokens)`` appends tokens the engine emitted,
``draft(slot, k)`` returns up to k proposed tokens (possibly []),
``release(slot)`` drops the slot, ``warmup()`` runs the device work
once.  Unknown slots are tolerated.  Neither drafter builds a kernel:
the draft model is plain PyTorch, so the engine's compile count (the
process's kernel library loads) covers drafting with nothing added.

Drafts are PROPOSALS: the exact-match rejection rule
(`sampler.speculative_accept`) filters every token against the model's
own sample, so a poor draft costs throughput, never correctness.  A
failure inside a drafter raises; the JAX package's degradation to plain
decode is not carried over.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .._device import resolve_device
from ..models.transformer import (lm_embed, lm_layer_finish, lm_layer_qkv,
                                  lm_logits, lm_params_from_numpy)
from .kv_cache import DenseKVCache

__all__ = ["NgramDrafter", "DraftModelDrafter", "make_drafter"]


class NgramDrafter:
    """Suffix n-gram matcher over each sequence's own token history.

    ``draft`` finds the most recent earlier occurrence of the longest
    suffix n-gram (n from ``max_n`` down to 1) and proposes the k tokens
    that followed it.  No match -> no drafts -> a plain decode row."""

    def __init__(self, max_n=3, max_seqs=None):
        # max_seqs is accepted and ignored, as in the JAX package: the
        # history is a dict keyed by slot
        if max_n < 1:
            raise ValueError("max_n must be >= 1")
        self.max_n = int(max_n)
        self._hist = {}          # slot -> list of token ids

    def admit(self, slot, tokens):
        self._hist[slot] = [int(t) for t in tokens]

    def commit(self, slot, tokens):
        h = self._hist.get(slot)
        if h is not None:
            h.extend(int(t) for t in tokens)

    def release(self, slot):
        self._hist.pop(slot, None)

    def warmup(self):
        pass                     # no device work

    def draft(self, slot, k):
        h = self._hist.get(slot)
        if not h or k <= 0:
            return []
        arr = np.asarray(h, np.int64)
        L = arr.size
        for n in range(min(self.max_n, L - 1), 0, -1):
            suffix = arr[L - n:]
            # candidate windows end at j in [n, L-1] (j == L is the
            # suffix itself; excluding it guarantees a continuation)
            windows = np.lib.stride_tricks.sliding_window_view(arr, n)
            hits = np.flatnonzero(np.all(windows[:L - n] == suffix, axis=1))
            if hits.size:
                ends = hits + n
                # prefer the most recent occurrence whose continuation
                # has all k tokens: inside a repeating run the latest
                # match abuts the end of history
                full = ends[ends + k <= L]
                j = int(full[-1]) if full.size else int(ends[-1])
                return [int(t) for t in arr[j:j + k]]
        return []


class DraftModelDrafter:
    """A small draft LM rolled forward greedily over a private dense KV
    cache, one fixed-shape [max_seqs] step per fed token.

    Per slot it tracks the committed history and how much of it has been
    fed; ``draft`` first catches the KV up to the history, then feeds its
    own greedy predictions k-1 more steps.  Speculative feeds write KV
    past the committed length, but ``fed`` is not advanced — the next
    catch-up overwrites those positions before any masked read covers
    them."""

    def __init__(self, model_cfg, params, max_seqs, max_len,
                 dtype=torch.float32, device=None):
        if max_len > model_cfg.max_position:
            raise ValueError(
                f"draft model max_position {model_cfg.max_position} < "
                f"engine max_seq_len {max_len}")
        self.model_cfg = model_cfg
        self.device = resolve_device(device)
        # the draft model computes in float32; only its cache is dtype
        self.params = lm_params_from_numpy(params, self.device)
        self.max_seqs = int(max_seqs)
        self.max_len = int(max_len)
        self._sm_scale = 1.0 / math.sqrt(
            model_cfg.hidden_size // model_cfg.num_heads)
        self._cache = DenseKVCache(
            num_layers=model_cfg.num_layers, hidden=model_cfg.hidden_size,
            max_seqs=self.max_seqs, max_len=self.max_len, dtype=dtype,
            device=self.device)
        self._st = {}            # slot -> {hist, fed, pending}

    def _step_fn(self, toks, pos, rows, eff_lens):
        """One greedy decode step over all slots (argmax only: drafts
        need no sampling, mismatches are the verifier's job)."""
        cfg, cache, params = self.model_cfg, self._cache, self.params
        with torch.no_grad():
            x = lm_embed(params, cfg, toks, pos)
            for i in range(cfg.num_layers):
                q, k, v = lm_layer_qkv(params, cfg, i, x)
                cache.write_token(i, k, v, rows, pos)
                ctxt = cache.attend(q, i, rows, eff_lens, cfg.num_heads,
                                    self._sm_scale)
                x = lm_layer_finish(params, cfg, i, x, ctxt)
            return torch.argmax(lm_logits(params, cfg, x), dim=-1)

    def _run(self, toks, pos, eff, rows):
        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(
                self.device, torch.int64)
        return self._step_fn(t(toks), t(pos), t(rows), t(eff)).cpu().numpy()

    def _step(self, slot, tok, pos):
        S = self.max_seqs
        toks = np.zeros(S, np.int64)
        posv = np.zeros(S, np.int64)
        eff = np.zeros(S, np.int64)
        toks[slot] = tok
        posv[slot] = pos
        eff[slot] = pos + 1
        rows = self._cache.rows_for(
            [s if s == slot else None for s in range(S)])
        return int(self._run(toks, posv, eff, rows)[slot])

    def warmup(self):
        """Run the one step shape against scratch rows."""
        z = np.zeros(self.max_seqs, np.int64)
        self._run(z, z, z, self._cache.rows_for([None] * self.max_seqs))

    def admit(self, slot, tokens):
        self._st[slot] = {"hist": [int(t) for t in tokens], "fed": 0,
                          "pending": None}

    def commit(self, slot, tokens):
        st = self._st.get(slot)
        if st is not None:
            st["hist"].extend(int(t) for t in tokens)

    def release(self, slot):
        self._st.pop(slot, None)

    def draft(self, slot, k):
        st = self._st.get(slot)
        if st is None or k <= 0:
            return []
        hist = st["hist"]
        m = len(hist)
        # feeding position p needs p < max_len; the last speculative
        # feed sits at position m + k - 2
        k = min(int(k), self.max_len - m + 1)
        if m < 1 or k <= 0:
            return []
        while st["fed"] < m:             # catch the KV up to history
            p = st["fed"]
            st["pending"] = self._step(slot, hist[p], p)
            st["fed"] = p + 1
        out = [st["pending"]]
        pos = m
        while len(out) < k:              # roll greedy predictions
            out.append(self._step(slot, out[-1], pos))
            pos += 1
        return out


def make_drafter(kind, *, spec_ngram=3, max_seqs=None, max_len=None,
                 draft_model=None, dtype=torch.float32, device=None):
    """The drafter for ``GenerationConfig.speculation``; ``draft_model``
    is the ``(model_cfg, params)`` pair for ``kind == "draft"``."""
    if kind == "ngram":
        return NgramDrafter(max_n=spec_ngram)
    if kind == "draft":
        if draft_model is None:
            raise ValueError(
                "speculation='draft' needs GenerationEngine("
                "draft_model=(cfg, params))")
        dcfg, dparams = draft_model
        return DraftModelDrafter(dcfg, dparams, max_seqs=max_seqs,
                                 max_len=max_len, dtype=dtype, device=device)
    raise ValueError(f"unknown speculation kind {kind!r}")
