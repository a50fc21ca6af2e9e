"""Serving integration: run a GenerationEngine behind the
dynamic-batching `serving.InferenceServer`, plus a direct streaming
path.  Counterpart of paddle_tpu/generation/backend.py.

    backend = GenerationBackend(engine, max_new_tokens=32)
    server = serving.InferenceServer(backend, serving.ServingConfig(
        batch_buckets=(1, 4), seq_buckets=(16, 32),
        pad_values={"prompt_lens": 1}))
    server.start()
    out_tokens, out_lens = server.infer(
        {"token_ids": ids, "prompt_lens": lens})

Feeds: ``token_ids`` [B, T] int32 (right-padded prompts) and
``prompt_lens`` [B] int32.  Outputs: ``out_tokens`` [B, max_new]
int32 (-1 beyond each request's generated length) and ``out_lens``
[B] int32.
"""
from __future__ import annotations

import numpy as np

from ..serving.batcher import BadRequestError
from .sampler import SamplingParams

__all__ = ["GenerationBackend"]


class GenerationBackend:
    input_names = ["token_ids", "prompt_lens"]

    def __init__(self, engine, max_new_tokens=16, sampling=None,
                 warmup=True):
        """``warmup=True`` (default) runs `engine.warmup()` now if it has
        not run yet, so the first request finds the kernel loaded."""
        self._engine = engine
        self._sp = sampling or SamplingParams(
            max_new_tokens=max_new_tokens)
        self.max_new_tokens = self._sp.max_new_tokens
        if warmup and not engine.warmed:
            engine.warmup()

    def input_spec(self):
        return {"token_ids": ((None,), np.dtype(np.int32)),
                "prompt_lens": ((), np.dtype(np.int32))}

    def run(self, feeds):
        ids = np.asarray(feeds["token_ids"], np.int32)
        lens = np.asarray(feeds["prompt_lens"], np.int32).reshape(-1)
        B, T = ids.shape
        # malformed lengths are REJECTED, not clamped — a silently
        # truncated prompt would return plausible-looking garbage
        bad = np.flatnonzero((lens < 1) | (lens > T))
        if bad.size:
            raise BadRequestError(
                f"prompt_lens out of range [1, {T}] at rows "
                f"{bad.tolist()}: {lens[bad].tolist()}")
        prompts = [ids[i, :lens[i]] for i in range(B)]
        results = self._engine.generate(prompts, sampling=self._sp)
        out = np.full((B, self.max_new_tokens), -1, np.int32)
        out_lens = np.zeros(B, np.int32)
        for i, r in enumerate(results):
            n = len(r.tokens)
            out[i, :n] = r.tokens
            out_lens[i] = n
        return [out, out_lens]

    def compile_count(self):
        return self._engine.compile_count()

    def stream(self, prompt, sampling=None):
        """Token-at-a-time generator for ONE prompt (bypasses the
        batcher; use engine.stream for multi-request streaming)."""
        for ev in self._engine.stream([np.asarray(prompt, np.int32)],
                                      sampling=sampling or self._sp):
            yield ev.token
