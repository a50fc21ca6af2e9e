"""paddle_tpu_torch.generation — paged-KV-cache autoregressive decoding
with continuous batching, on PyTorch and CUDA.

Counterpart of paddle_tpu.generation: a block-paged KV cache (with a
refcounted global prefix cache) or a dense one, driven by the chunked
scheduler — one fixed-shape step read by the unified ragged paged
attention — or the legacy one — bucketed prefill plus a decode step read
by the paged decode attention (each a hand-written CUDA kernel on the
card), with continuous batching, speculative decoding and
schedule-invariant sampling that draws the JAX engine's tokens bit for
bit, and the prefill/decode handoff of the cluster tier
(``PrefillHandoff``, ``prefill_detached``/``prefill_stream`` on one
engine, ``decode_prefilled`` on another)."""
from .attention import (gathered_decode_attention, paged_decode_attention,
                        paged_decode_shapes_ok, paged_plain_decode_attention,
                        paged_ref_decode_attention)
from .backend import GenerationBackend
from .drafter import DraftModelDrafter, NgramDrafter, make_drafter
from .engine import (GenerationConfig, GenerationEngine, GenerationResult,
                     PrefillHandoff, StreamEvent)
from .kv_cache import CacheFullError, DenseKVCache, PagedKVCache, PrefixIndex
from .ragged_attention import ragged_paged_attention, ragged_ref_attention
from .sampler import (SamplingParams, batch_sampling_arrays, fold_data_for,
                      root_key_data, sample_tokens_folded,
                      speculative_accept)

__all__ = [
    "GenerationConfig", "GenerationEngine", "GenerationResult",
    "StreamEvent", "PrefillHandoff", "GenerationBackend", "SamplingParams",
    "sample_tokens_folded", "fold_data_for", "root_key_data",
    "batch_sampling_arrays", "speculative_accept", "PagedKVCache",
    "DenseKVCache", "PrefixIndex", "CacheFullError", "NgramDrafter",
    "DraftModelDrafter", "make_drafter", "paged_decode_shapes_ok",
    "paged_ref_decode_attention", "paged_plain_decode_attention",
    "paged_decode_attention", "gathered_decode_attention",
    "ragged_paged_attention", "ragged_ref_attention",
]
