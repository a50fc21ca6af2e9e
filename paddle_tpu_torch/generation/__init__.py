"""paddle_tpu_torch.generation — paged-KV-cache autoregressive decoding
with continuous batching, on PyTorch and CUDA.

Counterpart of paddle_tpu.generation, chunked scheduling only: a
block-paged KV cache read by the unified ragged paged attention (a
hand-written CUDA kernel on the card), driven by one fixed-shape step,
with continuous batching and schedule-invariant sampling that draws the
JAX engine's tokens bit for bit."""
from .attention import (gathered_decode_attention, paged_decode_shapes_ok,
                        paged_ref_decode_attention)
from .backend import GenerationBackend
from .engine import (GenerationConfig, GenerationEngine, GenerationResult,
                     StreamEvent)
from .kv_cache import CacheFullError, PagedKVCache
from .ragged_attention import ragged_paged_attention, ragged_ref_attention
from .sampler import (SamplingParams, batch_sampling_arrays, fold_data_for,
                      root_key_data, sample_tokens_folded)

__all__ = [
    "GenerationConfig", "GenerationEngine", "GenerationResult",
    "StreamEvent", "GenerationBackend", "SamplingParams",
    "sample_tokens_folded", "fold_data_for", "root_key_data",
    "batch_sampling_arrays", "PagedKVCache", "CacheFullError",
    "paged_decode_shapes_ok", "paged_ref_decode_attention",
    "gathered_decode_attention", "ragged_paged_attention",
    "ragged_ref_attention",
]
