"""paddle_tpu_torch.serving — dynamic-batching inference serving.

Counterpart of paddle_tpu.serving: concurrent client requests coalesce
into padded batches drawn from a closed set of shape buckets, with
warmup, bounded-queue backpressure, per-request deadlines, error
isolation, graceful drain, and latency/QPS/occupancy statistics."""
from .batcher import (BadRequestError, InferenceFuture, QueueFullError,
                      RequestTimeoutError, ServerClosedError, ServingError)
from .buckets import BucketError, ShapeBucketer
from .config import ServingConfig
from .server import CallableBackend, InferenceServer
from .stats import GenerationStats, LatencyHistogram, ServingStats

__all__ = [
    "ServingConfig", "InferenceServer", "CallableBackend",
    "ShapeBucketer", "ServingStats", "GenerationStats",
    "LatencyHistogram", "ServingError", "QueueFullError",
    "RequestTimeoutError", "ServerClosedError", "BadRequestError",
    "BucketError", "InferenceFuture",
]
