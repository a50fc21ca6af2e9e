"""ServingConfig — the knobs of the dynamic-batching server.

A copy of paddle_tpu/serving/config.py.  The bucket sets define the
closed universe of padded shapes the server executes: the JAX package
compiles one executable per shape, and the port keeps the same contract
so a backend's fixed-shape steps (the generation engine's unified step)
see only shapes that warmup ran.
"""
from __future__ import annotations

import dataclasses

__all__ = ["ServingConfig"]


@dataclasses.dataclass
class ServingConfig:
    """Knobs:

    - ``batch_buckets``: allowed padded batch sizes, ascending.  A batch
      of n requests pads up to the smallest bucket >= n; the largest is
      the coalescing cap.
    - ``seq_buckets``: optional allowed lengths for the ``seq_axis`` of
      ragged feeds.  Empty = no sequence padding (requests must agree on
      non-batch dims exactly to share a batch).
    - ``seq_axis``: which axis of a feed is the ragged one (counting the
      batch axis; default 1).  Only feeds with rank > seq_axis are
      padded.
    - ``pad_values``: per-feed scalar used for padding (default 0 — for
      a mask feed that is exactly "padding is masked out").
    - ``max_queue_size``: backpressure bound; `submit` on a full queue
      raises ``QueueFullError`` instead of queueing unbounded work.
    - ``max_batch_wait_ms``: the latency/throughput knob — how long the
      batcher holds an under-full batch open for more arrivals.  0 means
      "ship whatever is queued right now".
    - ``default_timeout_ms``: per-request deadline when the caller gives
      none; None = wait forever.
    - ``slo_ms``: latency SLO recorded by the stats (violations counter);
      purely observational.
    - ``drain_timeout_s``: how long `close(drain=True)` waits for the
      queue to empty before cancelling what's left.
    """

    batch_buckets: tuple = (1, 2, 4, 8, 16, 32)
    seq_buckets: tuple = ()
    seq_axis: int = 1
    pad_values: dict = dataclasses.field(default_factory=dict)
    max_queue_size: int = 256
    max_batch_wait_ms: float = 5.0
    default_timeout_ms: float = None
    slo_ms: float = None
    drain_timeout_s: float = 30.0

    def __post_init__(self):
        self.batch_buckets = tuple(sorted(int(b) for b in
                                          self.batch_buckets))
        if not self.batch_buckets or self.batch_buckets[0] < 1:
            raise ValueError(
                f"batch_buckets must be positive ints, got "
                f"{self.batch_buckets}")
        self.seq_buckets = tuple(sorted(int(s) for s in self.seq_buckets))
        if self.seq_buckets and self.seq_buckets[0] < 1:
            raise ValueError(
                f"seq_buckets must be positive ints, got "
                f"{self.seq_buckets}")
        if self.seq_axis < 1:
            raise ValueError("seq_axis counts the batch axis; must be >= 1")
        if self.max_queue_size < 1:
            raise ValueError("max_queue_size must be >= 1")
        if self.max_batch_wait_ms < 0:
            raise ValueError("max_batch_wait_ms must be >= 0")

    @property
    def max_batch_size(self):
        return self.batch_buckets[-1]
