"""Shape buckets: the closed set of padded shapes the server executes.

A copy of paddle_tpu/serving/buckets.py.  A serving process never lets
client-chosen shapes reach its backend.  The bucketer maps every request
onto a (batch bucket x seq bucket) grid:

- the BATCH axis (axis 0 of every feed) is padded up to the smallest
  configured batch bucket that fits the coalesced rows.  Pad rows are
  pure garbage rows sliced off the outputs — per-sample computations
  (fc stacks, per-row attention) cannot leak across rows, so real rows
  are BIT-EQUAL to an unpadded run of the same executable shape.
- optionally, one ragged SEQUENCE axis per feed is padded up to a seq
  bucket (`pad_values` supplies the fill — 0 for an attention mask feed
  means "padding is masked out", the standard BERT serving contract).
  Requests only share a batch with requests in the SAME seq bucket.
"""
from __future__ import annotations

import bisect

import numpy as np

__all__ = ["ShapeBucketer", "BucketError"]


class BucketError(ValueError):
    """Request shape that no configured bucket can hold."""


class ShapeBucketer:
    def __init__(self, config):
        self._cfg = config

    # -- bucket selection --------------------------------------------------
    def batch_bucket(self, rows):
        buckets = self._cfg.batch_buckets
        i = bisect.bisect_left(buckets, rows)
        if i == len(buckets):
            raise BucketError(
                f"request batch of {rows} rows exceeds the largest batch "
                f"bucket {buckets[-1]} (configured buckets: {buckets})")
        return buckets[i]

    def seq_bucket(self, length):
        buckets = self._cfg.seq_buckets
        i = bisect.bisect_left(buckets, length)
        if i == len(buckets):
            raise BucketError(
                f"sequence length {length} exceeds the largest seq "
                f"bucket {buckets[-1]} (configured buckets: {buckets})")
        return buckets[i]

    def padded_shape(self, arr):
        """Full padded shape of one feed array, batch axis EXCLUDED
        (the batch bucket is a property of the coalesced batch, not of
        one request)."""
        shape = list(arr.shape[1:])
        ax = self._cfg.seq_axis - 1  # axis index after dropping batch
        if self._cfg.seq_buckets and 0 <= ax < len(shape):
            shape[ax] = self.seq_bucket(shape[ax])
        return tuple(shape)

    def group_key(self, feeds):
        """Two requests may share a batch iff their group keys match:
        same feed names, dtypes, and PADDED per-sample shapes."""
        return tuple(
            (name, str(np.asarray(feeds[name]).dtype),
             self.padded_shape(np.asarray(feeds[name])))
            for name in sorted(feeds))

    # -- batch assembly / disassembly --------------------------------------
    def assemble(self, requests):
        """Coalesce requests (all same group key) into one padded feed
        dict.  Returns (feeds, padded_batch, row_slices, real_elements,
        padded_elements); row_slices[i] = (start, rows) of request i."""
        rows_total = sum(r.rows for r in requests)
        padded_batch = self.batch_bucket(rows_total)
        feeds = {}
        row_slices = []
        start = 0
        for r in requests:
            row_slices.append((start, r.rows))
            start += r.rows
        real_elements = 0
        padded_elements = 0
        first = requests[0].feeds
        for name in first:
            sample_shape = self.padded_shape(np.asarray(first[name]))
            dtype = np.asarray(first[name]).dtype
            pad_value = self._cfg.pad_values.get(name, 0)
            out = np.full((padded_batch,) + sample_shape, pad_value,
                          dtype=dtype)
            for (s, n), r in zip(row_slices, requests):
                arr = np.asarray(r.feeds[name])
                # place the real data at the origin of every padded axis
                sl = (slice(s, s + n),) + tuple(
                    slice(0, d) for d in arr.shape[1:])
                out[sl] = arr
                real_elements += arr.size
            padded_elements += out.size
            feeds[name] = out
        return feeds, padded_batch, row_slices, real_elements, \
            padded_elements

    @staticmethod
    def split_outputs(outs, padded_batch, row_slices):
        """Slice each request's rows back out of the batched outputs.
        Outputs whose leading dim is not the padded batch (reduced
        scalars etc.) are handed to every request whole."""
        per_request = []
        for start, rows in row_slices:
            per_request.append([
                np.asarray(o)[start:start + rows]
                if (np.ndim(o) >= 1
                    and np.shape(o)[0] == padded_batch)
                else np.asarray(o)
                for o in outs
            ])
        return per_request
