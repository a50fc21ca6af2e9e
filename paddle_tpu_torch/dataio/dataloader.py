"""DataLoader: prefetching host->device pipeline.

Parity: fluid/reader.py PyReader/DataLoader over LoDTensorBlockingQueue +
operators/reader/buffered_reader.cc (double-buffered device prefetch).
Counterpart of paddle_tpu/dataio/dataloader.py.

The double buffer runs on a producer thread (``dataio.prefetch.
background_iter``): it converts each batch to tensors and starts their
host->device copy there, so the copy of batch i+1 overlaps the step on
batch i.  On a card each array is staged in pinned memory and copied
with ``non_blocking=True`` on a side stream, and an event is recorded
after the copies; the consumer's stream waits on that event before the
batch is handed out, and the batch's tensors are marked as used on the
consumer's stream (``record_stream``) for the caching allocator.  The
pinned buffers need no holding: ``pin_memory`` takes them from PyTorch's
caching host allocator, and a non-blocking copy records an event on its
stream for the block, which the allocator hands out again only after
that event has completed (core/trainer.py's ``_stage`` relies on the
same rule).

``places`` (a ``Place``, a ``torch.device``, a device string, or a list
whose first entry is one of them) resolve to one ``torch.device``; with
no ``places`` the batches go to the card, and a loader without one
raises, as every entry point of the port does.  ``CPUPlace()`` keeps
them on the host (the tests)."""
from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device

__all__ = ["DataLoader"]


class DataLoader:
    @staticmethod
    def from_generator(feed_list=None, capacity=4, iterable=True,
                       return_list=False, use_double_buffer=True):
        return _GeneratorLoader(feed_list, capacity, use_double_buffer)


def _resolve_places(places):
    if isinstance(places, (list, tuple)):
        places = places[0] if places else None
    if places is not None and hasattr(places, "torch_device"):
        return places.torch_device()
    return resolve_device(places)


class _GeneratorLoader:
    def __init__(self, feed_list, capacity, use_double_buffer):
        self.feed_list = feed_list or []
        self.capacity = capacity
        self.double_buffer = use_double_buffer
        self._gen = None
        self._places = None

    # -- reference-parity configuration methods ------------------------
    def set_sample_list_generator(self, reader, places=None):
        from ..data_feeder import DataFeeder

        feeder = DataFeeder(self.feed_list)

        def gen():
            for samples in reader():
                yield feeder.feed(samples)

        self._gen = gen
        self._places = places
        return self

    def set_batch_generator(self, reader, places=None):
        """reader yields feed dicts {name: ndarray} or tuples aligned with
        feed_list."""

        def gen():
            for batch in reader():
                if isinstance(batch, dict):
                    yield batch
                else:
                    yield {
                        v.name if not isinstance(v, str) else v: arr
                        for v, arr in zip(self.feed_list, batch)
                    }

        self._gen = gen
        self._places = places
        return self

    # -- iteration ------------------------------------------------------
    def __iter__(self):
        if self._gen is None:
            raise RuntimeError(
                "DataLoader not configured: call set_batch_generator or "
                "set_sample_list_generator first")
        if not self.double_buffer:
            yield from self._gen()
            return
        from .prefetch import background_iter

        device = _resolve_places(self._places)
        if device.type != "cuda":
            yield from background_iter(
                self._gen, capacity=self.capacity,
                name="paddle_tpu-loader",
                transform=lambda batch: {
                    k: torch.as_tensor(np.asarray(v)).to(device)
                    for k, v in batch.items()})
            return

        side = torch.cuda.Stream(device)

        def to_card(batch):
            # on the producer thread: pin, copy on the side stream, and
            # record the event the consumer's stream will wait on
            pinned = {k: torch.as_tensor(np.asarray(v)).pin_memory()
                      for k, v in batch.items()}
            with torch.cuda.stream(side):
                out = {k: p.to(device, non_blocking=True)
                       for k, p in pinned.items()}
                event = torch.cuda.Event()
                event.record(side)
            return out, event

        for out, event in background_iter(
                self._gen, capacity=self.capacity,
                name="paddle_tpu-loader", transform=to_card):
            stream = torch.cuda.current_stream(device)
            stream.wait_event(event)
            for t in out.values():
                t.record_stream(stream)
            yield out
