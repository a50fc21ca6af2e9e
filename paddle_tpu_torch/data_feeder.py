"""DataFeeder (parity: python/paddle/fluid/data_feeder.py): convert
reader-yielded sample tuples into the Executor's feed dict.

Counterpart of paddle_tpu/data_feeder.py.  Each column is stacked in its
variable's runtime dtype (int64 stays int64 in the port, where the JAX
package narrows it to int32)."""
from __future__ import annotations

import numpy as np
import torch

from .core.program import Variable, default_main_program
from .core.types import runtime_dtype

__all__ = ["DataFeeder"]


def _numpy_dtype(name):
    """The numpy dtype of a variable dtype's runtime torch dtype."""
    return torch.empty(0, dtype=runtime_dtype(name)).numpy().dtype


class DataFeeder:
    def __init__(self, feed_list, place=None, program=None):
        self.feed_vars: list[Variable] = []
        for v in feed_list:
            if isinstance(v, str):
                v = (program or default_main_program()).global_block().var(v)
            self.feed_vars.append(v)

    def feed(self, iterable):
        """iterable: list of sample tuples (one tuple per example), each
        aligned with feed_list.  Returns {name: batched ndarray}."""
        columns = list(zip(*iterable))
        out = {}
        for var, col in zip(self.feed_vars, columns):
            dtype = _numpy_dtype(var.dtype or "float32")
            batch = np.stack([np.asarray(c, dtype=dtype) for c in col])
            # conform to declared rank: e.g. label declared [N,1] but
            # samples are scalars
            want = var.shape
            if want is not None and batch.ndim == len(want) - 1 \
                    and want[-1] == 1:
                batch = batch[..., None]
            out[var.name] = batch
        return out
