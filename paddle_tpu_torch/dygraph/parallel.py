"""Dygraph data parallelism (parity: python/paddle/fluid/dygraph/
parallel.py — DataParallel :84, scale_loss :150, apply_collective_grads
:211; imperative/nccl_context.h).

Counterpart of paddle_tpu/dygraph/parallel.py over ``torch.distributed``
(distributed/collectives.py): each rank is a process of the default
process group (``prepare_context`` starts it from the launcher's env, or
the caller does), and the gradient average is an all-reduce of each
parameter's ``.grad`` after ``loss.backward()`` — on the card under
NCCL, through the host under gloo.  One process (or a world of one)
makes every collective a no-op, the reference's nranks == 1 fast path.
"""
from __future__ import annotations

import os

from .layers import Layer

__all__ = ["DataParallel", "prepare_context", "Env"]


class Env:
    """Cluster env view (parity: dygraph.parallel.Env reading
    PADDLE_TRAINER_* vars)."""

    def __init__(self):
        self.nranks = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
        self.local_rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
        self.current_endpoint = os.environ.get("PADDLE_CURRENT_ENDPOINT",
                                               "")
        self.trainer_endpoints = [
            e for e in os.environ.get("PADDLE_TRAINER_ENDPOINTS",
                                      "").split(",") if e]


def prepare_context(strategy=None):
    """Join the process group (parity: prepare_context building the
    imperative NCCL context).  Returns the Env."""
    env = Env()
    if env.nranks > 1:
        from ..distributed.collectives import \
            ensure_distributed_initialized

        coord = os.environ.get("PADDLE_COORDINATOR") or (
            env.trainer_endpoints[0] if env.trainer_endpoints else None)
        ensure_distributed_initialized(coord, env.nranks, env.local_rank)
    return env


class DataParallel(Layer):
    """Wrap a Layer for multi-process data-parallel dygraph training::

        env = parallel.prepare_context()
        model = parallel.DataParallel(MyNet(), env)
        loss = model(x).mean()
        loss = model.scale_loss(loss)
        loss.backward()
        model.apply_collective_grads()   # grad allreduce
        opt.minimize(loss)
    """

    def __init__(self, layers, strategy=None):
        super().__init__()
        self._layers = layers
        self._env = strategy if isinstance(strategy, Env) else Env()

    @property
    def nranks(self):
        """World size: the process group's wins over the env var, so a
        job whose group was started without the launcher's env still
        synchronizes instead of silently diverging."""
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return max(1, dist.get_world_size())
        return max(1, self._env.nranks)

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    def parameters(self, include_sublayers=True):
        return self._layers.parameters(include_sublayers)

    def named_parameters(self, prefix=""):
        return self._layers.named_parameters(prefix)

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def set_state_dict(self, *a, **k):
        return self._layers.set_state_dict(*a, **k)

    def clear_gradients(self):
        self._layers.clear_gradients()

    def scale_loss(self, loss):
        """Divide by nranks so the summed allreduce equals the global
        mean (parity: parallel.py:150)."""
        if self.nranks <= 1:
            return loss
        return loss * (1.0 / self.nranks)

    def apply_collective_grads(self):
        """Sum every parameter gradient across ranks (parity:
        parallel.py:211 coalesce+allreduce; here one all-reduce per
        gradient).  The ranks scaled their losses by 1/nranks already,
        so the sum is the global mean's gradient."""
        if self.nranks <= 1:
            return
        import torch.distributed as dist

        for p in self._layers.parameters():
            if p.grad is not None:
                g = p.grad.clone()
                dist.all_reduce(g)
                p.grad = g
