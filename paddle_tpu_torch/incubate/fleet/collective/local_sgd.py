"""LocalSGD (parity: python/paddle/fluid/transpiler/collective.py:270
LocalSGD — each worker trains its own weights, every k steps the
parameters are averaged across workers).

Counterpart of paddle_tpu/incubate/fleet/collective/local_sgd.py: each
rank runs the UNMODIFIED local program (no mesh), and the periodic
averaging is an eager ``cross_process_mean`` (an all-reduce over the
default process group) applied to the scope's parameters, each put back
on the device it came from — the algorithm, no IR surgery."""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["LocalSGDSyncer"]


class LocalSGDSyncer:
    """Attach after minimize; call step_end(scope) after every local
    step::

        opt.minimize(loss)              # plain optimizer, local program
        syncer = LocalSGDSyncer(main_program, k_steps=4)
        for batch in data:
            exe.run(main, feed=...)
            syncer.step_end(scope)      # every k-th call averages params
    """

    def __init__(self, program, k_steps=1):
        self._param_names = [p.name for p in
                             program.global_block().all_parameters()
                             if p.trainable]
        self._k = max(1, int(k_steps))
        self._step = 0

    @property
    def k_steps(self):
        return self._k

    def step_end(self, scope):
        """Returns True when a sync happened at this step."""
        self._step += 1
        if self._step % self._k != 0:
            return False
        self.sync(scope)
        return True

    def sync(self, scope):
        """Average all trainable params across the processes in place."""
        from ....distributed.collectives import cross_process_mean

        if not dist.is_initialized() or dist.get_world_size() <= 1:
            return
        for name in self._param_names:
            old = scope.find_var(name)
            mean = cross_process_mean(old)
            scope.set_var(name, torch.from_numpy(mean).to(old.device)
                          if torch.is_tensor(old) else np.asarray(mean))
