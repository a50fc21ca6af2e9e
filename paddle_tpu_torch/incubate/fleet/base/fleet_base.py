"""Fleet base class (parity: python/paddle/fluid/incubate/fleet/base/
fleet_base.py:38 — init :184, distributed_optimizer :238, minimize :337,
save APIs :252).

Counterpart of paddle_tpu/incubate/fleet/base/fleet_base.py, copied."""
from __future__ import annotations

import abc

from .role_maker import PaddleCloudRoleMaker, RoleMakerBase


class Fleet(abc.ABC):
    def __init__(self):
        self._role_maker: RoleMakerBase | None = None
        self._optimizer = None

    # -- topology ----------------------------------------------------------
    def is_first_worker(self):
        return self._role_maker.is_first_worker()

    def worker_index(self):
        return self._role_maker.worker_index()

    def worker_num(self):
        return self._role_maker.worker_num()

    def is_worker(self):
        return self._role_maker.is_worker()

    def is_server(self):
        return self._role_maker.is_server()

    def server_num(self):
        return self._role_maker.server_num()

    def server_index(self):
        return self._role_maker.server_index()

    def worker_endpoints(self):
        return self._role_maker.get_trainer_endpoints()

    def server_endpoints(self):
        return self._role_maker.get_pserver_endpoints()

    # -- lifecycle ---------------------------------------------------------
    def init(self, role_maker=None):
        self._role_maker = role_maker or PaddleCloudRoleMaker()
        self._post_init()

    def _post_init(self):
        pass

    @abc.abstractmethod
    def distributed_optimizer(self, optimizer, strategy=None):
        ...

    @abc.abstractmethod
    def save_inference_model(self, executor, dirname, feeded_var_names,
                             target_vars, main_program=None,
                             export_for_deployment=True):
        ...

    @abc.abstractmethod
    def save_persistables(self, executor, dirname, main_program=None):
        ...


class DistributedOptimizer(abc.ABC):
    """Wrapper contract (parity: fleet_base.py DistributedOptimizer)."""

    def __init__(self, optimizer, strategy=None):
        self._optimizer = optimizer
        self._strategy = strategy

    @abc.abstractmethod
    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        ...
