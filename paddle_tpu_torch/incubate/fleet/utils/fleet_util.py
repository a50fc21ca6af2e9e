"""Fleet utilities (parity: incubate/fleet/utils/fleet_util.py:40
FleetUtil — rank-0 logging, scope var zeroing, and GLOBAL metric
aggregation: the reference all-reduces per-worker AUC bucket stats over
Gloo; here the same stats ride the role maker's rendezvous
communicator).

Counterpart of paddle_tpu/incubate/fleet/utils/fleet_util.py, copied over
the port's role makers; the histogram AUC is the JAX package's
``metrics.auc_from_histograms``, kept here (the port has no ``metrics``
module)."""
from __future__ import annotations

import logging

import numpy as np
import torch

__all__ = ["FleetUtil"]

_logger = logging.getLogger(__name__)


def _trapezoid_area(x1, x2, y1, y2):
    return abs(x1 - x2) * (y1 + y2) / 2.0


def auc_from_histograms(stat_pos, stat_neg):
    """Trapezoid ROC AUC from score-bucket histograms (0.0 when a class
    is empty)."""
    tot_pos = tot_neg = 0.0
    auc = 0.0
    idx = len(stat_pos) - 1
    while idx >= 0:
        prev_pos, prev_neg = tot_pos, tot_neg
        tot_pos += float(stat_pos[idx])
        tot_neg += float(stat_neg[idx])
        auc += _trapezoid_area(prev_neg, tot_neg, prev_pos, tot_pos)
        idx -= 1
    return auc / tot_pos / tot_neg if tot_pos > 0 and tot_neg > 0 \
        else 0.0


class FleetUtil:
    """Collective-aware helpers around a role maker (reference
    fleet_util.py:40).  `role_maker` needs the GeneralRoleMaker surface
    (worker_index / all_reduce_worker); single-process use works with
    the default UserDefined role maker (reductions are identity)."""

    def __init__(self, role_maker=None):
        self._role_maker = role_maker

    # -- rank-0 logging ----------------------------------------------------
    def _is_rank0(self):
        # is_first_worker, NOT worker_index()==0: pserver 0 shares index
        # 0 with trainer 0 and must not claim rank-0 duties
        rm = self._role_maker
        return rm is None or rm.is_first_worker()

    def rank0_print(self, s):
        if self._is_rank0():
            print(s, flush=True)

    def rank0_info(self, s):
        if self._is_rank0():
            _logger.info(s)

    def rank0_error(self, s):
        if self._is_rank0():
            _logger.error(s)

    # -- scope helpers -----------------------------------------------------
    def set_zero(self, var_name, scope=None):
        """Zero a scope variable in place (reference set_zero — used to
        reset in-graph metric accumulators between passes)."""
        import paddle_tpu_torch as pt

        scope = scope or pt.global_scope()
        # write into the OWNING scope (find_var resolves through the
        # parent chain; a local set_var would only shadow the parent)
        s = scope
        while s is not None and var_name not in s._vars:
            s = s._parent
        if s is None:
            raise KeyError(f"set_zero: no variable {var_name!r} in scope")
        old = s._vars[var_name]
        s.set_var(var_name, torch.zeros_like(old) if torch.is_tensor(old)
                  else np.zeros_like(np.asarray(old)))

    # -- global metrics ----------------------------------------------------
    def get_global_auc(self, stat_pos=None, stat_neg=None, metric=None):
        """ROC AUC over ALL workers' bucket statistics (reference
        get_global_auc: all-reduce the pos/neg histograms, then one
        trapezoid pass).  Pass either a metrics.Auc instance or the raw
        stat arrays."""
        if metric is not None:
            stat_pos = metric._stat_pos
            stat_neg = metric._stat_neg
        stat_pos = np.asarray(stat_pos, np.int64)
        stat_neg = np.asarray(stat_neg, np.int64)
        rm = self._role_maker
        if rm is not None and hasattr(rm, "all_reduce_worker"):
            stat_pos = np.asarray(rm.all_reduce_worker(stat_pos))
            stat_neg = np.asarray(rm.all_reduce_worker(stat_neg))
        return auc_from_histograms(stat_pos, stat_neg)

    def print_global_auc(self, stat_pos=None, stat_neg=None, metric=None,
                         print_prefix=""):
        auc = self.get_global_auc(stat_pos, stat_neg, metric)
        self.rank0_print(f"{print_prefix} global auc = {auc}")
        return auc
