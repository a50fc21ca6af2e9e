"""RollingSwap — worker-by-worker model version rollout behind the
router, gated by a parity canary.

The roll replaces one worker at a time: spawn a replacement from the
new version's spec (it warms up in the child before answering health),
run the CANARY — old and new worker answer the same probe through the
same RPC surface the router uses — and only on an exact match attach
the replacement, drain the old worker (zero requests drop: its
dispatcher finishes the request in hand, queued work goes to the
survivors) and retire it.  At every instant the model keeps at least
its original capacity minus zero workers: the replacement is warm and
attached BEFORE the old worker stops taking work.

A canary mismatch means the new version does not reproduce the old
version's answers: the roll ABORTS with the old version still serving,
the mismatching replacement is retired, and the ``fleet.rollout`` seam
degrades PERMANENTLY (a control-plane seam of the DegradationRegistry,
listed in the router's stats snapshot) so no later roll retries into
the same mismatch without an operator resetting the seam.

Canary semantics: generation roles compare token sequences exactly
(greedy parity is this repo's cross-process correctness currency);
the infer role compares outputs within ``canary_rtol``.

Counterpart of paddle_tpu/fleet/rollout.py, copied.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..observability import flightrec as _flightrec
from ..resilience.retry import degradations

__all__ = ["DEGRADE_KEY", "RolloutResult", "RollingSwap"]

DEGRADE_KEY = "fleet.rollout"


@dataclasses.dataclass
class RolloutResult:
    model: str
    replaced: int = 0          # old workers retired
    aborted: bool = False
    reason: str = None
    canary: dict = None        # old/new answers on the aborting probe


class RollingSwap:
    """One roll of ``model`` onto ``spawn_kwargs`` (the new version's
    ``pool.spawn_worker`` arguments — e.g. ``{"spec": WorkerSpec(...)}``
    for a WorkerPool, ``{"factory": fn}`` for a StaticPool).

    The canary probe defaults to a generation probe
    (``canary_prompt`` through the ``generate`` RPC); pass
    ``canary_feeds`` instead for infer-role pools.
    """

    def __init__(self, router, pool, model=None, spawn_kwargs=None,
                 canary_prompt=(1, 2, 3, 4), canary_sampling=None,
                 canary_feeds=None, canary_rtol=1e-5):
        self.router = router
        self.pool = pool
        self.model = model or router.cfg.default_model
        self.spawn_kwargs = dict(spawn_kwargs or {})
        self.canary_prompt = list(canary_prompt)
        self.canary_sampling = canary_sampling
        self.canary_feeds = canary_feeds
        self.canary_rtol = float(canary_rtol)

    # -- the canary --------------------------------------------------------
    def _probe(self, handle):
        if self.canary_feeds is not None:
            resp = handle.call("infer", feeds=self.canary_feeds)
            if not resp.get("ok"):
                raise RuntimeError(
                    f"canary infer failed on worker {handle.rank}: "
                    f"{resp.get('error', '?')}")
            return [np.asarray(y) for y in resp["outputs"]]
        resp = handle.call("generate", prompts=[self.canary_prompt],
                           sampling=[self.canary_sampling])
        if not resp.get("ok"):
            raise RuntimeError(
                f"canary generate failed on worker {handle.rank}: "
                f"{resp.get('error', '?')}")
        return list(resp["results"][0]["tokens"])

    def _parity(self, old_ans, new_ans):
        if self.canary_feeds is not None:
            return (len(old_ans) == len(new_ans)
                    and all(np.allclose(a, b, rtol=self.canary_rtol)
                            for a, b in zip(old_ans, new_ans)))
        return list(old_ans) == list(new_ans)

    # -- the roll ----------------------------------------------------------
    def run(self):
        stats = self.router.stats_
        if degradations.is_degraded(DEGRADE_KEY):
            stats.on_rollout(self.model, "refused")
            return RolloutResult(
                self.model, aborted=True,
                reason=f"{DEGRADE_KEY} is degraded (a previous roll "
                       f"failed its parity canary)")
        old_workers = self.router.workers_for(self.model)
        if not old_workers:
            stats.on_rollout(self.model, "noop")
            return RolloutResult(self.model, aborted=True,
                                 reason="model has no warm workers")
        replaced = 0
        for old in old_workers:
            new = self.pool.spawn_worker(model_id=self.model,
                                         **self.spawn_kwargs)
            stats.on_worker_state(self.model, new.rank, "warming")
            try:
                old_ans = self._probe(old)
                new_ans = self._probe(new)
            except Exception as e:  # noqa: BLE001 — abort, old serves
                stats.on_worker_state(self.model, new.rank, None)
                self.pool.retire(new.rank)
                degradations.degrade(DEGRADE_KEY, e)
                stats.on_rollout(self.model, "aborted")
                _flightrec.trigger("rollout_abort",
                                   detail=f"canary probe failed: {e}",
                                   model=str(self.model))
                return RolloutResult(
                    self.model, replaced=replaced, aborted=True,
                    reason=f"canary probe failed: {e}")
            if not self._parity(old_ans, new_ans):
                # mismatch: the new version answers differently — kill
                # the replacement, keep the old version serving, and
                # poison the seam so nothing retries the same roll
                stats.on_worker_state(self.model, new.rank, None)
                self.pool.retire(new.rank)
                detail = {"old": old_ans, "new": new_ans}
                degradations.degrade(
                    DEGRADE_KEY,
                    detail=f"parity canary mismatch on worker "
                           f"{old.rank}: {detail}")
                stats.on_rollout(self.model, "aborted")
                _flightrec.trigger("rollout_abort",
                                   detail="parity canary mismatch",
                                   model=str(self.model),
                                   worker=old.rank)
                return RolloutResult(
                    self.model, replaced=replaced, aborted=True,
                    reason="parity canary mismatch", canary=detail)
            # match: new worker becomes routable FIRST, then the old
            # one drains (no capacity dip, zero dropped requests)
            self.router.attach_worker(new, model=self.model)
            self.router.drain_worker(old)
            self.pool.retire(old.rank)
            replaced += 1
        stats.on_rollout(self.model, "ok")
        return RolloutResult(self.model, replaced=replaced)
