"""Auto-resuming, NaN-guarded training loop.

:class:`ResilientLoop` wraps the executor step loop (the host-driven
side of ``core/trainer.py``) with the three behaviors a preemptible
fleet needs:

* **checkpoint every N steps** through a
  :class:`~paddle_tpu_torch.resilience.checkpoint.CheckpointManager` —
  atomic versions carrying params, optimizer accumulators AND the
  executor RNG stream state;
* **auto-resume**: ``run()`` first restores the newest intact version
  and continues from its step.  Because the feed is a *function of the
  step index* (not a consumed iterator) and the RNG fold-in counter is
  restored, the replayed steps are bit-identical to an uninterrupted
  run with the same seed;
* **non-finite loss guard**: each step's loss is checked on the host;
  a NaN/Inf step is rolled back (the pre-step persistables are put back
  into the scope) and skipped, up to ``max_consecutive_skips`` in a row
  before :class:`NonFiniteLossError` aborts the job.  The snapshot
  holds REFERENCES to the pre-step values, not copies: the port's
  Executor writes each step's persistables back as new tensors and no
  op writes a scope tensor in place (tests/test_torch_resilience.py
  checks every pre-step tensor's ``_version`` across a step of the BERT
  recipe), so a reference keeps the pre-step value at no cost (where
  XLA donates the old buffers, a host copy is needed instead).

Counterpart of paddle_tpu/resilience/train_loop.py (a copy, imports
pointed at the port; mixed precision is not ported).

Preemption is delivered through ``resilience.faults`` when a plan is
armed (tests) — a real deployment simply lets SIGTERM kill the process;
both resume identically.
"""
from __future__ import annotations

import time

import numpy as np

from ..core.program import default_main_program
from ..core.scope import global_scope
from ..observability import tracing as _tracing
from . import faults

__all__ = ["ResilientLoop", "NonFiniteLossError"]


class NonFiniteLossError(RuntimeError):
    """The loss was NaN/Inf for more than ``max_consecutive_skips``
    consecutive steps — the run has diverged; aborting beats burning
    accelerator time skipping forever."""


class ResilientLoop:
    """Fault-tolerant driver for one training program.

    Parameters
    ----------
    executor, program : the step pair (``Executor.run`` is the per-step
        engine, so the lowering cache is shared with any other driver of
        the same program).
    loss : the loss Variable (or its name) fetched every step.
    manager : optional CheckpointManager; None disables checkpointing
        (the NaN guard still works).
    checkpoint_every : save a version after every N completed steps.
    nan_guard : keep the pre-step persistables and roll back on a
        non-finite loss.  Costs a reference per persistable (and keeps
        the pre-step tensors alive through the step).
    max_consecutive_skips : NaN-step budget before aborting.
    monitor : optional :class:`~paddle_tpu_torch.observability.
        TrainingMonitor` — receives every step (wall time, loss,
        examples), NaN skip, and checkpoint save; None emits nothing
        (zero per-step telemetry cost).
    """

    def __init__(self, executor, program=None, loss=None, manager=None,
                 checkpoint_every=50, nan_guard=True,
                 max_consecutive_skips=3, scope=None, async_save=True,
                 monitor=None):
        self.executor = executor
        self.program = program or default_main_program()
        self.loss_name = (loss if isinstance(loss, (str, type(None)))
                          else loss.name)
        self.manager = manager
        self.checkpoint_every = checkpoint_every
        self.nan_guard = nan_guard
        self.max_consecutive_skips = max_consecutive_skips
        self.scope = scope
        # overlap checkpoint disk writes with the next steps' compute
        # (the state SNAPSHOT is always synchronous — see
        # CheckpointManager.save); run() joins before returning
        self.async_save = async_save
        self.monitor = monitor
        # run() telemetry
        self.start_step = 0
        self.skipped_steps = []
        self.checkpoints_written = 0

    # -- internals ---------------------------------------------------------
    def _persistable_names(self, scope):
        return [v.name for v in self.program.list_vars()
                if v.persistable and scope.has_var(v.name)]

    def _snapshot(self, scope, names):
        # references: the executor writes new tensors back and never
        # writes a scope value in place (see the module docstring)
        return {n: scope.find_var(n) for n in names}

    # -- driver ------------------------------------------------------------
    def run(self, feed_fn, n_steps, resume=True, save_final=True):
        """Run steps ``[start, n_steps)`` where ``start`` comes from the
        newest checkpoint (0 when none / ``resume=False``).

        ``feed_fn(step) -> {name: array}`` must be deterministic in the
        step index — that is the resumability contract (an iterator
        cannot be rewound to the checkpointed step).

        Returns the list of finite per-step mean losses (skipped steps
        contribute nothing)."""
        scope = self.scope or global_scope()
        self.skipped_steps = []
        self.checkpoints_written = 0
        start = 0
        if self.manager is not None and resume:
            manifest = self.manager.restore(program=self.program,
                                            scope=scope)
            if manifest is not None:
                start = int(manifest["step"])
        self.start_step = start
        if start >= n_steps:
            return []

        names = self._persistable_names(scope)
        fetch = [self.loss_name] if self.loss_name else []
        losses = []
        try:
            self._run_steps(feed_fn, start, n_steps, scope, names, fetch,
                            losses, save_final)
        except BaseException:
            if self.manager is not None and self.async_save:
                # already unwinding (e.g. a preemption): settle in-flight
                # writes WITHOUT draining the writer's error, so it is
                # neither lost nor allowed to mask the real exception —
                # it re-surfaces on the next save/join/restore
                self.manager.join(reraise=False)
            raise
        if self.manager is not None and self.async_save:
            self.manager.join()          # a failed final save must surface
        return losses

    @staticmethod
    def _examples_in(feed):
        """Examples per step = the leading dim of any batched feed (the
        resumability contract makes feeds tensors, so this is cheap)."""
        for v in feed.values():
            shape = np.shape(v)
            if len(shape) >= 1:
                return int(shape[0])
        return None

    def _save(self, step, scope):
        t0 = time.perf_counter()
        self.manager.save(step, program=self.program, scope=scope,
                          block=not self.async_save)
        self.checkpoints_written += 1
        if self.monitor is not None:
            # async mode: this is the time the save occupied the STEP
            # path (snapshot + enqueue), which is what step-time
            # telemetry attributes; the disk write overlaps compute
            self.monitor.on_checkpoint(step, time.perf_counter() - t0)

    def _run_steps(self, feed_fn, start, n_steps, scope, names, fetch,
                   losses, save_final):
        skips = 0
        for step in range(start, n_steps):
            faults.maybe_preempt(step)
            t_step = time.perf_counter()
            with _tracing.span("train:step", step=step):
                feed = faults.maybe_corrupt_feed(step, feed_fn(step))
                snap = (self._snapshot(scope, names)
                        if (self.nan_guard and fetch) else None)
                out = self.executor.run(self.program, feed=feed,
                                        fetch_list=fetch, scope=scope)
            skipped = False
            if fetch:
                loss_v = np.asarray(out[0])
                if snap is not None and not np.all(np.isfinite(loss_v)):
                    for n, v in snap.items():
                        scope.set_var(n, v)
                    self.skipped_steps.append(step)
                    skipped = True
                    skips += 1
                    if self.monitor is not None:
                        self.monitor.on_nan_skip(step)
                    # flight-recorder trigger: a NaN skip is exactly the
                    # moment the ring's recent steps are worth keeping
                    try:
                        from ..observability import flightrec

                        flightrec.trigger("nan_skip", step=step)
                    except Exception:  # noqa: BLE001 — never raises
                        pass
                    if skips > self.max_consecutive_skips:
                        raise NonFiniteLossError(
                            f"loss non-finite for {skips} consecutive "
                            f"steps (last: step {step}); aborting — "
                            f"the last checkpoint is step "
                            f"{self.manager.latest_step() if self.manager else None}")
                else:
                    skips = 0
                    losses.append(float(np.mean(loss_v)))
            step_wall = time.perf_counter() - t_step
            # NOTE: a skipped step still reaches the checkpoint block —
            # the step is CONSUMED (rolled-back state, advanced RNG), so
            # a boundary save must record it or the final interval of a
            # run whose last step skipped would be lost to restore
            done = step + 1
            if (self.manager is not None and self.checkpoint_every
                    and done % self.checkpoint_every == 0):
                self._save(done, scope)
            # monitor AFTER the checkpoint block so the save at this
            # step's boundary lands in THIS step's record, not the next
            # one's (a final save flushes via monitor.close); step_ms
            # stays compute-only — the save cost is its own field
            if self.monitor is not None and not skipped:
                self.monitor.on_step(
                    step, loss=(losses[-1] if fetch and losses else None),
                    wall_s=step_wall,
                    examples=self._examples_in(feed))
        already_saved = (self.checkpoint_every
                         and n_steps % self.checkpoint_every == 0)
        if self.manager is not None and save_final and not already_saved:
            self._save(n_steps, scope)
