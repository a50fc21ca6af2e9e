"""Atomic, versioned, checksummed training checkpoints.

Layout (one directory per manager)::

    <root>/
      latest                      # text file: name of the newest intact
                                  # version ("ckpt-00000042")
      ckpt-00000040/
        __params__.npz            # every persistable (params, optimizer
                                  # accumulators, BN stats) — io.save_vars
        manifest.json             # step, RNG state, per-array checksums
      ckpt-00000042/ ...

Write protocol (crash-safe at every point):

1. all files are written into a hidden temp dir (``.tmp-ckpt-*``) in the
   SAME filesystem, each file fsync'd;
2. the temp dir is atomically renamed into its versioned name — a crash
   mid-write leaves only a temp dir the next save sweeps away, never a
   half-written version;
3. the ``latest`` pointer is updated via its own temp+fsync+``os.replace``
   AFTER the version lands — readers either see the old pointer or the
   new one, both naming complete versions;
4. retention GC removes versions beyond ``keep``, oldest first, never
   the one ``latest`` names.

Restore verifies the manifest's per-array CRC32 checksums and falls
back to the next-newest intact version when the latest is corrupt
(truncated archive, flipped bits, missing manifest) — a fleet that
crashed mid-upload resumes from the previous step instead of dying on
a ``BadZipFile``.

The manifest carries the executor RNG stream state (seed + step
counter, see ``Executor._next_seed``), so a resumed run replays the
exact per-step seeds of the uninterrupted run — this is what makes
preempt/resume BIT-equal, not just close (asserted in
tests/test_torch_resilience.py and by ``chip_smoke.py`` phase 10).

Counterpart of paddle_tpu/resilience/checkpoint.py, in the same on-disk
format: a version written by one package restores in the other (the
port keeps the LR counter in int64 where the JAX package holds 32 bits;
each executor casts on placement).  The snapshot is a host copy of every
persistable taken on the step path; the disk work may run on a
background writer.  ``upload_to`` mirrors each new version to a remote
store through ``fs`` (HadoopFS commands retry transient failures with
backoff), the ``latest`` pointer last.
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading
import warnings
import zlib

import numpy as np
import torch

from .. import io as _io
from ..core.program import default_main_program
from ..core.scope import global_scope
from .atomic import atomic_output, fsync_dir as _fsync_dir

__all__ = ["CheckpointManager", "CheckpointError"]

MANIFEST_FILENAME = "manifest.json"
LATEST_FILENAME = "latest"
_VERSION_PREFIX = "ckpt-"
_TMP_PREFIX = ".tmp-"
_ASIDE_PREFIX = ".old-"   # re-save parks the previous copy here (see
                          # _write_version / _recover_aside)
_STOP = object()       # worker-shutdown sentinel (see close())


class CheckpointError(RuntimeError):
    """No intact checkpoint could be restored."""


def _fsync_file(path):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _atomic_write_text(path, text):
    with atomic_output(path, mode="w", durable_dir=True) as f:
        f.write(text)


def _checksum(arr):
    a = np.ascontiguousarray(arr)
    return zlib.crc32(a.tobytes()) & 0xFFFFFFFF


def _host_copy(val):
    """A host copy of a scope value that nothing else holds: one
    device-to-host copy for a tensor on the card, one memcpy for a CPU
    tensor or an array."""
    if torch.is_tensor(val):
        return val.detach().to("cpu", copy=True).numpy()
    return np.array(val, copy=True)


def _version_name(step):
    return f"{_VERSION_PREFIX}{step:08d}"


def _version_step(name):
    try:
        return int(name[len(_VERSION_PREFIX):])
    except ValueError:
        return None


class CheckpointManager:
    """Versioned checkpoint store for one training program.

    ``keep``: how many intact versions to retain (None = all).
    ``upload_to``: optional remote url (e.g. ``hdfs://ns/ckpt``) each
    new version is mirrored to through the `fs` layer — HadoopFS
    commands are themselves retried with backoff on transient failures.
    """

    def __init__(self, root, keep=3, upload_to=None):
        self.root = str(root)
        self.keep = keep
        self.upload_to = upload_to
        # async-save machinery (lazy): a single FIFO worker serializes
        # writes so versions/`latest` always advance in order
        self._queue = None
        self._worker = None
        self._state_lock = threading.Lock()
        # serializes worker start/stop: held across ensure+enqueue and
        # across all of close(), so a save(block=False) racing close()
        # can neither strand its job behind a _STOP nor start a second
        # worker while the first is still draining (NEVER held while
        # the worker thread might need _state_lock for error recording)
        self._lifecycle_lock = threading.Lock()
        self._error = None

    # -- inventory ---------------------------------------------------------
    def versions(self):
        """Sorted (ascending step) list of version step numbers present
        on disk (intact or not — restore() decides intactness)."""
        if not os.path.isdir(self.root):
            return []
        steps = []
        for name in os.listdir(self.root):
            if name.startswith(_VERSION_PREFIX):
                s = _version_step(name)
                if s is not None and os.path.isdir(
                        os.path.join(self.root, name)):
                    steps.append(s)
        return sorted(steps)

    def latest_step(self):
        """The step the ``latest`` pointer names, or None."""
        path = os.path.join(self.root, LATEST_FILENAME)
        try:
            with open(path) as f:
                return _version_step(f.read().strip())
        except (OSError, ValueError):
            return None

    # -- save --------------------------------------------------------------
    def save(self, step, program=None, scope=None, extra=None, block=True):
        """Snapshot every persistable and write version ``ckpt-<step>``
        atomically; returns the version path.

        ``block=False`` moves the disk work (savez, fsyncs, checksums,
        GC) to a background worker so the training step loop only pays
        for the host-side state copy — the copy itself stays synchronous
        on the step path, so the version holds this step's state
        whatever the steps after it do.  Writes are FIFO on one worker,
        so `latest` never moves backwards; a failed background write
        surfaces on the next ``save``/``join``."""
        program = program or default_main_program()
        scope = scope or global_scope()
        data = _io._collect(program, scope, lambda v: v.persistable,
                            host=_host_copy)
        rng = self._rng_state(program)
        layout = {
            "arrays": "gathered_full",
            "optimizer_state": sorted(
                v.name for v in program.list_vars()
                if getattr(v, "is_optimizer_state", False)
                and v.name in data),
        }
        if not block:
            self._drain_error()
            with self._lifecycle_lock:
                self._ensure_worker()
                self._queue.put((step, data, rng, extra, layout))
            return os.path.join(self.root, _version_name(step))
        # a blocking save must first DRAIN queued async saves: writing
        # on the caller thread while an older job is still queued would
        # let the worker move `latest` BACKWARDS afterwards (and race
        # _sweep_tmp against the worker's live temp dir)
        if self._queue is not None:
            self._queue.join()
        self._drain_error()
        return self._write_version(step, data, rng, extra, layout)

    def join(self, reraise=True):
        """Wait for queued background saves.  ``reraise=True`` re-raises
        (and clears) the first writer error; ``reraise=False`` only
        waits, leaving any stored error to surface on the next
        ``save``/``join``/``restore`` — for callers that are already
        unwinding another exception."""
        if self._queue is not None:
            self._queue.join()
        if reraise:
            self._drain_error()

    def close(self):
        """Drain queued saves and stop the background writer thread.
        Idempotent; a later ``save(block=False)`` transparently starts a
        fresh worker.  Long-lived services that build many managers
        should close each when its job ends (the writer is a daemon
        thread, so process exit never hangs either way)."""
        with self._lifecycle_lock:
            with self._state_lock:
                worker, self._worker = self._worker, None
            if worker is not None and worker.is_alive():
                self._queue.join()
                self._queue.put(_STOP)
                worker.join(timeout=10.0)
        self._drain_error()

    def _drain_error(self):
        with self._state_lock:
            err, self._error = self._error, None
        if err is not None:
            raise err

    def _ensure_worker(self):
        with self._state_lock:
            # check-then-start under the lock: two concurrent
            # save(block=False) callers must not spawn two writers (two
            # workers could complete out of order and move `latest`
            # BACKWARDS — the single-FIFO-worker invariant)
            if self._worker is None or not self._worker.is_alive():
                if self._queue is None:
                    self._queue = queue.Queue()
                self._worker = threading.Thread(
                    target=self._worker_loop, daemon=True,
                    name="paddle_tpu_torch-ckpt-writer")
                self._worker.start()

    def _worker_loop(self):
        while True:
            job = self._queue.get()
            if job is _STOP:
                self._queue.task_done()
                return
            try:
                self._write_version(*job)
            except BaseException as e:
                with self._state_lock:
                    if self._error is None:
                        self._error = e
            finally:
                self._queue.task_done()

    def _write_version(self, step, data, rng, extra, layout=None):
        os.makedirs(self.root, exist_ok=True)
        self._sweep_tmp()
        tmp = os.path.join(self.root,
                           f"{_TMP_PREFIX}{_version_name(step)}.{os.getpid()}")
        os.makedirs(tmp)
        try:
            _io.save_vars(None, tmp, data)
            _fsync_file(_io._params_path(tmp, None))
            manifest = {
                "format": 1,
                "step": int(step),
                "rng": rng,
                "arrays": {
                    n: {"crc32": _checksum(a),
                        "shape": list(np.shape(a)),
                        "dtype": str(np.asarray(a).dtype)}
                    for n, a in data.items()
                },
                "extra": extra or {},
                "layout": layout or {},
            }
            mpath = os.path.join(tmp, MANIFEST_FILENAME)
            with open(mpath, "w") as f:
                json.dump(manifest, f, indent=1)
                f.flush()
                os.fsync(f.fileno())
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        final = os.path.join(self.root, _version_name(step))
        aside = None
        if os.path.exists(final):      # re-save of the same step
            # park-then-replace, NOT rmtree-then-replace: a crash at any
            # point leaves either the old intact copy (renamed back by
            # _recover_aside on the next save/restore) or the new one —
            # deleting first would open a window where `latest` names a
            # version that no longer exists anywhere
            aside = os.path.join(
                self.root,
                f"{_ASIDE_PREFIX}{_version_name(step)}.{os.getpid()}")
            shutil.rmtree(aside, ignore_errors=True)
            os.rename(final, aside)
        os.replace(tmp, final)
        _fsync_dir(self.root)
        if aside is not None:
            shutil.rmtree(aside, ignore_errors=True)
        _atomic_write_text(os.path.join(self.root, LATEST_FILENAME),
                           _version_name(step))
        self._gc()
        if self.upload_to:
            self._upload_version(_version_name(step))
        return final

    @staticmethod
    def _rng_state(program):
        seed = program.random_seed or getattr(program, "_auto_seed", None)
        return {"seed": seed,
                "counter": int(getattr(program, "_rng_counter", 0))}

    def _recover_aside(self):
        """Finish an interrupted re-save: if the replace never landed,
        the parked old copy is the only intact one — rename it back; if
        the replace DID land, the parked copy is garbage."""
        if not os.path.isdir(self.root):
            return
        for name in os.listdir(self.root):
            if not name.startswith(_ASIDE_PREFIX):
                continue
            version = name[len(_ASIDE_PREFIX):].rsplit(".", 1)[0]
            path = os.path.join(self.root, name)
            final = os.path.join(self.root, version)
            if os.path.exists(final):
                shutil.rmtree(path, ignore_errors=True)
            else:
                try:
                    os.rename(path, final)
                except OSError:
                    pass

    def _sweep_tmp(self):
        self._recover_aside()
        for name in os.listdir(self.root):
            path = os.path.join(self.root, name)
            if name.startswith(_TMP_PREFIX):
                shutil.rmtree(path, ignore_errors=True)
            elif ".tmp." in name and os.path.isfile(path):
                # stray pointer temp from a crash mid-_atomic_write_text
                try:
                    os.unlink(path)
                except OSError:
                    pass

    def _gc(self):
        if self.keep is None:
            return
        steps = self.versions()
        latest = self.latest_step()
        for s in steps[:max(0, len(steps) - self.keep)]:
            if s == latest:
                continue
            shutil.rmtree(os.path.join(self.root, _version_name(s)),
                          ignore_errors=True)

    def _upload_version(self, version):
        from .. import fs

        src = os.path.join(self.root, version)
        dst = f"{self.upload_to.rstrip('/')}/{version}"
        fs.mkdir(dst)
        for name in sorted(os.listdir(src)):
            fs.upload(os.path.join(src, name), f"{dst}/{name}")
        # pointer last: a remote reader never sees `latest` name a
        # version whose files are still uploading
        fs.upload(os.path.join(self.root, LATEST_FILENAME),
                  f"{self.upload_to.rstrip('/')}/{LATEST_FILENAME}")

    # -- restore -----------------------------------------------------------
    def restore(self, program=None, scope=None, strict=True):
        """Load the newest INTACT version into the scope and restore the
        program's RNG stream.  Returns the manifest dict, or None when
        the store is empty.  ``strict=False`` tolerates arrays in the
        archive that the program does not declare (they are skipped).

        Corrupt versions (bad checksum, unreadable archive, missing or
        malformed manifest) are skipped with a warning, falling back to
        the next-newest version — a partial checkpoint is NEVER
        half-applied: verification completes before any scope write."""
        declared = {v.name for v in (program or default_main_program())
                    .list_vars() if v.persistable}
        program = program or default_main_program()
        scope = scope or global_scope()
        if self._queue is not None:
            # settle in-flight background saves; a failed write is only
            # a warning here — what restore trusts is the disk state
            try:
                self.join()
            except Exception as e:
                warnings.warn(f"pending background checkpoint save "
                              f"failed: {e}")
        if os.path.isdir(self.root):
            # a fresh process resuming after a crash mid-re-save is
            # exactly when the parked copy must be put back
            self._recover_aside()
        candidates = self._restore_order()
        if not candidates:
            return None
        errors = []
        for version in candidates:
            path = os.path.join(self.root, version)
            try:
                manifest, data = self._load_verified(path)
            except Exception as e:
                errors.append(f"{version}: {e}")
                warnings.warn(
                    f"checkpoint {path} is corrupt ({e}); falling back "
                    f"to the previous version")
                continue
            extra = sorted(set(data) - declared)
            missing = sorted(declared - set(data))
            if strict and (extra or missing):
                # an INTACT checkpoint that does not match the program's
                # persistable set means the store/program pairing is
                # wrong (model gained/lost a layer, wrong directory) —
                # surface it immediately, outside the corruption
                # fallback: resuming from an older version would only
                # hide it, and a declared var left at its fresh-init
                # value silently voids the bit-equal-resume guarantee
                raise CheckpointError(
                    f"checkpoint {path} does not match the program: "
                    + (f"missing persistable(s) {missing}" if missing
                       else "")
                    + ("; " if missing and extra else "")
                    + (f"unknown to the program: {extra}" if extra
                       else "")
                    + " (pass strict=False to load the intersection)")
            for name, arr in data.items():
                if name in declared:
                    scope.set_var(name, arr)
            rng = manifest.get("rng") or {}
            program._rng_counter = int(rng.get("counter", 0))
            if rng.get("seed") is not None and not program.random_seed:
                program._auto_seed = rng["seed"]
            return manifest
        raise CheckpointError(
            "no intact checkpoint in " + self.root + ": "
            + "; ".join(errors))

    def _restore_order(self):
        steps = self.versions()
        order = [_version_name(s) for s in sorted(steps, reverse=True)]
        latest = self.latest_step()
        if latest is not None and _version_name(latest) in order:
            order.remove(_version_name(latest))
            order.insert(0, _version_name(latest))
        return order

    def _load_verified(self, path):
        mpath = os.path.join(path, MANIFEST_FILENAME)
        with open(mpath) as f:
            manifest = json.load(f)
        wanted = manifest.get("arrays", {})
        data = {}
        with np.load(_io._params_path(path, None)) as archive:
            missing = sorted(set(wanted) - set(archive.files))
            if missing:
                raise CheckpointError(
                    f"archive is missing arrays {missing}")
            for name, meta in wanted.items():
                arr = archive[name]
                crc = _checksum(arr)
                if crc != meta["crc32"]:
                    raise CheckpointError(
                        f"checksum mismatch for '{name}' "
                        f"(stored {meta['crc32']}, computed {crc})")
                data[name] = arr
        return manifest, data
