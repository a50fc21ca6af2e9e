"""THE atomic file-write protocol, in one place.

``atomic_output(path)`` yields an open temp file in the SAME directory
as ``path`` (same filesystem — ``os.replace`` must not cross a mount);
on clean exit the temp is flushed, fsync'd, and renamed into place, so
a crash at ANY point can only ever lose the new copy, never truncate an
existing file at ``path``.  On failure the temp is unlinked.

Counterpart of paddle_tpu/resilience/atomic.py, copied.  In the port
``observability.export`` writes its Prometheus and snapshot files
through it; the checkpoint and file-system users come with their own
modules.
"""
from __future__ import annotations

import contextlib
import os
import shutil

__all__ = ["atomic_output", "fsync_dir"]


def fsync_dir(path):
    """Persist a rename in its directory (POSIX entry durability);
    best-effort on filesystems that refuse directory fds."""
    try:
        fd = os.open(path or ".", os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


@contextlib.contextmanager
def atomic_output(path, mode="wb", fsync=True, copy_mode_from=None,
                  durable_dir=False):
    """Context manager yielding a temp file that atomically becomes
    ``path`` on success.

    ``copy_mode_from``: replicate this file's permission bits onto the
    result (``shutil.copy`` parity for file copies).
    ``durable_dir``: also fsync the containing directory after the
    rename (checkpoint pointers want this; bulk data usually not)."""
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, mode) as f:
            yield f
            f.flush()
            if fsync:
                os.fsync(f.fileno())
        if copy_mode_from is not None:
            shutil.copymode(copy_mode_from, tmp)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    if durable_dir:
        fsync_dir(os.path.dirname(path))
