"""Pluggable filesystem layer (parity: paddle/fluid/framework/io/fs.cc
+ shell.cc and incubate/fleet/utils/hdfs.py:45 HDFSClient).

The reference reads datasets and writes checkpoints through a uniform
local/HDFS API that shells out to ``hadoop fs`` for remote paths; the
dataset pipeline and PS-mode checkpointing both route through it.  Here
the same routing: paths are dispatched by scheme — ``hdfs://`` /
``afs://`` go to :class:`HadoopFS` (shelling out, command configurable
via ``FLAGS`` env ``PADDLE_TPU_HADOOP_CMD`` or :func:`hdfs_set_command`),
anything else to :class:`LocalFS`.  Remote reads are LOCALIZED (fetched
to a cache dir) before parsing — the slot parser reads local files; the
reference's streaming-pipe variant buys nothing here.

Counterpart of paddle_tpu/fs.py, over the port's ``resilience.retry``
and ``resilience.faults``; ``dataset.py`` localizes remote file-list
entries through it and ``resilience.CheckpointManager(upload_to=...)``
mirrors versions through it.

Usage::

    from paddle_tpu_torch import fs
    local_path = fs.localize("hdfs://ns/warehouse/part-00000")
    fs.exists("hdfs://ns/warehouse")
    fs.upload("model/ckpt-1", "hdfs://ns/ckpt/ckpt-1")
"""
from __future__ import annotations

import os
import re
import shutil
import subprocess
import tempfile
import threading

from .resilience import faults as _faults
from .resilience.retry import TransientError, retry_call

__all__ = ["LocalFS", "HadoopFS", "select", "exists", "ls", "mkdir",
           "remove", "localize", "upload", "download",
           "hdfs_set_command", "hdfs_command", "TransientError"]

_REMOTE_SCHEMES = ("hdfs://", "afs://")
_hadoop_cmd = None


def hdfs_set_command(cmd):
    """Override the hadoop launcher (parity: hdfs_set_command fs.cc)."""
    global _hadoop_cmd
    _hadoop_cmd = cmd


def hdfs_command():
    return (_hadoop_cmd
            or os.environ.get("PADDLE_TPU_HADOOP_CMD", "hadoop fs"))


class LocalFS:
    """Plain local filesystem backend (parity: localfs_* in fs.cc)."""

    def exists(self, path):
        return os.path.exists(path)

    def is_file(self, path):
        return os.path.isfile(path)

    def ls(self, path):
        if not os.path.isdir(path):
            return [path] if os.path.exists(path) else []
        return sorted(
            os.path.join(path, p) for p in os.listdir(path))

    def mkdir(self, path):
        os.makedirs(path, exist_ok=True)

    def remove(self, path):
        if os.path.isdir(path):
            shutil.rmtree(path)
        elif os.path.exists(path):
            os.unlink(path)

    def localize(self, path, cache_dir=None):
        return path                      # already local

    @staticmethod
    def _atomic_copy(src, dst):
        """copy via the shared temp+fsync+rename protocol
        (``resilience.atomic``) — a crash mid-copy never truncates an
        existing file at ``dst``; permission bits follow the source
        (shutil.copy parity)."""
        from .resilience.atomic import atomic_output

        if os.path.isdir(dst):
            dst = os.path.join(dst, os.path.basename(src))
        with atomic_output(dst, copy_mode_from=src) as fdst:
            with open(src, "rb") as fsrc:
                shutil.copyfileobj(fsrc, fdst)
            fdst.flush()
            _faults.maybe_fail("fs_write", path=dst)

    def download(self, src, dst):
        self.mkdir(os.path.dirname(dst) or ".")
        self._atomic_copy(src, dst)

    def upload(self, src, dst):
        self.download(src, dst)


#: stderr patterns that mark a hadoop shell failure as worth retrying —
#: the storage/network hiccup class, not user error.  (Parity: the
#: reference HDFSClient retries every command a fixed count; classifying
#: first means "file not found" fails in one round trip instead of N.)
#: Every alternation is multi-word or a specific exception class name:
#: error text always embeds the USER-SUPPLIED PATH, so a bare token like
#: `timeout` would misclassify `rm /jobs/timeout-sweep: No such file`
#: as transient and burn the whole retry deadline on a permanent error.
_TRANSIENT_PATTERNS = re.compile(
    "|".join([
        r"connection (refused|reset|timed out)",
        r"timed out",
        r"sockettimeoutexception|connecttimeoutexception",
        r"temporarily unavailable",
        r"safe ?mode is on|in safe ?mode",
        r"lease .*(expired|recover)",
        r"could not obtain block",
        r"retriableexception|standbyexception",
        r"no route to host|network is unreachable",
    ]), re.IGNORECASE)


class HadoopFS:
    """``hadoop fs`` shell-out backend (parity: hdfs_* in fs.cc, which
    runs "<hdfs_command> -<verb> ..." through shell.cc; and the Python
    HDFSClient of incubate/fleet/utils/hdfs.py).

    Mutating/reading commands are retried with jittered exponential
    backoff when the failure classifies as TRANSIENT (see
    ``_TRANSIENT_PATTERNS``); permanent failures (missing path, bad
    perms) raise immediately.  Policy knobs via the constructor or env:
    ``PADDLE_TPU_FS_RETRIES`` / ``PADDLE_TPU_FS_RETRY_BASE_S`` /
    ``PADDLE_TPU_FS_RETRY_DEADLINE_S``."""

    def __init__(self, command=None, cache_dir=None, retries=None,
                 retry_base_delay=None, retry_deadline=None):
        self._command = command
        self._cache = cache_dir
        self._lock = threading.Lock()
        self._path_locks = {}
        self._retries = int(
            retries if retries is not None
            else os.environ.get("PADDLE_TPU_FS_RETRIES", "4"))
        self._retry_base = float(
            retry_base_delay if retry_base_delay is not None
            else os.environ.get("PADDLE_TPU_FS_RETRY_BASE_S", "0.5"))
        self._retry_deadline = float(
            retry_deadline if retry_deadline is not None
            else os.environ.get("PADDLE_TPU_FS_RETRY_DEADLINE_S", "120"))

    def _cmd(self, *args):
        base = (self._command or hdfs_command()).split()
        r = subprocess.run([*base, *args], capture_output=True, text=True)
        return r

    @staticmethod
    def _is_transient(r):
        msg = f"{r.stderr} {r.stdout}"
        return bool(_TRANSIENT_PATTERNS.search(msg))

    def _check(self, r, what):
        """Classify a failed command: transient (retryable) failures
        raise TransientError, everything else RuntimeError."""
        if r.returncode != 0:
            detail = (f"hadoop fs {what} failed (rc={r.returncode}): "
                      f"{r.stderr.strip() or r.stdout.strip()}")
            if self._is_transient(r):
                raise TransientError(detail)
            raise RuntimeError(detail)
        return r

    def _checked(self, what, *args):
        """Run + check one command, retrying transient failures."""
        return retry_call(
            lambda: self._check(self._cmd(*args), what),
            max_attempts=max(1, self._retries),
            base_delay=self._retry_base,
            deadline=self._retry_deadline,
            # flag only, not the full "what" string: a path in a metric
            # label would explode series cardinality
            op_name=f"hadoop {what.split()[0]}")

    def _test(self, flag, path):
        """``-test`` answers False with rc=1 and no error text; anything
        transient-looking (or an rc other than 0/1) is a command FAILURE,
        not an answer — a NameNode hiccup must not read as "absent"
        (a caller probing for a remote checkpoint would restart from
        scratch on a False that really meant "try again")."""

        def once():
            r = self._cmd("-test", flag, path)
            if r.returncode == 0:
                return True
            if self._is_transient(r):
                raise TransientError(
                    f"hadoop fs -test {flag} {path} (rc={r.returncode}): "
                    f"{r.stderr.strip()}")
            if r.returncode == 1:
                return False
            raise RuntimeError(
                f"hadoop fs -test {flag} {path} failed "
                f"(rc={r.returncode}): {r.stderr.strip() or r.stdout.strip()}")

        return retry_call(once, max_attempts=max(1, self._retries),
                          base_delay=self._retry_base,
                          deadline=self._retry_deadline,
                          op_name="hadoop -test")

    def exists(self, path):
        return self._test("-e", path)

    def is_file(self, path):
        return self._test("-f", path)

    def ls(self, path):
        r = self._checked(f"-ls {path}", "-ls", path)
        out = []
        for line in r.stdout.splitlines():
            parts = line.split()
            # "drwxr-xr-x - user group size date time path"
            if len(parts) >= 8 and (parts[0].startswith("-")
                                    or parts[0].startswith("d")):
                out.append(parts[-1])
        return out

    def mkdir(self, path):
        self._checked(f"-mkdir {path}", "-mkdir", "-p", path)

    def remove(self, path):
        self._checked(f"-rm {path}", "-rm", "-r", path)

    def _cache_dir(self):
        with self._lock:
            if self._cache is None:
                self._cache = tempfile.mkdtemp(prefix="paddle_tpu_hdfs_")
            return self._cache

    def _path_lock(self, path):
        with self._lock:
            return self._path_locks.setdefault(path, threading.Lock())

    def localize(self, path, cache_dir=None):
        """Fetch a remote file into the cache; returns the local path.
        Idempotent per full remote path — the cache name embeds a hash
        of the whole path, so same-basename files from different
        directories (day1/part-0 vs day2/part-0, the standard warehouse
        layout) never collide.  Concurrent calls for the SAME path
        serialize on a per-path lock (the dataset thread pool hits this
        when a filelist repeats a file), so a fetch in flight is never
        mistaken for a stale leftover.

        Note the cache is unbounded — it exists for checkpoint/model
        reads; the dataset's out-of-core path downloads into private
        temp files it deletes after parsing instead."""
        import hashlib

        d = cache_dir or self._cache_dir()
        os.makedirs(d, exist_ok=True)
        tag = hashlib.sha1(path.encode()).hexdigest()[:12]
        local = os.path.join(d, f"{tag}_{os.path.basename(path)}")
        with self._path_lock(path):
            if not os.path.exists(local):
                tmp = local + ".part"
                self._get_fresh(path, tmp)  # clears stale leftovers itself
                os.replace(tmp, local)
        return local

    def _get_fresh(self, src, dst):
        """Retried -get that clears the partial target between attempts
        (``-get`` refuses to overwrite an existing file)."""

        def once():
            if os.path.exists(dst):
                os.unlink(dst)
            self._check(self._cmd("-get", src, dst), f"-get {src}")

        retry_call(once, max_attempts=max(1, self._retries),
                   base_delay=self._retry_base,
                   deadline=self._retry_deadline,
                   op_name="hadoop -get")

    def download(self, src, dst):
        os.makedirs(os.path.dirname(dst) or ".", exist_ok=True)
        # fetch into a temp then rename: a transient mid-transfer
        # failure (retried) or crash never leaves a truncated dst
        tmp = f"{dst}.tmp.{os.getpid()}"
        try:
            self._get_fresh(src, tmp)
            os.replace(tmp, dst)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def upload(self, src, dst):
        self._checked(f"-put {dst}", "-put", "-f", src, dst)


_local = LocalFS()
_hadoop = None


def select(path):
    """Backend for a path (parity: fs_select_internal, fs.cc)."""
    global _hadoop
    if isinstance(path, str) and path.startswith(_REMOTE_SCHEMES):
        if _hadoop is None:
            _hadoop = HadoopFS()
        return _hadoop
    return _local


def exists(path):
    return select(path).exists(path)


def ls(path):
    return select(path).ls(path)


def mkdir(path):
    return select(path).mkdir(path)


def remove(path):
    return select(path).remove(path)


def localize(path, cache_dir=None):
    return select(path).localize(path, cache_dir)


def download(src, dst):
    return select(src).download(src, dst)


def upload(src, dst):
    return select(dst).upload(src, dst)
