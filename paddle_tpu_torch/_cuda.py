"""Build, load and count the port's hand-written CUDA kernels.

Each kernel source ``csrc/<name>.cu`` exposes a plain C interface and is
compiled with ``nvcc`` for ``sm_90a`` into a shared library that is
loaded with ``ctypes``.  The build happens at first use, into
``paddle_tpu_torch/_build`` (git ignores it), and the library's file
name carries a hash of the source and the flags, so an edited source is
rebuilt and a stale library is never loaded.

Two process-wide counters make the kernel path observable:

* ``LAUNCHES[name]`` — launches of each kernel; a wrapper adds one where
  it launches its kernel and nowhere else.
* ``library_loads()`` — libraries built or loaded so far; the engine's
  ``compile_count`` (a load after warmup is a steady-state compile).

Nothing here runs at import: no ``nvcc``, no CUDA call.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["LAUNCHES", "NVCC_FLAGS", "build", "library", "library_loads",
           "reset_launches", "check"]

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: kernel name -> launches (read and reset by chip_smoke.py and tests)
LAUNCHES = collections.Counter()
#: kernel name -> (seconds, nvcc's stderr) of the build this process ran
BUILD_LOG = {}

_lock = threading.Lock()
_libs = {}
_loads = 0


def reset_launches():
    LAUNCHES.clear()


def library_loads():
    return _loads


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels are built from "
        "paddle_tpu_torch/csrc at first use and need the CUDA toolkit")


def _target(name):
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return src, BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names):
    """Compile every stale library among ``names``, all ``nvcc``
    processes started together; returns {name: seconds} for the ones
    built.  Raises RuntimeError naming the source if one fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        src, so = _target(name)
        if so.exists():
            continue
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True), tmp, so, time.perf_counter())
    built = {}
    failures = []
    for name, (proc, tmp, so, t0) in procs.items():
        _, err = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"{name}.cu (nvcc rc {proc.returncode}):\n{err}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, so)        # atomic: a reader never sees half a file
        BUILD_LOG[name] = (secs, err)
        built[name] = secs
    if failures:
        raise RuntimeError("kernel build failed: " + "\n".join(failures))
    return built


def library(name):
    """The loaded ``ctypes.CDLL`` of ``csrc/<name>.cu``, built if stale."""
    global _loads
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _, so = _target(name)
            if not so.exists():
                build([name])
            lib = ctypes.CDLL(str(so))
            lib.paddle_cuda_error_string.argtypes = [ctypes.c_int]
            lib.paddle_cuda_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
            _loads += 1
        return lib


def check(lib, rc, what):
    """Raise if a kernel's C entry returned a CUDA error (the launch was
    refused or an earlier asynchronous fault surfaced)."""
    if rc != 0:
        msg = lib.paddle_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
