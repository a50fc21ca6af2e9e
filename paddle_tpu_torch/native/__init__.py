"""Native (C++) components of the port, built at first use with the
system's g++.

Counterpart of paddle_tpu/native/__init__.py for the MultiSlot parser
and the parameter server.  ``slot_parser.cpp`` is the JAX package's
source, copied unchanged, and builds with ``g++ -O3 -std=c++17 -shared
-fPIC`` into ``paddle_tpu_torch/_build/`` (git ignores it), rebuilt when
the source or the command changes (``build_if_stale``).
``ps_server.cpp`` is the JAX package's parameter server (its wire
protocol, ``splitmix64`` row init, sgd/adagrad update, barriers,
heartbeats and save format byte for byte) with one repair: ``SAVE``
closes the file and reads the stream's state before it answers, so a
client's ``save`` returns only once the file is whole on disk, and a
failed write answers 1.  It builds with ``g++ -O2 -std=c++17 -shared
-fPIC -pthread`` (``get_ps_server``).  Nothing builds at import.

No quiet fallback: a failed build raises with the compiler's stderr.
``parse_multislot_file_python`` is the plain version, the same format
in pure Python; setting ``_lib, _tried = None, True`` routes
``parse_multislot_file`` to it (the tests do, to hold one against the
other).  The PJRT loader of the JAX package's ``native/`` is not ported
here.
"""
from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

__all__ = ["build_if_stale", "get_ps_server", "get_slot_parser",
           "parse_multislot_file", "parse_multislot_file_python"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
_LIB_PATH = os.path.join(_BUILD_DIR, "_slot_parser.so")
_SRC_PATH = os.path.join(_HERE, "slot_parser.cpp")
_PS_LIB_PATH = os.path.join(_BUILD_DIR, "_ps_server.so")
_PS_SRC_PATH = os.path.join(_HERE, "ps_server.cpp")

_lib = None
_tried = False
_ps_lib = None


def build_if_stale(out, cmd, srcs, subst=None):
    """Run `cmd` unless `out` exists and was built from exactly these
    sources with exactly this command.  Staleness is keyed on a content
    hash of the sources AND the command line (so flag changes rebuild),
    stored in a sibling ``<out>.srchash`` stamp — never on mtimes, which
    are all equal to checkout time after a fresh clone and would
    silently prefer a stale or wrong-arch artifact.

    ``cmd`` elements may contain ``{name}`` placeholders resolved via
    the ``subst()`` callable (returning a dict) only when a build
    actually runs.  The digest is over the placeholder form.

    The compiler writes to a temp file renamed into place, so
    concurrent first builds (several processes on a fresh checkout)
    never observe a partially written binary.  A failed build raises
    ``RuntimeError`` with the compiler's stderr."""
    import hashlib
    import tempfile

    h = hashlib.sha256()
    for s in srcs:
        with open(s, "rb") as f:
            data = f.read()
        h.update(str(len(data)).encode() + b":")
        h.update(data)
    h.update("\x00".join(cmd).encode())
    digest = h.hexdigest()
    stamp = out + ".srchash"
    if os.path.exists(out) and os.path.exists(stamp):
        with open(stamp) as f:
            if f.read().strip() == digest:
                return
    if subst is not None:
        mapping = subst()
        cmd = [c.format_map(mapping) if "{" in c else c for c in cmd]
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(out) or ".",
                               suffix=".build")
    os.close(fd)
    try:
        r = subprocess.run([tmp if c == out else c for c in cmd],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(
                f"native build failed ({' '.join(cmd)}):\n{r.stderr}")
        os.chmod(tmp, 0o755)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    with open(stamp, "w") as f:
        f.write(digest + "\n")


def get_slot_parser():
    """The ctypes library of slot_parser.cpp, built on the first call.
    Raises when the build fails (and tries again on the next call);
    returns None only after a caller selected the plain parser
    (``_lib, _tried = None, True``)."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    build_if_stale(
        _LIB_PATH,
        ["g++", "-O3", "-std=c++17", "-shared", "-fPIC",
         _SRC_PATH, "-o", _LIB_PATH],
        [_SRC_PATH])
    lib = ctypes.CDLL(_LIB_PATH)
    lib.pt_parse_file.restype = ctypes.c_void_p
    lib.pt_parse_file.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.pt_slot_size.restype = ctypes.c_int64
    lib.pt_slot_size.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.pt_slot_fill.restype = None
    lib.pt_slot_fill.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.pt_free.restype = None
    lib.pt_free.argtypes = [ctypes.c_void_p]
    _lib, _tried = lib, True
    return _lib


def get_ps_server():
    """The ctypes library of ps_server.cpp (server and client ABI), built
    on the first call.  Raises when the build fails (and tries again on
    the next call)."""
    global _ps_lib
    if _ps_lib is not None:
        return _ps_lib
    build_if_stale(
        _PS_LIB_PATH,
        ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-pthread",
         _PS_SRC_PATH, "-o", _PS_LIB_PATH],
        [_PS_SRC_PATH])
    lib = ctypes.CDLL(_PS_LIB_PATH)
    lib.pt_ps_serve.restype = ctypes.c_int
    lib.pt_ps_serve.argtypes = [
        ctypes.c_int, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_char_p,
        ctypes.c_float, ctypes.c_uint64, ctypes.c_uint32, ctypes.c_int64]
    lib.pt_ps_connect.restype = ctypes.c_void_p
    lib.pt_ps_connect.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                  ctypes.c_uint32]
    lib.pt_ps_pull.restype = ctypes.c_int
    lib.pt_ps_pull.argtypes = [
        ctypes.c_void_p, ctypes.c_uint32, ctypes.c_void_p,
        ctypes.c_uint64, ctypes.c_uint32, ctypes.c_void_p]
    lib.pt_ps_push.restype = ctypes.c_int
    lib.pt_ps_push.argtypes = [
        ctypes.c_void_p, ctypes.c_uint32, ctypes.c_void_p,
        ctypes.c_uint64, ctypes.c_uint32, ctypes.c_void_p, ctypes.c_float]
    for name in ("pt_ps_barrier", "pt_ps_heartbeat", "pt_ps_stop"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p]
    for name in ("pt_ps_save", "pt_ps_load"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.pt_ps_stats.restype = ctypes.c_int
    lib.pt_ps_stats.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32)]
    lib.pt_ps_disconnect.restype = None
    lib.pt_ps_disconnect.argtypes = [ctypes.c_void_p]
    _ps_lib = lib
    return lib


def parse_multislot_file(path, slot_types):
    """Parse one MultiSlot text file (per line, for each slot in order:
    ``<count> v1 .. v<count>``; a malformed line drops its instance).

    slot_types: list of 'f' / 'u' per slot.
    Returns (n_instances, [(values ndarray, offsets ndarray)] per slot):
    float32 values for 'f', int64 for 'u', int64 CSR offsets."""
    lib = get_slot_parser()
    if lib is None:
        return parse_multislot_file_python(path, slot_types)
    n = ctypes.c_int64(0)
    handle = lib.pt_parse_file(
        path.encode(), len(slot_types),
        "".join(slot_types).encode(), ctypes.byref(n))
    if not handle:
        raise IOError(f"cannot parse {path}")
    try:
        out = []
        for i, t in enumerate(slot_types):
            size = lib.pt_slot_size(handle, i)
            values = np.empty(
                size, dtype=np.float32 if t == "f" else np.int64)
            offsets = np.empty(n.value + 1, dtype=np.int64)
            lib.pt_slot_fill(
                handle, i, values.ctypes.data_as(ctypes.c_void_p),
                offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
            out.append((values, offsets))
        return n.value, out
    finally:
        lib.pt_free(handle)


def parse_multislot_file_python(path, slot_types):
    """The plain version of ``parse_multislot_file``: the same format and
    result in pure Python."""
    per_slot_vals = [[] for _ in slot_types]
    per_slot_offs = [[0] for _ in slot_types]
    n_inst = 0
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            pos = 0
            ok = True
            row = [[] for _ in slot_types]
            for s, t in enumerate(slot_types):
                if pos >= len(parts):
                    ok = False
                    break
                try:
                    num = int(parts[pos])
                except ValueError:
                    ok = False
                    break
                pos += 1
                # malformed counts (negative / overrunning the line) discard
                # the whole instance — identical to the native parser
                if num < 0 or pos + num > len(parts):
                    ok = False
                    break
                conv = float if t == "f" else int
                try:
                    row[s] = [conv(v) for v in parts[pos:pos + num]]
                except ValueError:
                    ok = False
                    break
                pos += num
            if not ok:
                continue
            n_inst += 1
            for s in range(len(slot_types)):
                per_slot_vals[s].extend(row[s])
                per_slot_offs[s].append(len(per_slot_vals[s]))
    out = []
    for s, t in enumerate(slot_types):
        values = np.asarray(
            per_slot_vals[s], dtype=np.float32 if t == "f" else np.int64)
        out.append((values, np.asarray(per_slot_offs[s], dtype=np.int64)))
    return n_inst, out
