"""Versioned, fleet-distributable tuning store.

Counterpart of paddle_tpu/tuning/store.py, copied: the same file, env
variable (``PADDLE_TPU_AUTOTUNE_CACHE``), key formats and schema
(``SCHEMA_VERSION = 2``), so each package reads the other's store.  In
the port an entry's device kind is ``torch.cuda.get_device_name()`` (or
``"cpu"``), and its attestation names the backend it was timed on.

The flat autotune JSON file (``ops/autotune.py``) had two structural
problems once tuning became a fleet service rather than a per-process
cache:

* **lost updates** — ``_store`` read-modify-wrote the whole snapshot,
  so two concurrently tuning processes silently dropped each other's
  entries;
* **no provenance** — an entry was just ``{"bm": .., "bk": ..}``; a
  stale config pushed from an old daemon could overwrite a newer
  locally-searched winner, and nothing recorded whether the config had
  ever passed the parity gate it claims to have passed.

:class:`TuningStore` replaces the file format with a versioned envelope

.. code-block:: json

    {"schema_version": 2,
     "entries": {"<key>": {
        "config":      {"bm": 256, "bk": 512},
        "version":     3,
        "kernel":      "matmul",
        "device_kind": "NVIDIA H100 80GB HBM3",
        "geometry":    "4096x768x3072",
        "dtype":       "float32",
        "ms":          0.41, "heuristic_ms": 0.55, "speedup": 1.34,
        "attestation": {"parity": true, "rtol": 0.02, "atol": 0.002,
                        "ref": "reference_matmul_epilogue",
                        "backend": "cuda", "interpret": false},
        "source":      "search"}}}

while staying READ-compatible with the legacy flat file: a legacy entry
is adopted as ``{"config": <entry>, "version": 0}``, so monotonic
versioning starts working the moment any writer upgrades the file.
Every write happens as *merge against a fresh re-read under an
exclusive file lock, then* ``os.replace`` — concurrent writers
interleave instead of clobbering (the lost-update fix), and a reader
never observes a half-written file.

Distribution discipline (the degrade seam): a config arriving over the
cluster RPC plane (``merge(..., distributed=True)``) is applied only if
it carries a PASSING parity attestation and a version strictly newer
than what the process already holds.  An entry with a missing or
failing attestation permanently degrades ``tuning.distributed_config:
<key>`` in the DegradationRegistry — that key can never be applied for
the life of the process, even if re-pushed — and the rejection is
counted (``autotune_configs_rejected_total``).  A merely-stale version
is dropped without degrading (stale is benign; unattested is not).
"""
from __future__ import annotations

import contextlib
import json
import os
import tempfile

from ..resilience.retry import degradations

try:  # POSIX file locks; the only platform the port targets
    import fcntl
except ImportError:  # pragma: no cover - non-POSIX fallback
    fcntl = None

__all__ = ["TuningStore", "DEGRADE_KEY", "SCHEMA_VERSION", "make_key",
           "parse_key", "attestation_ok"]

#: DegradationRegistry key family for distributed configs that failed
#: admission (missing/failing parity attestation).  Per-entry keys are
#: ``tuning.distributed_config:<store key>`` — one poisoned config
#: never blocks the rest of the push.
DEGRADE_KEY = "tuning.distributed_config"

SCHEMA_VERSION = 2

#: store-key prefixes per kernel family; the bare (prefix-less) legacy
#: matmul key format ``device|MxKxN|dtype`` is preserved for
#: compatibility with caches written before the store existed
_KERNEL_PREFIX = {"matmul": None, "ffn": "ffn", "ragged": "ragged",
                  "attn_epilogue": "attn", "fusion_plan": "plan"}
_PREFIX_KERNEL = {v: k for k, v in _KERNEL_PREFIX.items() if v}


def cache_path():
    """The store file (same file + env var as the legacy cache, so
    every existing ``PADDLE_TPU_AUTOTUNE_CACHE`` deployment keeps
    working)."""
    from ..ops import autotune as at

    return at.cache_path()


def make_key(kernel, device_kind, geometry, dtype):
    """The store key for one (kernel, device, geometry, dtype) — the
    exact legacy key formats, so readers written against the flat file
    resolve the same entries."""
    prefix = _KERNEL_PREFIX[kernel]
    body = f"{device_kind}|{geometry}|{dtype}"
    return body if prefix is None else f"{prefix}|{body}"


def parse_key(key):
    """(kernel, device_kind, geometry, dtype) from a store key, or
    None for a key in no known format."""
    parts = key.split("|")
    if len(parts) == 3:
        return ("matmul",) + tuple(parts)
    if len(parts) == 4 and parts[0] in _PREFIX_KERNEL:
        return (_PREFIX_KERNEL[parts[0]],) + tuple(parts[1:])
    return None


def attestation_ok(entry):
    """True iff the entry carries a PASSING parity attestation."""
    att = entry.get("attestation") if isinstance(entry, dict) else None
    return bool(isinstance(att, dict) and att.get("parity") is True)


def _adopt(raw):
    """Normalize one on-disk entry to the v2 envelope (legacy flat
    entries become version-0 configs so monotonic versioning engages)."""
    if not isinstance(raw, dict):
        return None
    if "config" in raw:
        cfg = raw.get("config")
        if not isinstance(cfg, dict) or not cfg:
            return None
        out = dict(raw)
        out["version"] = int(raw.get("version", 0) or 0)
        return out
    cfg = {k: v for k, v in raw.items()
           if k not in ("ms", "heuristic_ms", "speedup",
                        "parity_checked")}
    if not cfg:
        return None
    entry = {"config": cfg, "version": 0, "source": "legacy"}
    # a legacy winner was only ever persisted after the parity gate
    # (``parity_checked``); carry that forward as an attestation so
    # pulled-then-pushed legacy caches still pass admission
    if raw.get("parity_checked"):
        entry["attestation"] = {"parity": True, "ref": "legacy"}
    for k in ("ms", "heuristic_ms", "speedup"):
        if k in raw:
            entry[k] = raw[k]
    return entry


def _parse_file(data):
    """{key: v2 entry} from either file format (corrupt entries are
    dropped — a bad record is a miss, not a crash)."""
    if not isinstance(data, dict):
        return {}
    raw = data.get("entries") if "schema_version" in data else data
    if not isinstance(raw, dict):
        return {}
    out = {}
    for key, val in raw.items():
        entry = _adopt(val)
        if entry is not None:
            out[key] = entry
    return out


def flatten(entry):
    """The legacy flat view of one v2 entry — config fields at top
    level — which is what ``cached_block_sizes`` & friends read."""
    flat = dict(entry.get("config") or {})
    for k in ("ms", "heuristic_ms", "speedup"):
        if entry.get(k) is not None:
            flat[k] = entry[k]
    if attestation_ok(entry):
        flat["parity_checked"] = True
    return flat


def _count(name, amount=1, **labels):
    """Registry bump that can never raise into a tuning path."""
    try:
        from ..observability.registry import get_registry

        get_registry().counter(name).inc(amount, **labels)
    except Exception:  # noqa: BLE001 — telemetry never raises
        pass


class TuningStore:
    """One store file: locked merge-writes, monotonic versions,
    attestation-gated distributed admission."""

    def __init__(self, path=None):
        self.path = path or cache_path()

    # -- locking -----------------------------------------------------------
    @contextlib.contextmanager
    def _locked(self):
        """Exclusive advisory lock for the read-merge-replace window.
        A sidecar ``.lock`` file is the lock subject — ``os.replace``
        swaps the data file's inode, so locking the data file itself
        would serialize nothing across that swap."""
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        if fcntl is None:  # pragma: no cover - non-POSIX
            yield
            return
        with open(self.path + ".lock", "a+") as lockf:
            fcntl.flock(lockf.fileno(), fcntl.LOCK_EX)
            try:
                yield
            finally:
                fcntl.flock(lockf.fileno(), fcntl.LOCK_UN)

    def _read_disk(self):
        """Fresh parse straight from disk (no mtime cache — this is the
        merge baseline; going through a cached view is how updates get
        lost)."""
        try:
            with open(self.path) as f:
                return _parse_file(json.load(f))
        except Exception:  # noqa: BLE001 — absent/corrupt file: empty
            return {}

    def _write(self, entries):
        payload = {"schema_version": SCHEMA_VERSION, "entries": entries}
        fd, tmp = tempfile.mkstemp(
            dir=os.path.dirname(self.path) or ".",
            prefix=os.path.basename(self.path) + ".")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f, indent=1, sort_keys=True)
            os.replace(tmp, self.path)
        except BaseException:
            with contextlib.suppress(OSError):
                os.unlink(tmp)
            raise
        self._invalidate_readers()

    def _invalidate_readers(self):
        """Drop the legacy module's in-process mtime cache for this
        path so the next block-size resolution re-reads the file."""
        try:
            from ..ops import autotune as at

            at._LOADED.pop(self.path, None)
        except Exception:  # noqa: BLE001
            pass

    # -- reads -------------------------------------------------------------
    def read(self):
        """{key: v2 entry} — fresh from disk."""
        return self._read_disk()

    def get(self, key):
        return self._read_disk().get(key)

    def flat(self):
        """{key: legacy flat entry} — the view the in-kernel readers
        consume."""
        return {k: flatten(e) for k, e in self._read_disk().items()}

    # -- writes ------------------------------------------------------------
    def put(self, key, config, *, kernel=None, geometry=None,
            dtype=None, device_kind=None, ms=None, heuristic_ms=None,
            speedup=None, attestation=None, source="search",
            version=None):
        """Insert/refresh one locally-searched entry.  The version is
        assigned UNDER the lock (existing + 1) unless given, so two
        racing writers produce strictly ordered versions instead of a
        tie that a later merge resolves arbitrarily."""
        meta = parse_key(key)
        if meta is not None:
            kernel = kernel or meta[0]
            device_kind = device_kind or meta[1]
            geometry = geometry or meta[2]
            dtype = dtype or meta[3]
        with self._locked():
            entries = self._read_disk()
            prev = entries.get(key)
            entry = {
                "config": dict(config),
                "version": (int(version) if version is not None
                            else (prev["version"] + 1 if prev else 1)),
                "kernel": kernel, "device_kind": device_kind,
                "geometry": geometry, "dtype": dtype,
                "source": source,
            }
            for field, val in (("ms", ms), ("heuristic_ms", heuristic_ms),
                               ("speedup", speedup),
                               ("attestation", attestation)):
                if val is not None:
                    entry[field] = val
            entries[key] = entry
            self._write(entries)
        return entry

    def merge(self, incoming, distributed=False):
        """Merge a batch of v2 (or legacy flat) entries: fresh re-read
        under the exclusive lock, monotonic-version arbitration, one
        ``os.replace``.  Returns ``(applied, rejected)`` where
        ``applied`` is the list of keys written and ``rejected`` maps
        key -> reason.

        With ``distributed=True`` (the RPC-push path) every entry must
        additionally carry a passing parity attestation; a violation
        permanently degrades ``tuning.distributed_config:<key>``."""
        applied, rejected = [], {}
        with self._locked():
            entries = self._read_disk()
            dirty = False
            for key, raw in (incoming or {}).items():
                entry = _adopt(raw)
                kernel = (parse_key(key) or ("unknown",))[0]
                if entry is None:
                    rejected[key] = "malformed entry"
                    _count("autotune_configs_rejected_total",
                           kernel=kernel, reason="malformed")
                    continue
                if distributed:
                    dkey = f"{DEGRADE_KEY}:{key}"
                    if degradations.is_degraded(dkey):
                        rejected[key] = "degraded key"
                        _count("autotune_configs_rejected_total",
                               kernel=kernel, reason="degraded")
                        continue
                    if not attestation_ok(entry):
                        rejected[key] = "missing/failing parity " \
                                        "attestation"
                        degradations.degrade(
                            dkey, detail="distributed config without "
                                         "passing parity attestation")
                        _count("autotune_configs_rejected_total",
                               kernel=kernel, reason="unattested")
                        continue
                prev = entries.get(key)
                if prev is not None \
                        and int(prev.get("version", 0)) \
                        >= int(entry.get("version", 0)):
                    rejected[key] = (
                        f"stale version {entry.get('version', 0)} "
                        f"<= {prev.get('version', 0)}")
                    _count("autotune_configs_rejected_total",
                           kernel=kernel, reason="stale")
                    continue
                if distributed:
                    entry = dict(entry)
                    entry["source"] = "distributed"
                    _count("autotune_configs_pushed_total",
                           kernel=kernel)
                entries[key] = entry
                applied.append(key)
                dirty = True
            if dirty:
                self._write(entries)
        return applied, rejected
