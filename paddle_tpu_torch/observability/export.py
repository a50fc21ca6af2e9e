"""Snapshot export helpers: Prometheus file export and snapshot diffs.

The registry itself renders the Prometheus text (``MetricsRegistry.
prometheus_text``) and the JSON snapshot; this module adds the
file-shaped conveniences an operator wires into a node exporter or a
CI check, plus :func:`snapshot_diff` — the comparison engine behind
``tools/metrics_diff.py`` (pretty-print what moved between two JSON
dumps of the registry).

Counterpart of paddle_tpu/observability/export.py, copied.
"""
from __future__ import annotations

import json

from ..resilience.atomic import atomic_output
from .registry import get_registry

__all__ = ["write_prometheus", "write_snapshot", "snapshot_diff",
           "format_diff"]


def write_prometheus(path, registry=None):
    """Write the text exposition payload to ``path`` (scrape it with a
    textfile collector, or serve the string from any HTTP handler).
    Atomic temp+rename: the textfile-collector contract — a scrape
    landing mid-write must see the previous complete payload, never a
    torn one."""
    reg = registry or get_registry()
    with atomic_output(path, "w", fsync=False) as f:
        f.write(reg.prometheus_text())
    return path


def write_snapshot(path, registry=None):
    """Atomic JSON snapshot dump (same torn-read protection as
    :func:`write_prometheus`)."""
    reg = registry or get_registry()
    with atomic_output(path, "w", fsync=False) as f:
        json.dump(reg.snapshot(), f, indent=1, sort_keys=True)
    return path


def _flatten(snapshot):
    """{(metric, labels_str): scalar} for every comparable value in a
    registry snapshot — counters/gauges flatten to their value,
    histograms to count/sum/p50/p95/p99."""
    out = {}
    for name, entry in snapshot.get("metrics", {}).items():
        for s in entry.get("series", []):
            labels = ",".join(
                f"{k}={v}"
                for k, v in sorted(s.get("labels", {}).items()))
            base = f"{name}{{{labels}}}" if labels else name
            if entry.get("type") == "histogram":
                for field in ("count", "sum", "p50", "p95", "p99"):
                    if field in s:
                        out[f"{base}.{field}"] = s[field]
            else:
                out[base] = s.get("value")
    return out


def snapshot_diff(before, after):
    """Compare two registry snapshots (dicts or JSON file paths).

    Returns {"added": {...}, "removed": {...}, "changed":
    {key: (before, after, delta)}} — unchanged series are omitted, so
    the diff of a quiet interval is empty."""
    if isinstance(before, str):
        with open(before) as f:
            before = json.load(f)
    if isinstance(after, str):
        with open(after) as f:
            after = json.load(f)
    a, b = _flatten(before), _flatten(after)
    added = {k: b[k] for k in sorted(set(b) - set(a))}
    removed = {k: a[k] for k in sorted(set(a) - set(b))}
    changed = {}
    for k in sorted(set(a) & set(b)):
        if a[k] != b[k]:
            va, vb = a[k], b[k]
            delta = (vb - va if isinstance(va, (int, float))
                     and isinstance(vb, (int, float)) else None)
            changed[k] = (va, vb, delta)
    return {"added": added, "removed": removed, "changed": changed}


def format_diff(diff):
    """Human-readable rendering of :func:`snapshot_diff` output."""
    lines = []
    for key, val in diff["added"].items():
        lines.append(f"+ {key} = {val}")
    for key, val in diff["removed"].items():
        lines.append(f"- {key} (was {val})")
    for key, (va, vb, delta) in diff["changed"].items():
        d = (f" ({delta:+g})" if delta is not None else "")
        lines.append(f"~ {key}: {va} -> {vb}{d}")
    if not lines:
        lines.append("(no changes)")
    return "\n".join(lines)
