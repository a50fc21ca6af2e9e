"""Harvest side of the tuning plane: kernels publish what they run.

Counterpart of paddle_tpu/tuning/observe.py, copied (the series names
are declared in observability/monitor.py).  In the port the ragged
serving kernel's ``block_rows`` resolution
(``generation.ragged_attention.resolve_block_rows``) is the resolution
that publishes; #9, #10 and #11 fix their tiles at compile time.

Every guarded kernel's block-size resolution calls
:func:`record_resolution` with the kernel family, the live problem
geometry, the config it chose, and WHERE the config came from:

* ``env``       — explicit operator override (``PADDLE_TPU_FUSED_BM``
  and friends);
* ``cache``     — a tuning-store hit (the tuned steady state);
* ``heuristic`` — the built-in fallback (the signal the autotune
  daemon exists to drive to zero).

Two registry series result (names declared in
``observability/monitor.py``, spelling held by ``tools/metric_lint``):

* ``autotune_cache_hits_total{kernel,source}`` — the hit/miss mix; a
  fleet whose steady state shows ``source="heuristic"`` growth is
  running un-tuned shapes;
* ``autotune_geometry_observed_total{kernel,geometry,dtype,source,
  config}`` — one series per live problem shape.  This is the harvest
  payload: ``TelemetryScraper`` carries it to the router tier, and
  ``tools/autotune_daemon.py`` turns its label sets into the offline
  search work-list (:func:`observed_geometries`).

The record path can NEVER raise into a kernel trace and costs two
uncontended counter bumps; it fires at trace/lowering time only (block
sizes resolve once per compiled shape), so per-step cost is zero.
"""
from __future__ import annotations

__all__ = ["KERNELS", "SOURCES", "record_resolution",
           "observed_geometries"]

KERNELS = ("matmul", "ffn", "ragged", "attn_epilogue")
SOURCES = ("env", "cache", "heuristic")


def record_resolution(kernel, geometry, source, config, dtype="float32"):
    """Publish one block-size resolution to the process registry.
    Swallows every failure — telemetry must never break a trace."""
    try:
        from ..observability.registry import get_registry

        reg = get_registry()
        reg.counter(
            "autotune_cache_hits_total",
            "kernel block-size resolutions by source "
            "(env|cache|heuristic)",
        ).inc(kernel=str(kernel), source=str(source))
        reg.counter(
            "autotune_geometry_observed_total",
            "live kernel geometries observed at trace time",
        ).inc(kernel=str(kernel), geometry=str(geometry),
              dtype=str(dtype), source=str(source), config=str(config))
    except Exception:  # noqa: BLE001 — telemetry never raises
        pass


def observed_geometries(snapshot):
    """The daemon's work-list: aggregate a registry snapshot's
    ``autotune_geometry_observed_total`` series into one record per
    (kernel, geometry, dtype) with the total observation count and the
    per-source breakdown.  Accepts a single-process snapshot, a
    ``TelemetryScraper.fleet_snapshot()`` or a ``rollup()`` — worker
    relabels are ignored.  Sorted most-observed first, so a bounded
    search budget spends itself on the shapes production actually
    runs."""
    metrics = (snapshot or {}).get("metrics", {})
    entry = metrics.get("autotune_geometry_observed_total") or {}
    agg = {}
    for rec in entry.get("series", []) or []:
        labels = rec.get("labels") or {}
        kernel = labels.get("kernel")
        geometry = labels.get("geometry")
        if not kernel or not geometry:
            continue
        key = (kernel, geometry, labels.get("dtype", "float32"))
        row = agg.setdefault(
            key, {"kernel": key[0], "geometry": key[1],
                  "dtype": key[2], "count": 0, "sources": {}})
        n = rec.get("value") or 0
        row["count"] += n
        src = labels.get("source", "unknown")
        row["sources"][src] = row["sources"].get(src, 0) + n
    return sorted(agg.values(), key=lambda r: -r["count"])
