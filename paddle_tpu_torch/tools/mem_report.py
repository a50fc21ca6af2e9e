"""Per-device optimizer-state memory report from a registry snapshot
(counterpart of the JAX package's tools/mem_report.py).

Usage::

    python3 -m paddle_tpu_torch.tools.mem_report snapshot.json

where the file is a ``paddle_tpu_torch.observability`` registry snapshot
(``get_registry().dump_json(path)`` or ``observability.write_snapshot``).
Reads the ``optimizer_state_bytes`` gauge the Executor publishes at
lowering time and prints the global vs per-device footprint, the
data-parallel degree, and how close the sharding is to the ideal 1/dp
(the ZeRO-1 saving); ``chip_smoke.py`` and the tests gate on the same
numbers through :func:`optimizer_state_report`.

Exit status: 0 when the gauge is present, 2 when the snapshot carries
no optimizer-state series (nothing compiled yet, or telemetry off).
"""
from __future__ import annotations

import argparse
import json
import sys


def _gauge_series(snapshot, name):
    entry = snapshot.get("metrics", {}).get(name)
    if not entry:
        return {}
    out = {}
    for s in entry.get("series", []):
        key = tuple(sorted(s.get("labels", {}).items()))
        out[key] = s.get("value")
    return out


def optimizer_state_report(snapshot):
    """Digest the ``optimizer_state_bytes`` gauge of a snapshot dict
    (or JSON file path) into::

        {"global_bytes", "per_device_bytes", "dp_degree",
         "ideal_per_device_bytes", "ratio_vs_ideal"}

    or None when the gauge is absent.  ``ratio_vs_ideal`` is
    per_device / (global / dp) — 1.0 is a perfect 1/dp shard; small
    overshoot comes from state too small to shard (beta-pow scalars,
    tiny biases) staying replicated."""
    if isinstance(snapshot, str):
        with open(snapshot) as f:
            snapshot = json.load(f)
    series = _gauge_series(snapshot, "optimizer_state_bytes")
    if not series:
        return None
    g = series.get((("placement", "global"),))
    p = series.get((("placement", "per_device"),))
    if g is None or p is None:
        return None
    dp_series = _gauge_series(snapshot, "data_parallel_degree")
    dp = int(dp_series.get((), 1) or 1)
    ideal = g / dp if dp else g
    return {
        "global_bytes": int(g),
        "per_device_bytes": int(p),
        "dp_degree": dp,
        "ideal_per_device_bytes": int(ideal),
        "ratio_vs_ideal": round(p / ideal, 4) if ideal else None,
    }


def _fmt_bytes(n):
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024 or unit == "GiB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{int(n)} B"
        n /= 1024.0
    return f"{n:.1f} GiB"


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="optimizer-state memory report from a "
                    "paddle_tpu_torch metrics-registry JSON snapshot")
    ap.add_argument("snapshot", help="registry snapshot JSON")
    args = ap.parse_args(argv)
    rep = optimizer_state_report(args.snapshot)
    if rep is None:
        print("no optimizer_state_bytes series in snapshot "
              "(nothing compiled yet, or telemetry disabled)")
        return 2
    print(f"optimizer state (global):     "
          f"{_fmt_bytes(rep['global_bytes'])}")
    print(f"optimizer state (per device): "
          f"{_fmt_bytes(rep['per_device_bytes'])}")
    print(f"data-parallel degree:         {rep['dp_degree']}")
    print(f"ideal 1/dp per device:        "
          f"{_fmt_bytes(rep['ideal_per_device_bytes'])}")
    print(f"ratio vs ideal:               {rep['ratio_vs_ideal']}")
    saved = rep["global_bytes"] - rep["per_device_bytes"]
    print(f"saved per device vs replicated: {_fmt_bytes(saved)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
