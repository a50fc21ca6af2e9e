"""Fleet autotune service: harvest -> parity-gated search -> push.

Counterpart of paddle_tpu/tuning/service.py.  The searches are the
Hopper ones (``ops/autotune.py``): ``ragged`` searches kernel #1's
``block_rows`` on the card; ``ffn`` searches the fusion plan (the #11
chain against two #10 launches, :mod:`.plans`), its tile search being
absent on Hopper (the kernels fix their tiles at compile time);
``matmul`` and ``attn_epilogue`` raise ``NotImplementedError`` for the
same reason.  Entries are stamped with the card's device kind.

The offline half of the tuning plane (the online half is the harvest
instrumentation in the kernels and the store's admission gate).  One
:class:`TuningService` owns three verbs, each usable alone:

* :meth:`harvest` — scrape every worker's registry via
  ``TelemetryScraper`` and fold the fleet's
  ``autotune_geometry_observed_total`` series into a search work-list
  (most-observed geometries first);
* :meth:`search` — run the established parity-gate-then-time searches
  (``ops/autotune.py``, plus :mod:`..tuning.plans` for the fusion-plan
  dimension) for geometries the store does not yet cover, and persist
  winners as versioned, attested store entries;
* :meth:`push` — ship the store's attested entries to every worker
  over the existing cluster RPC plane (the ``tuning_push`` verb), so
  a worker that boots AFTER a push — or against the pushed store file
  — resolves every tuned geometry from cache with zero on-path search.

``cluster/worker.py``
exposes :func:`search_geometry` as the ``tuning_search`` RPC verb so a
router can delegate the search itself to an idle worker of the right
device kind.

The service is deliberately one-directional: workers never push
configs at each other.  Everything a worker accepts arrives through
the store's ``merge(distributed=True)`` admission gate — versioned,
parity-attested, or permanently rejected.
"""
from __future__ import annotations

from . import observe
from .store import TuningStore, make_key

__all__ = ["TuningService", "search_geometry", "parse_geometry"]

#: probe page depth for ragged searches — the observed geometry key
#: (rows/heads/d_head/page) does not pin pages_per_seq, which only
#: shapes the probe batch, not the cached config
RAGGED_PROBE_PAGES = 8


def parse_geometry(kernel, geometry):
    """The observed-geometry label back into search arguments."""
    if kernel in ("matmul", "ffn"):
        dims = tuple(int(v) for v in geometry.lower().split("x"))
        want = 3 if kernel == "matmul" else 4
        if len(dims) != want:
            raise ValueError(
                f"{kernel} geometry {geometry!r}: want {want} dims")
        return dims
    if kernel == "ragged":
        import re

        m = re.fullmatch(r"r(\d+)h(\d+)d(\d+)p(\d+)", geometry)
        if not m:
            raise ValueError(f"ragged geometry {geometry!r}")
        return tuple(int(g) for g in m.groups())
    if kernel == "attn_epilogue":
        import re

        m = re.fullmatch(r"t(\d+)h(\d+)nh(\d+)", geometry)
        if not m:
            raise ValueError(f"attn_epilogue geometry {geometry!r}")
        return tuple(int(g) for g in m.groups())
    raise ValueError(f"unknown kernel family {kernel!r}")


def _attestation(device, ref, rtol, atol):
    return {"parity": True, "rtol": rtol, "atol": atol, "ref": ref,
            "backend": device.type, "interpret": False}


def _speedup(result, heuristic_cfg, fields):
    """(ms, heuristic_ms, speedup) from a search result's candidate
    list: the winner's time vs the heuristic default's time (None when
    the search was parity-only or the heuristic config was not in the
    grid)."""
    best_ms = result.get("ms")
    heur_ms = None
    for cand in result.get("candidates", []):
        if cand.get("error") or cand.get("ms") is None:
            continue
        if tuple(cand.get(f) for f in fields) == tuple(heuristic_cfg):
            heur_ms = cand["ms"]
            break
    speed = (heur_ms / best_ms
             if best_ms and heur_ms and best_ms > 0 else None)
    return best_ms, heur_ms, speed


def search_geometry(kernel, geometry, dtype="float32", reps=10,
                    force_time=False, write=True, store=None,
                    plan_search=True, device=None):
    """One parity-gated search for one observed geometry on ``device``
    (the card unless asked); persists an attested, versioned store
    entry for the winner (when ``write`` and the winner was timed).
    Returns a JSON-able report: ``{"kernel", "geometry", "config",
    "ms", "heuristic_ms", "speedup", "parity_only", "entry",
    ["plan"], ["tile_search"]}``.  ``matmul`` and ``attn_epilogue``
    raise ``NotImplementedError`` (no runtime tile on Hopper)."""
    from .._device import resolve_device
    from ..ops import autotune as at

    device = resolve_device(device)
    store = store if store is not None else TuningStore()
    report = {"kernel": kernel, "geometry": geometry, "dtype": dtype,
              "config": None, "ms": None, "heuristic_ms": None,
              "speedup": None, "parity_only": None, "entry": None}
    rtol, atol = 2e-2, 2e-3

    if kernel == "matmul":
        M, K, N = parse_geometry(kernel, geometry)
        at.autotune(M, K, N, dtype=dtype)
    if kernel == "attn_epilogue":
        T, H, nh = parse_geometry(kernel, geometry)
        at.autotune_attn(T, H, nh, dtype=dtype)
    if kernel == "ffn":
        M, K, F, N = parse_geometry(kernel, geometry)
        report["tile_search"] = at.NO_TILE_SEARCH
        report["parity_only"] = device.type != "cuda" and not force_time
        if plan_search:
            from . import plans

            report["plan"] = plans.autotune_fusion_plan(
                M, K, F, N, dtype=dtype, reps=reps, write=write,
                force_time=force_time, device=device, store=store)
            report["plan"].pop("entry", None)
        return report
    if kernel != "ragged":
        raise ValueError(f"unknown kernel family {kernel!r}")

    rows, heads, d_head, page = parse_geometry(kernel, geometry)
    rtol, atol = 2e-5, 2e-6
    r = at.autotune_ragged(rows, heads, d_head, page, RAGGED_PROBE_PAGES,
                           dtype=dtype, reps=reps, write=False,
                           force_time=force_time, rtol=rtol, atol=atol,
                           device=device)
    report["parity_only"] = r["parity_only"]
    report["candidates"] = r["candidates"]
    if r["block_rows"] is None:
        return report
    report["config"] = {"block_rows": r["block_rows"]}
    ms, heur, speed = _speedup(r, (1,), ("block_rows",))
    report.update(ms=ms, heuristic_ms=heur, speedup=speed)
    # a parity-only pass (the CPU, no force_time) validated the geometry
    # but timed nothing — never persist an untimed winner
    if write and not report["parity_only"]:
        kind = at.device_kind(device)
        key = make_key(kernel, kind, geometry, str(dtype))
        report["entry"] = store.put(
            key, report["config"], kernel=kernel, geometry=geometry,
            dtype=str(dtype), device_kind=kind, ms=ms, heuristic_ms=heur,
            speedup=speed,
            attestation=_attestation(
                device, "ragged_flash_plain_attention (contract_bound)"
                if device.type == "cuda" and str(dtype) != "float32"
                else "ragged_ref_attention", rtol, atol))
    return report


class TuningService:
    """harvest -> search -> push over a set of worker handles."""

    def __init__(self, handles_fn, store=None, registry=None, reps=10,
                 force_time=False, device=None):
        from ..observability.scrape import TelemetryScraper

        self.device = device
        self.handles_fn = handles_fn
        self.store = store if store is not None else TuningStore()
        self.scraper = TelemetryScraper(handles_fn, registry=registry)
        self.reps = reps
        self.force_time = force_time

    # -- harvest -----------------------------------------------------------
    def harvest(self, include_local=True):
        """The fleet's observed-geometry work-list (most-observed
        first).  Scrapes every live handle; with ``include_local`` the
        local process's own registry rows count too (a single-process
        deployment is still a fleet of one)."""
        self.scraper.scrape()
        observed = observe.observed_geometries(self.scraper.rollup())
        if include_local and not observed:
            from ..observability.registry import get_registry

            observed = observe.observed_geometries(
                get_registry().snapshot())
        return observed

    def pending(self, observed=None):
        """Observed geometries with no store entry for this service's
        device kind — the actual search backlog."""
        from ..ops.autotune import device_kind as _kind

        observed = observed if observed is not None else self.harvest()
        device_kind = _kind(self.device)
        have = self.store.read()
        out = []
        for row in observed:
            key = make_key(row["kernel"], device_kind,
                           row["geometry"], row["dtype"])
            if key not in have:
                out.append(row)
        return out

    # -- search ------------------------------------------------------------
    def search(self, observed=None, limit=None):
        """Run searches for the pending work-list (bounded by
        ``limit``); per-geometry failures are reported, never raised —
        one hostile geometry must not starve the rest."""
        todo = self.pending(observed)
        if limit is not None:
            todo = todo[:limit]
        reports = []
        for row in todo:
            try:
                reports.append(search_geometry(
                    row["kernel"], row["geometry"], dtype=row["dtype"],
                    reps=self.reps, force_time=self.force_time,
                    store=self.store, device=self.device))
            except Exception as e:  # noqa: BLE001
                reports.append({"kernel": row["kernel"],
                                "geometry": row["geometry"],
                                "error": repr(e)})
        return reports

    # -- push --------------------------------------------------------------
    def push(self, entries=None):
        """Ship attested entries fleet-wide.  Unattested entries never
        leave the router (the same gate the receiving store would
        apply — rejecting locally keeps the fleet's degradation
        registries clean).  Returns {endpoint: reply-or-error}."""
        if entries is None:
            entries = self.store.read()
        from .store import attestation_ok

        entries = {k: e for k, e in entries.items()
                   if attestation_ok(e)}
        results = {}
        for h in list(self.handles_fn() or []):
            ep = getattr(h, "endpoint", f"w{getattr(h, 'rank', '?')}")
            try:
                results[ep] = h.call("tuning_push", entries=entries)
            except Exception as e:  # noqa: BLE001 — dead worker
                results[ep] = {"ok": False, "error": repr(e)}
        return results

    def run_once(self, search=True, push=True, limit=None):
        """One daemon pass: harvest, search what's missing, push what's
        attested."""
        observed = self.harvest()
        report = {"observed": observed, "searched": [], "pushed": {}}
        if search:
            report["searched"] = self.search(observed, limit=limit)
        if push:
            report["pushed"] = self.push()
        return report
