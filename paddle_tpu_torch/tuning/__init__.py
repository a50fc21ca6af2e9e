"""paddle_tpu_torch.tuning — the self-tuning kernel plane.

Counterpart of paddle_tpu/tuning: the Hopper searches of
``ops/autotune.py`` (kernel #1's ``block_rows``) and :mod:`.plans` (the
FFN's chain against per-GEMM plan) as a fleet-persistent service:

* :mod:`.observe` — every guarded kernel publishes its live
  geometries, chosen configs, and hit/miss source as registry series;
* :mod:`.store`   — the versioned :class:`TuningStore` (device kind,
  kernel, geometry, measured speedup, parity attestation, monotonic
  versions) behind the same JSON file and
  ``PADDLE_TPU_AUTOTUNE_CACHE`` env var the flat cache used;
* :mod:`.service` — harvest observed geometries fleet-wide, run
  parity-gated searches offline, push attested winners over the
  cluster RPC plane (the worker's ``tuning_*`` verbs);
* :mod:`.plans`   — the widened search space: measured fusion-plan
  selection (whole-block FFN chain vs per-GEMM) per geometry.
"""
from .observe import observed_geometries, record_resolution
from .plans import autotune_fusion_plan, fusion_plan_override
from .service import TuningService, search_geometry
from .store import TuningStore, attestation_ok, make_key, parse_key

__all__ = [
    "TuningStore", "TuningService", "attestation_ok", "make_key",
    "parse_key", "search_geometry", "record_resolution",
    "observed_geometries", "fusion_plan_override",
    "autotune_fusion_plan",
]
