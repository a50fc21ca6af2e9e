"""The port's tuning plane (``paddle_tpu_torch.tuning``,
``ops/autotune.py``, ``generation.ragged_attention.resolve_block_rows``,
the fusion pass's plan override, the worker's tuning verbs) against the
JAX package's, on the CPU.

* Keys and store files round-trip between the two packages: a store
  either package writes, the other reads entry for entry.
* The cases of ``tests/test_tuning.py`` that have a port counterpart:
  monotonic versions, legacy adoption, the lost-update fix and
  concurrent writers, stale and unattested merges (the latter
  degrading ``tuning.distributed_config:<key>``), the mtime reader
  cache, precedence env > store > default for ``block_rows`` (the same
  answers as the JAX resolver for the same env and store), the harvest
  series, fusion-plan overrides in the fusion pass, the searches (the
  ragged one parity-only on the CPU unless ``force_time``; the tile
  searches of #9/#10/#11 refused with the ROADMAP item), the worker
  verbs over the port's RPC (a real socket) and the service's
  harvest -> search -> push round trip.
* The port's engine resolves ``block_rows`` as the JAX engine does for
  the same env and store.
* The degradation registry takes control-plane keys only, and no kernel
  path consults it.
"""
import json
import os
import pathlib
import threading

import numpy as np
import pytest
import torch

from paddle_tpu.ops import autotune as j_at
from paddle_tpu.resilience.retry import degradations as j_degradations
from paddle_tpu.tuning import TuningStore as JTuningStore
from paddle_tpu.tuning import make_key as j_make_key
from paddle_tpu.tuning import parse_key as j_parse_key
from paddle_tpu_torch.observability.registry import get_registry
from paddle_tpu_torch.ops import autotune as at
from paddle_tpu_torch.resilience.retry import degradations
from paddle_tpu_torch.tuning import (TuningStore, attestation_ok, make_key,
                                     observe, parse_key, plans)

ROOT = pathlib.Path(__file__).resolve().parents[1]
ATT = {"parity": True, "ref": "test"}
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _isolated_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_AUTOTUNE_CACHE",
                       str(tmp_path / "tune.json"))
    monkeypatch.delenv("PADDLE_TPU_RAGGED_BM", raising=False)
    for mod in (at, j_at):
        mod._LOADED.clear()
    yield
    for mod in (at, j_at):
        mod._LOADED.clear()
    degradations.reset()
    j_degradations.reset()


def _counter(name, **labels):
    """Current value of one series of the port's registry (0 when
    absent)."""
    entry = get_registry().snapshot()["metrics"].get(name)
    for rec in (entry or {}).get("series", []):
        if rec.get("labels", {}) == labels:
            return rec["value"]
    return 0


# -- keys and files across the packages ---------------------------------------

@pytest.mark.parametrize("kernel,geom", [
    ("matmul", "8x8x8"), ("ffn", "8x8x16x8"), ("ragged", "r8h4d8p8"),
    ("attn_epilogue", "t8h8nh2"), ("fusion_plan", "8x8x16x8")])
def test_keys_round_trip_between_the_packages(kernel, geom):
    kind = "NVIDIA H100 80GB HBM3"
    key = make_key(kernel, kind, geom, "float32")
    assert key == j_make_key(kernel, kind, geom, "float32")
    assert parse_key(key) == j_parse_key(key) == (kernel, kind, geom,
                                                  "float32")
    assert parse_key("garbage") is None


def test_device_kind_is_the_cards_name_or_cpu():
    assert at.device_kind("cpu") == "cpu"
    if not torch.cuda.is_available():       # None is the card, as always
        with pytest.raises(RuntimeError, match="CUDA"):
            at.device_kind()
    assert at.dtype_name(torch.float32) == "float32"
    assert at.dtype_name("float32") == "float32"
    key = at.ragged_cache_key("cpu", 24, 12, 64, 16, "float32")
    assert key == j_at.ragged_cache_key("cpu", 24, 12, 64, 16, "float32")
    assert at.ffn_cache_key("cpu", 1, 2, 3, 4, "float32") \
        == j_at.ffn_cache_key("cpu", 1, 2, 3, 4, "float32")
    assert at.attn_cache_key("cpu", 8, 8, 2, "float32") \
        == j_at.attn_cache_key("cpu", 8, 8, 2, "float32")


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_store_files_round_trip_between_the_packages(writer, tmp_path):
    path = str(tmp_path / "shared.json")
    w, r = ((JTuningStore(path), TuningStore(path)) if writer == "jax"
            else (TuningStore(path), JTuningStore(path)))
    k1 = make_key("ragged", "cpu", "r8h4d8p8", "float32")
    k2 = make_key("fusion_plan", "cpu", "8x8x16x8", "float32")
    w.put(k1, {"block_rows": 2}, ms=0.5, attestation=ATT)
    w.put(k1, {"block_rows": 4}, ms=0.25, attestation=ATT)
    w.put(k2, {"plan": "per_gemm"}, attestation=ATT)
    assert r.read() == w.read()
    got = r.get(k1)
    assert got["version"] == 2 and got["config"] == {"block_rows": 4}
    assert r.flat() == w.flat()
    # a merge by the reader on top keeps the writer's versioning
    applied, _ = r.merge({k1: {"config": {"block_rows": 8}, "version": 3,
                               "attestation": ATT}}, distributed=True)
    assert applied == [k1] and w.get(k1)["source"] == "distributed"


# -- the store (tests/test_tuning.py's cases) -------------------------------

def test_put_assigns_monotonic_versions():
    st = TuningStore()
    key = make_key("matmul", "cpu", "8x8x8", "float32")
    e1 = st.put(key, {"bm": 8, "bk": 8}, ms=1.0, attestation=ATT)
    e2 = st.put(key, {"bm": 4, "bk": 8}, ms=0.5, attestation=ATT)
    assert (e1["version"], e2["version"]) == (1, 2)
    got = st.get(key)
    assert got["config"] == {"bm": 4, "bk": 8}
    assert got["kernel"] == "matmul" and got["geometry"] == "8x8x8"
    assert attestation_ok(got)
    flat = st.flat()[key]
    assert flat["bm"] == 4 and flat["parity_checked"] is True
    assert at.cached_block_sizes(8, 8, 8, device_kind="cpu") == (4, 8)


def test_legacy_flat_file_adopted():
    path = at.cache_path()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump({"cpu|8x8x8|float32": {"bm": 4, "bk": 8, "ms": 1.0,
                                         "parity_checked": True}}, f)
    st = TuningStore()
    entry = st.get("cpu|8x8x8|float32")
    assert entry == JTuningStore().get("cpu|8x8x8|float32")
    assert entry["version"] == 0 and entry["config"] == {"bm": 4, "bk": 8}
    assert attestation_ok(entry)
    assert at.cached_block_sizes(8, 8, 8, device_kind="cpu") == (4, 8)
    assert st.put("cpu|8x8x8|float32", {"bm": 8, "bk": 8},
                  attestation=ATT)["version"] == 1


def test_store_write_merges_against_fresh_disk_state():
    path = at.cache_path()
    key_a, key_b = "cpu|8x8x8|float32", "cpu|16x8x8|float32"
    at._store(key_a, {"bm": 8, "bk": 8, "ms": 1.0, "parity_checked": True})
    at._load(path)                      # prime the stale mtime cache
    TuningStore().put(key_b, {"bm": 16, "bk": 8}, attestation=ATT)
    at._store(key_a, {"bm": 4, "bk": 8, "ms": 0.5, "parity_checked": True})
    entries = TuningStore().read()
    assert entries[key_b]["config"] == {"bm": 16, "bk": 8}
    assert entries[key_a]["config"] == {"bm": 4, "bk": 8}
    assert entries[key_a]["version"] == 2


def test_concurrent_writers_all_survive():
    st = TuningStore()
    errs = []

    def put(i):
        try:
            st.put(make_key("matmul", "cpu", f"{8 * (i + 1)}x8x8",
                            "float32"), {"bm": 8, "bk": 8}, attestation=ATT)
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=put, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs and len(st.read()) == 8


def test_merge_stale_version_is_benign():
    st = TuningStore()
    key = make_key("matmul", "cpu", "8x8x8", "float32")
    st.put(key, {"bm": 8, "bk": 8}, version=3, attestation=ATT)
    applied, rejected = st.merge(
        {key: {"config": {"bm": 4, "bk": 4}, "version": 2,
               "attestation": ATT}})
    assert applied == [] and "stale" in rejected[key]
    assert not degradations.is_degraded(
        f"tuning.distributed_config:{key}")
    applied, _ = st.merge({key: {"config": {"bm": 4, "bk": 4},
                                 "version": 4, "attestation": ATT}})
    assert applied == [key] and st.get(key)["version"] == 4


def test_distributed_push_requires_attestation_and_degrades():
    st = TuningStore()
    key = make_key("ragged", "cpu", "r8h4d8p8", "float32")
    applied, rejected = st.merge(
        {key: {"config": {"block_rows": 2}, "version": 5}},
        distributed=True)
    assert applied == [] and "attestation" in rejected[key]
    assert st.get(key) is None
    assert degradations.is_degraded(f"tuning.distributed_config:{key}")
    good = {key: {"config": {"block_rows": 2}, "version": 6,
                  "attestation": ATT}}
    applied, rejected = st.merge(good, distributed=True)
    assert applied == [] and rejected[key] == "degraded key"
    key2 = make_key("ragged", "cpu", "r16h4d8p8", "float32")
    applied, _ = st.merge({key2: {"config": {"block_rows": 4},
                                  "version": 1, "attestation": ATT}},
                          distributed=True)
    assert applied == [key2] and st.get(key2)["source"] == "distributed"


def test_merge_counts_rejections():
    st = TuningStore()
    key = make_key("matmul", "cpu", "8x8x8", "float32")
    before = _counter("autotune_configs_rejected_total", kernel="matmul",
                      reason="unattested")
    st.merge({key: {"config": {"bm": 8, "bk": 8}, "version": 1}},
             distributed=True)
    assert _counter("autotune_configs_rejected_total", kernel="matmul",
                    reason="unattested") == before + 1


def test_load_reloads_on_mtime_change():
    path = at.cache_path()
    key = "cpu|8x8x8|float32"
    TuningStore().put(key, {"bm": 8, "bk": 8}, attestation=ATT)
    assert at._load(path)[key]["bm"] == 8 and path in at._LOADED
    with open(path, "w") as f:
        json.dump({key: {"bm": 4, "bk": 8}}, f)
    os.utime(path, (os.path.getmtime(path) + 10,) * 2)
    assert at._load(path)[key]["bm"] == 4
    assert at._load(path) is at._load(path)


def test_store_write_invalidates_reader_cache():
    path = at.cache_path()
    key = "cpu|8x8x8|float32"
    TuningStore().put(key, {"bm": 8, "bk": 8}, attestation=ATT)
    at._load(path)
    TuningStore().put(key, {"bm": 4, "bk": 8}, attestation=ATT)
    assert path not in at._LOADED
    assert at.cached_block_sizes(8, 8, 8, device_kind="cpu") == (4, 8)


# -- block_rows: precedence and harvest ---------------------------------------

def _both_resolve(*geom):
    from paddle_tpu.generation.ragged_attention import \
        resolve_block_rows as j_resolve
    from paddle_tpu_torch.generation.ragged_attention import \
        resolve_block_rows

    j_at._LOADED.clear()
    at._LOADED.clear()
    return resolve_block_rows(*geom, device=CPU), j_resolve(*geom)


def test_env_beats_store_beats_default_as_in_jax(monkeypatch):
    geom = (24, 4, 16, 16)
    assert _both_resolve(*geom) == (1, 1)
    TuningStore().put(at.ragged_cache_key("cpu", *geom, "float32"),
                      {"block_rows": 4}, attestation=ATT)
    assert _both_resolve(*geom) == (4, 4)
    monkeypatch.setenv("PADDLE_TPU_RAGGED_BM", "2")
    assert _both_resolve(*geom) == (2, 2)
    monkeypatch.setenv("PADDLE_TPU_RAGGED_BM", "junk")
    assert _both_resolve(*geom) == (4, 4)
    monkeypatch.delenv("PADDLE_TPU_RAGGED_BM")
    os.unlink(at.cache_path())
    assert _both_resolve(*geom) == (1, 1)


def test_resolution_publishes_the_harvest_series():
    from paddle_tpu_torch.generation.ragged_attention import \
        resolve_block_rows

    geom = (24, 4, 16, 16)
    label = "r24h4d16p16"
    before = {s: _counter("autotune_cache_hits_total", kernel="ragged",
                          source=s) for s in observe.SOURCES}
    resolve_block_rows(*geom, device=CPU)
    TuningStore().put(at.ragged_cache_key("cpu", *geom, "float32"),
                      {"block_rows": 2}, attestation=ATT)
    resolve_block_rows(*geom, device=CPU)
    for s, n in (("heuristic", 1), ("cache", 1), ("env", 0)):
        assert _counter("autotune_cache_hits_total", kernel="ragged",
                        source=s) == before[s] + n, s
    rows = observe.observed_geometries(get_registry().snapshot())
    mine = [r for r in rows if r["kernel"] == "ragged"
            and r["geometry"] == label]
    assert mine and mine[0]["sources"]["cache"] >= 1


@pytest.mark.parametrize("stored", [None, 4])
def test_engine_resolves_block_rows_as_the_jax_engine(stored):
    from paddle_tpu.generation import GenerationConfig as JConfig
    from paddle_tpu.generation import GenerationEngine as JEngine
    from paddle_tpu.models.transformer import BertConfig as JBert
    from paddle_tpu.models.transformer import lm_random_params as j_params
    from paddle_tpu_torch.generation import (GenerationConfig,
                                             GenerationEngine)
    from paddle_tpu_torch.models import BertConfig, lm_random_params

    kw = dict(vocab_size=64, hidden_size=32, num_layers=1, num_heads=4,
              ffn_size=64, max_position=64)
    gkw = dict(page_size=8, max_seqs=4, max_seq_len=64)
    rows = gkw["max_seqs"] + min(16, gkw["max_seq_len"])
    if stored is not None:
        TuningStore().put(at.ragged_cache_key("cpu", rows, 4, 8, 8,
                                              "float32"),
                          {"block_rows": stored}, attestation=ATT)
    cfg = BertConfig(**kw)
    port = GenerationEngine(cfg, lm_random_params(
        cfg, np.random.RandomState(0)), GenerationConfig(**gkw),
        device="cpu")
    j_at._LOADED.clear()
    jcfg = JBert(**kw)
    jax_eng = JEngine(jcfg, j_params(jcfg, np.random.RandomState(0)),
                      JConfig(**gkw))
    assert port._bm == jax_eng._bm == (stored or 1)
    assert port._rows == jax_eng._rows


# -- fusion plans -------------------------------------------------------------

def test_cached_fusion_plan_round_trip():
    assert plans.cached_fusion_plan(8, 8, 16, 8, device=CPU) is None
    TuningStore().put(plans.plan_key("cpu", 8, 8, 16, 8, "float32"),
                      {"plan": "per_gemm"}, attestation=ATT)
    assert plans.cached_fusion_plan(8, 8, 16, 8, device=CPU) == "per_gemm"
    assert plans.fusion_plan_override(8, 8, 16, 8, torch.float32,
                                      device=CPU) == "per_gemm"


def test_unknown_plan_value_degrades_permanently():
    TuningStore().put(plans.plan_key("cpu", 8, 8, 16, 8, "float32"),
                      {"plan": "warp_drive"}, attestation=ATT)
    assert plans.cached_fusion_plan(8, 8, 16, 8, device=CPU) is None
    assert degradations.is_degraded("tuning.fusion_plan:8x8x16x8|float32")
    TuningStore().put(plans.plan_key("cpu", 8, 8, 16, 8, "float32"),
                      {"plan": "chain"}, attestation=ATT)
    assert plans.cached_fusion_plan(8, 8, 16, 8, device=CPU) is None


def _ffn_program(pt):
    main, startup = pt.Program(), pt.Program()
    startup.random_seed = 5
    with pt.program_guard(main, startup), pt.unique_name.guard():
        x = pt.data("x", [8, 64])
        h = pt.layers.fc(x, 128, act="gelu")
        y = pt.layers.fc(h, 64)
    return main, startup, y


@pytest.mark.parametrize("plan", ["per_gemm", "chain"])
def test_fusion_pass_follows_the_plan_override(plan, monkeypatch):
    """A stored plan for the FFN geometry steers the group: per_gemm runs
    two fused matmul epilogues and never the chain, chain the chain; the
    numbers stay within 1e-5 of the plain arithmetic."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops import ffn_chain as fc
    from paddle_tpu_torch.ops import fused_matmul as fm

    feed = {"x": np.random.RandomState(0).randn(8, 64).astype(np.float32)}
    TuningStore().put(plans.plan_key("cpu", 8, 64, 128, 64, "float32"),
                      {"plan": plan}, attestation=ATT)
    calls = {"chain": 0, "gemm": 0}
    real_chain, real_mm = fc.fused_ffn_chain, fm.fused_matmul

    def chain(*a, **k):
        calls["chain"] += 1
        return real_chain(*a, **k)

    def mm(*a, **k):
        calls["gemm"] += 1
        return real_mm(*a, **k)

    monkeypatch.setattr(fc, "fused_ffn_chain", chain)
    monkeypatch.setattr(fm, "fused_matmul", mm)
    main, startup, y = _ffn_program(pt)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    got, = exe.run(main, feed=feed, fetch_list=[y], scope=scope)
    (grp,) = next(iter(main._exec_cache.values())).fusion_plan.groups
    assert grp.kind == "ffn_chain"
    assert calls == ({"chain": 0, "gemm": 2} if plan == "per_gemm"
                     else {"chain": 1, "gemm": 0})
    exe.run(main, feed=feed, fetch_list=[y], scope=scope)   # cached plan
    assert calls == ({"chain": 0, "gemm": 4} if plan == "per_gemm"
                     else {"chain": 2, "gemm": 0})
    w = [np.asarray(scope.find_var(p.name)) for p in
         main.global_block().all_parameters()]
    w1, b1, w2, b2 = _fc_weights(w)
    want = _gelu(feed["x"] @ w1 + b1) @ w2 + b2
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _fc_weights(ws):
    """(w1 [64, 128], b1 [128], w2 [128, 64], b2 [64]) of _ffn_program."""
    by = {a.shape: a for a in ws}
    return by[(64, 128)], by[(128,)], by[(128, 64)], by[(64,)]


def _gelu(x):
    from scipy.special import erf

    return 0.5 * x * (1.0 + erf(x / np.sqrt(2.0)))


def test_a_chain_plan_the_process_cannot_run_is_rejected():
    from paddle_tpu_torch.core.fusion import _plan_override

    class G:
        extra = {}

    TuningStore().put(plans.plan_key("cpu", 8, 12, 100, 8, "float32"),
                      {"plan": "chain"}, attestation=ATT)
    x = torch.zeros(8, 12)
    assert _plan_override(G, (8, 12, 100, 8), x, chain_ok=False) is None
    assert degradations.is_degraded("tuning.fusion_plan:8x12x100x8|float32")


def test_autotune_fusion_plan_on_the_cpu_is_parity_only():
    r = plans.autotune_fusion_plan(8, 16, 128, 8, reps=1, device=CPU)
    assert r["parity_only"] is True and r["plan"] is None
    assert r["entry"] is None and set(r["max_abs_err"]) == {"chain",
                                                            "per_gemm"}
    assert max(r["max_abs_err"].values()) < 1e-5
    assert not os.path.exists(at.cache_path())


def test_autotune_fusion_plan_force_time_persists_attested():
    r = plans.autotune_fusion_plan(8, 16, 128, 8, reps=1, device=CPU,
                                   force_time=True)
    assert r["plan"] in plans.PLANS
    assert r["entry"]["version"] == 1 and attestation_ok(r["entry"])
    assert r["entry"]["attestation"]["backend"] == "cpu"
    key = plans.plan_key("cpu", 8, 16, 128, 8, "float32")
    assert TuningStore().get(key)["config"]["plan"] == r["plan"]


# -- searches ----------------------------------------------------------------

def test_ragged_search_attests_every_candidate():
    r = at.autotune_ragged(24, 4, 16, 16, 4, reps=1, device=CPU)
    assert r["parity_only"] is True
    assert [c["block_rows"] for c in r["candidates"]] == [8, 4, 2, 1]
    assert all(c["parity"] and c["max_abs_err"] == 0.0
               for c in r["candidates"])
    assert not os.path.exists(at.cache_path())
    odd = at.autotune_ragged(6, 4, 16, 16, 4, reps=1, device=CPU)
    assert [c["block_rows"] for c in odd["candidates"]] == [2, 1]


def test_search_geometry_ragged_parity_only_writes_nothing():
    from paddle_tpu_torch.tuning import search_geometry

    r = search_geometry("ragged", "r8h4d8p8", reps=1, device=CPU)
    assert r["parity_only"] is True and r["entry"] is None
    assert not os.path.exists(at.cache_path())


def test_search_geometry_ragged_persists_and_the_resolver_serves_it():
    from paddle_tpu_torch.generation.ragged_attention import \
        resolve_block_rows
    from paddle_tpu_torch.tuning import search_geometry

    r = search_geometry("ragged", "r8h4d8p8", reps=1, force_time=True,
                        device=CPU)
    entry = TuningStore().get(make_key("ragged", "cpu", "r8h4d8p8",
                                       "float32"))
    assert entry["config"] == r["config"] and attestation_ok(entry)
    assert entry["attestation"]["ref"] == "ragged_ref_attention"
    assert entry["source"] == "search"
    assert resolve_block_rows(8, 4, 8, 8, device=CPU) \
        == r["config"]["block_rows"]


@pytest.mark.parametrize("kernel,geometry", [("matmul", "8x128x16"),
                                             ("attn_epilogue", "t8h8nh2")])
def test_tile_searches_are_refused_with_the_roadmap_item(kernel, geometry):
    from paddle_tpu_torch.tuning import search_geometry

    with pytest.raises(NotImplementedError, match="ROADMAP.md, Queue 2"):
        search_geometry(kernel, geometry, reps=1, device=CPU)
    roadmap = (ROOT / "ROADMAP.md").read_text()
    assert "tile search for #9, #10 and #11" in roadmap


def test_search_geometry_ffn_searches_the_plan_only():
    from paddle_tpu_torch.tuning import search_geometry

    r = search_geometry("ffn", "8x16x128x8", reps=1, force_time=True,
                        device=CPU)
    assert "ROADMAP.md" in r["tile_search"] and r["config"] is None
    assert r["plan"]["plan"] in plans.PLANS
    assert TuningStore().get(plans.plan_key("cpu", 8, 16, 128, 8,
                                            "float32")) is not None


# -- the worker verbs over a real socket, the service -------------------------

class _SocketHandle:
    """A worker handle over the port's RPC (a real socket)."""

    def __init__(self, rank, servicer):
        from paddle_tpu_torch.cluster import RpcClient, RpcServer

        self.rank, self.alive, self.role, self.model_id = (
            rank, True, servicer.role, None)
        self.server = RpcServer("127.0.0.1", 0, servicer.handle).start()
        self.client = RpcClient("127.0.0.1", self.server.port,
                                connect_timeout_s=5.0)
        self.endpoint = self.client.endpoint

    def call(self, op, **payload):
        return self.client.call(op, **payload)

    def close(self):
        self.client.close()
        self.server.close()


def test_worker_tuning_verbs_over_the_rpc(tmp_path):
    from paddle_tpu_torch.cluster import testing as ct
    from paddle_tpu_torch.cluster.worker import WorkerServicer

    servicer = WorkerServicer("infer", ct.timed_backend)
    h = _SocketHandle(0, servicer)
    try:
        key = make_key("ragged", "cpu", "r8h4d8p8", "float32")
        wpath = str(tmp_path / "worker_tune.json")
        rep = h.call("tuning_push", path=wpath, entries={
            key: {"config": {"block_rows": 2}, "version": 1,
                  "attestation": ATT}})
        assert rep["ok"] and rep["applied"] == [key]
        rep = h.call("tuning_pull", path=wpath)
        assert rep["ok"] and rep["entries"][key]["source"] == "distributed"
        rep = h.call("tuning_push", path=wpath, entries={
            "ragged|cpu|r16h4d8p8|float32": {"config": {"block_rows": 2},
                                             "version": 1}})
        assert rep["ok"] and "attestation" in \
            rep["rejected"]["ragged|cpu|r16h4d8p8|float32"]
        rep = h.call("tuning_search", kernel="ragged", geometry="r8h4d8p8",
                     reps=1, device="cpu")
        assert rep["ok"] and rep["report"]["parity_only"] is True
        rep = h.call("tuning_search", kernel="matmul", geometry="8x8x8",
                     device="cpu")
        assert not rep["ok"] and rep["error_type"] == "NotImplementedError"
    finally:
        h.close()
        servicer.close()


def test_service_harvest_search_push_round_trip(tmp_path):
    from paddle_tpu_torch.cluster import testing as ct
    from paddle_tpu_torch.cluster.worker import WorkerServicer
    from paddle_tpu_torch.generation.ragged_attention import \
        resolve_block_rows
    from paddle_tpu_torch.tuning import TuningService

    resolve_block_rows(8, 4, 8, 8, device=CPU)   # the fleet's geometry
    servicer = WorkerServicer("infer", ct.timed_backend)
    handles = [_SocketHandle(0, servicer)]
    svc = TuningService(lambda: handles, store=TuningStore(
        str(tmp_path / "router_tune.json")), reps=1, force_time=True,
        device=CPU)
    try:
        observed = svc.harvest()
        todo = [r for r in svc.pending(observed)
                if r["kernel"] == "ragged" and r["geometry"] == "r8h4d8p8"]
        assert todo
        reports = svc.search(todo)
        assert reports and reports[0]["config"] is not None
        assert not svc.pending(todo)
        (reply,) = svc.push().values()
        assert reply["ok"] and reply["applied"]
        at._LOADED.clear()
        assert resolve_block_rows(8, 4, 8, 8, device=CPU) \
            == reports[0]["config"]["block_rows"]
        entry = TuningStore().get(make_key("ragged", "cpu", "r8h4d8p8",
                                           "float32"))
        assert entry["source"] == "distributed" and attestation_ok(entry)
    finally:
        for h in handles:
            h.close()
        servicer.close()


# -- the degradation registry: control-plane keys only ------------------------

@pytest.mark.parametrize("key", ["ops.ffn_chain", "generation.paged_decode",
                                 "ops.flash_attention", "fleetrollout"])
def test_degrade_refuses_kernel_keys(key):
    with pytest.raises(ValueError, match="control-plane"):
        degradations.degrade(key)
    assert degradations.events() == []


def test_degrade_takes_control_plane_keys_once():
    before = _counter("kernel_degradations_total", key="fleet.rollout")
    assert degradations.degrade("fleet.rollout", detail="canary") is True
    assert degradations.degrade("fleet.rollout") is False
    assert degradations.degrade("tuning.fusion_plan:1x2x3x4|float32")
    ev = {e["key"]: e for e in degradations.events()}
    assert ev["fleet.rollout"]["count"] == 2
    assert _counter("kernel_degradations_total",
                    key="fleet.rollout") == before + 2


def test_no_kernel_path_consults_the_registry():
    pkg = ROOT / "paddle_tpu_torch"
    paths = (sorted((pkg / "ops").rglob("*.py"))
             + sorted((pkg / "generation").rglob("*.py"))
             + [pkg / "core" / "lowering.py"])
    users = [str(p.relative_to(ROOT)) for p in paths
             if "degradations" in p.read_text()]
    assert users == []
