"""The port's observability modules against the JAX package's, on the CPU.

Each test feeds the same operations, drawn from a numpy seed, to both
packages' modules and compares what they keep.  The comparison is exact;
wall-clock readings (dump and write times, timestamps of exemplars and
host events, step wall times) are left out of it, and nothing else is.
Both registries are reset before and after every test.
"""
import json
import threading

import numpy as np
import pytest

from paddle_tpu import observability as jobs
from paddle_tpu import profiler as jprof
from paddle_tpu.observability import flightrec as jflight
from paddle_tpu.observability import ledger as jledger
from paddle_tpu.observability import tracing as jtracing
from paddle_tpu_torch import observability as tobs
from paddle_tpu_torch import profiler as tprof
from paddle_tpu_torch.observability import flightrec as tflight
from paddle_tpu_torch.observability import ledger as tledger
from paddle_tpu_torch.observability import tracing as ttracing

PACKAGES = {"jax": (jobs, jprof, jflight, jledger, jtracing),
            "torch": (tobs, tprof, tflight, tledger, ttracing)}


@pytest.fixture(autouse=True)
def _fresh_registries():
    for obs, prof, flight, _, _ in PACKAGES.values():
        obs.get_registry().reset()
        prof.reset_profiler()
        flight.disarm(clear=True)
    yield
    for obs, prof, flight, _, _ in PACKAGES.values():
        obs.get_registry().reset()
        if prof.is_profiling():
            prof.stop_profiler(quiet=True)
        prof.reset_profiler()
        flight.disarm(clear=True)


def _drive_registry(obs, seed, clock):
    """Counters, gauges, labelled histograms and exemplars on a private
    registry, every value drawn from ``seed``."""
    rng = np.random.RandomState(seed)
    reg = obs.MetricsRegistry()
    c = reg.counter("reqs_total", "requests by outcome")
    g = reg.gauge("depth", "queue depth")
    h = reg.histogram("lat_ms", "latency")
    occ = reg.histogram("occ", "occupancy",
                        bounds=tuple(i / 10 for i in range(1, 11)))
    for i in range(200):
        c.inc(int(rng.randint(1, 5)), outcome=str(rng.choice(
            ["ok", "failed", "shed"])), server=str(i % 3))
        g.set(float(rng.randint(0, 64)), server=str(i % 3))
        h.labels(server=str(i % 2), phase=str(rng.choice(
            ["prefill", "decode"]))).observe(float(rng.lognormal(1, 1)))
        occ.observe(float(rng.rand()))
    # exemplars: a fixed clock stamps them in both packages
    ex = obs.Histogram("ex_ms", "exemplar latency", clock=clock)
    reg._metrics["ex_ms"] = ex
    for i in range(40):
        ex.observe(float(rng.lognormal(2, 1)), exemplar=int(rng.randint(
            1, 1 << 30)), route=str(i % 2))
    # odd label values: the text exposition escapes them
    c.inc(1, outcome='a"b\\c\nd', server="x")
    return reg


def _drop_exemplar_ts(snap):
    for entry in snap["metrics"].values():
        for rec in entry["series"]:
            for ex in rec.get("exemplars", ()):
                ex[3] = None
    return snap


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_snapshot_and_prometheus_text_equal(seed):
    regs = {k: _drive_registry(obs, seed, clock=lambda: 1234.5)
            for k, (obs, *_) in PACKAGES.items()}
    snaps = {k: _drop_exemplar_ts(r.snapshot()) for k, r in regs.items()}
    assert snaps["torch"] == snaps["jax"]
    assert json.dumps(snaps["torch"], sort_keys=True) == \
        json.dumps(snaps["jax"], sort_keys=True)
    assert regs["torch"].prometheus_text() == regs["jax"].prometheus_text()
    # the process registry is the same kind of object
    assert isinstance(tobs.get_registry(), tobs.MetricsRegistry)


def test_histogram_percentiles_and_series_equal():
    rng = np.random.RandomState(3)
    vals = rng.lognormal(1, 1, size=5000)
    got = {}
    for k, (obs, *_) in PACKAGES.items():
        h = obs.Histogram("h", max_samples=512)
        for v in vals:
            h.observe(float(v), shard=int(v) % 4)
        got[k] = [(labels, s.state()[:3], s.buckets(), s.percentile(50),
                   s.percentile(99)) for labels, s in h.series()]
    assert got["torch"] == got["jax"]


def test_snapshot_diff_and_format_diff_equal(tmp_path):
    out = {}
    for k, (obs, *_) in PACKAGES.items():
        reg = obs.MetricsRegistry()
        c = reg.counter("c_total", "c")
        g = reg.gauge("g", "g")
        h = reg.histogram("h_ms", "h")
        rng = np.random.RandomState(5)
        c.inc(3, kind="a")
        g.set(2.0)
        h.observe(1.5)
        before = reg.snapshot()
        for _ in range(20):
            c.inc(int(rng.randint(1, 4)), kind=str(rng.choice(["a", "b"])))
            g.set(float(rng.randint(0, 9)))
            h.observe(float(rng.lognormal(1, 1)))
        after = reg.snapshot()
        diff = obs.snapshot_diff(before, after)
        prom = tmp_path / f"{k}.prom"
        snap = tmp_path / f"{k}.json"
        obs.write_prometheus(str(prom), registry=reg)
        obs.write_snapshot(str(snap), registry=reg)
        out[k] = (diff, obs.format_diff(diff), prom.read_text(),
                  json.loads(snap.read_text()))
    assert out["torch"] == out["jax"]


def _ledger_ops(seed):
    rng = np.random.RandomState(seed)
    ops = []
    for i in range(300):
        ops.append(dict(
            uid=f"r{i}", trace_id=int(rng.randint(1, 1 << 20)),
            tenant=str(rng.choice(["t0", "t1", "t2"])),
            model=str(rng.choice(["m0", "m1"])),
            outcome=str(rng.choice(["ok", "shed", "error"])),
            prefix_tokens=int(rng.randint(0, 64)),
            decode_tokens=int(rng.randint(0, 96)),
            service_ms=float(rng.lognormal(2, 1)),
            queue_wait_ms=float(rng.lognormal(0, 1)),
            t_admit=float(i), t_done=float(i) + float(rng.rand())))
    return ops


@pytest.mark.parametrize("capacity", [64, 4096])
def test_request_ledger_records_eviction_and_rollup_equal(capacity):
    got = {}
    for k, (obs, _, _, ledger, _) in PACKAGES.items():
        reg = obs.MetricsRegistry()
        book = ledger.RequestLedger(capacity=capacity, registry=reg,
                                    name="L")
        for fields in _ledger_ops(7):
            book.record(**fields)
        with pytest.raises(ValueError, match="unknown ledger fields"):
            book.record(uid="x", bogus_key=1)
        got[k] = (book.tail(), book.tail(5), len(book), book.rollup(),
                  ledger.rollup(book.tail()), reg.snapshot())
        prev = ledger.set_enabled(False)
        book.record(uid="off")
        ledger.set_enabled(prev)
        got[k] += (len(book),)
    assert got["torch"] == got["jax"]


def _slo_run(obs, seed):
    """Availability and latency objectives over a fixed clock: cumulative
    good/bad counters and a stamped latency histogram, evaluated at
    fixed instants."""
    rng = np.random.RandomState(seed)
    t = [0.0]
    reg = obs.MetricsRegistry()
    hist = obs.Histogram("lat_ms", "latency", clock=lambda: t[0])
    reg._metrics["lat_ms"] = hist
    counts = [0, 0]
    objs = [obs.SloObjective("avail", "availability", 0.99,
                             counters=lambda: tuple(counts)),
            obs.SloObjective("p99", "latency", 0.95, latency_ms=40.0,
                             histogram="lat_ms")]
    pol = obs.SloPolicy(objs, fast_windows=(10.0, 60.0),
                        slow_windows=(120.0, 600.0))
    eng = obs.SloEngine(pol, registry=reg, clock=lambda: t[0],
                        fire_trigger=False)
    states = []
    for step in range(60):
        t[0] = step * 5.0
        bad_rate = 0.3 if 20 <= step < 30 else 0.002
        n = int(rng.randint(50, 150))
        bad = int(rng.binomial(n, bad_rate))
        counts[0] += n - bad
        counts[1] += bad
        for _ in range(int(rng.randint(5, 20))):
            hist.observe(float(rng.lognormal(3 if step < 40 else 4, 0.5)))
        states.append(eng.evaluate(now=t[0]))
    return states, eng.burn_state(), eng.paging(), reg.snapshot()


def test_slo_burn_states_equal_over_a_fixed_clock():
    got = {k: _slo_run(obs, 11) for k, (obs, *_) in PACKAGES.items()}
    assert got["torch"] == got["jax"]
    states = got["torch"][0]
    assert any(s["avail"]["page"] for s in states)       # the burst pages
    assert not states[-1]["avail"]["page"]


def _strip_times(dump):
    dump = dict(dump)
    for key in ("pid", "dumped_at_unix", "perf_origin_unix_us"):
        dump.pop(key)
    events = []
    for ev in dump["events"]:
        ev = {k: v for k, v in ev.items() if k not in ("t0", "t1", "t")}
        events.append(ev)
    dump["events"] = events
    return dump


def test_flight_recorder_ring_equal():
    got = {}
    for k, (obs, prof, flight, _, tracing) in PACKAGES.items():
        tracing.reseed_ids(1)
        flight.arm(ring_size=32)
        rng = np.random.RandomState(13)
        for i in range(50):
            with tracing.span("outer", i=i):
                flight.note("admit", slot=int(rng.randint(0, 8)))
                with tracing.span("inner", rows=int(rng.randint(1, 9))):
                    pass
            tracing.record_span("queue_wait", 0.0, 1.0)
        rec = flight.get_recorder()
        n_ring = len(rec)
        dump = rec.dump()
        chrome = flight.FlightRecorder.to_chrome_trace(dump)
        reasons = []
        flight.add_trigger_listener(lambda r, d, f: reasons.append(r))
        flight.trigger("slo_shed", "burst", model="m")
        flight.disarm(clear=True)
        got[k] = (_strip_times(dump), n_ring, reasons,
                  sorted(chrome), obs.get_registry().snapshot())
    assert got["torch"] == got["jax"]
    assert got["torch"][1] == 32


def _span_tree(tracing, flight):
    """Nested spans across two threads joined with attach; returns the
    (name, trace_id, span_id, parent_span_id) of every closed span."""
    tracing.reseed_ids(1)
    flight.arm()
    flight.get_recorder().clear()
    with tracing.span("client", user=1):
        ctx = tracing.current_span()
        with tracing.span("prep"):
            pass

        def worker():
            with tracing.attach(ctx):
                with tracing.span("serving:batch_b4", n_requests=2):
                    with tracing.span("generation:chunk_step",
                                      decode=3, chunk_tokens=16,
                                      spec_rows=0):
                        pass
                    tracing.record_span("serving:queue_wait", 1.0, 2.0,
                                        ctx=ctx)
            with tracing.span("orphan"):
                pass

        t = threading.Thread(target=worker)
        t.start()
        t.join()
    root = tracing.new_trace()
    tracing.record_span("detached", 3.0, 4.0, ctx=root)
    events = flight.get_recorder().dump()["events"]
    flight.disarm(clear=True)
    return [(e["name"], e["trace_id"], e["span_id"], e["parent_span_id"],
             e.get("attrs")) for e in events]


def test_span_id_triples_equal_across_threads():
    got = {k: _span_tree(tracing, flight)
           for k, (_, _, flight, _, tracing) in PACKAGES.items()}
    assert got["torch"] == got["jax"]
    names = [g[0] for g in got["torch"]]
    assert names == ["prep", "generation:chunk_step", "serving:queue_wait",
                     "serving:batch_b4", "orphan", "client", "detached"]
    by_name = {g[0]: g for g in got["torch"]}
    client = by_name["client"]
    assert by_name["serving:batch_b4"][1] == client[1]
    assert by_name["serving:batch_b4"][3] == client[2]
    assert by_name["orphan"][1] != client[1]


def test_disabled_span_yields_none_and_records_nothing():
    for _, (obs, prof, flight, _, tracing) in PACKAGES.items():
        with tracing.span("x") as ctx:
            assert ctx is None
        assert tracing.record_span("y", 0.0, 1.0) is None
        assert prof.summary().count("\n") == 2      # the header only


def _profile_events(prof, tracing, tmp_path, name):
    """The same host events through each profiler; returns its summary
    (timings dropped) and its Chrome-trace export."""
    tracing.reseed_ids(1)
    prof.start_profiler("CPU")
    for i in range(5):
        with prof.RecordEvent("fwd"):
            pass
        prof.record("bwd", 1.0 + i, 1.5 + i, args={"k": i})
        with tracing.span("train:step", step=i):
            with tracing.span("run:1"):
                pass
    report = prof.stop_profiler(sorted_key="calls", quiet=True)
    path = prof.export_chrome_tracing(str(tmp_path / f"{name}.json"))
    with open(path) as f:
        doc = json.load(f)
    rows = [line.split()[:2] for line in report.splitlines()[3:]]
    return report.splitlines()[:3], rows, doc


def test_profiler_summary_and_chrome_export_match(tmp_path):
    got = {k: _profile_events(prof, tracing, tmp_path, k)
           for k, (_, prof, _, _, tracing) in PACKAGES.items()}
    assert got["torch"][:2] == got["jax"][:2]
    assert sorted(got["torch"][1]) == [["bwd", "5"], ["fwd", "5"],
                                       ["run:1", "5"], ["train:step", "5"]]
    jdoc, tdoc = got["jax"][2], got["torch"][2]
    assert sorted(tdoc) == sorted(jdoc) == ["metadata", "traceEvents"]
    assert sorted(tdoc["metadata"]) == sorted(jdoc["metadata"]) == \
        ["perf_origin_unix_us", "pid"]

    def schema(doc):
        return [(e["ph"], e["name"], sorted(e), sorted(e.get("args", {})))
                for e in doc["traceEvents"] if e["name"] not in
                ("process_name",)]

    assert schema(tdoc) == schema(jdoc)
    # the summary of identical (name, t0, t1) events is the same table
    for prof in (jprof, tprof):
        prof.reset_profiler()
        prof.start_profiler("CPU")
        for i in range(4):
            prof.record("ev", 0.0, 0.001 * (i + 1))
        prof.stop_profiler(quiet=True)
    assert tprof.summary("ave") == jprof.summary("ave")
    assert tprof.summary("max") == jprof.summary("max")


def test_profiler_device_states(tmp_path):
    """'CPU' with a tracer_path runs a torch.profiler session of the host
    and writes its Kineto trace, where a span is a record_function range;
    'GPU' and 'All' with a tracer_path raise without a card."""
    import torch

    tprof.start_profiler("CPU", tracer_path=str(tmp_path / "cpu"))
    assert tprof.device_tracing()
    with ttracing.span("traced:block"):
        torch.ones(8).add_(1)
    ttracing.record_span("after_the_fact", 0.0, 1.0)
    tprof.stop_profiler(quiet=True)
    assert not tprof.device_tracing()
    path = tprof.last_device_trace()
    assert path and path.startswith(str(tmp_path / "cpu"))
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "traced:block" in names
    assert "after_the_fact" not in names
    assert tprof.last_device_profile() is not None
    if torch.cuda.is_available():
        return
    for state in ("GPU", "All"):
        with pytest.raises(RuntimeError, match="CUDA"):
            tprof.start_profiler(state, tracer_path=str(tmp_path / state))
        assert not tprof.is_profiling() and not tprof.device_tracing()
    with pytest.raises(RuntimeError, match="CUDA"):
        with tprof.cuda_profiler(str(tmp_path / "nvprof")):
            pass
    # without a tracer path, every state records host events only
    tprof.start_profiler("All")
    assert tprof.is_profiling() and not tprof.device_tracing()
    tprof.stop_profiler(quiet=True)


def test_trace_readers_place_kernels_in_their_ranges():
    """The Kineto readers on a trace of the shape torch.profiler writes:
    host ranges, their device twins, and kernels counted inside a range
    by the device twin's span on the device clock."""
    def x(cat, name, ts, dur, tid=1):
        return {"ph": "X", "cat": cat, "name": name, "tid": tid, "ts": ts,
                "dur": dur, "args": {}}

    ragged = "void ragged_attention_kernel<64>(float const*)"
    doc = {"traceEvents": [
        x("user_annotation", "step", 100.0, 50.0),
        x("user_annotation", "step", 200.0, 50.0, tid=2),
        x("gpu_user_annotation", "step", 300.0, 20.0, tid=7),
        x("gpu_user_annotation", "step", 400.0, 20.0, tid=7),
        # runtime events take no part: their clock is not the device's
        x("cuda_runtime", "cudaLaunchKernel", 110.0, 1.0),
        x("kernel", ragged, 300.0, 9.0, tid=7),
        x("kernel", ragged, 410.0, 10.0, tid=7),
        x("kernel", ragged, 421.0, 2.0, tid=7),
        x("kernel", "gemm_tc_kernel", 305.0, 6.0, tid=7),
        x("kernel", "flash_fwd_tc_kernel", 500.0, 5.0, tid=7)]}
    assert tprof.trace_ranges(doc, "step") == [(1, 100.0, 150.0),
                                               (2, 200.0, 250.0)]
    assert tprof.trace_ranges(doc, "step", device=True) == [
        (7, 300.0, 320.0), (7, 400.0, 420.0)]
    assert tprof.trace_kernels(doc)[:2] == [(ragged, 300.0, 309.0),
                                            (ragged, 410.0, 420.0)]
    assert tprof.kernels_inside(doc, "ragged_attention_kernel",
                                "step") == (3, 2)
    assert tprof.kernels_inside(doc, "gemm_tc_kernel", "step") == (1, 1)
    assert tprof.kernels_inside(doc, "flash_fwd", "step") == (1, 0)
    assert tprof.kernels_inside(doc, "missing", "step") == (0, 0)


def test_training_monitor_records_equal(tmp_path):
    got = {}
    for k, (obs, *_) in PACKAGES.items():
        reg = obs.get_registry()
        reg.counter("executor_compiles_total",
                    "executor program lowerings").inc(3)
        rng = np.random.RandomState(17)
        path = tmp_path / f"{k}.jsonl"
        mon = obs.TrainingMonitor(jsonl_path=str(path), run="r")
        for step in range(12):
            loss = float(rng.rand()) if step != 5 else float("nan")
            if step == 7:
                mon.on_nan_skip(step)
                continue
            if step == 9:
                mon.on_checkpoint(step, 0.25)
            mon.on_step(step, loss=loss, wall_s=float(rng.rand()) / 10,
                        examples=32)
        mon.close()
        recs = [json.loads(line) for line in path.read_text().splitlines()]
        for r in recs:
            r.pop("ts")
        got[k] = (recs, mon.summary()["records_written"],
                  {n: e["series"] for n, e in reg.snapshot()["metrics"]
                   .items() if n.startswith("train_")})
    assert got["torch"] == got["jax"]
    assert len(got["torch"][0]) == 12
    assert got["torch"][0][0]["compiles_total"] == 3
    assert got["torch"][0][0]["kernel_degradations_total"] == 0


class _Handle:
    """A duck-typed worker handle: ``call(verb)`` answers
    ``registry_snapshot`` and ``ledger_tail``."""

    def __init__(self, rank, role, snap, records, alive=True):
        self.rank, self.role, self.alive = rank, role, alive
        self.model_id = "m"
        self._snap, self._records = snap, records

    def call(self, verb):
        if verb == "registry_snapshot":
            return {"snapshot": self._snap, "role": self.role, "pid": 1}
        if verb == "ledger_tail":
            return {"ok": True, "records": self._records}
        raise ValueError(verb)


def test_telemetry_scraper_fleet_snapshot_and_rollup_equal():
    got = {}
    for k, (obs, _, _, ledger, _) in PACKAGES.items():
        workers = []
        for rank in range(3):
            wreg = _drive_registry(obs, 20 + rank, clock=lambda: 1.0)
            book = ledger.RequestLedger(capacity=16, registry=wreg)
            for fields in _ledger_ops(rank)[:20]:
                book.record(**fields)
            workers.append(_Handle(rank, "decode" if rank else "prefill",
                                   _drop_exemplar_ts(wreg.snapshot()),
                                   book.tail(), alive=rank != 2))
        reg = obs.MetricsRegistry()
        reg.counter("router_total", "r").inc(2)
        scr = obs.TelemetryScraper(lambda: workers, registry=reg,
                                   clock=lambda: 5.0)
        ok = scr.scrape()
        fleet = scr.fleet_snapshot()
        fleet["workers"] = {w: {k2: v for k2, v in e.items()
                                if k2 != "pid"}
                            for w, e in fleet["workers"].items()}
        rolled = scr.rollup()
        # the scrape pass's own wall time is a timing
        for doc in (fleet, rolled):
            doc["metrics"].pop("telemetry_scrape_ms")
        got[k] = (ok, json.dumps(fleet, sort_keys=True, default=str),
                  json.dumps(rolled, sort_keys=True, default=str),
                  scr.worker_signals())
    assert got["torch"][1:] == got["jax"][1:]
    assert got["torch"][0] == got["jax"][0] == 2


def test_enabled_switch():
    for obs, *_ in PACKAGES.values():
        assert obs.enabled()
        obs.set_enabled(False)
        assert not obs.enabled()
        obs.set_enabled(True)
    assert sorted(tobs.__all__) == sorted(jobs.__all__)
