"""The port's engine, server and Executor telemetry against the JAX
package's, on the CPU.

* Generation: BERT-tiny (initializer_range 0.6) with the same weights
  through the JAX engine and the port's (``device="cpu"``), chunked and
  legacy, each with an explicit ``engine=`` id.  After ``generate`` the
  ``GenerationStats`` snapshots are equal key for key, the registry's
  ``generation_*`` series are equal series for series, and
  ``ledger_counters()`` are equal; under a ``state="CPU"`` profiler the
  engine's span names and args, in order, are equal.
* Serving: the same engines behind ``InferenceServer`` with a
  ``GenerationBackend``, one client thread sending requests one after
  another, each inside its own ``span("client_request")``: the
  ``ServingStats`` count fields are equal, and every ``serving:*`` span
  joins the client's trace.
* Training: BERT-tiny at hidden 128 through both Executors with the
  fusion pass (the pairing of ``tests/test_torch_bert_train.py``): the
  ``fused_*_hits_total``, ``executor_compiles_total`` and
  ``optimizer_state_bytes`` series are equal.  (The JAX executor sets
  ``optimizer_state_bytes`` only for a CompiledProgram with a mesh; the
  port has no mesh yet and sets it for every CompiledProgram, so the
  JAX side's value comes from its own helper on its own state.)

What is left out of the comparisons, and why:
* timings — ``*_per_sec``, the ``inter_token``/latency summaries, the
  ``*_seconds_total`` series and the histograms of milliseconds;
* the two keys the port's snapshot differs in by design: ``steps`` /
  ``steps_total`` (the port's step count; the JAX snapshot has none)
  and ``kernel_degradations`` (the JAX snapshot's; the port has no
  degradation registry);
* ``compiles_total`` / ``compiles_at_warmup`` (and the ``*_compiles``
  gauges): they count different things — XLA compiles in the JAX
  package, kernel library builds and loads in the port (none on the
  CPU).  ``compiles_after_warmup`` is compared: 0 in both.
Everything else is compared exactly.
"""
import dataclasses
import os
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as pt
from paddle_tpu import observability as jobs
from paddle_tpu import profiler as jprof
from paddle_tpu.compiler import BuildStrategy as JBuildStrategy
from paddle_tpu.compiler import CompiledProgram as JCompiledProgram
from paddle_tpu.core import executor as jexecutor
from paddle_tpu.generation import GenerationBackend as JGenerationBackend
from paddle_tpu.generation import GenerationConfig as JGenerationConfig
from paddle_tpu.generation import GenerationEngine as JGenerationEngine
from paddle_tpu.generation import SamplingParams as JSamplingParams
from paddle_tpu.models import BertConfig as JBertConfig
from paddle_tpu.models import build_bert_pretrain as jax_bert
from paddle_tpu.models import lm_random_params as j_lm_random_params
from paddle_tpu.observability import flightrec as jflight
from paddle_tpu.observability import tracing as jtracing
from paddle_tpu.serving import InferenceServer as JInferenceServer
from paddle_tpu.serving import ServingConfig as JServingConfig
from paddle_tpu.serving.stats import GenerationStats as JGenerationStats
from paddle_tpu.serving.stats import ServingStats as JServingStats
from paddle_tpu_torch import observability as tobs
from paddle_tpu_torch import profiler as tprof
from paddle_tpu_torch.generation import (GenerationBackend, GenerationConfig,
                                         GenerationEngine, SamplingParams)
from paddle_tpu_torch.models import BertConfig, build_bert_pretrain
from paddle_tpu_torch.observability import flightrec as tflight
from paddle_tpu_torch.observability import tracing as ttracing
from paddle_tpu_torch.serving import InferenceServer, ServingConfig
from paddle_tpu_torch.serving.stats import GenerationStats, ServingStats

torch.set_num_threads(2)

CFG = dataclasses.replace(BertConfig.tiny(), initializer_range=0.6)
JCFG = dataclasses.replace(JBertConfig.tiny(), initializer_range=0.6)
PARAMS = j_lm_random_params(JCFG, np.random.RandomState(0))
#: explicit ragged_block_rows: the JAX engine's default comes from its
#: TPU block-size tuning, and R names the chunked warmup span
GEN = dict(page_size=8, max_seqs=4, max_seq_len=64, seed=7,
           ragged_block_rows=4)
MODES = {"chunked": dict(),
         "legacy": dict(scheduling="legacy", prefill_seq_buckets=(8, 16))}
LENGTHS = {"chunked": (3, 17, 9, 30, 5), "legacy": (3, 12, 9, 16, 5, 7)}
MAX_NEW = (12, 20, 9, 16, 14, 11)

#: snapshot keys that hold timings
TIMED = ("prefill_tokens_per_sec", "decode_tokens_per_sec", "inter_token",
         "inter_token_ms", "latency", "latency_ms", "queue_wait",
         "queue_wait_ms", "batch_execute", "batch_execute_ms", "qps")
#: the port's own keys / the JAX package's own keys (see the docstring)
PORT_ONLY = ("steps", "steps_total")
JAX_ONLY = ("kernel_degradations",)
COMPILE_COUNTS = ("compiles_total", "compiles_at_warmup")
#: registry series that hold timings or compile counts
SKIP_SERIES = ("generation_seconds_total", "generation_inter_token_ms",
               "generation_compiles", "serving_compiles",
               "serving_request_latency_ms", "serving_queue_wait_ms",
               "serving_batch_execute_ms")


@pytest.fixture(autouse=True)
def _fresh():
    for obs, prof, flight in ((jobs, jprof, jflight),
                              (tobs, tprof, tflight)):
        obs.get_registry().reset()
        prof.reset_profiler()
        flight.disarm(clear=True)
    yield
    for obs, prof, flight in ((jobs, jprof, jflight),
                              (tobs, tprof, tflight)):
        obs.get_registry().reset()
        if prof.is_profiling():
            prof.stop_profiler(quiet=True)
        prof.reset_profiler()
        flight.disarm(clear=True)


def _prompts(mode):
    rng = np.random.RandomState(1)
    return [rng.randint(1, CFG.vocab_size, (n,)).tolist()
            for n in LENGTHS[mode]]


def _engines(mode, eid):
    jeng = JGenerationEngine(JCFG, PARAMS, JGenerationConfig(
        **GEN, **MODES[mode]))
    jeng.stats = JGenerationStats(engine=eid)
    eng = GenerationEngine(CFG, PARAMS, GenerationConfig(
        **GEN, **MODES[mode]), device="cpu")
    eng.stats = GenerationStats(engine=eid)
    return jeng, eng


def _comparable(snap, drop):
    return {k: v for k, v in snap.items()
            if k not in TIMED + COMPILE_COUNTS + drop}


def _series(obs, prefix, label):
    """The registry's ``prefix*`` series of one engine or server (the
    ``label`` pair; constructors also register their auto-numbered ids,
    which depend on how many engines the process made before), timings
    and compile gauges left out; histograms as counts and buckets."""
    key, value = label
    out = {}
    for name, entry in obs.get_registry().snapshot()["metrics"].items():
        if not name.startswith(prefix) or name in SKIP_SERIES:
            continue
        out[name] = sorted(
            (sorted(rec["labels"].items()),
             rec.get("value", (rec.get("count"), rec.get("buckets"))))
            for rec in entry["series"] if rec["labels"].get(key) == value)
    return out


def _engine_spans(prof):
    return [(name, {k: v for k, v in (args or {}).items()
                    if k not in ("trace_id", "span_id", "parent_span_id")})
            for name, _, _, _, args in prof._events
            if name.startswith("generation:")]


@pytest.mark.parametrize("mode", list(MODES))
def test_generation_stats_registry_and_spans_equal(mode, tmp_path):
    eid = f"e-{mode}"
    jeng, eng = _engines(mode, eid)
    sp = [dict(max_new_tokens=n) for n in MAX_NEW[:len(LENGTHS[mode])]]
    jprof.start_profiler("CPU")
    tprof.start_profiler("CPU", tracer_path=str(tmp_path))
    jeng.warmup()
    eng.warmup()
    jres = jeng.generate(_prompts(mode), [JSamplingParams(**k) for k in sp])
    res = eng.generate(_prompts(mode), [SamplingParams(**k) for k in sp])
    jprof.stop_profiler(quiet=True)
    tprof.stop_profiler(quiet=True)
    assert [r.tokens for r in res] == [r.tokens for r in jres]

    jsnap, snap = jeng.stats.snapshot(), eng.stats.snapshot()
    assert snap["engine"] == jsnap["engine"] == eid
    assert set(snap) - set(jsnap) == set(PORT_ONLY)
    assert set(jsnap) - set(snap) == set(JAX_ONLY)
    assert _comparable(snap, PORT_ONLY) == _comparable(jsnap, JAX_ONLY)
    assert snap["compiles_after_warmup"] == jsnap["compiles_after_warmup"] \
        == 0
    assert snap["decode_tokens"] > 0 and snap["requests_done"] == len(res)
    assert eng.ledger_counters() == jeng.ledger_counters()
    series = _series(tobs, "generation_", ("engine", eid))
    assert series == _series(jobs, "generation_", ("engine", eid))
    assert len(series["generation_tokens_total"]) == 2   # both phases
    tok = tobs.get_registry().counter("generation_tokens_total")
    assert sum(s.value() for labels, s in tok.series()
               if dict(labels)["engine"] == eid) == \
        snap["prefill_tokens"] + snap["decode_tokens"]

    spans = _engine_spans(tprof)
    assert spans == _engine_spans(jprof)
    step = "generation:chunk_step" if mode == "chunked" else \
        "generation:decode_step"
    assert sum(name == step for name, _ in spans) > 0
    assert spans[0][0].startswith("generation:warmup_")
    # the torch.profiler session of the host saw the same spans
    import json
    with open(tprof.last_device_trace()) as f:
        kineto = [e["name"] for e in json.load(f)["traceEvents"]
                  if e.get("name", "").startswith("generation:")]
    assert sorted(kineto) == sorted(name for name, _ in spans)


@pytest.mark.parametrize("mode", list(MODES))
def test_flight_recorder_notes_every_finished_sequence(mode):
    notes = {}
    jeng, eng = _engines(mode, f"f-{mode}")
    sp = [dict(max_new_tokens=n) for n in MAX_NEW[:len(LENGTHS[mode])]]
    for key, flight, engine, make in (
            ("jax", jflight, jeng, JSamplingParams),
            ("torch", tflight, eng, SamplingParams)):
        flight.arm()
        engine.generate(_prompts(mode), [make(**k) for k in sp])
        dump = flight.get_recorder().dump()
        flight.disarm(clear=True)
        notes[key] = (
            [(e["note"], e.get("fields")) for e in dump["events"]
             if e["kind"] == "note"],
            [e["name"] for e in dump["events"] if e["kind"] == "span"])
    assert notes["torch"] == notes["jax"]
    finished = [f for n, f in notes["torch"][0] if n == "seq_finish"]
    assert len(finished) == len(LENGTHS[mode])
    assert all(f["engine"] == f"f-{mode}" for f in finished)


def _serve(mode, server_cls, backend_cls, stats_cls, cfg_cls, tracing,
           prof, engine, n_requests=4):
    """One client thread, one request at a time, each inside its own
    client span; returns (answers, stats, host events)."""
    backend = backend_cls(engine, max_new_tokens=6)
    server = server_cls(backend, cfg_cls(
        batch_buckets=(1, 2), seq_buckets=(16, 32),
        pad_values={"prompt_lens": 1}, max_batch_wait_ms=1))
    server._stats = stats_cls(server=f"s-{mode}")
    server._queue._stats = server._stats
    server.start()
    prompts = _prompts(mode)[:n_requests]
    answers, clients = [], []
    prof.start_profiler("CPU")
    try:
        server.warmup()

        def client():
            for p in prompts:
                p = np.asarray(p, np.int32)
                with tracing.span("client_request") as ctx:
                    out, n = server.infer(
                        {"token_ids": p[None],
                         "prompt_lens": np.asarray([p.size], np.int32)})
                clients.append(ctx.trace_id)
                answers.append(out[0, :int(n[0])].tolist())

        t = threading.Thread(target=client)
        t.start()
        t.join(timeout=120)
        assert not t.is_alive()
        stats = server.stats()
    finally:
        prof.stop_profiler(quiet=True)
        server.close()
    return answers, clients, stats, list(prof._events)


@pytest.mark.parametrize("mode", list(MODES))
def test_serving_stats_and_spans_join_the_client_trace(mode):
    jeng, eng = _engines(mode, f"g-{mode}")
    got = {}
    for key, args in (
            ("jax", (JInferenceServer, JGenerationBackend, JServingStats,
                     JServingConfig, jtracing, jprof, jeng)),
            ("torch", (InferenceServer, GenerationBackend, ServingStats,
                       ServingConfig, ttracing, tprof, eng))):
        args[4].reseed_ids(1)
        got[key] = _serve(mode, *args)
    (janswers, _, jstats, _), (answers, clients, stats, events) = \
        got["jax"], got["torch"]
    assert answers == janswers
    assert stats["server"] == jstats["server"] == f"s-{mode}"
    assert set(jstats) - set(stats) == set(JAX_ONLY)
    assert _comparable(stats, ()) == _comparable(jstats, JAX_ONLY)
    assert stats["requests_ok"] == len(answers) == 4
    series = _series(tobs, "serving_", ("server", f"s-{mode}"))
    assert series == _series(jobs, "serving_", ("server", f"s-{mode}"))
    assert series["serving_requests_total"]

    # every serving span joins the trace of the client that submitted
    spans = [(n, a) for n, _, _, _, a in events if a]
    by_name = {}
    for name, a in spans:
        by_name.setdefault(name.split("_b")[0] if name.startswith(
            "serving:batch") else name, []).append(a)
    assert [a["trace_id"] for a in by_name["serving:queue_wait"]] == clients
    assert [a["trace_id"] for a in by_name["serving:batch"]] == clients
    client_spans = {a["span_id"]: a for a in by_name["client_request"]}
    for a in by_name["serving:batch"]:
        assert a["parent_span_id"] in client_spans
    # every engine step outside the server's warmup runs under a batch
    step = "generation:chunk_step" if mode == "chunked" else \
        "generation:decode_step"
    batch_ids = {a["span_id"] for a in by_name["serving:batch"]}
    warm = [(t0, t1) for n, t0, t1, _, _ in events
            if n.startswith("serving:warmup_b")]
    served = [a for n, t0, t1, _, a in events if n == step
              and not any(w0 <= t0 and t1 <= w1 for w0, w1 in warm)]
    assert served and all(a["parent_span_id"] in batch_ids
                          for a in served)
    # the JAX server's spans have the same names in the same order
    jnames = [n for n, _, _, _, a in got["jax"][3] if a]
    assert [n for n, _ in spans] == jnames


# -- the Executor and the fusion pass ----------------------------------------

SEQ, BATCH, LR = 32, 8, 1e-3
TRAIN_SERIES = ("fused_epilogue_hits_total", "fused_block_hits_total",
                "executor_compiles_total", "optimizer_state_bytes",
                "data_parallel_degree")


def _train_feed(vocab):
    rng = np.random.RandomState(3)
    src = rng.randint(0, vocab, (BATCH, SEQ)).astype(np.int64)
    mask = np.ones((BATCH, SEQ), np.float32)
    mask[:3, SEQ - 6:] = 0.0
    labels = np.full((BATCH, SEQ, 1), -1, np.int64)
    pick = rng.rand(BATCH, SEQ) < 0.15
    labels[pick] = src[pick][:, None]
    return {"src_ids": src, "input_mask": mask, "masked_labels": labels}


class _NoMesh:
    """What the JAX helper reads of a CompiledProgram: its data-axis
    size (1 without a mesh)."""

    data_parallel_degree = 1


def _train_series(obs):
    snap = obs.get_registry().snapshot()["metrics"]
    return {n: sorted((sorted(r["labels"].items()), r["value"])
                      for r in snap[n]["series"])
            for n in TRAIN_SERIES if n in snap}


@pytest.mark.parametrize("fuse", [True, False])
def test_executor_and_fusion_series_equal(fuse, monkeypatch):
    jcfg = dataclasses.replace(JBertConfig.tiny(), hidden_dropout=0.0,
                               attn_dropout=0.0, hidden_size=128,
                               num_heads=4, ffn_size=256)
    cfg = BertConfig(**dataclasses.asdict(jcfg))
    feed = _train_feed(cfg.vocab_size)
    monkeypatch.setenv("PADDLE_TPU_FUSED_MATMUL_INTERPRET", "1")
    with jpt.new_program_scope():
        main, startup = jpt.Program(), jpt.Program()
        startup.random_seed = 7
        with jpt.program_guard(main, startup), jpt.unique_name.guard():
            loss, _ = jax_bert(jcfg, seq_len=SEQ)
            jpt.optimizer.Adam(LR).minimize(loss)
        scope = jpt.Scope()
        exe = jpt.Executor()
        bs = JBuildStrategy()
        bs.fuse_epilogues = fuse
        with jpt.scope_guard(scope):
            exe.run(startup)
            weights = {v.name: np.asarray(scope.find_var(v.name))
                       for v in main.list_vars() if v.persistable}
            jloss = exe.run(JCompiledProgram(main, build_strategy=bs),
                            feed=feed, fetch_list=[loss])[0]
            # the JAX executor gauges the optimizer state only for a
            # CompiledProgram with a mesh (its ``compiled`` is None
            # otherwise); the port, which has no mesh yet, gauges every
            # CompiledProgram.  Its helper, called on the JAX program's
            # own state, gives the value the port must match
            jexecutor._record_optimizer_state_bytes(
                main.global_block(), _NoMesh(),
                {n: scope.find_var(n) for n in weights})
    monkeypatch.delenv("PADDLE_TPU_FUSED_MATMUL_INTERPRET")

    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        loss, _ = build_bert_pretrain(cfg, seq_len=SEQ)
        pt.optimizer.Adam(LR).minimize(loss)
    scope = pt.Scope()
    exe = pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    pt.io.load_params(scope, weights, "cpu", program=main)
    bs = pt.BuildStrategy()
    bs.fuse_epilogues = fuse
    got = exe.run(pt.CompiledProgram(main, build_strategy=bs), feed=feed,
                  fetch_list=[loss], scope=scope)[0]
    np.testing.assert_allclose(got, jloss, rtol=0, atol=2e-3)

    series = _train_series(tobs)
    assert series == _train_series(jobs)
    # the startup program and the training program: one lowering each
    assert series["executor_compiles_total"] == [([], 2.0)]
    n_params = sum(int(np.prod(w.shape)) for n, w in weights.items()
                   if "moment" not in n and "pow" not in n
                   and "learning_rate" not in n)
    state = dict((tuple(lb), v) for lb, v in series["optimizer_state_bytes"])
    assert state[(("placement", "global"),)] == \
        state[(("placement", "per_device"),)] >= 2 * 4 * n_params
    if fuse:
        blk = dict((tuple(lb), v) for lb, v in series[
            "fused_block_hits_total"])
        assert blk[(("pattern", "attention_epilogue"),)] == cfg.num_layers
        assert blk[(("pattern", "ffn_chain"),)] == cfg.num_layers
    else:
        assert "fused_epilogue_hits_total" not in series


def test_lowering_scopes_ops_only_while_a_device_trace_runs(tmp_path):
    """Each program op is a ``type:first_output`` record_function range in
    the Kineto trace of a traced run; an untraced run opens none, and
    ``run:<id>`` is a range too."""
    from paddle_tpu_torch.core import lowering

    opened = []
    real = torch.profiler.record_function

    class Spy(real):
        def __init__(self, name, *a, **kw):
            opened.append(name)
            super().__init__(name, *a, **kw)

    with pt.new_program_scope():
        x = pt.data("x", [None, 3])
        y = pt.layers.fc(x, 2)
        exe = pt.Executor(pt.CPUPlace())
        exe.run(pt.default_startup_program())
        feed = {"x": np.ones((4, 3), np.float32)}
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(torch.profiler, "record_function", Spy)
            exe.run(feed=feed, fetch_list=[y])
            assert opened == []
            tprof.start_profiler("CPU", tracer_path=str(tmp_path))
            exe.run(feed=feed, fetch_list=[y])
            tprof.stop_profiler(quiet=True)
        main = pt.default_main_program()
    # a fused group runs (and is scoped) at its last member only
    (lowered,) = main._exec_cache.values()
    skip = lowered.fusion_plan.skip_uids if lowered.fusion_plan else ()
    want = [lowering._op_scope_name(op) for op in main.global_block().ops
            if op.uid not in skip]
    assert want and all(":" in n for n in want)
    assert [n for n in opened if not n.startswith("run:")] == want
    assert sum(n.startswith("run:") for n in opened) == 1
    import json
    with open(tprof.last_device_trace()) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert set(want) <= names
    host = [e[0] for e in tprof._events]
    assert any(n.startswith("run:") for n in host)
    assert os.path.exists(tprof.last_device_trace())
