"""The port's cluster tier (paddle_tpu_torch.cluster) against the JAX
package's.

Router logic runs the full Router against in-process loopback workers
(`cluster.testing.StaticPool`), with worker loss injected through the
``cluster_rpc`` fault site — the scenarios of tests/test_cluster.py's
tier-1 half, against the port's classes; the stats snapshot's keys must
be the JAX router's for the same traffic.  Disaggregated generation
runs `GenerationRouter` over loopback prefill and decode pools of port
engines on the CPU (``device="cpu"``): tokens must EQUAL a single port
engine's (the handoff moves K/V bit for bit, and greedy decode is
schedule-invariant).  The transport runs over a real socket, and one
test spawns a real prefill and a real decode worker process on the CPU.

Tolerances: none — outputs of the timed backend within rtol 1e-5 of
numpy's product (as in tests/test_cluster.py), everything else equal.
"""
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from paddle_tpu.cluster import ClusterConfig as JClusterConfig
from paddle_tpu.cluster import Router as JRouter
from paddle_tpu.cluster.testing import StaticPool as JStaticPool
from paddle_tpu.cluster.testing import timed_backend as j_timed_backend
from paddle_tpu.cluster.testing import tiny_lm_engine as j_tiny_lm_engine
from paddle_tpu.generation import SamplingParams as JSamplingParams
from paddle_tpu.resilience.retry import backoff_delays as j_backoff_delays
from paddle_tpu_torch.cluster import (ClusterConfig, ClusterOverloadError,
                                      GenerationRouter, QuotaExceededError,
                                      Router, RpcClient, RpcServer,
                                      WorkerPool, WorkerServicer, WorkerSpec,
                                      WorkerUnavailable)
from paddle_tpu_torch.cluster.testing import (StaticPool, timed_backend,
                                              tiny_lm_engine)
from paddle_tpu_torch.distributed import reserve_ports, terminate_procs
from paddle_tpu_torch.generation import SamplingParams
from paddle_tpu_torch.observability import get_registry
from paddle_tpu_torch.resilience import (FaultPlan, RetryError,
                                         TransientError, backoff_delays,
                                         retry_call)
from paddle_tpu_torch.serving import (RequestTimeoutError, ServerClosedError,
                                      ServingError)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTH = 8
BLOCK = 7.0   # marker value: the event backend blocks on this input


def _x(v=1.0, width=WIDTH):
    # leading batch dim: the worker's InferenceServer feeds are batched
    return {"x": np.full((1, width), float(v), np.float32)}


def _expected(v):
    w = (np.arange(WIDTH * WIDTH, dtype=np.float32)
         .reshape(WIDTH, WIDTH) / WIDTH)
    return np.full((WIDTH,), float(v), np.float32) @ w


def _out(out):
    return np.asarray(out[0], np.float32).reshape(-1)


def _fast_pool(n=2, service_ms=1.0):
    return StaticPool(
        "infer",
        [lambda: timed_backend(service_ms=service_ms) for _ in range(n)])


def _event_backend(order, started, release):
    """A 1-at-a-time backend that records arrival order and parks on
    ``release`` when fed the BLOCK marker (warmup feeds are zeros)."""
    from paddle_tpu_torch.serving import CallableBackend, ServingConfig

    def fn(feeds):
        x = np.asarray(feeds["x"], np.float32)
        v = float(x.reshape(-1)[0])
        order.append(v)
        if v == BLOCK:
            started.set()
            release.wait(30.0)
        return [x]

    backend = CallableBackend(
        fn, input_names=["x"],
        input_spec={"x": ((WIDTH,), np.dtype(np.float32))})
    return backend, ServingConfig(batch_buckets=(1,),
                                  max_batch_wait_ms=0.0)


def _event_pool():
    order, started, release = [], threading.Event(), threading.Event()
    pool = StaticPool(
        "infer", [lambda: _event_backend(order, started, release)])
    return pool, order, started, release


def _settled_stats(router, ok, failed=0, timeout_s=10.0):
    """The router's snapshot once ``ok`` + ``failed`` requests are
    counted: a future wakes its waiter before the router's completion
    callback counts it, so a snapshot read right after ``result()`` may
    be one request short."""
    deadline = time.monotonic() + timeout_s
    while True:
        snap = router.stats()
        if (snap["requests_ok"], snap["requests_failed"]) == (ok, failed) \
                or time.monotonic() > deadline:
            return snap
        time.sleep(0.01)


# ---------------------------------------------------------------------------
# routing + stats schema


def test_router_routes_and_stats_schema():
    pool = _fast_pool(2)
    r = Router(pool, ClusterConfig())
    try:
        outs = [r.infer(_x(i)) for i in range(4)]
        for i, out in enumerate(outs):
            np.testing.assert_allclose(_out(out), _expected(i), rtol=1e-5)
        snap = _settled_stats(r, ok=4)
        assert snap["schema_version"] == 2
        assert snap["workers_alive"] == 2
        assert snap["queue_depth"] == 0
        assert snap["requests_ok"] == snap["requests_ok_total"] == 4
        assert snap["requests_failed"] == 0
        assert snap["kernel_degradations"] == []
        reg = get_registry()
        rid = r.stats_.router_id
        assert reg.gauge("cluster_workers_alive").labels(
            router=rid).value() == 2
        assert reg.gauge("cluster_queue_depth").labels(
            router=rid).value() == 0
    finally:
        r.close()
        pool.close()


def test_stats_snapshot_keys_are_the_reference_routers():
    """The same traffic through the JAX router and the port's: the same
    snapshot keys (and latency summary keys), the same counts."""
    snaps = []
    for router_cls, cfg_cls, pool_cls, backend in (
            (JRouter, JClusterConfig, JStaticPool, j_timed_backend),
            (Router, ClusterConfig, StaticPool, timed_backend)):
        pool = pool_cls("infer", [lambda b=backend: b(service_ms=1.0)
                                  for _ in range(2)])
        r = router_cls(pool, cfg_cls(tenant_quota={"t": 5}))
        try:
            for i in range(3):
                r.infer(_x(i), tenant="t")
            with pytest.raises(Exception) as err:
                r.infer({"y": np.zeros((1, WIDTH), np.float32)})
            assert type(err.value).__name__ == "ServingError"
            snaps.append(_settled_stats(r, ok=3, failed=1))
        finally:
            r.close()
            pool.close()
    want, got = snaps
    assert sorted(got) == sorted(want)
    assert sorted(got["latency"]) == sorted(want["latency"])
    for k in ("schema_version", "requests_ok", "requests_failed",
              "requests_shed", "shed_by_tenant", "reroutes",
              "stream_chunks", "stream_fallbacks", "queue_depth",
              "workers_alive", "hedges", "respawns_total",
              "deadline_expired", "kernel_degradations"):
        assert got[k] == want[k], k


def test_worker_error_is_request_error_not_worker_death():
    """A bad request fails THAT request (the error travels as data over
    the RPC envelope); the worker stays routable."""
    pool = _fast_pool(2)
    r = Router(pool, ClusterConfig())
    try:
        with pytest.raises(ServingError):
            r.infer({"y": np.zeros((1, WIDTH), np.float32)})
        assert pool.alive_count() == 2
        np.testing.assert_allclose(_out(r.infer(_x(3.0))), _expected(3.0),
                                   rtol=1e-5)
        snap = _settled_stats(r, ok=1, failed=1)
        assert snap["requests_failed"] == 1 and snap["requests_ok"] == 1
        assert snap["reroutes"] == 0
    finally:
        r.close()
        pool.close()


# ---------------------------------------------------------------------------
# admission: quota / overload / SLO / priority / deadline


def test_quota_shed_is_distinct_error_and_counted_per_tenant():
    pool, _, started, release = _event_pool()
    r = Router(pool, ClusterConfig(tenant_quota={"t0": 1}))
    try:
        blocker = r.submit(_x(BLOCK), tenant="t0")
        assert started.wait(10.0)
        with pytest.raises(QuotaExceededError):
            r.submit(_x(1.0), tenant="t0")
        other = r.submit(_x(2.0), tenant="t1")   # unlisted: unlimited
        release.set()
        blocker.result(timeout=10.0)
        other.result(timeout=10.0)
        snap = r.stats()
        assert snap["shed_by_tenant"] == {"t0": 1}
        assert snap["requests_shed"] == 1
        assert get_registry().counter("cluster_shed_total").labels(
            tenant="t0", reason="quota", model="default",
            router=r.stats_.router_id).value() == 1
    finally:
        release.set()
        r.close()
        pool.close()


def test_overload_shed_off_queue_depth():
    pool, _, started, release = _event_pool()
    r = Router(pool, ClusterConfig(max_queue_depth=2))
    try:
        blocker = r.submit(_x(BLOCK))
        assert started.wait(10.0)
        queued = [r.submit(_x(v)) for v in (1.0, 2.0)]
        with pytest.raises(ClusterOverloadError):
            r.submit(_x(3.0))
        release.set()
        for f in [blocker] + queued:
            f.result(timeout=10.0)
        assert r.stats()["requests_shed"] == 1
    finally:
        release.set()
        r.close()
        pool.close()


def test_slo_shed_off_p99_with_depth_floor():
    pool, _, started, release = _event_pool()
    r = Router(pool, ClusterConfig(shed_p99_ms=0.001, shed_min_depth=1))
    try:
        r.infer(_x(0.5))   # seeds the latency histogram
        blocker = r.submit(_x(BLOCK))
        assert started.wait(10.0)
        queued = r.submit(_x(1.0))
        with pytest.raises(ClusterOverloadError):
            r.submit(_x(2.0))
        release.set()
        blocker.result(timeout=10.0)
        queued.result(timeout=10.0)
        assert get_registry().counter("cluster_shed_total").labels(
            tenant="default", reason="slo", model="default",
            router=r.stats_.router_id).value() == 1
    finally:
        release.set()
        r.close()
        pool.close()


def test_priority_beats_fifo_within_queue():
    pool, order, started, release = _event_pool()
    r = Router(pool, ClusterConfig())
    try:
        blocker = r.submit(_x(BLOCK))
        assert started.wait(10.0)
        lows = [r.submit(_x(v), priority=0) for v in (1.0, 2.0)]
        high = r.submit(_x(3.0), priority=5)
        release.set()
        for f in [blocker, high] + lows:
            f.result(timeout=10.0)
        assert order[order.index(BLOCK):] == [BLOCK, 3.0, 1.0, 2.0]
    finally:
        release.set()
        r.close()
        pool.close()


def test_deadline_expires_while_queued():
    pool, _, started, release = _event_pool()
    r = Router(pool, ClusterConfig())
    try:
        blocker = r.submit(_x(BLOCK))
        assert started.wait(10.0)
        doomed = r.submit(_x(1.0), timeout_ms=30.0)
        time.sleep(0.1)
        release.set()
        blocker.result(timeout=10.0)
        with pytest.raises(RequestTimeoutError):
            doomed.result(timeout=10.0)
        assert r.stats()["deadline_expired"] == {"router": 1}
    finally:
        release.set()
        r.close()
        pool.close()


# ---------------------------------------------------------------------------
# worker loss -> re-route (fault-injected)


def test_worker_loss_midrequest_reroutes_and_succeeds():
    pool = _fast_pool(2)
    r = Router(pool, ClusterConfig())
    try:
        with FaultPlan(rpc_failures=[0]).armed() as plan:
            out = r.infer(_x(4.0), timeout_ms=10_000)
            assert plan.fired("cluster_rpc") == 1
        np.testing.assert_allclose(_out(out), _expected(4.0), rtol=1e-5)
        snap = r.stats()
        assert snap["reroutes"] == 1
        assert snap["workers_alive"] == 1 == pool.alive_count()
        assert get_registry().gauge("cluster_workers_alive").labels(
            router=r.stats_.router_id).value() == 1
        r.infer(_x(5.0), timeout_ms=10_000)    # the survivor serves on
        assert _settled_stats(r, ok=2)["requests_ok"] == 2
    finally:
        r.close()
        pool.close()


def test_all_workers_lost_fails_request_not_hangs():
    pool = _fast_pool(1)
    r = Router(pool, ClusterConfig())
    try:
        with FaultPlan(rpc_failures=[0]).armed():
            fut = r.submit(_x(1.0))
            with pytest.raises(WorkerUnavailable) as ei:
                fut.result(timeout=10.0)
        assert "no workers left" in str(ei.value)
        assert pool.alive_count() == 0
    finally:
        r.close()
        pool.close()


def test_parked_request_ends_on_the_respawn_wait_timeout():
    """With ``reroute_wait_for_respawn`` a request whose pool emptied is
    parked; with no supervisor to respawn a worker (the port has no
    fleet tier) it fails once ``respawn_wait_timeout_s`` passes."""
    pool = _fast_pool(1)
    r = Router(pool, ClusterConfig(reroute_wait_for_respawn=True,
                                   respawn_wait_timeout_s=0.2))
    try:
        with FaultPlan(rpc_failures=[0]).armed():
            fut = r.submit(_x(1.0))
            with pytest.raises(WorkerUnavailable, match="respawned"):
                fut.result(timeout=10.0)
        assert r.stats()["reroutes"] == 1
    finally:
        r.close(drain=False, timeout=1.0)
        pool.close()


# ---------------------------------------------------------------------------
# drain / close


def test_close_drains_inflight_then_rejects_new_work():
    pool = _fast_pool(1, service_ms=40.0)
    r = Router(pool, ClusterConfig())
    futs = [r.submit(_x(v)) for v in range(3)]
    r.close(drain=True)
    for v, f in enumerate(futs):
        np.testing.assert_allclose(_out(f.result(timeout=1.0)),
                                   _expected(v), rtol=1e-5)
    with pytest.raises(ServerClosedError):
        r.submit(_x(9.0))
    assert r.stats()["requests_ok"] == 3
    pool.close()


def test_close_without_drain_fails_queued_work():
    pool, _, started, release = _event_pool()
    r = Router(pool, ClusterConfig())
    blocker = r.submit(_x(BLOCK))
    assert started.wait(10.0)
    queued = r.submit(_x(1.0))
    r.close(drain=False, timeout=1.0)
    with pytest.raises(ServerClosedError):
        queued.result(timeout=10.0)
    release.set()
    blocker.result(timeout=10.0)   # the in-flight one still lands
    pool.close()


# ---------------------------------------------------------------------------
# prefill/decode disaggregation (loopback)

SP = SamplingParams(max_new_tokens=8)
PROMPTS = [[3, 5, 7, 9, 11], [2, 4, 6, 8, 10, 12, 14, 16, 18], [1] * 17,
           [4] * 12]


def _engine(**kw):
    return tiny_lm_engine(seed=0, max_seq_len=32, device="cpu", **kw)


@pytest.fixture(scope="module")
def single_engine_tokens():
    eng = _engine()
    eng.warmup()
    return [r.tokens for r in eng.generate(PROMPTS, sampling=SP)]


def test_tiny_lm_engine_is_the_reference_factorys(single_engine_tokens):
    """The worker factory holds the JAX factory's weights: the same seed
    gives the same greedy tokens in both packages."""
    ref = j_tiny_lm_engine(seed=0, max_seq_len=32)
    want = [r.tokens for r in ref.generate(
        PROMPTS, sampling=JSamplingParams(max_new_tokens=8))]
    assert single_engine_tokens == want


@pytest.mark.parametrize("decode", ["chunked", "legacy"])
@pytest.mark.parametrize("stream_pages", [True, False],
                         ids=["streamed", "monolithic"])
def test_generation_router_token_parity_loopback(single_engine_tokens,
                                                 stream_pages, decode):
    """Prefill pool -> (K/V through the router) -> decode pool emits the
    single engine's tokens.  Streaming forwards every prefill chunk
    (none falls back); a legacy decode engine cannot take a stream
    (``stream_open`` refuses), so its K/V travels inline, which is not
    a fallback either; the monolithic path streams nothing."""
    pp = StaticPool("prefill", [_engine])
    dp = StaticPool("decode", [lambda: _engine(scheduling=decode)])
    gr = GenerationRouter(pp, dp, ClusterConfig(stream_pages=stream_pages))
    try:
        got = [r.tokens for r in gr.generate(PROMPTS, sampling=SP)]
        assert got == single_engine_tokens
        snap = _settled_stats(gr, ok=len(PROMPTS))
        assert snap["requests_ok"] == len(PROMPTS)
        assert snap["workers_alive"] == 2
        # the prefill side chunks every prompt (16-token chunks)
        chunks = sum(-(-len(p) // 16) for p in PROMPTS)
        assert snap["stream_chunks"] == (chunks if stream_pages else 0)
        assert snap["stream_fallbacks"] == 0
        # the decode worker holds nothing once every request finished
        eng = dp.workers[0]._servicer._engine
        assert eng.cache.free_slots() == list(range(4))
        assert not eng._streams
    finally:
        gr.close()
        pp.close()
        dp.close()


def test_generation_router_single_pool_and_decode_loss_reroute(
        single_engine_tokens):
    """Single-pool chunked mode (``decode_pool=None``) gives the same
    tokens; and a decode worker lost mid-request re-routes its handoffs
    to the survivor without re-running their prefill."""
    gp = StaticPool("generate", [_engine])
    gr = GenerationRouter(gp, None, ClusterConfig())
    try:
        got = [r.tokens for r in gr.generate(PROMPTS, sampling=SP)]
        assert got == single_engine_tokens
    finally:
        gr.close()
        gp.close()
    pp = StaticPool("prefill", [_engine])
    dp = StaticPool("decode", [_engine, _engine])
    gr = GenerationRouter(pp, dp, ClusterConfig(stream_pages=False,
                                                decode_batch=1))
    try:
        # cluster_rpc occurrences: prefill of request 0, then its decode
        with FaultPlan(rpc_failures=[1]).armed():
            got = [r.tokens for r in gr.generate(PROMPTS[:1], sampling=SP)]
        assert got == single_engine_tokens[:1]
        snap = gr.stats()
        assert snap["reroutes"] == 1 and snap["workers_alive"] == 2
        # one prefill: the re-routed decode replayed the router's copy
        assert pp.workers[0]._servicer._engine._uid == 1
    finally:
        gr.close()
        pp.close()
        dp.close()


def test_prefill_that_finishes_returns_without_decode():
    """max_new_tokens 1: the prefill worker's first token is the whole
    result, streamed or not, and the decode pool is never asked."""
    for stream_pages in (True, False):
        pp = StaticPool("prefill", [_engine])
        dp = StaticPool("decode", [_engine])
        gr = GenerationRouter(pp, dp,
                              ClusterConfig(stream_pages=stream_pages))
        try:
            res = gr.generate(PROMPTS[:2],
                              sampling=SamplingParams(max_new_tokens=1))
            assert [len(r.tokens) for r in res] == [1, 1]
            assert [r.finish_reason for r in res] == ["length", "length"]
            eng = dp.workers[0]._servicer._engine
            assert eng.stats.snapshot()["decode_steps"] == 0
            assert eng.cache.free_slots() == list(range(4))
        finally:
            gr.close()
            pp.close()
            dp.close()


def test_worker_servicer_verbs(tmp_path):
    """The servicer's envelope: health, a tuning verb (an empty push
    answers ``ok``), an unknown op and an engine error answer as data;
    a cancelled or expired request is bounced at admission."""
    s = WorkerServicer("decode", lambda: _engine(), rank=3)
    assert s.handle({"op": "health"})["rank"] == 3
    resp = s.handle({"op": "tuning_push", "entries": {},
                     "path": str(tmp_path / "tune.json")})
    assert resp["ok"] is True and resp["applied"] == [] \
        and resp["rejected"] == {} and resp["rank"] == 3
    resp = s.handle({"op": "no_such_op"})
    assert resp == {"ok": False, "error": "unknown op 'no_such_op'",
                    "error_type": "ValueError"}
    resp = s.handle({"op": "stream_commit", "stream_id": "x",
                     "last_token": 1})
    assert resp["ok"] is False and resp["error_type"] == "ValueError"
    s.handle({"op": "cancel", "uid": "u1"})
    resp = s.handle({"op": "generate", "prompts": [[1, 2]],
                     "uids": ["u1"], "deadline_ms": [None]})
    assert resp == {"ok": True, "results": [{"cancelled": True}]}
    resp = s.handle({"op": "generate", "prompts": [[1, 2]],
                     "deadline_ms": [0.0]})
    assert resp == {"ok": True, "results": [{"expired": True}]}
    assert s.handle({"op": "stats"})["stats"]["schema_version"] == 2
    with pytest.raises(TypeError, match="GenerationEngine"):
        WorkerServicer("prefill", lambda: timed_backend())


# ---------------------------------------------------------------------------
# transport, retries and process plumbing


def test_rpc_round_trip_and_error_envelope():
    """A real socket: payloads (numpy arrays included) round-trip, a
    handler exception answers as data without severing the connection,
    and a closed server reads as WorkerUnavailable."""
    def handler(msg):
        if msg["op"] == "boom":
            raise KeyError("nope")
        return {"ok": True, "echo": msg["a"] * 2}

    srv = RpcServer("127.0.0.1", 0, handler).start()
    cli = RpcClient("127.0.0.1", srv.port, connect_timeout_s=5.0)
    try:
        a = np.arange(12, dtype=np.float32).reshape(3, 4)
        np.testing.assert_array_equal(cli.call("echo", a=a)["echo"], a * 2)
        resp = cli.call("boom")
        assert resp == {"ok": False, "error": "'nope'",
                        "error_type": "KeyError"}
        assert cli.call("echo", a=1)["echo"] == 2   # connection survived
        with FaultPlan(rpc_failures=[0]).armed():
            with pytest.raises(WorkerUnavailable, match="lost during"):
                cli.call("echo", a=1)
        assert cli.call("echo", a=3)["echo"] == 6   # redialed
    finally:
        cli.close()
        srv.close()
    with pytest.raises(WorkerUnavailable, match="closed"):
        cli.call("echo", a=1)
    assert issubclass(WorkerUnavailable, TransientError)


def test_backoff_and_retry_match_the_reference():
    kw = dict(max_attempts=6, base_delay=0.1, max_delay=1.0,
              multiplier=1.4, jitter=0.2, seed=3)
    assert backoff_delays(**kw) == j_backoff_delays(**kw)
    calls, sleeps = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise TransientError("try again")
        return "ok"

    assert retry_call(flaky, max_attempts=4, seed=1,
                      sleep=sleeps.append) == "ok"
    assert sleeps == backoff_delays(4, 0.05, 2.0, 2.0, 0.5, 1)[:2]
    with pytest.raises(RetryError):
        retry_call(lambda: (_ for _ in ()).throw(TransientError("x")),
                   max_attempts=2, sleep=lambda s: None)


def test_reserve_ports_are_distinct_and_held_until_release():
    with reserve_ports(4) as res:
        ports = list(res.ports)
        assert len(set(ports)) == 4
        s = socket.socket()
        with pytest.raises(OSError):
            s.bind(("", ports[0]))
        s.close()
    s = socket.socket()
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.bind(("", ports[0]))
    s.close()


def test_terminate_procs_escalates_sigterm_to_sigkill():
    polite = subprocess.Popen(
        [sys.executable, "-c", "import time; time.sleep(60)"])
    stubborn = subprocess.Popen(
        [sys.executable, "-c",
         "import signal, time\n"
         "signal.signal(signal.SIGTERM, signal.SIG_IGN)\n"
         "print('armed', flush=True)\n"
         "time.sleep(60)"],
        stdout=subprocess.PIPE)
    assert stubborn.stdout.readline().strip() == b"armed"
    t0 = time.monotonic()
    terminate_procs([polite, stubborn], timeout=1.0)
    assert polite.poll() is not None
    assert stubborn.poll() is not None
    assert time.monotonic() - t0 < 10.0   # one shared deadline, not N
    stubborn.stdout.close()


# ---------------------------------------------------------------------------
# real worker processes


@pytest.mark.multiproc
def test_real_disaggregated_generation_parity(tmp_path, single_engine_tokens):
    """One prefill and one decode worker process (``python -m
    paddle_tpu_torch.cluster.worker`` on the CPU) behind a streaming
    GenerationRouter give the single engine's tokens; closing the pools
    leaves no process behind."""
    spec = dict(seed=0, max_seq_len=32, device="cpu")
    pools = []
    try:
        for role in ("prefill", "decode"):
            pools.append(WorkerPool(
                WorkerSpec("paddle_tpu_torch.cluster.testing:"
                           "tiny_lm_engine", spec, role=role), 1,
                log_dir=str(tmp_path / role), ready_timeout_s=60.0))
        for pool in pools:
            pool.wait_ready()
        gr = GenerationRouter(*pools, ClusterConfig(
            stream_pages=True, default_timeout_ms=60_000))
        try:
            got = [r.tokens for r in gr.generate(PROMPTS, sampling=SP)]
            snap = _settled_stats(gr, ok=len(PROMPTS))
        finally:
            gr.close()
        assert got == single_engine_tokens
        assert snap["stream_chunks"] > 0 and snap["stream_fallbacks"] == 0
        assert snap["workers_alive"] == 2
    finally:
        for pool in pools:
            pool.close()
    procs = [h.proc for pool in pools for h in pool.handles()]
    assert procs and all(p.poll() is not None for p in procs)
    log = (tmp_path / "decode" / "workerlog.0").read_text()
    assert "PADDLE_TPU_WORKER_READY rank=0 role=decode" in log


@pytest.mark.multiproc
def test_chip_smoke_cluster_phase_rehearses_on_the_cpu(tmp_path,
                                                       monkeypatch):
    """chip_smoke.py's phase 9 at BertConfig.tiny() width on the CPU: the
    in-process handoff gates (bit-exact detached vs streamed prefill and
    cache round trips, depth-2 tokens) and the worker-process run with
    its own worker factory all hold; the launch gates only bind on the
    card."""
    import dataclasses

    sys.path.insert(0, ROOT)
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(ROOT)
    from paddle_tpu_torch.generation import GenerationConfig
    from paddle_tpu_torch.models import BertConfig, lm_random_params

    monkeypatch.setattr(cs, "CLUSTER_LOG_DIR", tmp_path)
    cfg = dataclasses.replace(BertConfig.tiny(), initializer_range=0.6)
    params = lm_random_params(cfg, np.random.RandomState(cs.SEED))
    gen = GenerationConfig(page_size=cs.PAGE_SIZE, max_seqs=cs.MAX_SEQS,
                           max_seq_len=cs.MAX_SEQ_LEN, seed=cs.SEED)
    report = cs.cluster_phase(torch.device("cpu"), cfg, gen, params,
                              model="tiny")
    line = report["line"]
    assert line["handoff_bytes_per_request"] == \
        2 * cfg.num_layers * cs.PROMPT_LEN * cfg.hidden_size * 4
    assert line["stream_chunks"] == 2 * cs.N_PROMPTS
    assert line["stream_fallbacks"] == 0
    assert report["reference"]["chunked"]["equal_to_single"]
    assert report["processes"]["depth2"]["worst_gap"] <= cs.GREEDY_LOGIT_TOL
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "depth2_decode", "depth2_prefill", "full_decode", "full_prefill"]
