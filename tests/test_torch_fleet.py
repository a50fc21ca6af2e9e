"""The port's fleet tier (``paddle_tpu_torch.fleet``: the autoscaler and its
policy, the supervisor, the rolling swap; the router's park-monitor
branch) against the JAX package's, on the CPU.

* For the same fake clock and the same signal sequence, the port's
  ``HysteresisPolicy`` and ``Autoscaler`` decide as the JAX package's,
  step for step.
* The scenarios of ``tests/test_fleet_autoscale.py`` and
  ``tests/test_self_healing.py`` over ``cluster.testing``'s fakes
  (loopback ``StaticPool`` workers, tiny engines from a seed): scale up
  under a spike and drain down when idle with zero drops, never drain
  the last worker, a fault-injected drain under load, a drain timeout
  that parks its victim, cold models and quotas, two models with token
  parity, the rolling swap (same weights; a canary mismatch that aborts
  and degrades ``fleet.rollout``), supervised respawn with parity, the
  crash-loop budget (degrade once, one incident bundle, refuse), the
  stability window, a request parked for respawn, and the parked
  request failed with the model named once the supervisor gives up.
"""
import threading
import time

import numpy as np
import pytest

import paddle_tpu.fleet as jfleet
from paddle_tpu.cluster import ClusterConfig as JClusterConfig
from paddle_tpu.cluster import Router as JRouter
from paddle_tpu.cluster.testing import StaticPool as JStaticPool
from paddle_tpu.cluster.testing import timed_backend as j_timed_backend
from paddle_tpu.resilience.retry import degradations as j_degradations
from paddle_tpu_torch.cluster import (ClusterConfig, GenerationRouter,
                                      ModelUnavailableError,
                                      QuotaExceededError, Router)
from paddle_tpu_torch.cluster.rpc import WorkerUnavailable
from paddle_tpu_torch.cluster.testing import (StaticPool, timed_backend,
                                              tiny_lm_engine)
from paddle_tpu_torch.fleet import (ROLLOUT_DEGRADE_KEY,
                                    SUPERVISOR_DEGRADE_KEY, Autoscaler,
                                    HysteresisPolicy, RollingSwap,
                                    ScaleDecision, ScalePolicy, ScaleSignals,
                                    Supervisor)
from paddle_tpu_torch.fleet.supervisor import degrade_key
from paddle_tpu_torch.observability import IncidentManager, flightrec
from paddle_tpu_torch.observability import get_registry
from paddle_tpu_torch.resilience.faults import FaultPlan
from paddle_tpu_torch.resilience.retry import degradations
from paddle_tpu_torch.serving.batcher import RequestTimeoutError

WIDTH = 8


def _x(v=1.0):
    return {"x": np.full((1, WIDTH), float(v), np.float32)}


def _expected(v):
    w = (np.arange(WIDTH * WIDTH, dtype=np.float32)
         .reshape(WIDTH, WIDTH) / WIDTH)
    return np.full((WIDTH,), float(v), np.float32) @ w


def _pool(n=1, service_ms=5.0):
    return StaticPool(
        "infer",
        [lambda: timed_backend(service_ms=service_ms) for _ in range(n)])


def _engine(seed=0, **kw):
    return tiny_lm_engine(seed=seed, device="cpu", **kw)


def _lm_pool(n=1, seed=0):
    return StaticPool("generate",
                      [lambda: _engine(seed=seed) for _ in range(n)])


def _prompts(n=4, length=8, vocab=64):
    rng = np.random.RandomState(3)
    return [[int(t) for t in rng.randint(1, vocab, size=length)]
            for _ in range(n)]


def _reference(prompts, seed=0):
    eng = _engine(seed=seed)
    return {tuple(p): list(r.tokens)
            for p, r in zip(prompts, eng.generate(prompts))}


class _FakeClock:
    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


@pytest.fixture(autouse=True)
def _clean_state():
    yield
    degradations.reset()
    j_degradations.reset()
    flightrec.disarm(clear=True)
    with flightrec._listener_lock:
        flightrec._listeners.clear()


# -- the policy and the autoscaler against the JAX package's ------------------

#: (clock advance, signals) — a spike, a plateau, the cooldown, an idle
#: tail, an SLO burn, a shed wave, a full fleet with an empty queue
SIGNALS = [(0.0, dict(queue_depth=9, workers=1)),
           (1.0, dict(queue_depth=9, workers=1)),
           (1.0, dict(queue_depth=12, workers=2)),
           (20.0, dict(queue_depth=12, workers=2)),
           (1.0, dict(queue_depth=5, workers=3, p99_ms=90.0)),
           (1.0, dict(queue_depth=0, workers=3, inflight=3)),
           (20.0, dict(queue_depth=0, workers=3, inflight=0)),
           (1.0, dict(queue_depth=0, workers=3, inflight=0)),
           (1.0, dict(queue_depth=0, workers=3, inflight=0)),
           (1.0, dict(queue_depth=0, workers=3, inflight=0)),
           (20.0, dict(queue_depth=0, workers=2, shed_rate=2.0)),
           (1.0, dict(queue_depth=0, workers=2, slo_page=True)),
           (1.0, dict(queue_depth=0, workers=4)),
           (1.0, dict(queue_depth=3, workers=1, draining=3))]


@pytest.mark.parametrize("knobs", [
    dict(min_workers=1, max_workers=3, high_queue_depth=8, up_ticks=2,
         down_ticks=3, cooldown_s=10.0, slo_p99_ms=50.0),
    dict(min_workers=2, max_workers=4, high_queue_depth=4, up_ticks=1,
         down_ticks=1, cooldown_s=0.0, shed_is_overload=False)])
def test_policy_decides_as_the_jax_policy_step_for_step(knobs):
    clocks = _FakeClock(), _FakeClock()
    port = HysteresisPolicy(clock=clocks[0], **knobs)
    jax = jfleet.HysteresisPolicy(clock=clocks[1], **knobs)
    for dt, sig in SIGNALS:
        for c in clocks:
            c.advance(dt)
        a = port.decide(ScaleSignals(**sig))
        b = jax.decide(jfleet.ScaleSignals(**sig))
        assert (a.delta, a.reason) == (b.delta, b.reason), sig
    # the clones start fresh in both
    assert (port.clone().decide(ScaleSignals(**SIGNALS[0][1])).reason
            == jax.clone().decide(jfleet.ScaleSignals(
                **SIGNALS[0][1])).reason)


def _events(events):
    return [{k: e.get(k) for k in ("model", "action", "reason", "ok",
                                   "worker")} for e in events]


def test_autoscaler_decides_as_the_jax_autoscaler_step_for_step():
    """The same burst, the same fake clock, the same policy knobs over
    the two packages' loopback pools: every tick takes the same actions
    on the same workers."""
    runs = {}
    for name, (router_cls, cfg_cls, pool_cls, backend, scaler_cls,
               policy_cls) in {
            "torch": (Router, ClusterConfig, StaticPool, timed_backend,
                      Autoscaler, HysteresisPolicy),
            "jax": (JRouter, JClusterConfig, JStaticPool, j_timed_backend,
                    jfleet.Autoscaler, jfleet.HysteresisPolicy)}.items():
        clk = _FakeClock()
        pool = pool_cls("infer", [lambda backend=backend: backend(
            service_ms=50.0)])
        r = router_cls(pool, cfg_cls())
        scaler = scaler_cls(r, pool, policy=policy_cls(
            min_workers=1, max_workers=2, high_queue_depth=4, up_ticks=2,
            down_ticks=2, cooldown_s=5.0, clock=clk), clock=clk)
        ticks = []
        try:
            # ten requests of 50 ms on one worker: the queue stays deep
            # through the ticks below (each takes microseconds)
            futs = [r.submit(_x(v), timeout_ms=30_000) for v in range(10)]
            time.sleep(0.02)                 # one request in hand
            for _ in range(3):               # hot: debounce, then up
                ticks.append(_events(scaler.tick()))
                clk.advance(1.0)
            for f in futs:
                f.result(timeout=30.0)
            for dt in (1.0, 10.0, 1.0, 1.0):  # cooldown, then idle
                clk.advance(dt)
                ticks.append(_events(scaler.tick()))
            runs[name] = (ticks, len(r.workers_for()))
        finally:
            scaler.stop()
            r.close()
            pool.close()
    assert runs["torch"] == runs["jax"]
    ticks, workers = runs["torch"]
    assert [e["action"] for t in ticks for e in t] == ["up", "down"]
    assert workers == 1


# -- tests/test_fleet_autoscale.py's scenarios --------------------------------

def test_policy_rejects_degenerate_knobs():
    with pytest.raises(ValueError):
        HysteresisPolicy(min_workers=0)
    with pytest.raises(ValueError):
        HysteresisPolicy(min_workers=3, max_workers=2)
    with pytest.raises(ValueError):
        HysteresisPolicy(low_queue_depth=4, high_queue_depth=4)


def test_autoscaler_scales_up_on_spike_then_drains_down_idle():
    clk = _FakeClock()
    pool = _pool(1, service_ms=10.0)
    r = Router(pool, ClusterConfig())
    scaler = Autoscaler(r, pool, policy=HysteresisPolicy(
        min_workers=1, max_workers=2, high_queue_depth=4, up_ticks=1,
        down_ticks=2, cooldown_s=0.0, clock=clk), clock=clk)
    try:
        futs = [r.submit(_x(v), timeout_ms=30_000) for v in range(12)]
        events = scaler.tick()
        assert events and events[0]["action"] == "up"
        assert events[0]["ok"] and "queue_depth" in events[0]["reason"]
        assert len(r.workers_for()) == 2
        new = pool.workers[1]
        base = new._servicer._server.backend.compile_count()
        for i, f in enumerate(futs):
            np.testing.assert_allclose(
                np.asarray(f.result(timeout=30.0)[0]).reshape(-1),
                _expected(i), rtol=1e-5)
        assert new._servicer._server.backend.compile_count() == base
        clk.advance(1.0)
        scaler.tick()
        clk.advance(1.0)
        events = scaler.tick()
        assert any(e["action"] == "down" and e["ok"] for e in events)
        assert len(r.workers_for()) == 1
        victim = pool.workers[1]
        assert victim.reaped and not victim.alive
        snap = r.stats()
        assert snap["requests_ok"] == 12 and snap["requests_failed"] == 0
        ups = get_registry().counter("fleet_scale_events_total")
        assert ups.labels(router=r.stats_.router_id, model="default",
                          direction="up",
                          reason="queue_depth>=4").value() >= 1
    finally:
        scaler.stop()
        r.close()
        pool.close()


def test_autoscaler_never_drains_the_last_worker():
    clk = _FakeClock()
    pool = _pool(1)
    r = Router(pool, ClusterConfig())
    scaler = Autoscaler(r, pool, policy=HysteresisPolicy(
        min_workers=1, down_ticks=1, cooldown_s=0.0, clock=clk), clock=clk)
    try:
        for _ in range(5):
            clk.advance(1.0)
            for e in scaler.tick():
                assert e["action"] != "down" or not e["ok"]
        assert len(r.workers_for()) == 1
        r.infer(_x(2.0))
    finally:
        scaler.stop()
        r.close()
        pool.close()


class _ForceDown(ScalePolicy):
    def __init__(self):
        self.fired = False

    def decide(self, signals):
        if not self.fired:
            self.fired = True
            return ScaleDecision(-1, "forced")
        return ScaleDecision(0, "steady")

    def clone(self):
        return _ForceDown()


def test_fault_injected_scale_down_under_load_drops_nothing():
    pool = _pool(3, service_ms=10.0)
    r = Router(pool, ClusterConfig(max_reroutes=2))
    scaler = Autoscaler(r, pool, policy=_ForceDown())
    try:
        with FaultPlan(rpc_failures=[0]).armed() as plan:
            futs = [r.submit(_x(v), timeout_ms=30_000) for v in range(16)]
            time.sleep(0.02)
            events = scaler.tick()
            down = [e for e in events if e["action"] == "down"]
            assert down and down[0]["ok"], events
            for i, f in enumerate(futs):
                np.testing.assert_allclose(
                    np.asarray(f.result(timeout=30.0)[0]).reshape(-1),
                    _expected(i), rtol=1e-5)
            assert plan.fired("cluster_rpc") == 1
        snap = r.stats()
        assert snap["requests_ok"] == 16 and snap["requests_failed"] == 0
        assert snap["reroutes"] == 1
        victim = pool.workers[down[0]["worker"]]
        assert victim.reaped
        sig = r.fleet_signals()["default"]
        assert sig["inflight"] == 0 and sig["queue_depth"] == 0
        assert pool.alive_count() == 1
    finally:
        scaler.stop()
        r.close()
        pool.close()


def test_drain_timeout_parks_victim_and_never_reaps_inflight():
    release = threading.Event()

    def slow_factory():
        from paddle_tpu_torch.serving.config import ServingConfig
        from paddle_tpu_torch.serving.server import CallableBackend

        def fn(feeds):
            x = np.asarray(feeds["x"], np.float32)
            if float(x.reshape(-1)[0]) == 7.0:
                release.wait(30.0)
            return [x]

        backend = CallableBackend(
            fn, input_names=["x"],
            input_spec={"x": ((WIDTH,), np.dtype(np.float32))})
        return backend, ServingConfig(batch_buckets=(1,),
                                      max_batch_wait_ms=0.0)

    pool = StaticPool("infer", [slow_factory, slow_factory])
    r = Router(pool, ClusterConfig())
    scaler = Autoscaler(r, pool, policy=_ForceDown(), drain_timeout_s=0.1)
    try:
        futs = [r.submit(_x(7.0), timeout_ms=30_000) for _ in range(2)]
        time.sleep(0.05)
        down = [e for e in scaler.tick() if e["action"] == "down"]
        assert down and not down[0]["ok"]
        assert down[0]["error"] == "drain timeout"
        victim = pool.workers[down[0]["worker"]]
        assert victim.draining and not victim.reaped and victim.alive
        release.set()
        for f in futs:
            f.result(timeout=30.0)
        deadline = time.monotonic() + 10.0
        while not victim.reaped and time.monotonic() < deadline:
            scaler.tick()
            time.sleep(0.02)
        assert victim.reaped
        assert any(e["reason"] == "drain_done" and e["ok"]
                   for e in scaler.events)
    finally:
        release.set()
        scaler.stop()
        r.close()
        pool.close()


def test_cold_model_sheds_then_ensure_model_flips_admission():
    pool = _pool(1)
    r = Router(pool, ClusterConfig())
    scaler = Autoscaler(r, pool, catalog={
        "m1": {"factory": lambda: timed_backend(service_ms=1.0)}})
    try:
        with pytest.raises(ModelUnavailableError) as ei:
            r.infer(_x(1.0), model_id="m1")
        assert ei.value.model_id == "m1"
        shed = get_registry().counter("cluster_shed_total")
        assert shed.labels(router=r.stats_.router_id, tenant="default",
                           reason="model_cold", model="m1").value() == 1
        events = scaler.tick()
        assert any(e["action"] == "warmup" and e["reason"] == "model_cold"
                   for e in events)
        deadline = time.monotonic() + 30.0
        while not r.workers_for("m1") and time.monotonic() < deadline:
            time.sleep(0.01)
        assert r.workers_for("m1")
        out = r.infer(_x(3.0), model_id="m1", timeout_ms=30_000)
        np.testing.assert_allclose(np.asarray(out[0]).reshape(-1),
                                   _expected(3.0), rtol=1e-5)
        r.infer(_x(2.0))                      # the default model serves
    finally:
        scaler.stop()
        r.close()
        pool.close()


def test_model_quota_sheds_with_model_label():
    pool = _pool(1)
    r = Router(pool, ClusterConfig(model_quota={"m0": 0}))
    try:
        r.attach_worker(pool.spawn_worker(model_id="m0"), model="m0")
        with pytest.raises(QuotaExceededError) as ei:
            r.infer(_x(1.0), model_id="m0")
        assert ei.value.model_id == "m0"
        r.infer(_x(2.0))
    finally:
        r.close()
        pool.close()


def test_two_models_route_to_their_own_workers_token_parity():
    pool = _lm_pool(1, seed=0)
    r = GenerationRouter(pool, config=ClusterConfig(default_model="m0"))
    try:
        h1 = pool.spawn_worker(factory=lambda: _engine(seed=1),
                               model_id="m1")
        r.attach_worker(h1, model="m1")
        prompts = [[1, 2, 3], [4, 5, 6, 7], [2, 9]]
        ref = {m: [list(res.tokens)
                   for res in _engine(seed=s).generate(prompts)]
               for m, s in (("m0", 0), ("m1", 1))}
        assert ref["m0"] != ref["m1"]
        for m in ("m0", "m1"):
            got = [list(res.tokens) for res in r.generate(
                prompts, model_id=m, timeout_ms=60_000)]
            assert got == ref[m], m
        sig = r.fleet_signals()
        assert sig["m0"]["workers"] == 1 and sig["m1"]["workers"] == 1
    finally:
        r.close()
        pool.close()


def test_rolling_swap_same_weights_replaces_all_workers():
    pool = _lm_pool(2)
    r = GenerationRouter(pool, config=ClusterConfig())
    try:
        before = [list(res.tokens) for res in r.generate([[1, 2, 3, 4]])]
        res = RollingSwap(r, pool, spawn_kwargs={
            "factory": lambda: _engine(seed=0)}).run()
        assert not res.aborted and res.replaced == 2
        assert pool.workers[0].reaped and pool.workers[1].reaped
        assert not degradations.is_degraded(ROLLOUT_DEGRADE_KEY)
        after = [list(x.tokens) for x in r.generate([[1, 2, 3, 4]])]
        assert after == before
        rolls = get_registry().counter("fleet_rollouts_total")
        assert rolls.labels(router=r.stats_.router_id, model="default",
                            outcome="ok").value() == 1
    finally:
        r.close()
        pool.close()


def test_rolling_swap_canary_mismatch_aborts_and_degrades():
    pool = _lm_pool(1)
    r = GenerationRouter(pool, config=ClusterConfig())
    try:
        before = [list(res.tokens) for res in r.generate([[1, 2, 3, 4]])]
        roll = RollingSwap(r, pool, spawn_kwargs={
            "factory": lambda: _engine(seed=1)})
        res = roll.run()
        assert res.aborted and res.replaced == 0
        assert res.reason == "parity canary mismatch"
        assert res.canary["old"] != res.canary["new"]
        assert pool.workers[1].reaped
        assert not pool.workers[0].reaped and pool.workers[0].alive
        after = [list(x.tokens) for x in r.generate([[1, 2, 3, 4]])]
        assert after == before
        assert degradations.is_degraded(ROLLOUT_DEGRADE_KEY)
        assert [e["key"] for e in r.stats()["kernel_degradations"]] \
            == [ROLLOUT_DEGRADE_KEY]
        res2 = roll.run()
        assert res2.aborted and "degraded" in res2.reason
    finally:
        r.close()
        pool.close()


def test_rolling_swap_infer_canary_compares_within_rtol():
    pool = _pool(1)
    r = Router(pool, ClusterConfig())
    try:
        res = RollingSwap(r, pool, spawn_kwargs={
            "factory": lambda: timed_backend(service_ms=1.0)},
            canary_feeds=_x(2.0)).run()
        assert not res.aborted and res.replaced == 1
    finally:
        r.close()
        pool.close()


def test_static_pool_retire_is_idempotent_and_fires_death_once():
    pool = _pool(2)
    deaths = []
    pool.add_death_callback(lambda h: deaths.append(h.rank))
    try:
        pool.retire(1)
        pool.retire(1)
        assert deaths == [1]
        assert pool.alive_count() == 1
    finally:
        pool.close()


# -- tests/test_self_healing.py's supervisor scenarios ------------------------

def test_supervisor_respawns_crashed_worker_with_parity():
    prompts = _prompts()
    expected = _reference(prompts)
    pool = _lm_pool(2)
    with GenerationRouter(pool) as router:
        sup = Supervisor(router, pool, stability_window_s=60.0)
        for p, f in zip(prompts, [router.submit(p) for p in prompts]):
            assert list(f.result(timeout=60.0).tokens) == expected[tuple(p)]
        pool.kill(0)
        assert [e["action"] for e in sup.run_pending()] == ["ok"]
        assert pool.alive_count() == 2 and len(router.workers_for()) == 2
        snap = router.stats()
        assert snap["respawns_total"] == 1 and snap["workers_alive"] == 2
        for p, f in zip(prompts, [router.submit(p) for p in prompts]):
            assert list(f.result(timeout=60.0).tokens) == expected[tuple(p)]


def test_supervisor_ignores_intentional_removal():
    pool = _lm_pool(2)
    with GenerationRouter(pool) as router:
        sup = Supervisor(router, pool)
        pool.retire(1)
        assert sup.run_pending() == []
        assert pool.alive_count() == 1


def test_supervisor_crash_loop_degrades_once_and_refuses(tmp_path):
    pool = _lm_pool(1)
    clk = _FakeClock()
    sleeps = []
    with GenerationRouter(pool) as router:
        sup = Supervisor(router, pool, max_respawns=2, base_delay=1.0,
                         multiplier=2.0, jitter=0.0,
                         stability_window_s=60.0, clock=clk,
                         sleep=sleeps.append)

        def _boom(**kw):
            raise RuntimeError("engine OOM on warmup")

        pool.spawn_worker = _boom
        flightrec.arm()
        mgr = IncidentManager(str(tmp_path), cooldown_s=300.0).install()
        try:
            pool.kill(0)
            actions = []
            for _ in range(6):
                actions += [e["action"] for e in sup.run_pending()]
                if actions and actions[-1] in ("gave_up", "refused"):
                    break
            assert actions == ["failed", "failed", "gave_up"]
            assert sleeps == [1.0]
            key = degrade_key(router.cfg.default_model)
            assert degradations.is_degraded(key)
            assert key.startswith(SUPERVISOR_DEGRADE_KEY + ":")
            assert len(mgr.bundles) == 1
            sup._on_death(pool.workers[0])
            assert [e["action"] for e in sup.run_pending()] == ["refused"]
            assert len(mgr.bundles) == 1
            assert router.stats_.respawns_by_outcome() == {
                "failed": 2, "gave_up": 1, "refused": 1}
        finally:
            mgr.uninstall()


def test_supervisor_stability_window_resets_strikes():
    pool = _lm_pool(1)
    clk = _FakeClock()
    sleeps = []
    with GenerationRouter(pool) as router:
        sup = Supervisor(router, pool, max_respawns=2, base_delay=1.0,
                         jitter=0.0, stability_window_s=30.0, clock=clk,
                         sleep=sleeps.append)
        pool.kill(0)
        assert [e["action"] for e in sup.run_pending()] == ["ok"]
        clk.advance(31.0)
        pool.kill(1)
        assert [e["action"] for e in sup.run_pending()] == ["ok"]
        assert sleeps == []


def test_reroute_parks_request_for_supervised_respawn():
    prompts = _prompts(1)
    expected = _reference(prompts)
    pool = _lm_pool(1)
    cfg = ClusterConfig(reroute_wait_for_respawn=True)
    with GenerationRouter(pool, config=cfg) as router:
        sup = Supervisor(router, pool)
        plan = FaultPlan(rpc_failures=[0])
        plan.arm()
        try:
            fut = router.submit(prompts[0])
            deadline = time.monotonic() + 10.0
            while (plan.fired("cluster_rpc") < 1
                   and time.monotonic() < deadline):
                time.sleep(0.01)
        finally:
            plan.disarm()
        assert not fut.done() and pool.alive_count() == 0
        assert [e["action"] for e in sup.run_pending()] == ["ok"]
        assert list(fut.result(timeout=60.0).tokens) \
            == expected[tuple(prompts[0])]


def _park_one_request(router, **submit_kwargs):
    plan = FaultPlan(rpc_failures=[0])
    plan.arm()
    try:
        fut = router.submit(_x(1.0), **submit_kwargs)
        deadline = time.monotonic() + 10.0
        while (plan.fired("cluster_rpc") < 1
               and time.monotonic() < deadline):
            time.sleep(0.01)
    finally:
        plan.disarm()
    return fut


def _park_router():
    pool = StaticPool("infer", [lambda: timed_backend(service_ms=1.0)])
    return pool, ClusterConfig(reroute_wait_for_respawn=True)


@pytest.mark.parametrize("package", ["torch", "jax"])
def test_parked_request_fails_when_supervisor_gives_up(package):
    """The park monitor's branch (JAX router.py:1054): a crash-looped
    model's permanent degradation fails the parked request with the
    model named, in both packages alike."""
    if package == "jax":
        pool = JStaticPool("infer",
                           [lambda: j_timed_backend(service_ms=1.0)])
        router_cls, cfg = JRouter, JClusterConfig(
            reroute_wait_for_respawn=True)
        registry = j_degradations
        from paddle_tpu.resilience.faults import FaultPlan as Plan
    else:
        pool, cfg = _park_router()
        router_cls, registry, Plan = Router, degradations, FaultPlan
    with router_cls(pool, cfg) as router:
        plan = Plan(rpc_failures=[0])
        plan.arm()
        try:
            fut = router.submit(_x(1.0))
            deadline = time.monotonic() + 10.0
            while (plan.fired("cluster_rpc") < 1
                   and time.monotonic() < deadline):
                time.sleep(0.01)
        finally:
            plan.disarm()
        assert not fut.done()
        registry.degrade(f"fleet.supervisor:{router.cfg.default_model}")
        with pytest.raises(Exception) as ei:
            fut.result(timeout=10.0)
        assert type(ei.value).__name__ == "WorkerUnavailable"
        assert str(ei.value) == (
            f"model {router.cfg.default_model!r} degraded permanently "
            f"(supervisor crash-loop budget exhausted) while parked for "
            f"respawn")


def test_parked_request_deadline_and_backstop():
    pool, cfg = _park_router()
    with Router(pool, cfg) as router:
        fut = _park_one_request(router, timeout_ms=500)
        with pytest.raises(RequestTimeoutError):
            fut.result(timeout=10.0)
    pool, cfg = _park_router()
    cfg.respawn_wait_timeout_s = 0.3
    with Router(pool, cfg) as router:
        fut = _park_one_request(router)
        with pytest.raises(WorkerUnavailable, match="no worker respawned"):
            fut.result(timeout=10.0)
