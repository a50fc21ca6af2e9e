"""The port's parameter server (paddle_tpu_torch.distributed.ps over its
copy of native/ps_server.cpp) against the JAX package's, on the CPU.

The two servers run side by side from one seed: their rows, their sgd
and adagrad updates, their stats and their snapshots are held equal bit
for bit, and a snapshot either one saves loads in the other.  The port's
server acknowledges a save only once the file is closed (50 saves read
back at once); ``DistributedEmbedding`` trains the JAX test's loop
within 1e-5 of the JAX package's run from the same weights;
``DeviceCachedEmbedding(device="cpu")`` holds the JAX cache's contents
over the JAX test's sequence."""
import os
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as pt
from paddle_tpu.distributed import ps as jps
from paddle_tpu_torch.distributed import ps as tps
from paddle_tpu_torch.distributed.launch import reserve_ports

pytestmark = pytest.mark.multiproc

DIM = 4


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


def _start(mod, n=1, **kw):
    """``n`` servers of package ``mod`` on reserved ports; returns
    (processes, clients)."""
    res = reserve_ports(n)
    ports = res.ports
    res.release()
    procs = [mod.PSServerProcess(p, **kw) for p in ports]
    clients = [mod.PSClient("127.0.0.1", p, worker_id=0) for p in ports]
    return procs, clients


def _stop(procs, clients):
    for p, c in zip(procs, clients):
        try:
            c.stop_server()
            p.wait(timeout=10)
        except Exception:
            p.kill()
        finally:
            c.close()


@pytest.fixture(scope="module")
def pair():
    """A JAX and a port server from one seed: sgd, two tables."""
    kw = dict(num_tables=2, dim=DIM, optimizer="sgd", init_range=0.5,
              seed=7, num_workers=1)
    (jp,), (jc,) = _start(jps, **kw)
    (tp,), (tc,) = _start(tps, **kw)
    yield jc, tc
    _stop([jp, tp], [jc, tc])


@pytest.fixture(scope="module")
def adagrad_pair():
    kw = dict(num_tables=1, dim=2, optimizer="adagrad", init_range=0.0)
    (jp,), (jc,) = _start(jps, **kw)
    (tp,), (tc,) = _start(tps, **kw)
    yield jc, tc
    _stop([jp, tp], [jc, tc])


def test_rows_are_bit_equal_for_one_seed(pair):
    jc, tc = pair
    ids = np.array([0, 5, 42, 1000000007, -3, 2 ** 40], np.int64)
    for table in (0, 1):
        j, t = jc.pull(table, ids, DIM), tc.pull(table, ids, DIM)
        assert np.array_equal(_bits(j), _bits(t))
        assert (np.abs(t) <= 0.5).all() and not np.allclose(t[0], t[1])
    # a second pull gives the same rows
    assert np.array_equal(_bits(tc.pull(1, ids, DIM)), _bits(t))


def test_sgd_pushes_match_the_jax_server(pair):
    jc, tc = pair
    rng = np.random.RandomState(0)
    ids = np.array([100, 101, 102, 101, 107], np.int64)   # a duplicate
    for step in range(3):
        g = rng.randn(len(ids), DIM).astype(np.float32)
        for c in (jc, tc):
            c.push(0, ids, g, lr=0.3)
    j, t = jc.pull(0, ids, DIM), tc.pull(0, ids, DIM)
    assert np.array_equal(_bits(j), _bits(t))
    # table isolation: table 1 still at its init
    assert np.array_equal(_bits(tc.pull(1, ids, DIM)),
                          _bits(jc.pull(1, ids, DIM)))


def test_adagrad_pushes_match_the_jax_server(adagrad_pair):
    jc, tc = adagrad_pair
    ids = np.array([3, 4], np.int64)
    g = np.array([[2.0, 4.0], [-1.0, 0.5]], np.float32)
    for c in (jc, tc):
        c.push(0, ids, g, lr=0.1)
        c.push(0, ids, 0.5 * g, lr=0.1)
    j, t = jc.pull(0, ids, 2), tc.pull(0, ids, 2)
    assert np.array_equal(_bits(j), _bits(t))
    # the JAX test's closed form after one push: -lr * sign(g)
    tc.push(0, np.array([9], np.int64), g[:1], lr=0.1)
    np.testing.assert_allclose(tc.pull(0, np.array([9], np.int64), 2),
                               [[-0.1, -0.1]], atol=1e-4)


def test_stats_and_heartbeat_match(pair):
    jc, tc = pair
    for c in (jc, tc):
        c.heartbeat()
        c.push(1, np.arange(500, 510, dtype=np.int64),
               np.full((10, DIM), 2.0, np.float32), lr=0.1)
    js, ts = jc.stats(), tc.stats()
    assert ts == js
    assert ts["rows"] >= 10 and ts["alive_workers"] == 1 \
        and ts["lost_workers"] == 0


def test_barrier_holds_until_every_worker_arrives():
    (p,), (c0,) = _start(tps, num_tables=1, dim=DIM, num_workers=2)
    c1 = tps.PSClient("127.0.0.1", p.port, worker_id=1)
    try:
        order = []

        def late():
            time.sleep(0.3)
            order.append("w1-enter")
            c1.barrier()

        t = threading.Thread(target=late)
        t.start()
        t0 = time.time()
        c0.barrier()
        waited = time.time() - t0
        t.join()
        assert waited > 0.2 and order == ["w1-enter"]
    finally:
        c1.close()
        _stop([p], [c0])


def test_a_save_by_either_package_loads_in_the_other(pair, tmp_path):
    jc, tc = pair
    ids_j = np.arange(300, 306, dtype=np.int64)
    ids_t = np.arange(400, 406, dtype=np.int64)
    g = np.arange(6 * DIM, dtype=np.float32).reshape(6, DIM)
    jc.push(0, ids_j, g, lr=1.0)                 # only the JAX server
    tc.push(1, ids_t, -g, lr=0.5)                # only the port's
    j_rows, t_rows = jc.pull(0, ids_j, DIM), tc.pull(1, ids_t, DIM)
    assert not np.array_equal(_bits(tc.pull(0, ids_j, DIM)), _bits(j_rows))
    jc.save(str(tmp_path / "jax.bin"))
    tc.save(str(tmp_path / "port.bin"))
    assert (tmp_path / "jax.bin").read_bytes()[:8] == \
        (tmp_path / "port.bin").read_bytes()[:8]       # one header
    tc.load(str(tmp_path / "jax.bin"))
    jc.load(str(tmp_path / "port.bin"))
    assert np.array_equal(_bits(tc.pull(0, ids_j, DIM)), _bits(j_rows))
    assert np.array_equal(_bits(jc.pull(1, ids_t, DIM)), _bits(t_rows))


def test_save_acknowledges_a_closed_file(pair, tmp_path):
    """The repair: ``save`` returns once the snapshot is on disk whole,
    50 times back to back; a path the server cannot write answers an
    error."""
    jc, tc = pair
    ids = np.arange(10, dtype=np.int64)
    for c in (jc, tc):
        c.push(0, ids, np.full((10, DIM), 2.0, np.float32), lr=0.1)
    sizes = set()
    for i in range(50):
        path = str(tmp_path / f"tables{i}.bin")
        tc.save(path)
        sizes.add(os.path.getsize(path))
        assert sizes == {os.path.getsize(str(tmp_path / "tables0.bin"))}
    assert sizes.pop() > 0
    with pytest.raises(RuntimeError, match="save"):
        tc.save(str(tmp_path / "missing" / "dir" / "x.bin"))
    # the saved state restores over a clobber
    before = tc.pull(0, ids, DIM)
    tc.push(0, ids, np.full((10, DIM), 100.0, np.float32), lr=1.0)
    tc.load(str(tmp_path / "tables49.bin"))
    assert np.array_equal(_bits(tc.pull(0, ids, DIM)), _bits(before))


def _embedding_loop(pkg, exe, client, w0=None, steps=6, B=8):
    """The JAX test's DownpourWorker loop: pull rows, the step's row
    gradients, push; SGD(0.2) on the local fc weight."""
    emb = pkg.distributed.ps.DistributedEmbedding(client, table=0, dim=DIM)
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = 21
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        rows = pkg.data("rows", [None, DIM])
        rows.stop_gradient = False
        inverse = pkg.data("inverse", [B], "int32")
        label = pkg.data("label", [B, 1])
        batch_emb = pkg.layers.gather(rows, inverse)
        pred = pkg.layers.fc(batch_emb, 1, param_attr=pkg.ParamAttr(
            name="w"), bias_attr=False)
        loss = pkg.layers.mean(pkg.layers.square_error_cost(pred, label))
        (row_grad,) = pkg.gradients([loss], [rows])
        pkg.optimizer.SGD(0.2).minimize(loss, parameter_list=["w"])
    rng = np.random.RandomState(0)
    fixed_ids = rng.randint(0, 20, (B,)).astype(np.int64)
    labels = rng.rand(B, 1).astype(np.float32)
    scope = pkg.Scope()
    with pkg.scope_guard(scope):
        exe.run(startup)
        if w0 is not None:
            pkg.io.load_params(scope, {"w": w0}, "cpu")
        w_start = np.array(scope.find_var("w")).copy()
        losses = []
        for _ in range(steps):
            rows_np, uniq, inv = emb.pull(fixed_ids)
            lv, gv = exe.run(main, feed={"rows": rows_np, "inverse": inv,
                                         "label": labels},
                             fetch_list=[loss, row_grad])
            emb.push(uniq, np.asarray(gv), lr=0.2)
            losses.append(float(np.asarray(lv)))
    return losses, w_start


def test_distributed_embedding_matches_the_jax_run(pair):
    import paddle_tpu.distributed.ps  # noqa: F401 — pkg.distributed.ps
    import paddle_tpu_torch.distributed.ps  # noqa: F401

    jc, tc = pair
    j_losses, w0 = _embedding_loop(jpt, jpt.Executor(), jc)
    t_losses, _ = _embedding_loop(pt, pt.Executor(pt.CPUPlace()), tc,
                                  w0=w0)
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-5, atol=1e-7)
    assert t_losses[-1] < t_losses[0]
    ids = np.arange(20, dtype=np.int64)
    np.testing.assert_allclose(tc.pull(0, ids, DIM), jc.pull(0, ids, DIM),
                               rtol=1e-5, atol=1e-7)


def _cache_sequence(dce, client):
    """The JAX test's DeviceCachedEmbedding sequence (on the cache's
    table); returns the cache (host numpy) after each stage and the
    stats."""
    out = []
    ids = np.array([[3, 5], [3, 9]], np.int64)
    slots = dce.lookup_slots(ids)
    assert slots[0, 0] == slots[1, 0] and dce.stats()["pulls"] == 1
    out.append(slots)
    dce.lookup_slots(np.array([3, 5, 9], np.int64))
    assert dce.stats()["pulls"] == 1
    dce.push(np.array([3, 5], np.int64), np.ones((2, 4), np.float32),
             lr=0.5)
    out.append(np.array(dce.cache).copy())
    for i in range(20, 27):
        dce.lookup_slots(np.array([i], np.int64))
    assert dce.stats()["cached"] <= 8
    dup = np.array([30, 30], np.int64)
    dce.lookup_slots(dup)
    dce.push(dup, np.ones((2, 4), np.float32), lr=1.0)
    out.append(np.array(dce.cache).copy())
    client.push(dce.table, np.array([3], np.int64),
                np.full((1, 4), 2.0, np.float32), lr=1.0)
    dce.refresh()
    out.append(np.array(dce.cache).copy())
    out.append(dce.lookup_slots(np.array([3, 5, 30], np.int64)))
    return out, dce.stats()


def test_device_cached_embedding_holds_the_jax_cache(pair):
    jc, tc = pair
    jd = jps.DeviceCachedEmbedding(jc, table=1, dim=DIM, capacity=8)
    td = tps.DeviceCachedEmbedding(tc, table=1, dim=DIM, capacity=8,
                                   device="cpu")
    assert isinstance(td.cache, torch.Tensor) \
        and td.cache.device.type == "cpu"
    j_out, j_stats = _cache_sequence(jd, jc)
    t_out, t_stats = _cache_sequence(td, tc)
    assert t_stats == j_stats
    for a, b in zip(t_out, j_out):
        assert np.array_equal(a, b)
    # the cache against the PS truth after the refresh
    ids = np.array(sorted(td._slot_of), np.int64)
    cached = td.cache[torch.as_tensor(
        [td._slot_of[int(i)] for i in ids])].numpy()
    np.testing.assert_allclose(cached, tc.pull(1, ids, DIM), rtol=1e-6)


def test_device_cached_embedding_refuses_over_capacity(pair):
    _, tc = pair
    dce = tps.DeviceCachedEmbedding(tc, table=0, dim=DIM, capacity=4,
                                    device="cpu")
    with pytest.raises(RuntimeError, match="capacity"):
        dce.lookup_slots(np.arange(5, dtype=np.int64))
    assert dce.stats()["cached"] == 0
    s = dce.lookup_slots(np.array([1, 2], np.int64))
    np.testing.assert_allclose(dce.cache[torch.as_tensor(s)].numpy(),
                               tc.pull(0, np.array([1, 2], np.int64), DIM),
                               rtol=1e-6)
    with pytest.raises(ValueError, match="sgd"):
        tps.DeviceCachedEmbedding(tc, server_optimizer="adagrad",
                                  device="cpu")


def test_device_cached_embedding_defaults_to_the_card(pair):
    _, tc = pair
    if torch.cuda.is_available():
        assert tps.DeviceCachedEmbedding(tc, dim=DIM, capacity=2) \
            .cache.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        tps.DeviceCachedEmbedding(tc, dim=DIM, capacity=2)


def test_two_backward_passes_over_one_forward_op():
    """``gradients([loss], [rows])`` and then ``minimize(loss)``
    differentiate the same forward ops twice (the DownpourWorker loop's
    program); the port's lowering keeps each forward graph for the later
    pass, as the JAX lowering does: the row gradient and the updated
    weight equal the JAX package's."""
    def build(pkg):
        main, startup = pkg.Program(), pkg.Program()
        startup.random_seed = 3
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            rows = pkg.data("rows", [6, DIM])
            rows.stop_gradient = False
            label = pkg.data("label", [6, 1])
            pred = pkg.layers.fc(rows, 1, param_attr=pkg.ParamAttr(
                name="w"), bias_attr=False)
            loss = pkg.layers.mean(pkg.layers.square_error_cost(pred,
                                                                label))
            (g,) = pkg.gradients([loss], [rows])
            pkg.optimizer.SGD(0.5).minimize(loss, parameter_list=["w"])
        return main, startup, loss, g

    rng = np.random.RandomState(1)
    feed = {"rows": rng.randn(6, DIM).astype(np.float32),
            "label": rng.randn(6, 1).astype(np.float32)}
    jmain, jstart, jloss, jg = build(jpt)
    jscope = jpt.Scope()
    with jpt.scope_guard(jscope):
        exe = jpt.Executor()
        exe.run(jstart)
        w0 = np.array(jscope.find_var("w")).copy()
        jl, jgv = exe.run(jmain, feed=feed, fetch_list=[jloss, jg])
        jw = np.array(jscope.find_var("w"))
    main, startup, loss, g = build(pt)
    scope = pt.Scope()
    exe = pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    pt.io.load_params(scope, {"w": w0}, "cpu")
    tl, tgv = exe.run(main, feed=feed, fetch_list=[loss, g], scope=scope)
    np.testing.assert_allclose(tl, jl, rtol=1e-6)
    np.testing.assert_allclose(tgv, jgv, rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(scope.find_var("w").numpy(), jw, rtol=1e-6)
    assert not np.allclose(jw, w0)
