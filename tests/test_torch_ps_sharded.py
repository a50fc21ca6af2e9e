"""The port's sharded parameter-server client (ps_sharded: id routing,
``DenseTable``, ``AsyncCommunicator``) and GEO-SGD (geo) against the
JAX package's, on the CPU: two servers of each package from one seed,
the same calls on both, the rows held bit for bit; GEO-SGD's two workers
(threads here, each with its own client) held within 1e-5 of the JAX
package's run on the same data."""
import threading
import time

import numpy as np
import pytest

from paddle_tpu.distributed import geo as jgeo
from paddle_tpu.distributed import ps as jps
from paddle_tpu.distributed import ps_sharded as jsh
from paddle_tpu_torch.distributed import geo as tgeo
from paddle_tpu_torch.distributed import ps as tps
from paddle_tpu_torch.distributed import ps_sharded as tsh
from paddle_tpu_torch.distributed.launch import reserve_ports

pytestmark = pytest.mark.multiproc


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


def _servers(ps_mod, n=2, **kw):
    res = reserve_ports(n)
    ports = res.ports
    res.release()
    return ports, [ps_mod.PSServerProcess(p, **kw) for p in ports]


def _shutdown(sh_mod, ports, procs):
    try:
        c = sh_mod.ShardedPSClient([("127.0.0.1", p) for p in ports])
        c.stop_servers()
        c.close()
    except Exception:
        pass
    for p in procs:
        try:
            p.wait(timeout=10)
        except Exception:
            p.kill()


@pytest.fixture(scope="module")
def clients():
    """Two JAX and two port servers (sgd, zero init), a sharded client
    over each pair."""
    kw = dict(num_tables=2, dim=4, optimizer="sgd", init_range=0.0,
              num_workers=1)
    jports, jprocs = _servers(jps, **kw)
    tports, tprocs = _servers(tps, **kw)
    jc = jsh.ShardedPSClient([("127.0.0.1", p) for p in jports])
    tc = tsh.ShardedPSClient([f"127.0.0.1:{p}" for p in tports])
    yield jc, tc
    jc.close()
    tc.close()
    _shutdown(jsh, jports, jprocs)
    _shutdown(tsh, tports, tprocs)


def test_routing_round_trip(clients):
    jc, tc = clients
    ids = np.array([0, 1, 2, 3, 10, 11], np.int64)
    g = np.arange(24, dtype=np.float32).reshape(6, 4)
    for c in (jc, tc):
        assert np.allclose(c.pull(0, ids, 4), 0.0)
        c.push(0, ids, g, lr=1.0)
    got = tc.pull(0, ids, 4)
    np.testing.assert_allclose(got, -g, rtol=1e-6)
    assert np.array_equal(_bits(got), _bits(jc.pull(0, ids, 4)))
    st = tc.stats()
    assert all(s["rows"] >= 3 for s in st["per_server"])
    assert [s["rows"] for s in st["per_server"]] == \
        [s["rows"] for s in jc.stats()["per_server"]]


def test_dense_table_spans_shards(clients):
    jc, tc = clients
    tabs = [sh.DenseTable(c, 1, "w", (3, 4), dim=4)
            for sh, c in ((jsh, jc), (tsh, tc))]
    assert np.array_equal(tabs[0].ids, tabs[1].ids)
    val = np.arange(12, dtype=np.float32).reshape(3, 4)
    for t in tabs:
        assert np.allclose(t.pull(), 0.0)
        t.init(val)
        t.push(np.ones((3, 4), np.float32), lr=0.5)
    np.testing.assert_allclose(tabs[1].pull(), val - 0.5, rtol=1e-6)
    assert np.array_equal(_bits(tabs[1].pull()), _bits(tabs[0].pull()))
    with pytest.raises(RuntimeError, match="sgd"):
        tsh.DenseTable(tc, 1, "w", (3, 4), 4,
                       server_optimizer="adagrad").init(val)


def test_dense_tables_are_namespaced_as_in_jax(clients):
    jc, tc = clients
    for name in ("alpha", "beta", "encoder.layer0.attn.qkv.w"):
        assert tsh._name_base(name) == jsh._name_base(name)
    a = tsh.DenseTable(tc, 1, "alpha", (2, 4), dim=4)
    b = tsh.DenseTable(tc, 1, "beta", (2, 4), dim=4)
    a.init(np.ones((2, 4), np.float32))
    np.testing.assert_allclose(b.pull(), 0.0)
    # a parameter whose size is not a multiple of the block: padded
    c = tsh.DenseTable(tc, 1, "gamma", (5,), dim=4)
    assert c.n_blocks == 2
    c.init(np.arange(5, dtype=np.float32))
    np.testing.assert_allclose(c.pull(), np.arange(5), rtol=1e-6)


def test_async_communicator_merges(clients):
    jc, tc = clients
    ids = np.array([20, 22, 22], np.int64)        # a duplicate in a batch
    for sh, c in ((jsh, jc), (tsh, tc)):
        comm = sh.AsyncCommunicator(c, 0, lr=1.0, merge_every=3)
        for k in range(4):
            comm.push(ids, np.full((3, 4), k + 1.0, np.float32))
        comm.flush()
        comm.stop()
        with pytest.raises(RuntimeError, match="stop"):
            comm.flush()
    got = tc.pull(0, np.array([20, 22], np.int64), 4)
    np.testing.assert_allclose(got[0], -10.0)
    np.testing.assert_allclose(got[1], -20.0)
    assert np.array_equal(_bits(got),
                          _bits(jc.pull(0, np.array([20, 22], np.int64), 4)))


class _LatePull:
    """A sharded client whose first pull (a GEO worker's bootstrap
    snapshot) comes late."""

    def __init__(self, client, delay):
        self._client, self._delay = client, delay

    def __getattr__(self, name):
        return getattr(self._client, name)

    def pull(self, *a):
        if self._delay:
            time.sleep(self._delay)
            self._delay = 0
        return self._client.pull(*a)


def _geo_worker(geo_mod, sh_mod, ports, worker_id, out, late=0.0,
                fence=True):
    """tests/dist_geo_sgd.py's worker on a client of its own.  ``fence``:
    a barrier after the bootstrap (the JAX package's GeoSGDWorker has
    none, so under load a worker can push its first delta before the
    other pulled its snapshot); ``late``: seconds worker 1's bootstrap
    pull waits."""
    client = sh_mod.ShardedPSClient([("127.0.0.1", p) for p in ports],
                                    worker_id=worker_id)
    if late and worker_id == 1:
        client = _LatePull(client, late)
    rng = np.random.RandomState(3)
    w0 = rng.randn(4, 1).astype(np.float32) * 0.1
    geo = geo_mod.GeoSGDWorker(client, 1, {"w": w0}, dim=4, sync_every=4,
                               trainers=2)
    if fence:
        client.barrier()
    data_rng = np.random.RandomState(100 + worker_id)
    X = data_rng.randn(16, 4).astype(np.float32)
    y = X @ (np.arange(1, 5, dtype=np.float32).reshape(4, 1) / 4)
    params = geo.initial_params()
    losses = []
    for step in range(40):
        pred = X @ params["w"]
        losses.append(0.5 * float(((pred - y) ** 2).sum()))
        params["w"] = params["w"] - 0.01 * (X.T @ (pred - y))
        params = geo.maybe_sync(params, step)
    out[worker_id] = (losses, params["w"].copy())
    client.close()


def _geo_run(geo_mod, ps_mod, sh_mod, **kw):
    ports, procs = _servers(ps_mod, num_tables=2, dim=4, optimizer="sgd",
                            init_range=0.0, num_workers=2)
    out = {}
    try:
        threads = [threading.Thread(target=_geo_worker, args=(
            geo_mod, sh_mod, ports, i, out), kwargs=kw) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert len(out) == 2, "a GEO worker failed"
    finally:
        _shutdown(sh_mod, ports, procs)
    return out


def test_geo_sgd_matches_the_jax_package():
    jout = _geo_run(jgeo, jps, jsh)
    tout = _geo_run(tgeo, tps, tsh)
    for wk in range(2):
        np.testing.assert_allclose(tout[wk][0], jout[wk][0], rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(tout[wk][1], jout[wk][1], rtol=1e-5,
                                   atol=1e-7)
        assert tout[wk][0][-1] < 0.05 * tout[wk][0][0]
    # both workers end on the same global parameter
    np.testing.assert_allclose(tout[0][1], tout[1][1], rtol=1e-5, atol=1e-6)
    with pytest.raises(RuntimeError, match="sgd"):
        tgeo.GeoSGDWorker(None, 1, {}, 4, server_optimizer="adagrad")


def _geo_reference(steps=8):
    """The GEO protocol in numpy: both workers' losses."""
    w0 = np.random.RandomState(3).randn(4, 1).astype(np.float32) * 0.1
    data = []
    for wk in range(2):
        X = np.random.RandomState(100 + wk).randn(16, 4).astype(np.float32)
        data.append((X, X @ (np.arange(1, 5, dtype=np.float32)
                             .reshape(4, 1) / 4)))
    glob, params, snap = w0, [w0, w0], [w0, w0]
    losses = [[], []]
    for step in range(steps):
        for wk, (X, y) in enumerate(data):
            pred = X @ params[wk]
            losses[wk].append(0.5 * float(((pred - y) ** 2).sum()))
            params[wk] = params[wk] - 0.01 * (X.T @ (pred - y))
        if (step + 1) % 4 == 0:
            for wk in range(2):
                glob = glob + (params[wk] - snap[wk]) / 2
            params, snap = [glob, glob], [glob, glob]
    return losses


def test_geo_bootstrap_waits_for_every_snapshot():
    """The port's repair: worker 1's bootstrap pull comes 0.5 s late, and
    worker 0 still pushes its first delta only after it; the losses are
    the protocol's (numpy) within 1e-5."""
    out = _geo_run(tgeo, tps, tsh, late=0.5, fence=False)
    want = _geo_reference()
    for wk in range(2):
        np.testing.assert_allclose(out[wk][0][:8], want[wk], rtol=1e-5)
