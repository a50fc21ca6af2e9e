"""The port's data pipeline pieces on the CPU: ``dataio.prefetch.
background_iter`` (order, bounding, error propagation with the original
traceback, the thread's name, an early exit that does not hang, a
worker fault, the registry's series), ``DataFeeder`` against the JAX
package's, and ``DataLoader`` (its double buffer on the CPU, the sample
list form, no card without one).  Counterparts of
tests/test_data_pipeline.py's loader and prefetch cases and
tests/test_resilience.py's prefetch cases."""
import threading
import time
import traceback

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as pt
from paddle_tpu_torch.dataio.prefetch import background_iter
from paddle_tpu_torch.observability import get_registry
from paddle_tpu_torch.resilience import FaultPlan
from paddle_tpu_torch.resilience.faults import InjectedFault


def test_items_come_in_order_off_the_named_thread():
    seen = []

    def src():
        for i in range(50):
            seen.append(threading.current_thread().name)
            yield i

    assert list(background_iter(src, capacity=3, name="t-order")) == \
        list(range(50))
    assert set(seen) == {"t-order"}


def test_the_queue_bounds_the_producer():
    """The producer runs at most capacity + 1 items ahead (capacity in
    the queue, one waiting to be put)."""
    made = []

    def src():
        for i in range(20):
            made.append(i)
            yield i

    it = background_iter(src, capacity=2, name="t-bound")
    assert next(it) == 0
    time.sleep(0.3)
    assert len(made) <= 1 + 2 + 1
    assert list(it) == list(range(1, 20))


def test_transform_runs_on_the_producer_thread():
    where = []

    def tf(x):
        where.append(threading.current_thread().name)
        return x * 10

    assert list(background_iter(lambda: iter(range(5)), name="t-tf",
                                transform=tf)) == [0, 10, 20, 30, 40]
    assert set(where) == {"t-tf"}


def test_a_source_error_reaches_the_consumer_with_its_traceback():
    def boom_source():
        yield 1
        yield 2
        raise ValueError("bad record")

    got = []
    with pytest.raises(ValueError, match="bad record") as e:
        for item in background_iter(boom_source, capacity=1):
            got.append(item)
    assert got == [1, 2]          # items before the failure are delivered
    frames = [f.name for f in traceback.extract_tb(e.value.__traceback__)]
    assert "boom_source" in frames


def test_an_early_exit_does_not_hang_on_a_blocked_source():
    ev = threading.Event()

    def src():
        yield 1
        ev.wait()                 # never set: blocked I/O
        yield 2

    t0 = time.monotonic()
    for item in background_iter(src, capacity=2):
        assert item == 1
        break
    elapsed = time.monotonic() - t0
    ev.set()
    assert elapsed < 5.0


def test_an_early_exit_stops_the_producer():
    made = []

    def src():
        for i in range(10_000):
            made.append(i)
            yield i

    for item in background_iter(src, capacity=2, name="t-stop"):
        if item == 3:
            break
    time.sleep(0.3)
    n = len(made)
    time.sleep(0.2)
    assert len(made) == n < 100
    assert not any(t.name == "t-stop" and t.is_alive()
                   for t in threading.enumerate())


def test_an_injected_worker_fault_surfaces():
    with FaultPlan(worker_failures=[2]).armed():
        got = []
        with pytest.raises(InjectedFault):
            for item in background_iter(lambda: iter(range(5))):
                got.append(item)
    assert got == [0, 1]


def test_items_and_waits_are_counted_in_the_registry():
    reg = get_registry()
    items = reg.counter("dataio_prefetch_items_total").labels(name="t-reg")
    waits = reg.histogram("dataio_prefetch_wait_ms").labels(name="t-reg")
    n0, w0 = items.value(), waits.count

    def slow():
        for i in range(3):
            time.sleep(0.02)
            yield i

    assert list(background_iter(slow, name="t-reg")) == [0, 1, 2]
    assert items.value() - n0 == 3
    assert waits.count - w0 >= 1


def _feed_vars(P):
    main = P.Program()
    with P.program_guard(main, P.Program()):
        x = P.data("x", [None, 4])
        y = P.data("y", [None, 1], "int64")
        z = P.data("z", [None, 2, 3], "float32")
    return main, x, y, z


def test_data_feeder_matches_the_jax_package():
    rng = np.random.RandomState(0)
    samples = [(rng.rand(4), int(rng.randint(10)), rng.rand(2, 3))
               for _ in range(5)]
    out = {}
    for P in (jpt, pt):
        main, x, y, z = _feed_vars(P)
        out[P] = P.DataFeeder([x, "y", z], program=main).feed(samples)
    want, got = out[jpt], out[pt]
    assert set(got) == set(want) == {"x", "y", "z"}
    assert got["y"].shape == want["y"].shape == (5, 1)
    assert got["y"].dtype == np.int64 and want["y"].dtype == np.int32
    np.testing.assert_array_equal(got["y"], want["y"])
    for n in ("x", "z"):
        assert got[n].dtype == want[n].dtype == np.float32
        np.testing.assert_array_equal(got[n], want[n])


def _gen():
    for i in range(5):
        yield {"x": np.full((2, 4), i, np.float32)}


def test_dataloader_double_buffer_on_the_cpu():
    _, x, _, _ = _feed_vars(pt)
    loader = pt.DataLoader.from_generator(feed_list=[x], capacity=2)
    loader.set_batch_generator(_gen, places=pt.CPUPlace())
    out = list(loader)
    assert len(out) == 5
    assert all(torch.is_tensor(b["x"]) and b["x"].device.type == "cpu"
               for b in out)
    assert [float(b["x"][0, 0]) for b in out] == [0, 1, 2, 3, 4]


def test_dataloader_tuple_batches_and_sample_lists():
    main, x, y, _ = _feed_vars(pt)
    loader = pt.DataLoader.from_generator(feed_list=[x, y])
    loader.set_batch_generator(
        lambda: iter([(np.ones((2, 4), np.float32),
                       np.zeros((2, 1), np.int64))]), places=["cpu"])
    (b,) = list(loader)
    assert set(b) == {"x", "y"} and b["y"].dtype == torch.int64
    with pt.program_guard(main):
        loader = pt.DataLoader.from_generator(feed_list=[x, y],
                                              use_double_buffer=False)
        loader.set_sample_list_generator(
            lambda: iter([[(np.ones(4), 3), (np.zeros(4), 1)]]))
        (b,) = list(loader)
    assert isinstance(b["x"], np.ndarray) and b["y"].tolist() == [[3], [1]]


def test_dataloader_feeds_the_executor():
    main, startup = pt.Program(), pt.Program()
    startup.random_seed = 1
    with pt.program_guard(main, startup), pt.unique_name.guard():
        x = pt.data("x", [None, 4])
        loss = pt.layers.mean(pt.layers.fc(x, 1))
    exe = pt.Executor(pt.CPUPlace())
    loader = pt.DataLoader.from_generator(feed_list=[x])
    loader.set_batch_generator(_gen, places=pt.CPUPlace())
    with pt.scope_guard(pt.Scope()):
        exe.run(startup)
        got = [exe.run(main, feed=b, fetch_list=[loss])[0] for b in loader]
        want = [exe.run(main, feed=b, fetch_list=[loss])[0] for b in _gen()]
    np.testing.assert_array_equal(got, want)


def test_dataloader_without_places_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    loader = pt.DataLoader.from_generator(feed_list=["x"])
    loader.set_batch_generator(_gen)
    with pytest.raises(RuntimeError, match="CUDA device"):
        next(iter(loader))


def test_dataloader_unconfigured_raises():
    with pytest.raises(RuntimeError, match="not configured"):
        next(iter(pt.DataLoader.from_generator()))

