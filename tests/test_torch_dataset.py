"""The port's Dataset pipeline (``paddle_tpu_torch.dataset``) against
the JAX package's ``paddle_tpu.dataset`` on the CPU, on MultiSlot files
written from a numpy seed.

* ``QueueDataset`` and ``InMemoryDataset`` give the JAX package's
  batches, array for array (ids exactly, floats exactly: both parse the
  same text), also after ``local_shuffle(seed)`` and with
  ``drop_last=False``'s remainder;
* a parallel parse (``set_thread``) gives the serial parse's batches,
  remote (hdfs://) entries included, localized through ``fs``;
* ``global_shuffle`` across two gloo ranks in two processes keeps the
  union of the instances, and each rank holds exactly the instances its
  seeded destinations give, in the order of the final
  ``local_shuffle(seed + rank)`` (counterpart of
  tests/test_dist_extras.py:58); with one process it is
  ``local_shuffle(seed)``.
"""
import json
import os
import stat
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import paddle_tpu as jpt
import paddle_tpu_torch as pt
from paddle_tpu_torch import fs
from paddle_tpu_torch.distributed.launch import reserve_ports, \
    terminate_procs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write_multislot(path, n, seed=0, max_ids=6):
    """2 slots: sparse ids (u, ragged 1..max_ids-1), dense (f, dim 3)."""
    rng = np.random.RandomState(seed)
    with open(path, "w") as f:
        for _ in range(n):
            n_ids = rng.randint(1, max_ids)
            ids = rng.randint(0, 100, n_ids)
            dense = rng.rand(3)
            parts = [str(n_ids)] + [str(v) for v in ids]
            parts += ["3"] + [f"{v:.4f}" for v in dense]
            f.write(" ".join(parts) + "\n")


@pytest.fixture()
def files(tmp_path):
    out = []
    for i in range(3):
        p = str(tmp_path / f"part-{i}")
        _write_multislot(p, 20 + 3 * i, seed=40 + i)
        out.append(p)
    return out


def _vars(P):
    main = P.Program()
    with P.program_guard(main, P.Program()):
        ids = P.data("ids", [None, 4], "int64")     # pads/truncates to 4
        dense = P.data("dense", [None, 3], "float32")
    return [ids, dense]


def _dataset(P, kind, files, batch=4, drop_last=True, threads=1):
    ds = P.DatasetFactory().create_dataset(kind)
    ds.set_batch_size(batch)
    ds.set_use_var(_vars(P))
    ds.set_filelist(files)
    ds.set_thread(threads)
    ds.drop_last = drop_last
    return ds


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for n in w:
            assert g[n].dtype == w[n].dtype and g[n].shape == w[n].shape
            np.testing.assert_array_equal(g[n], w[n])


@pytest.mark.parametrize("drop_last", [True, False])
def test_queue_dataset_matches_the_jax_package(files, drop_last):
    got = list(_dataset(pt, "QueueDataset", files,
                        drop_last=drop_last).batches())
    want = list(_dataset(jpt, "QueueDataset", files,
                         drop_last=drop_last).batches())
    _assert_batches_equal(got, want)
    sizes = [len(b["ids"]) for b in got]
    assert sizes == ([4] * 16 if drop_last else
                     [4] * 5 + [4] * 5 + [3] + [4] * 6 + [2])


@pytest.mark.parametrize("seed", [None, 0, 11])
def test_in_memory_dataset_matches_the_jax_package(files, seed):
    out = []
    for P in (pt, jpt):
        ds = _dataset(P, "InMemoryDataset", files, batch=5,
                      drop_last=False)
        ds.load_into_memory()
        assert ds.get_memory_data_size() == 20 + 23 + 26
        if seed is not None:
            ds.local_shuffle(seed)
        out.append(list(ds.batches()))
    _assert_batches_equal(*out)
    if seed is not None:
        plain = _dataset(pt, "InMemoryDataset", files, batch=5,
                         drop_last=False)
        plain.load_into_memory()
        unshuffled = np.concatenate([b["dense"] for b in plain.batches()])
        perm = np.random.RandomState(seed).permutation(69)
        np.testing.assert_array_equal(
            np.concatenate([b["dense"] for b in out[0]]), unshuffled[perm])


def test_parallel_parse_matches_serial(files):
    serial = list(_dataset(pt, "QueueDataset", files).batches())
    parallel = list(_dataset(pt, "QueueDataset", files * 2,
                             threads=3).batches())
    _assert_batches_equal(parallel, serial * 2)


def test_parse_is_bounded_and_in_order(files, monkeypatch):
    """At most thread_num + 1 files in flight, results in file order."""
    import threading
    import time

    from paddle_tpu_torch import dataset as dmod

    lock, live, peak = threading.Lock(), [0], [0]
    real = dmod.parse_multislot_file

    def slow(path, types):
        with lock:
            live[0] += 1
            peak[0] = max(peak[0], live[0])
        time.sleep(0.02)
        try:
            return real(path, types)
        finally:
            with lock:
                live[0] -= 1

    monkeypatch.setattr(dmod, "parse_multislot_file", slow)
    ds = _dataset(pt, "QueueDataset", files * 4, threads=2)
    seen = []
    for b in ds.batches():
        seen.append(b)
        time.sleep(0.01)          # a slow consumer
    assert peak[0] <= 2
    _assert_batches_equal(seen, list(_dataset(pt, "QueueDataset",
                                              files).batches()) * 4)


FAKE_HADOOP = r"""#!/bin/bash
root="${FAKE_HDFS_ROOT:?}"
[ "$1" = "fs" ] && shift
verb="$1"; shift
case "$verb" in
  -get) cp "$root/${1#hdfs://ns/}" "$2" ;;
  -test) [ "$1" = "-e" ] && shift; [ -e "$root/${1#hdfs://ns/}" ] ;;
  *) echo "unsupported verb $verb" >&2; exit 2 ;;
esac
"""


def test_a_remote_file_list_is_localized(files, tmp_path, monkeypatch):
    shim = tmp_path / "hadoop"
    shim.write_text(FAKE_HADOOP)
    shim.chmod(shim.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("FAKE_HDFS_ROOT", os.path.dirname(files[0]))
    monkeypatch.setenv("PADDLE_TPU_HADOOP_CMD", str(shim))
    monkeypatch.setattr(fs, "_hadoop", None)
    remote = [f"hdfs://ns/{os.path.basename(p)}" for p in files]
    mixed = [remote[0], files[1], remote[2]]
    for threads in (1, 3):
        got = list(_dataset(pt, "QueueDataset", mixed,
                            threads=threads).batches())
        _assert_batches_equal(got, list(_dataset(pt, "QueueDataset",
                                                 files).batches()))
    # the private temp copies are gone after parsing
    import tempfile

    assert not [n for n in os.listdir(tempfile.gettempdir())
                if n.startswith("paddle_tpu_torch_part_")]


def test_setters_and_defaults():
    ds = pt.DatasetFactory().create_dataset()
    assert isinstance(ds, pt.QueueDataset)
    assert isinstance(pt.DatasetFactory().create_dataset("InMemoryDataset"),
                      pt.InMemoryDataset)
    assert ds.steps_per_dispatch == 8 and ds.batch_size == 1 \
        and ds.thread_num == 1 and ds.drop_last
    ds.set_steps_per_dispatch(3)
    ds.set_pipe_command("cat")
    assert ds.steps_per_dispatch == 3 and ds.pipe_command == "cat"
    main = pt.Program()
    with pt.program_guard(main, pt.Program()):
        a = pt.data("a", [None, -1], "int64")
        b = pt.data("b", [None, 7], "float32")
    assert [ds._pad_len(v) for v in (a, b)] == [1, 7]
    ds.set_use_var([a, b])
    assert ds._slot_types() == ["u", "f"]


def test_in_memory_batches_need_a_load():
    with pytest.raises(RuntimeError, match="load_into_memory"):
        next(pt.InMemoryDataset().batches())


def test_global_shuffle_with_one_process_is_a_local_shuffle(files):
    a = _dataset(pt, "InMemoryDataset", files)
    b = _dataset(pt, "InMemoryDataset", files)
    a.load_into_memory()
    b.load_into_memory()
    a.global_shuffle(seed=3)
    b.local_shuffle(3)
    _assert_batches_equal(list(a.batches()), list(b.batches()))


_RANK_SCRIPT = textwrap.dedent("""
    import json, sys
    import torch.distributed as dist
    sys.path.insert(0, {root!r})
    import paddle_tpu_torch as pt

    rank, port, path, out = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                             sys.argv[4])
    dist.init_process_group("gloo", init_method="tcp://127.0.0.1:" + port,
                            rank=rank, world_size=2)
    main = pt.Program()
    with pt.program_guard(main, pt.Program()):
        ids = pt.data("ids", [None, 2], "int64")
        dense = pt.data("dense", [None, 1], "float32")
    ds = pt.InMemoryDataset()
    ds.set_batch_size(1)
    ds.set_use_var([ids, dense])
    ds.set_filelist([path])
    ds.load_into_memory()
    ds.global_shuffle(seed=5)
    rows = [[int(b["ids"][0, 0]), int(b["ids"][0, 1]),
             float(b["dense"][0, 0])] for b in ds.batches()]
    dist.barrier()
    dist.destroy_process_group()
    json.dump(rows, open(out, "w"))
""")


def _records(rank, n):
    """rank r's instances: id 1000 r + i, a ragged second id (only on
    odd i, so the exchange carries ragged slots), dense i / 4."""
    return [(1000 * rank + i, [7] if i % 2 else [], i / 4)
            for i in range(n)]


@pytest.mark.multiproc
def test_global_shuffle_two_gloo_ranks(tmp_path):
    n = 20
    paths, outs = [], []
    for r in range(2):
        p = tmp_path / f"part-{r}"
        with open(p, "w") as f:
            for id0, more, d in _records(r, n):
                ids = [id0] + more
                f.write(f"{len(ids)} {' '.join(map(str, ids))} 1 {d}\n")
        paths.append(str(p))
        outs.append(str(tmp_path / f"out-{r}.json"))
    script = tmp_path / "rank.py"
    script.write_text(_RANK_SCRIPT.format(root=ROOT))
    res = reserve_ports(1, host="127.0.0.1")
    port = str(res.ports[0])
    res.release()
    procs = [subprocess.Popen([sys.executable, str(script), str(r), port,
                               paths[r], outs[r]],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for r in range(2)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=120)
            assert p.returncode == 0, err.decode()[-2000:]
    finally:
        terminate_procs(procs)
    got = [json.load(open(o)) for o in outs]

    # what each rank must hold: the seeded destinations of both sources,
    # in source order, then local_shuffle(5 + rank)
    dests = [np.random.RandomState(5 + 7919 * src).randint(0, 2, size=n)
             for src in range(2)]
    for r in range(2):
        mine = [rec for src in range(2)
                for rec, d in zip(_records(src, n), dests[src]) if d == r]
        perm = np.random.RandomState(5 + r).permutation(len(mine))
        want = [[mine[i][0], (mine[i][1] or [0])[0], mine[i][2]]
                for i in perm]
        assert got[r] == want
    union = sorted(row[0] for rows in got for row in rows)
    assert union == sorted(list(range(n)) + [1000 + i for i in range(n)])
    assert any(row[0] >= 1000 for row in got[0])
    assert any(row[0] < 1000 for row in got[1])
