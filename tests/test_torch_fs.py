"""The port's filesystem layer (``paddle_tpu_torch.fs``): the cases of
tests/test_fs.py over a fake ``hadoop`` launcher that serves hdfs://
paths from a local warehouse directory (the shell-out contract of the
reference), plus the transient-failure retry, ``hdfs_set_command`` and
``resilience.CheckpointManager(upload_to=...)`` mirroring versions
through it.  The JAX package's ``fs`` runs the same calls where its
behaviour is the reference (routing, listing, errors)."""
import hashlib
import os
import stat

import numpy as np
import pytest

import paddle_tpu_torch as pt
from paddle_tpu import fs as jfs
from paddle_tpu_torch import fs
from paddle_tpu_torch.resilience import CheckpointManager

FAKE_HADOOP = r"""#!/bin/bash
# fake `hadoop fs` shim: maps hdfs://ns/... onto $FAKE_HDFS_ROOT/...
root="${FAKE_HDFS_ROOT:?}"
map() { echo "$root/${1#hdfs://ns/}"; }
[ "$1" = "fs" ] && shift
while [[ "$1" == -D* ]]; do shift; done
verb="$1"; shift
if [ -n "$FAKE_HDFS_FLAKY" ] && [ ! -e "$FAKE_HDFS_FLAKY" ]; then
  touch "$FAKE_HDFS_FLAKY"
  echo "java.net.ConnectException: Connection refused" >&2; exit 1
fi
case "$verb" in
  -test) [ "$1" = "-e" ] && shift; [ -e "$(map "$1")" ] ;;
  -mkdir) [ "$1" = "-p" ] && shift; mkdir -p "$(map "$1")" ;;
  -rm) [ "$1" = "-r" ] && shift; rm -rf "$(map "$1")" ;;
  -get) cp "$(map "$1")" "$2" ;;
  -put) [ "$1" = "-f" ] && shift; cp "$1" "$(map "$2")" ;;
  -ls)
    p="$(map "$1")"
    if [ -d "$p" ]; then
      for f in "$p"/*; do
        echo "-rw-r--r-- 1 u g 1 2026-01-01 00:00 hdfs://ns/${f#$root/}"
      done
    elif [ -e "$p" ]; then
      echo "-rw-r--r-- 1 u g 1 2026-01-01 00:00 $1"
    else
      echo "ls: No such file or directory" >&2; exit 1
    fi ;;
  *) echo "unsupported verb $verb" >&2; exit 2 ;;
esac
"""


@pytest.fixture()
def fake_hdfs(tmp_path, monkeypatch):
    shim = tmp_path / "hadoop"
    shim.write_text(FAKE_HADOOP)
    shim.chmod(shim.stat().st_mode | stat.S_IEXEC)
    root = tmp_path / "warehouse"
    root.mkdir()
    monkeypatch.setenv("FAKE_HDFS_ROOT", str(root))
    monkeypatch.setenv("PADDLE_TPU_HADOOP_CMD", str(shim))
    monkeypatch.setenv("PADDLE_TPU_FS_RETRY_BASE_S", "0.01")
    # fresh backends so the new command is picked up
    fs._hadoop = jfs._hadoop = None
    yield root
    fs._hadoop = jfs._hadoop = None
    fs.hdfs_set_command(None)


def test_scheme_routing(fake_hdfs):
    for F in (jfs, fs):
        assert isinstance(F.select("hdfs://ns/x"), F.HadoopFS)
        assert isinstance(F.select("afs://ns/x"), F.HadoopFS)
        assert isinstance(F.select("/tmp/x"), F.LocalFS)


def test_hdfs_roundtrip(fake_hdfs, tmp_path):
    local = tmp_path / "data.txt"
    local.write_text("hello")
    assert not fs.exists("hdfs://ns/dir/data.txt")
    fs.mkdir("hdfs://ns/dir")
    fs.upload(str(local), "hdfs://ns/dir/data.txt")
    assert fs.exists("hdfs://ns/dir/data.txt")
    names = fs.ls("hdfs://ns/dir")
    assert names == jfs.ls("hdfs://ns/dir")
    assert any(n.endswith("data.txt") for n in names)
    got = fs.localize("hdfs://ns/dir/data.txt")
    assert open(got).read() == "hello"
    assert fs.localize("hdfs://ns/dir/data.txt") == got      # cache hit
    out = tmp_path / "back" / "data.txt"
    fs.download("hdfs://ns/dir/data.txt", str(out))
    assert out.read_text() == "hello"
    fs.remove("hdfs://ns/dir")
    assert not fs.exists("hdfs://ns/dir/data.txt")


def test_hdfs_error_surfaces(fake_hdfs):
    for F in (jfs, fs):
        with pytest.raises(RuntimeError, match="-ls"):
            F.ls("hdfs://ns/never-there")


def test_transient_failure_is_retried(fake_hdfs, tmp_path, monkeypatch):
    """One 'Connection refused' then success: the command is retried
    (a permanent error above fails at once)."""
    (fake_hdfs / "f.txt").write_text("data")
    monkeypatch.setenv("FAKE_HDFS_FLAKY", str(tmp_path / "flaked"))
    assert fs.exists("hdfs://ns/f.txt")
    assert (tmp_path / "flaked").exists()


def test_hdfs_set_command(fake_hdfs, tmp_path, monkeypatch):
    shim = os.environ["PADDLE_TPU_HADOOP_CMD"]
    monkeypatch.setenv("PADDLE_TPU_HADOOP_CMD", "/nonexistent/hadoop")
    assert fs.hdfs_command() == "/nonexistent/hadoop"
    fs.hdfs_set_command(shim)
    assert fs.hdfs_command() == shim
    (fake_hdfs / "g.txt").write_text("x")
    assert fs.exists("hdfs://ns/g.txt")


def test_local_fs(tmp_path):
    src = tmp_path / "a.bin"
    np.arange(4, dtype=np.float32).tofile(src)
    d = tmp_path / "d"
    fs.mkdir(str(d))
    fs.upload(str(src), str(d / "a.bin"))
    assert fs.exists(str(d / "a.bin"))
    assert fs.ls(str(d)) == [str(d / "a.bin")] == jfs.ls(str(d))
    assert fs.localize(str(src)) == str(src)
    fs.remove(str(d))
    assert not fs.exists(str(d))


def test_dataset_filelist_localizes_remote(fake_hdfs):
    """QueueDataset reads hdfs:// filelist entries through the fs layer
    (parity: DataFeed reading via fs.cc)."""
    (fake_hdfs / "part-0.txt").write_text("2 7 8 1 0.5\n2 1 2 1 1.5\n")
    ds = pt.DatasetFactory().create_dataset("QueueDataset")
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        a = pt.data("a", [None, 2], "int64")
        b = pt.data("b", [None, 1], "float32")
    ds.set_batch_size(2)
    ds.set_use_var([a, b])
    ds.set_filelist(["hdfs://ns/part-0.txt"])
    batches = list(ds.batches())
    assert len(batches) == 1
    np.testing.assert_array_equal(batches[0]["a"], [[7, 8], [1, 2]])
    np.testing.assert_allclose(batches[0]["b"].ravel(), [0.5, 1.5])


def test_localize_same_basename_no_collision(fake_hdfs):
    (fake_hdfs / "day1").mkdir()
    (fake_hdfs / "day2").mkdir()
    (fake_hdfs / "day1" / "part-0").write_text("one")
    (fake_hdfs / "day2" / "part-0").write_text("two")
    a = fs.localize("hdfs://ns/day1/part-0")
    b = fs.localize("hdfs://ns/day2/part-0")
    assert a != b
    assert open(a).read() == "one" and open(b).read() == "two"


def test_localize_recovers_from_stale_part_file(fake_hdfs):
    (fake_hdfs / "f.txt").write_text("data")
    cache = fs.select("hdfs://ns/f.txt")._cache_dir()
    tag = hashlib.sha1(b"hdfs://ns/f.txt").hexdigest()[:12]
    with open(os.path.join(cache, f"{tag}_f.txt.part"), "w") as f:
        f.write("junk")                 # interrupted previous fetch
    assert open(fs.localize("hdfs://ns/f.txt")).read() == "data"


def test_checkpoint_manager_mirrors_through_hdfs(fake_hdfs, tmp_path):
    """upload_to: every version's files, then the latest pointer, land in
    the remote store; a second save moves the remote pointer."""
    with pt.new_program_scope():
        pt.layers.fc(pt.data("x", [2, 3]), 2)
        prog, scope = pt.default_main_program(), pt.global_scope()
        names = [v.name for v in prog.list_vars() if v.persistable]
        mgr = CheckpointManager(str(tmp_path / "ck"), keep=2,
                                upload_to="hdfs://ns/ckpt")
        for step in (3, 7):
            for i, n in enumerate(names):
                scope.set_var(n, np.full((2, 2), step + i, np.float32))
            mgr.save(step, program=prog, scope=scope)
    assert fs.exists("hdfs://ns/ckpt/ckpt-00000003/manifest.json")
    remote = fake_hdfs / "ckpt"
    assert (remote / "latest").read_text() == "ckpt-00000007"
    assert sorted(os.listdir(remote / "ckpt-00000007")) == sorted(
        os.listdir(tmp_path / "ck" / "ckpt-00000007"))
    with np.load(remote / "ckpt-00000007" / "__params__.npz") as z:
        for i, n in enumerate(names):
            np.testing.assert_array_equal(z[n], np.full((2, 2), 7 + i,
                                                        np.float32))
