"""The port's MultiSlot parser (``paddle_tpu_torch.native``) against the
JAX package's ``paddle_tpu.native.parse_multislot_file`` on the CPU.

The port's native parser (its own copy of ``slot_parser.cpp``, built
with g++ into ``paddle_tpu_torch/_build/``), its plain Python parser and
the JAX package's parser give equal instance counts, CSR offsets and
values — ids exactly, floats exactly as well (each side parses the same
text with the same C/Python conversion) — on random files and on
malformed lines (counterparts of tests/test_data_pipeline.py:60, :72 and
:242).  The build is keyed on the source and the command, and a failed
build raises with the compiler's stderr.
"""
import os

import numpy as np
import pytest

import paddle_tpu.native as jnative
from paddle_tpu_torch import native


def _write_multislot(path, n, seed=0):
    """3 slots: sparse ids (u, ragged, some negative), a dense feature
    (f, dim 3) and an empty-or-not slot (u)."""
    rng = np.random.RandomState(seed)
    with open(path, "w") as f:
        for _ in range(n):
            n_ids = rng.randint(1, 6)
            ids = rng.randint(-5, 100, n_ids)
            dense = rng.rand(3) * 10 - 5
            n_tail = rng.randint(0, 3)
            parts = [str(n_ids)] + [str(v) for v in ids]
            parts += ["3"] + [f"{v:.6g}" for v in dense]
            parts += [str(n_tail)] + [str(v) for v in
                                      rng.randint(0, 9, n_tail)]
            f.write(" ".join(parts) + "\n")


def _plain(path, types):
    saved = native._lib, native._tried
    native._lib, native._tried = None, True
    try:
        return native.parse_multislot_file(path, types)
    finally:
        native._lib, native._tried = saved


def _assert_same(a, b):
    (n1, s1), (n2, s2) = a, b
    assert n1 == n2
    assert len(s1) == len(s2)
    for (v1, o1), (v2, o2) in zip(s1, s2):
        assert v1.dtype == v2.dtype
        np.testing.assert_array_equal(o1, o2)
        np.testing.assert_array_equal(v1, v2)


@pytest.mark.parametrize("seed", [0, 3])
def test_native_and_plain_parsers_match_the_jax_package(tmp_path, seed):
    path = str(tmp_path / "part-0")
    _write_multislot(path, 60, seed=seed)
    types = ["u", "f", "u"]
    got = native.parse_multislot_file(path, types)
    assert native.get_slot_parser() is not None
    assert os.path.dirname(native._LIB_PATH).endswith(
        os.path.join("paddle_tpu_torch", "_build"))
    _assert_same(got, jnative.parse_multislot_file(path, types))
    _assert_same(_plain(path, types), got)
    _assert_same(native.parse_multislot_file_python(path, types), got)
    n, slots = got
    assert n == 60 and slots[1][0].shape == (180,)
    assert (np.diff(slots[1][1]) == 3).all()


def test_malformed_lines_drop_their_instance(tmp_path):
    p = str(tmp_path / "bad.txt")
    with open(p, "w") as f:
        f.write("1 5 3 1.0 2.0 3.0\n")   # good
        f.write("1 9 -1\n")              # negative count
        f.write("1 7 3 1.0 2.0\n")       # count overruns line
        f.write("\n")                    # blank
        f.write("1 8 2 4.0 5.0\n")       # good
        f.write("x 8 2 4.0 5.0\n")       # junk count token
        f.write("2 1 z 1 1.0\n")         # junk id
        f.write("1 -3 1 2.5e-1\n")       # good, a negative id
    types = ["u", "f"]
    got = native.parse_multislot_file(p, types)
    n, slots = got
    assert n == 3
    assert slots[0][0].tolist() == [5, 8, -3]
    assert slots[1][0].tolist() == [1.0, 2.0, 3.0, 4.0, 5.0, 0.25]
    assert slots[1][1].tolist() == [0, 3, 5, 6]
    _assert_same(got, jnative.parse_multislot_file(p, types))
    _assert_same(_plain(p, types), got)


def test_empty_file(tmp_path):
    p = str(tmp_path / "empty")
    open(p, "w").close()
    n, slots = native.parse_multislot_file(p, ["u", "f"])
    assert n == 0
    assert [o.tolist() for _, o in slots] == [[0], [0]]
    _assert_same(_plain(p, ["u", "f"]), (n, slots))


def test_build_is_keyed_on_source_and_command(tmp_path):
    src = tmp_path / "a.cpp"
    src.write_text("extern \"C\" int f() { return 1; }\n")
    out = str(tmp_path / "liba.so")
    cmd = ["g++", "-O1", "-shared", "-fPIC", str(src), "-o", out]
    native.build_if_stale(out, cmd, [str(src)])
    stamp = open(out + ".srchash").read()
    first = os.stat(out).st_mtime_ns
    native.build_if_stale(out, cmd, [str(src)])      # fresh: no build
    assert os.stat(out).st_mtime_ns == first
    native.build_if_stale(out, cmd[:1] + ["-O2"] + cmd[2:], [str(src)])
    assert open(out + ".srchash").read() != stamp    # flags rebuild
    src.write_text("extern \"C\" int f() { return 2; }\n")
    native.build_if_stale(out, cmd, [str(src)])
    assert open(out + ".srchash").read() not in (stamp,)


def test_a_failed_build_raises_with_the_compilers_stderr(tmp_path,
                                                         monkeypatch):
    bad = tmp_path / "slot_parser.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SRC_PATH", str(bad))
    monkeypatch.setattr(native, "_LIB_PATH", str(tmp_path / "_sp.so"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    for _ in range(2):          # no quiet fallback on a second call
        with pytest.raises(RuntimeError, match="native build failed") as e:
            native.parse_multislot_file(str(bad), ["u"])
        assert "error" in str(e.value)
    assert not os.path.exists(tmp_path / "_sp.so")
