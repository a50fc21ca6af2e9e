"""The port's flags (``paddle_tpu_torch.flags``) and what reads them,
against the JAX package's on the CPU.

Counterparts of tests/test_aux.py's flag cases: get/set, environment
pickup, unknown names, the string "false"; then ``FLAGS_check_nan_inf``
through both Executors — the same RuntimeError text for the same faulty
op, the fusion pass off and the flag in the lowering cache's signature,
a clean feed passing, and the dataset trainer's refusal (ValueError in
both packages).  ``FLAGS_benchmark`` only adds a wait for the card,
which this CPU cannot show; a run under it gives the same values.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

import paddle_tpu as jpt
import paddle_tpu_torch as pt
from paddle_tpu import flags as jflags
from paddle_tpu_torch import flags as pflags


@pytest.fixture(autouse=True)
def _reset_flags():
    saved = dict(pflags._FLAGS), dict(jflags._FLAGS)
    yield
    pflags._FLAGS.clear()
    pflags._FLAGS.update(saved[0])
    jflags._FLAGS.clear()
    jflags._FLAGS.update(saved[1])


def test_defaults_and_names_are_the_jax_packages():
    assert pflags._DEFAULTS == jflags._DEFAULTS
    names = sorted(jflags._DEFAULTS)
    assert pt.get_flags(names) == {n: jflags._DEFAULTS[n] for n in names}
    assert pt.get_flags is pflags.get_flags
    assert pt.set_flags is pflags.set_flags


@pytest.mark.parametrize("value,want", [
    (True, True), ("1", True), ("true", True), ("on", True),
    ("false", False), ("0", False), ("no", False), (0, False)])
def test_set_flags_coerces_as_the_jax_package(value, want):
    pt.set_flags({"FLAGS_check_nan_inf": value})
    jpt.set_flags({"FLAGS_check_nan_inf": value})
    got = pt.get_flags("FLAGS_check_nan_inf")["FLAGS_check_nan_inf"]
    assert got is want
    assert jpt.get_flags("FLAGS_check_nan_inf") == {
        "FLAGS_check_nan_inf": want}


def test_typed_flags_coerce():
    pt.set_flags({"FLAGS_v": "3", "FLAGS_fraction_of_gpu_memory_to_use":
                  "0.5"})
    assert pt.get_flags(["FLAGS_v", "FLAGS_fraction_of_gpu_memory_to_use"]) \
        == {"FLAGS_v": 3, "FLAGS_fraction_of_gpu_memory_to_use": 0.5}
    assert pflags.flag("FLAGS_v") == 3


@pytest.mark.parametrize("call", ["get", "set"])
def test_unknown_flag_raises_key_error(call):
    for P in (jpt, pt):
        with pytest.raises(KeyError, match="unknown flag 'FLAGS_nope'"):
            if call == "get":
                P.get_flags(["FLAGS_nope"])
            else:
                P.set_flags({"FLAGS_nope": 1})


def test_environment_pickup():
    """FLAGS_* in the environment set the initial values, as in the
    reference (a fresh process: flags read the environment at import)."""
    env = dict(os.environ, FLAGS_check_nan_inf="1", FLAGS_benchmark="false",
               FLAGS_v="2")
    code = ("import paddle_tpu_torch.flags as f; print(f.get_flags("
            "['FLAGS_check_nan_inf', 'FLAGS_benchmark', 'FLAGS_v']))")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == str({"FLAGS_check_nan_inf": True,
                                      "FLAGS_benchmark": False,
                                      "FLAGS_v": 2})


def _log_program(P):
    main, startup = P.Program(), P.Program()
    startup.random_seed = 3
    with P.program_guard(main, startup), P.unique_name.guard():
        x = P.data("x", [4, 8])
        h = P.layers.fc(x, 6, act="relu")
        y = P.layers.mean(P.layers.log(x) + P.layers.reduce_sum(h))
    return main, startup, y


def _run(P, place, feed, flag):
    main, startup, y = _log_program(P)
    P.set_flags({"FLAGS_check_nan_inf": flag})
    with P.scope_guard(P.Scope()):
        exe = P.Executor(place)
        exe.run(startup)
        return exe.run(main, feed={"x": feed}, fetch_list=[y])[0], main


def _bad_feed():
    x = np.random.RandomState(0).rand(4, 8).astype(np.float32) + 0.5
    x[2, 5] = -1.0
    return x


def test_faulty_op_message_is_the_jax_packages():
    msgs = []
    for P, place in ((jpt, jpt.CPUPlace()), (pt, pt.CPUPlace())):
        with pytest.raises(RuntimeError) as e:
            _run(P, place, _bad_feed(), True)
        msgs.append(str(e.value))
    assert msgs[1] == msgs[0]
    assert "'log'" in msgs[1] and "contains nan" in msgs[1] \
        and "shape=(4, 8) dtype=float32" in msgs[1]


def test_inf_is_named_inf():
    x = np.ones((4, 8), np.float32)
    x[0, 0] = 0.0                      # log(0) = -inf
    with pytest.raises(RuntimeError, match="'log'.*contains inf"):
        _run(pt, pt.CPUPlace(), x, True)


def test_a_clean_feed_passes_with_the_flag_on():
    x = np.random.RandomState(1).rand(4, 8).astype(np.float32) + 0.5
    assert np.isfinite(_run(jpt, jpt.CPUPlace(), x, True)[0])
    got, _ = _run(pt, pt.CPUPlace(), x, True)
    off, _ = _run(pt, pt.CPUPlace(), x, False)
    # the scan changes nothing it sees (the startup's random weights
    # differ between the packages, so the values are held to each other)
    np.testing.assert_array_equal(got, off)
    pt.set_flags({"FLAGS_benchmark": True})
    bench, _ = _run(pt, pt.CPUPlace(), x, False)
    np.testing.assert_array_equal(bench, off)


def test_the_flag_turns_fusion_off_and_joins_the_signature():
    """One program, run with the flag off then on: two lowerings, the
    first with the fusion pass's groups, the second with none."""
    main, startup, y = _log_program(pt)
    x = np.random.RandomState(2).rand(4, 8).astype(np.float32) + 0.5
    exe = pt.Executor(pt.CPUPlace())
    with pt.scope_guard(pt.Scope()):
        exe.run(startup)
        for flag in (False, True):
            pt.set_flags({"FLAGS_check_nan_inf": flag})
            exe.run(main, feed={"x": x}, fetch_list=[y])
    lowered = list(main._exec_cache.items())
    assert len(lowered) == 2
    (sig_off, off), (sig_on, on) = lowered
    assert sig_off[-1] is False and sig_on[-1] is True
    assert off.fusion_plan is not None and off.fusion_plan.groups
    assert on.fusion_plan is None


def _dataset_program(P):
    main, startup = P.Program(), P.Program()
    with P.program_guard(main, startup), P.unique_name.guard():
        a = P.data("a", [None, 2], "float32")
        loss = P.layers.mean(P.layers.fc(a, 1))
        P.optimizer.SGD(0.1).minimize(loss)
    return main, startup, a, loss


def test_the_dataset_trainer_refuses_the_flag(tmp_path):
    path = tmp_path / "part-0"
    path.write_text("2 1.0 2.0\n2 3.0 4.0\n")
    errs = []
    for P, place in ((jpt, jpt.CPUPlace()), (pt, pt.CPUPlace())):
        main, startup, a, loss = _dataset_program(P)
        ds = P.DatasetFactory().create_dataset("QueueDataset")
        ds.set_batch_size(2)
        ds.set_use_var([a])
        ds.set_filelist([str(path)])
        P.set_flags({"FLAGS_check_nan_inf": True})
        with P.scope_guard(P.Scope()):
            exe = P.Executor(place)
            exe.run(startup)
            with pytest.raises(ValueError) as e:
                exe.train_from_dataset(main, ds, fetch_list=[loss])
        errs.append(str(e.value))
    assert errs[1] == errs[0]
