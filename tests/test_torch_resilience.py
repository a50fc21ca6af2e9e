"""The port's checkpoints and resilient train loop (``resilience.
checkpoint``, ``resilience.train_loop``), on the CPU.

The checkpoint and loop cases of ``tests/test_resilience.py`` run on the
port: atomic archive writes, retention and ``latest``, fallback past a
corrupt or truncated version, a crash during save, the re-save aside
copy, strict restore both ways, async failures surfacing, the NaN skip
(its budget, a skip on a checkpoint boundary) and preempt/resume
bit-equal to an uninterrupted run.  Then across the packages: a JAX
checkpoint restores into the port and a port checkpoint into the JAX
package, every array bit-equal (the LR counter's value equal: int64 in
the port, 32 bits in the JAX package) and the RNG counter carried.  Last,
the premise of the loop's reference snapshot: a step of the BERT recipe
(fused and unfused) writes no scope tensor in place, and a NaN step of
it rolls back bit for bit.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as pt
from paddle_tpu import resilience as jres
from paddle_tpu_torch import io as pio
from paddle_tpu_torch.models import BertConfig, build_bert_pretrain
from paddle_tpu_torch.observability import flightrec
from paddle_tpu_torch.resilience import (CheckpointError, CheckpointManager,
                                         FaultPlan, NonFiniteLossError,
                                         ResilientLoop)
from paddle_tpu_torch.resilience.faults import InjectedFault, Preempted


def _exe():
    return pt.Executor(pt.CPUPlace())


def _host(v):
    return v.detach().numpy().copy() if hasattr(v, "detach") \
        else np.array(v, copy=True)


# -- atomic io.save_vars + load_persistables key mismatch -------------------

def test_save_vars_crash_never_truncates_existing(tmp_path):
    d = str(tmp_path / "m")
    good = {"w": np.arange(6, dtype=np.float32).reshape(2, 3)}
    pio.save_vars(None, d, good)
    with FaultPlan(fs_write_failures=[0]).armed():
        with pytest.raises(InjectedFault):
            pio.save_vars(None, d, {"w": np.zeros((2, 3), np.float32)})
    with np.load(os.path.join(d, "__params__.npz")) as z:
        np.testing.assert_array_equal(z["w"], good["w"])
    assert not [f for f in os.listdir(d) if ".tmp." in f]


def test_load_persistables_names_missing_vars(tmp_path):
    with pt.new_program_scope():
        x = pt.data("x", [2, 3])
        pt.layers.fc(x, 4)
        exe = _exe()
        exe.run(pt.default_startup_program())
        d = str(tmp_path / "ckpt")
        pio.save_persistables(exe, d)
        pt.layers.fc(x, 5)
        with pytest.raises(KeyError, match="missing persistable"):
            pio.load_persistables(exe, d)


# -- CheckpointManager: versions, retention, corruption fallback ------------

def _param_program():
    x = pt.data("x", [2, 3])
    pt.layers.fc(x, 2)
    prog = pt.default_main_program()
    names = [v.name for v in prog.list_vars() if v.persistable]
    return prog, pt.global_scope(), names


def _stamp(scope, names, step):
    for i, n in enumerate(names):
        scope.set_var(n, np.full((2, 2), 10 * step + i, np.float32))


def _assert_stamped(scope, names, value):
    for i, n in enumerate(names):
        np.testing.assert_array_equal(
            _host(scope.find_var(n)), np.full((2, 2), value + i, np.float32))


@pytest.fixture(autouse=True)
def _fresh():
    with pt.new_program_scope():
        yield


def test_checkpoint_versions_retention_and_latest(tmp_path):
    prog, scope, names = _param_program()
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=2)
    for step in (1, 2, 3):
        _stamp(scope, names, step)
        prog._rng_counter = step
        mgr.save(step, program=prog, scope=scope)
    assert mgr.versions() == [2, 3]
    assert mgr.latest_step() == 3
    _stamp(scope, names, 99)
    prog._rng_counter = 0
    manifest = mgr.restore(program=prog, scope=scope)
    assert manifest["step"] == 3 and prog._rng_counter == 3
    _assert_stamped(scope, names, 30)


def test_corrupt_latest_falls_back_to_previous_intact(tmp_path):
    prog, scope, names = _param_program()
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=3)
    for step in (1, 2):
        _stamp(scope, names, step)
        mgr.save(step, program=prog, scope=scope)
    npz = os.path.join(str(tmp_path / "ck"), "ckpt-00000002",
                       "__params__.npz")
    size = os.path.getsize(npz)
    with open(npz, "r+b") as f:
        f.seek(size // 2)
        f.write(b"\xde\xad\xbe\xef")
    with pytest.warns(UserWarning, match="corrupt"):
        manifest = mgr.restore(program=prog, scope=scope)
    assert manifest["step"] == 1
    _assert_stamped(scope, names, 10)


def test_corrupt_manifest_and_truncated_archive_fall_back(tmp_path):
    prog, scope, names = _param_program()
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=3)
    for step in (1, 2, 3):
        _stamp(scope, names, step)
        mgr.save(step, program=prog, scope=scope)
    root = str(tmp_path / "ck")
    npz = os.path.join(root, "ckpt-00000003", "__params__.npz")
    with open(npz, "r+b") as f:
        f.truncate(os.path.getsize(npz) // 3)
    with open(os.path.join(root, "ckpt-00000002", "manifest.json"),
              "w") as f:
        f.write("{not json")
    with pytest.warns(UserWarning):
        manifest = mgr.restore(program=prog, scope=scope)
    assert manifest["step"] == 1
    _assert_stamped(scope, names, 10)


def test_all_versions_corrupt_raises_checkpoint_error(tmp_path):
    prog, scope, names = _param_program()
    mgr = CheckpointManager(str(tmp_path / "ck"))
    _stamp(scope, names, 1)
    mgr.save(1, program=prog, scope=scope)
    npz = os.path.join(str(tmp_path / "ck"), "ckpt-00000001",
                       "__params__.npz")
    with open(npz, "wb") as f:
        f.write(b"garbage")
    with pytest.warns(UserWarning):
        with pytest.raises(CheckpointError):
            mgr.restore(program=prog, scope=scope)


def test_checkpoint_crash_during_save_keeps_store_intact(tmp_path):
    prog, scope, names = _param_program()
    mgr = CheckpointManager(str(tmp_path / "ck"))
    _stamp(scope, names, 1)
    mgr.save(1, program=prog, scope=scope)
    _stamp(scope, names, 2)
    with FaultPlan(fs_write_failures=[0]).armed():
        with pytest.raises(InjectedFault):
            mgr.save(2, program=prog, scope=scope)
    assert mgr.versions() == [1] and mgr.latest_step() == 1
    assert mgr.restore(program=prog, scope=scope)["step"] == 1


def test_resave_same_step_parks_old_copy_and_recovers(tmp_path):
    prog, scope, names = _param_program()
    mgr = CheckpointManager(str(tmp_path / "ck"))
    _stamp(scope, names, 1)
    mgr.save(1, program=prog, scope=scope)
    _stamp(scope, names, 2)
    mgr.save(1, program=prog, scope=scope)
    assert [n for n in os.listdir(mgr.root) if n.startswith(".old-")] == []
    final = os.path.join(mgr.root, "ckpt-00000001")
    os.rename(final, os.path.join(mgr.root, ".old-ckpt-00000001.12345"))
    assert mgr.versions() == []
    _stamp(scope, names, 99)
    assert mgr.restore(program=prog, scope=scope)["step"] == 1
    _assert_stamped(scope, names, 20)


def test_restore_strict_rejects_foreign_checkpoint(tmp_path):
    prog, scope, names = _param_program()
    pt.layers.fc(pt.data("x2", [2, 2]), 2)
    for i, n in enumerate(v.name for v in prog.list_vars() if v.persistable):
        scope.set_var(n, np.full((2, 2), 10 + i, np.float32))
    CheckpointManager(str(tmp_path / "ck")).save(1, program=prog,
                                                 scope=scope)
    with pt.new_program_scope():
        prog2, scope2, names2 = _param_program()
        mgr2 = CheckpointManager(str(tmp_path / "ck"))
        with pytest.raises(CheckpointError, match="unknown to the"):
            mgr2.restore(program=prog2, scope=scope2)
        manifest = mgr2.restore(program=prog2, scope=scope2, strict=False)
        assert manifest["step"] == 1
        assert all(scope2.has_var(n) for n in names2)
        assert not any(scope2.has_var(n) for n in
                       set(manifest["arrays"]) - set(names2))


def test_restore_strict_rejects_missing_persistables(tmp_path):
    prog, scope, names = _param_program()
    _stamp(scope, names, 1)
    CheckpointManager(str(tmp_path / "ck")).save(1, program=prog,
                                                 scope=scope)
    with pt.new_program_scope():
        prog2, scope2, _ = _param_program()
        pt.layers.fc(pt.data("x2", [2, 2]), 2)
        for v in prog2.list_vars():
            if v.persistable and not scope2.has_var(v.name):
                scope2.set_var(v.name, np.zeros((2, 2), np.float32))
        mgr2 = CheckpointManager(str(tmp_path / "ck"))
        with pytest.raises(CheckpointError, match="missing persistable"):
            mgr2.restore(program=prog2, scope=scope2)
        assert mgr2.restore(program=prog2, scope=scope2,
                            strict=False)["step"] == 1


def test_blocking_save_drains_pending_async_saves(tmp_path):
    prog, scope, names = _param_program()
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=10)
    for step in (1, 2, 3):
        _stamp(scope, names, step)
        mgr.save(step, program=prog, scope=scope, block=False)
    _stamp(scope, names, 4)
    mgr.save(4, program=prog, scope=scope, block=True)
    assert mgr.latest_step() == 4 and mgr.versions() == [1, 2, 3, 4]
    mgr.close()
    assert mgr._worker is None
    mgr.close()
    _stamp(scope, names, 5)
    mgr.save(5, program=prog, scope=scope, block=False)
    mgr.join()
    assert mgr.latest_step() == 5
    mgr.close()


def test_upload_waits_for_fs():
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        CheckpointManager("unused", upload_to="hdfs://ns/ckpt")


# -- ResilientLoop ----------------------------------------------------------

def _build_train_program(P):
    """fc + dropout + momentum at a decaying LR: dropout makes the RNG
    stream load-bearing, momentum and the LR counter add state."""
    main, startup = P.Program(), P.Program()
    startup.random_seed = 7
    main.random_seed = 11
    with P.program_guard(main, startup), P.unique_name.guard():
        x = P.data("x", [8, 6])
        y = P.data("y", [8, 1], "int64")
        h = P.layers.fc(x, 16, act="relu")
        h = P.layers.dropout(h, dropout_prob=0.3)
        logits = P.layers.fc(h, 3)
        loss = P.layers.mean(P.layers.softmax_with_cross_entropy(logits, y))
        lr = P.layers.exponential_decay(0.05, 4, 0.5)
        P.optimizer.Momentum(lr, 0.9).minimize(loss)
    return main, startup, loss


def _feed_fn(step):
    r = np.random.RandomState(1000 + step)
    return {"x": r.rand(8, 6).astype(np.float32),
            "y": r.randint(0, 3, (8, 1)).astype(np.int64)}


def _persist_state(prog, scope):
    return {v.name: _host(scope.find_var(v.name))
            for v in prog.list_vars()
            if v.persistable and scope.has_var(v.name)}


def _port_run(fn):
    main, startup, loss = _build_train_program(pt)
    exe = _exe()
    exe.run(startup)
    return main, exe, loss, fn(main, exe, loss)


def test_preempt_resume_bit_equal(tmp_path):
    n_steps = 9
    main, exe, loss, _ = _port_run(
        lambda m, e, l: ResilientLoop(e, m, loss=l).run(_feed_fn, n_steps))
    base = _persist_state(main, pt.global_scope())
    assert any(np.any(v != 0) for v in base.values())

    with pt.new_program_scope():
        main, startup, loss = _build_train_program(pt)
        exe = _exe()
        exe.run(startup)
        mgr = CheckpointManager(str(tmp_path / "ck"), keep=3)
        loop = ResilientLoop(exe, main, loss=loss, manager=mgr,
                             checkpoint_every=3)
        with FaultPlan(preempt_steps=[7]).armed():
            with pytest.raises(Preempted):
                loop.run(_feed_fn, n_steps)
        assert mgr.latest_step() == 6
        # a new process: a new executor, scope and rebuilt program
        with pt.new_program_scope():
            main2, startup2, loss2 = _build_train_program(pt)
            exe2 = _exe()
            exe2.run(startup2)
            loop2 = ResilientLoop(exe2, main2, loss=loss2, manager=mgr,
                                  checkpoint_every=3)
            loop2.run(_feed_fn, n_steps)
            assert loop2.start_step == 6
            resumed = _persist_state(main2, pt.global_scope())
    assert set(base) == set(resumed)
    for name in base:
        np.testing.assert_array_equal(base[name], resumed[name],
                                      err_msg=name)


def test_nan_skip_step_restores_params_and_counts():
    main, startup, loss = _build_train_program(pt)
    exe = _exe()
    exe.run(startup)
    loop = ResilientLoop(exe, main, loss=loss, max_consecutive_skips=2)
    with FaultPlan(nan_loss_steps=[2, 3]).armed():
        losses = loop.run(_feed_fn, 6)
    assert loop.skipped_steps == [2, 3]
    assert len(losses) == 4 and np.all(np.isfinite(losses))
    state = _persist_state(main, pt.global_scope())
    assert all(np.all(np.isfinite(v)) for v in state.values())


class _SnapshotSpy(ResilientLoop):
    """Keeps a host copy of every pre-step snapshot the loop takes."""

    def _snapshot(self, scope, names):
        snap = super()._snapshot(scope, names)
        self.copies = getattr(self, "copies", [])
        self.copies.append({n: _host(v) for n, v in snap.items()})
        return snap


def _nan_step_rolls_back(exe, main, loss, feed_fn, scope):
    triggers = []

    def listener(reason, detail, fields):
        triggers.append(reason)

    was_armed = flightrec.armed()
    flightrec.arm()
    flightrec.add_trigger_listener(listener)
    try:
        loop = _SnapshotSpy(exe, main, loss=loss, scope=scope)
        with FaultPlan(nan_loss_steps=[2]).armed():
            losses = loop.run(feed_fn, 4)
    finally:
        flightrec.remove_trigger_listener(listener)
        if not was_armed:
            flightrec.disarm()
    assert loop.skipped_steps == [2] and len(losses) == 3
    assert np.all(np.isfinite(losses))
    assert triggers == ["nan_skip"]
    # the state step 3 started from is the state step 2 started from
    for n, want in loop.copies[2].items():
        assert loop.copies[3][n].tobytes() == want.tobytes(), n


def test_nan_step_rolls_back_bit_for_bit():
    main, startup, loss = _build_train_program(pt)
    exe = _exe()
    exe.run(startup)
    _nan_step_rolls_back(exe, main, loss, _feed_fn, pt.global_scope())


def test_nan_skip_at_boundary_still_checkpoints(tmp_path):
    main, startup, loss = _build_train_program(pt)
    exe = _exe()
    exe.run(startup)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    loop = ResilientLoop(exe, main, loss=loss, manager=mgr,
                         checkpoint_every=5)
    with FaultPlan(nan_loss_steps=[9]).armed():
        loop.run(_feed_fn, 10)
    assert loop.skipped_steps == [9]
    assert mgr.latest_step() == 10


def test_nan_skip_budget_aborts():
    main, startup, loss = _build_train_program(pt)
    exe = _exe()
    exe.run(startup)
    loop = ResilientLoop(exe, main, loss=loss, max_consecutive_skips=2)
    with FaultPlan(nan_loss_steps=[1, 2, 3, 4]).armed():
        with pytest.raises(NonFiniteLossError):
            loop.run(_feed_fn, 8)


def test_async_final_save_failure_surfaces_from_run(tmp_path):
    main, startup, loss = _build_train_program(pt)
    exe = _exe()
    exe.run(startup)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    loop = ResilientLoop(exe, main, loss=loss, manager=mgr,
                         checkpoint_every=100, async_save=True)
    with FaultPlan(fs_write_failures=[0]).armed():
        with pytest.raises(InjectedFault):
            loop.run(_feed_fn, 3)


# -- across the packages ----------------------------------------------------

def _archive(root, step):
    with np.load(os.path.join(root, f"ckpt-{step:08d}",
                              "__params__.npz")) as z:
        return {n: z[n] for n in z.files}


def _same(got, want):
    assert set(got) == set(want)
    for n, w in want.items():
        g = np.asarray(got[n])
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=n)
        else:
            assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), n


def test_jax_checkpoint_restores_into_the_port(tmp_path):
    root = str(tmp_path / "ck")
    with jpt.new_program_scope():
        jmain, jstartup, jloss = _build_train_program(jpt)
        jexe = jpt.Executor()
        jexe.run(jstartup)
        jres.ResilientLoop(jexe, jmain, loss=jloss,
                           manager=jres.CheckpointManager(root),
                           checkpoint_every=3).run(_feed_fn, 6)
    want = _archive(root, 6)
    assert want["@LR_DECAY_COUNTER@"].dtype == np.int32
    main, startup, loss = _build_train_program(pt)
    exe = _exe()
    exe.run(startup)
    scope = pt.global_scope()
    manifest = CheckpointManager(root).restore(program=main, scope=scope)
    assert manifest["step"] == 6 and main._rng_counter == 6
    _same({n: scope.find_var(n) for n in want}, want)
    # and the port trains on from it
    losses = ResilientLoop(exe, main, loss=loss,
                           manager=CheckpointManager(root),
                           checkpoint_every=3).run(_feed_fn, 8)
    assert len(losses) == 2 and np.all(np.isfinite(losses))
    counter = scope.find_var("@LR_DECAY_COUNTER@")
    assert counter.dtype == torch.int64 and int(counter) == 7
    # restored 0-d arrays (the counter, the beta powers) stay 0-d
    for v in main.list_vars():
        if v.persistable:
            assert tuple(scope.find_var(v.name).shape) == tuple(v.shape), \
                v.name


def test_port_checkpoint_restores_in_the_jax_package(tmp_path):
    root = str(tmp_path / "ck")
    main, startup, loss = _build_train_program(pt)
    exe = _exe()
    exe.run(startup)
    ResilientLoop(exe, main, loss=loss, manager=CheckpointManager(root),
                  checkpoint_every=3).run(_feed_fn, 6)
    want = _archive(root, 6)
    assert want["@LR_DECAY_COUNTER@"].dtype == np.int64
    with jpt.new_program_scope():
        jmain, jstartup, jloss = _build_train_program(jpt)
        jexe = jpt.Executor()
        jexe.run(jstartup)
        jscope = jpt.global_scope()
        manifest = jres.CheckpointManager(root).restore(program=jmain,
                                                        scope=jscope)
        assert manifest["step"] == 6 and jmain._rng_counter == 6
        _same({n: np.asarray(jscope.find_var(n)) for n in want}, want)
        losses = jres.ResilientLoop(jexe, jmain, loss=jloss).run(
            lambda s: _feed_fn(s), 2)
        assert np.all(np.isfinite(losses))


# -- the BERT recipe's step writes no scope tensor in place -----------------

def _recipe(cfg):
    main, startup = pt.Program(), pt.Program()
    startup.random_seed = 3
    main.random_seed = 4
    with pt.program_guard(main, startup), pt.unique_name.guard():
        loss, _ = build_bert_pretrain(cfg, seq_len=16)
        lr = pt.layers.linear_lr_warmup(
            pt.layers.polynomial_decay(1e-4, decay_steps=12,
                                       end_learning_rate=0.0),
            warmup_steps=4, start_lr=0.0, end_lr=1e-4)
        pt.optimizer.AdamW(
            lr, weight_decay=0.01,
            grad_clip=pt.clip.GradientClipByGlobalNorm(1.0)).minimize(loss)
    return main, startup, loss


def _bert_feed(vocab):
    def feed(step):
        r = np.random.RandomState(40 + step)
        src = r.randint(0, vocab, (4, 16)).astype(np.int64)
        labels = np.full((4, 16, 1), -1, np.int64)
        labels[:, ::3] = src[:, ::3, None]
        return {"src_ids": src, "input_mask": np.ones((4, 16), np.float32),
                "masked_labels": labels}
    return feed


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
def test_a_recipe_step_writes_no_scope_tensor_in_place(fuse):
    cfg = dataclasses.replace(BertConfig.tiny(), hidden_size=128,
                              num_heads=4, ffn_size=256)
    main, startup, loss = _recipe(cfg)
    bs = pt.BuildStrategy()
    bs.fuse_epilogues = fuse
    program = pt.CompiledProgram(main, build_strategy=bs)
    exe, scope = _exe(), pt.Scope()
    exe.run(startup, scope=scope)
    feed = _bert_feed(cfg.vocab_size)
    exe.run(program, feed=feed(0), fetch_list=[loss], scope=scope)
    names = [v.name for v in main.list_vars() if v.persistable]
    pre = {n: scope.find_var(n) for n in names}
    versions = {n: t._version for n, t in pre.items()}
    copies = {n: t.clone() for n, t in pre.items()}
    exe.run(program, feed=feed(1), fetch_list=[loss], scope=scope)
    for n, t in pre.items():
        assert t._version == versions[n], n
        assert t.numpy().tobytes() == copies[n].numpy().tobytes(), n
        assert scope.find_var(n) is not t, n      # a new tensor came back


def test_a_recipe_nan_step_rolls_back_bit_for_bit():
    cfg = dataclasses.replace(BertConfig.tiny(), hidden_size=128,
                              num_heads=4, ffn_size=256)
    main, startup, loss = _recipe(cfg)
    exe, scope = _exe(), pt.Scope()
    exe.run(startup, scope=scope)
    _nan_step_rolls_back(exe, main, loss, _bert_feed(cfg.vocab_size), scope)
