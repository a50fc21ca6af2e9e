"""Program cloning, pruning and serialization, the Scope's parent chain,
and io save/load across the two packages, on the CPU.

* ``clone(for_test=True)`` turns dropout off in the unfused ops and
  inside every fused group (BERT-tiny at hidden 128 with dropout 0.1
  through the default fusion pass): two runs of the clone are
  bit-equal, and the clone's loss equals the same weights' loss through
  a program built at dropout 0 within 1e-6.
* ``prune`` keeps the ops the JAX package's prune keeps (uids and types).
* ``to_dict`` of the BERT recipe program equals the JAX package's (int64
  variables read as int32, which the JAX package's shape inference
  declares), and ``from_dict`` round-trips it.
* ``Scope``: the same sequence of operations gives the same answers as
  the JAX package's Scope.
* ``save/load_persistables`` and ``save/load_inference_model`` across
  the packages in both directions: every array bit-equal after load, and
  the loaded inference program's prediction within 1e-6 of the writer's.
"""
import dataclasses
import json

import numpy as np
import pytest

import paddle_tpu as jpt
import paddle_tpu_torch as pt
from paddle_tpu.models import BertConfig as JBertConfig
from paddle_tpu.models import build_bert_pretrain as jbuild
from paddle_tpu_torch.models import BertConfig, build_bert_pretrain
from test_torch_tensor_math_ops import narrowed

SEQ, BATCH = 32, 4


def _batch(vocab, seed):
    r = np.random.RandomState(seed)
    src = r.randint(0, vocab, (BATCH, SEQ)).astype(np.int64)
    mask = np.ones((BATCH, SEQ), np.float32)
    mask[0, SEQ - 5:] = 0.0
    labels = np.full((BATCH, SEQ, 1), -1, np.int64)
    pick = r.rand(BATCH, SEQ) < 0.2
    labels[pick] = src[pick][:, None]
    return {"src_ids": src, "input_mask": mask, "masked_labels": labels}


def _recipe(P, cfg):
    """BERT pretraining with the published recipe (warmup then linear
    decay, AdamW, global-norm clip); the eval clone taken before
    minimize."""
    main, startup = P.Program(), P.Program()
    startup.random_seed = 3
    main.random_seed = 4
    with P.program_guard(main, startup), P.unique_name.guard():
        loss, _ = (jbuild if P is jpt else build_bert_pretrain)(
            cfg, seq_len=SEQ)
        test = main.clone(for_test=True)
        lr = P.layers.linear_lr_warmup(
            P.layers.polynomial_decay(1e-4, decay_steps=12,
                                      end_learning_rate=0.0),
            warmup_steps=4, start_lr=0.0, end_lr=1e-4)
        P.optimizer.AdamW(
            lr, weight_decay=0.01,
            grad_clip=P.clip.GradientClipByGlobalNorm(1.0)).minimize(loss)
    return main, startup, test, loss


def _tiny(dropout, hidden=128):
    return dataclasses.replace(BertConfig.tiny(), hidden_size=hidden,
                               num_heads=4, ffn_size=256,
                               hidden_dropout=dropout, attn_dropout=dropout)


def test_clone_for_test_turns_dropout_off_in_fused_groups():
    cfg = _tiny(0.1)
    main, startup, test, loss = _recipe(pt, cfg)
    assert test.is_test and not main.is_test
    assert test._exec_cache is not main._exec_cache
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    feed = _batch(cfg.vocab_size, 0)
    (a,) = exe.run(test, feed=feed, fetch_list=[loss], scope=scope)
    (b,) = exe.run(test, feed=feed, fetch_list=[loss], scope=scope)
    assert a.tobytes() == b.tobytes()
    plans = [lw.fusion_plan for lw in test._exec_cache.values()]
    assert plans and all(p is not None and any(
        g.dropout is not None for g in p.groups) for p in plans)
    # the train program draws masks: its loss differs from the eval's
    (t,) = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    assert t.tobytes() != a.tobytes()

    # the same weights through a program built at dropout 0
    weights = {n: scope.find_var(n) for n in
               [v.name for v in test.list_vars() if v.persistable]}
    main0, _, test0, loss0 = _recipe(pt, _tiny(0.0))
    scope0 = pt.Scope()
    for n, v in weights.items():
        scope0.set_var(n, v)
    (want,) = exe.run(test0, feed=feed, fetch_list=[loss0], scope=scope0)
    np.testing.assert_allclose(a, want, rtol=1e-6)


def test_clone_for_test_of_the_unfused_lowering():
    cfg = _tiny(0.3, hidden=32)
    main, startup, test, loss = _recipe(pt, cfg)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    bs = pt.BuildStrategy()
    bs.fuse_epilogues = False
    feed = _batch(cfg.vocab_size, 1)
    runs = [exe.run(pt.CompiledProgram(test, build_strategy=bs), feed=feed,
                    fetch_list=[loss], scope=scope)[0] for _ in range(2)]
    assert runs[0].tobytes() == runs[1].tobytes()
    fused = exe.run(test, feed=feed, fetch_list=[loss], scope=scope)[0]
    np.testing.assert_allclose(fused, runs[0], rtol=1e-5)


def test_prune_keeps_the_jax_packages_ops():
    def build(P):
        main, startup = P.Program(), P.Program()
        with P.program_guard(main, startup), P.unique_name.guard():
            x = P.data("x", [4, 6])
            y = P.data("y", [4, 1])
            h = P.layers.fc(x, 8, act="relu")
            h = P.layers.dropout(h, 0.2)
            pred = P.layers.fc(h, 1)
            loss = P.layers.mean(P.layers.square_error_cost(pred, y))
            lr = P.layers.exponential_decay(0.1, 5, 0.5)
            P.optimizer.Momentum(lr, 0.9).minimize(loss)
        return main, pred, loss

    (jmain, jpred, jloss), (main, pred, loss) = build(jpt), build(pt)
    for t, jt in ((pred, jpred), (loss, jloss)):
        got = main.prune([t]).global_block()
        want = jmain.prune([jt]).global_block()
        assert [(o.uid, o.type) for o in got.ops] == \
            [(o.uid, o.type) for o in want.ops]
        assert list(got.vars) == list(want.vars)
    assert "increment" not in [o.type for o in
                               main.prune([loss]).global_block().ops]


def test_to_dict_equals_the_jax_packages_and_round_trips():
    cfg = _tiny(0.1)
    main, _, test, _ = _recipe(pt, cfg)
    jmain, _, jtest, _ = _recipe(jpt, JBertConfig(**dataclasses.asdict(cfg)))
    for got, want in ((main, jmain), (test, jtest)):
        d = got.to_dict()
        assert narrowed(d) == narrowed(want.to_dict())
        back = pt.Program.from_dict(json.loads(json.dumps(d)))
        assert back.to_dict() == json.loads(json.dumps(d))
        # a JAX desc loads in the port
        assert narrowed(pt.Program.from_dict(want.to_dict()).to_dict()) \
            == narrowed(want.to_dict())


def test_block_helpers():
    p = pt.Program()
    blk = p.create_block()
    assert p.current_block() is blk and blk.parent_idx == 0
    p.rollback()
    assert p.current_block() is p.global_block()
    gb = p.global_block()
    gb.append_op("fill_constant", outputs={"Out": ["a"]},
                 attrs={"shape": [1], "value": 1.0, "dtype": "float32"})
    op = gb.prepend_op("fill_constant", outputs={"Out": ["b"]},
                       attrs={"shape": (1,), "value": np.float32(2.0),
                              "dtype": "float32"})
    assert gb.ops[0] is op and op.to_dict()["attrs"]["shape"] == [1]
    assert isinstance(op.to_dict()["attrs"]["value"], float)


def _scope_script(S):
    root = S()
    root.set_var("a", 1)
    kid = root.new_scope()
    kid.set_var("b", 2)
    grandkid = kid.new_scope()
    out = [root.find_var("b"), kid.find_var("a"), grandkid.find_var("a"),
           grandkid.has_var("b"), root.has_var("b"), kid.var("c"),
           sorted(kid.local_var_names()), grandkid.find_var("zz")]
    kid.set_var("a", 5)
    out += [grandkid.find_var("a"), root.find_var("a")]
    kid.erase("a")
    out += [grandkid.find_var("a"), kid.has_var("c")]
    root.drop_kids()
    out += [len(root._kids), repr(kid)]
    return out


def test_scope_parent_chain_matches_the_jax_scope():
    assert _scope_script(pt.Scope) == _scope_script(jpt.Scope)


# -- io across the packages ------------------------------------------------

def _fc(P):
    main, startup = P.Program(), P.Program()
    startup.random_seed = 9
    with P.program_guard(main, startup), P.unique_name.guard():
        x = P.data("x", [None, 6])
        y = P.data("y", [None, 1])
        h = P.layers.fc(x, 8, act="tanh")
        pred = P.layers.fc(h, 1)
        loss = P.layers.mean(P.layers.square_error_cost(pred, y))
        lr = P.layers.inverse_time_decay(0.1, 3, 0.5)
        P.optimizer.Adam(lr).minimize(loss)
    return main, startup, pred, loss


def _feed(step):
    r = np.random.RandomState(20 + step)
    return {"x": r.rand(5, 6).astype(np.float32),
            "y": r.rand(5, 1).astype(np.float32)}


def _train_jax(steps=3):
    main, startup, pred, loss = _fc(jpt)
    exe = jpt.Executor()
    exe.run(startup)
    for s in range(steps):
        exe.run(main, feed=_feed(s), fetch_list=[loss])
    scope = jpt.global_scope()
    state = {v.name: np.asarray(scope.find_var(v.name))
             for v in main.list_vars() if v.persistable}
    return main, exe, pred, state


def _train_port(steps=3):
    main, startup, pred, loss = _fc(pt)
    exe = pt.Executor(pt.CPUPlace())
    exe.run(startup)
    for s in range(steps):
        exe.run(main, feed=_feed(s), fetch_list=[loss])
    scope = pt.global_scope()
    state = {v.name: scope.find_var(v.name).numpy()
             for v in main.list_vars() if v.persistable}
    return main, exe, pred, state


def _same_arrays(got, want):
    assert set(got) == set(want)
    for n in want:
        g, w = np.asarray(got[n]), np.asarray(want[n])
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=n)
        else:
            assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), n


def test_persistables_from_the_jax_package_load_in_the_port(tmp_path):
    with jpt.new_program_scope():
        jmain, jexe, _, want = _train_jax()
        jpt.io.save_persistables(jexe, str(tmp_path), jmain)
    with pt.new_program_scope():
        main, _, _, _ = _fc(pt)
        pt.io.load_persistables(pt.Executor(pt.CPUPlace()), str(tmp_path),
                                main)
        scope = pt.global_scope()
        _same_arrays({n: scope.find_var(n) for n in want}, want)
        # the scope's numpy values run: the executor places and casts them
        pt.Executor(pt.CPUPlace()).run(main, feed=_feed(5),
                                       fetch_list=["@LR_DECAY_COUNTER@"])


def test_persistables_from_the_port_load_in_the_jax_package(tmp_path):
    with pt.new_program_scope():
        main, exe, _, want = _train_port()
        pt.io.save_persistables(exe, str(tmp_path), main)
        pt.io.save_params(exe, str(tmp_path / "params"), main)
    with jpt.new_program_scope():
        jmain, _, _, _ = _fc(jpt)
        jpt.io.load_persistables(jpt.Executor(), str(tmp_path), jmain)
        scope = jpt.global_scope()
        _same_arrays({n: scope.find_var(n) for n in want}, want)
    with np.load(tmp_path / "params" / "__params__.npz") as z:
        assert sorted(z.files) == sorted(
            p.name for p in main.all_parameters())


def test_inference_model_from_the_jax_package_runs_in_the_port(tmp_path):
    feed = _feed(7)
    with jpt.new_program_scope():
        jmain, jexe, jpred, _ = _train_jax()
        jpt.io.save_inference_model(str(tmp_path), ["x"], [jpred], jexe,
                                    jmain)
        jprog, _, jfetch = jpt.io.load_inference_model(str(tmp_path), jexe)
        (want,) = jexe.run(jprog, feed={"x": feed["x"]},
                           fetch_list=jfetch)
        jscope = jpt.global_scope()
        arrays = {v.name: np.asarray(jscope.find_var(v.name))
                  for v in jprog.list_vars() if v.persistable}
    with pt.new_program_scope():
        exe = pt.Executor(pt.CPUPlace())
        prog, feeds, fetch = pt.io.load_inference_model(str(tmp_path), exe)
        assert prog.is_test and feeds == ["x"]
        scope = pt.global_scope()
        _same_arrays({n: scope.find_var(n) for n in arrays}, arrays)
        (got,) = exe.run(prog, feed={"x": feed["x"]}, fetch_list=fetch)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6)


def test_inference_model_from_the_port_runs_in_the_jax_package(tmp_path):
    feed = _feed(8)
    with pt.new_program_scope():
        main, exe, pred, _ = _train_port()
        names = pt.io.save_inference_model(str(tmp_path), ["x"], [pred],
                                           exe, main)
        assert names == [pred.name]
        prog, _, fetch = pt.io.load_inference_model(str(tmp_path), exe)
        (want,) = exe.run(prog, feed={"x": feed["x"]}, fetch_list=fetch)
        scope = pt.global_scope()
        arrays = {v.name: np.asarray(scope.find_var(v.name))
                  for v in prog.list_vars() if v.persistable}
        assert "@LR_DECAY_COUNTER@" not in arrays      # pruned away
    with jpt.new_program_scope():
        jexe = jpt.Executor()
        jprog, _, jfetch = jpt.io.load_inference_model(str(tmp_path), jexe)
        jscope = jpt.global_scope()
        _same_arrays({n: np.asarray(jscope.find_var(n)) for n in arrays},
                     arrays)
        (got,) = jexe.run(jprog, feed={"x": feed["x"]}, fetch_list=jfetch)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-6)


def test_gradients_of_an_input():
    with pt.new_program_scope():
        x = pt.data("x", [3, 4])
        y = pt.layers.reduce_sum(pt.layers.square(x))
        (gx,) = pt.gradients(y, x)
        exe = pt.Executor(pt.CPUPlace())
        xv = np.arange(12, dtype=np.float32).reshape(3, 4)
        (got,) = exe.run(feed={"x": xv}, fetch_list=[gx])
    np.testing.assert_allclose(got, 2 * xv)


def test_train_from_dataset_waits_for_the_trainer():
    exe = pt.Executor(pt.CPUPlace())
    with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
        exe.train_from_dataset(pt.Program(), None)
    with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
        exe.infer_from_dataset(pt.Program(), None)
    exe.close()
