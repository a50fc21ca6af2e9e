"""The port's dataset trainer (``core/trainer.py`` behind
``Executor.train_from_dataset``) against the JAX package's on the CPU,
from the same startup weights (the JAX startup's, carried across with
``io.load_params``) and the same MultiSlot files.

* tests/test_data_pipeline.py's CTR program (:97; Adam, an embedding
  with a padding id, an in-graph label) over an InMemoryDataset after
  ``local_shuffle(0)``, 7 epochs of 2 chunks of 4 steps, and its
  threaded-feed SGD program (:142) over a QueueDataset: every chunk's
  mean loss (as each trainer prints it, to 6 places) and every epoch's
  last loss within 1e-5 relative;
* ``thread=2`` gives ``thread=0``'s losses and parameters bit for bit,
  its batches pulled by the "paddle_tpu-feed" thread;
* a ``drop_last=False`` remainder batch flushes its own chunk;
* ``chip_smoke.build_dataset_bert`` (phase 12c's program) at BERT-tiny
  width 128, dropout 0, K 2 and two chunks through both packages'
  default fusion pass (the JAX kernels in interpret mode): every chunk
  and last loss within 2e-3 (``_PARITY_TOL``).
"""
import dataclasses
import re
import threading

import numpy as np
import pytest

import chip_smoke as cs
import paddle_tpu as jpt
import paddle_tpu_torch as pt
from paddle_tpu import models as jmodels
from paddle_tpu_torch import models as pmodels

CHUNK_LINE = re.compile(r"\] step (\d+): .*=([-+0-9.e]+|nan|inf)$")


def _write_multislot(path, n, seed=0):
    """2 slots: sparse ids (u, ragged), dense feature (f, dim 3)."""
    rng = np.random.RandomState(seed)
    with open(path, "w") as f:
        for _ in range(n):
            n_ids = rng.randint(1, 6)
            ids = rng.randint(0, 100, n_ids)
            dense = rng.rand(3)
            parts = [str(n_ids)] + [str(v) for v in ids]
            parts += ["3"] + [f"{v:.4f}" for v in dense]
            f.write(" ".join(parts) + "\n")


def _ctr(P, opt="adam"):
    """The CTR program of tests/test_data_pipeline.py (:97, :142)."""
    main, startup = P.Program(), P.Program()
    startup.random_seed = 7
    with P.program_guard(main, startup), P.unique_name.guard():
        ids = P.data("ids", [None, 5], "int64")
        dense = P.data("dense", [None, 3], "float32")
        emb = P.layers.embedding(ids, (100, 8), padding_idx=0)
        pooled = P.layers.reduce_sum(emb, dim=1)
        concat = P.layers.concat([pooled, dense], axis=1)
        if opt == "adam":
            label_f = P.layers.reduce_sum(dense, dim=1, keep_dim=True)
            label = P.layers.cast(P.layers.greater_than(label_f, 1.5),
                                  "int64")
            label.stop_gradient = True
            logits = P.layers.fc(concat, 2)
            loss = P.layers.mean(
                P.layers.softmax_with_cross_entropy(logits, label))
            P.optimizer.Adam(1e-2).minimize(loss)
        else:
            target = P.layers.reduce_sum(dense, dim=1, keep_dim=True)
            target.stop_gradient = True
            pred = P.layers.fc(concat, 1)
            loss = P.layers.mean(P.layers.square_error_cost(pred, target))
            P.optimizer.SGD(1e-2).minimize(loss)
    return main, startup, [ids, dense], loss


def _dataset(P, kind, feeds, files, batch, k, drop_last=True):
    ds = P.DatasetFactory().create_dataset(kind)
    ds.set_batch_size(batch)
    ds.set_use_var(feeds)
    ds.set_filelist(files)
    ds.set_steps_per_dispatch(k)
    ds.drop_last = drop_last
    return ds


def _chunks(text):
    """(step, chunk mean) of every line a trainer printed."""
    return [(int(m.group(1)), float(m.group(2))) for m in
            map(CHUNK_LINE.search, text.splitlines()) if m]


def _jax_weights(main, startup):
    scope = jpt.Scope()
    with jpt.scope_guard(scope):
        jpt.Executor().run(startup)
    return scope, {v.name: np.asarray(scope.find_var(v.name))
                   for v in main.list_vars()
                   if v.persistable and scope.find_var(v.name) is not None}


def _port_scope(weights, main):
    scope = pt.Scope()
    pt.io.load_params(scope, weights, "cpu", program=main)
    return scope


def _train(P, exe, main, ds_fn, scope, epochs, capsys, thread=0,
           program=None):
    """``epochs`` train_from_dataset calls; (last losses, chunk means)."""
    lasts, chunks = [], []
    for _ in range(epochs):
        ds = ds_fn()
        out = exe.train_from_dataset(program or main, ds, scope=scope,
                                     fetch_list=[main._loss_name],
                                     debug=True, thread=thread)
        lasts.append(float(np.asarray(out[0]).reshape(-1)[0]))
        chunks += _chunks(capsys.readouterr().out)
    return lasts, chunks


def _close(got, want, rtol):
    assert len(got) == len(want) > 0
    for (gs, g), (ws, w) in zip(got, want):
        assert gs == ws
        assert abs(g - w) <= rtol * abs(w) + 1e-6, (got, want)


@pytest.fixture()
def ctr_files(tmp_path):
    files = []
    for i in range(2):
        p = str(tmp_path / f"part-{i}")
        _write_multislot(p, 64, seed=i)
        files.append(p)
    return files


def test_ctr_adam_in_memory_matches_the_jax_trainer(ctr_files, capsys):
    jmain, jstartup, jfeeds, jloss = _ctr(jpt)
    jmain._loss_name = jloss.name
    jscope, weights = _jax_weights(jmain, jstartup)

    def jds():
        ds = _dataset(jpt, "InMemoryDataset", jfeeds, ctr_files, 16, 4)
        ds.load_into_memory()
        ds.local_shuffle(seed=0)
        return ds

    with jpt.scope_guard(jscope):
        jl, jc = _train(jpt, jpt.Executor(), jmain, jds, jscope, 7, capsys)
    main, _, feeds, loss = _ctr(pt)
    main._loss_name = loss.name

    def pds():
        ds = _dataset(pt, "InMemoryDataset", feeds, ctr_files, 16, 4)
        ds.load_into_memory()
        ds.local_shuffle(seed=0)
        return ds

    scope = _port_scope(weights, main)
    pl, pc = _train(pt, pt.Executor(pt.CPUPlace()), main, pds, scope, 7,
                    capsys)
    assert [s for s, _ in pc] == [4, 8] * 7
    _close(pc, jc, 1e-5)
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    assert pl[-1] < pl[0]


def _sgd_files(tmp_path):
    files = []
    for i in range(4):
        p = str(tmp_path / f"sgd-{i}")
        _write_multislot(p, 32, seed=10 + i)
        files.append(p)
    return files


def test_threaded_sgd_matches_the_jax_trainer_and_thread_0(tmp_path,
                                                           capsys):
    files = _sgd_files(tmp_path)
    jmain, jstartup, jfeeds, jloss = _ctr(jpt, "sgd")
    jmain._loss_name = jloss.name
    jscope, weights = _jax_weights(jmain, jstartup)
    with jpt.scope_guard(jscope):
        jl, jc = _train(jpt, jpt.Executor(), jmain, lambda: _dataset(
            jpt, "QueueDataset", jfeeds, files, 8, 2), jscope, 2, capsys,
            thread=2)
    runs = {}
    for thread in (0, 2):
        main, _, feeds, loss = _ctr(pt, "sgd")
        main._loss_name = loss.name
        scope = _port_scope(weights, main)
        names = set()

        def ds_fn():
            ds = _dataset(pt, "QueueDataset", feeds, files, 8, 2)
            orig = ds.batches

            def spy():
                for b in orig():
                    names.add(threading.current_thread().name)
                    yield b

            ds.batches = spy
            return ds

        lasts, chunks = _train(pt, pt.Executor(pt.CPUPlace()), main, ds_fn,
                               scope, 2, capsys, thread=thread)
        params = {n: scope.find_var(n).numpy().copy() for n in weights}
        runs[thread] = (lasts, chunks, params, names)
    (l0, c0, p0, n0), (l2, c2, p2, n2) = runs[0], runs[2]
    assert n0 == {"MainThread"} and n2 == {"paddle_tpu-feed"}
    assert l0 == l2 and c0 == c2
    for n in p0:
        np.testing.assert_array_equal(p0[n], p2[n])
    assert [s for s, _ in c2] == [2 * i for i in range(1, 9)] * 2
    _close(c2, jc, 1e-5)
    np.testing.assert_allclose(l2, jl, rtol=1e-5)


def test_a_remainder_batch_flushes_its_own_chunk(tmp_path, capsys):
    path = str(tmp_path / "part-0")
    _write_multislot(path, 35, seed=5)     # 4 batches of 8 and one of 3
    out = {}
    jmain, jstartup, jfeeds, jloss = _ctr(jpt, "sgd")
    jmain._loss_name = jloss.name
    jscope, weights = _jax_weights(jmain, jstartup)
    with jpt.scope_guard(jscope):
        out["jax"] = _train(jpt, jpt.Executor(), jmain, lambda: _dataset(
            jpt, "QueueDataset", jfeeds, [path], 8, 3, drop_last=False),
            jscope, 1, capsys)
    main, _, feeds, loss = _ctr(pt, "sgd")
    main._loss_name = loss.name
    scope = _port_scope(weights, main)
    out["port"] = _train(pt, pt.Executor(pt.CPUPlace()), main,
                         lambda: _dataset(pt, "QueueDataset", feeds, [path],
                                          8, 3, drop_last=False),
                         scope, 1, capsys)
    (pl, pc), (jl, jc) = out["port"], out["jax"]
    # chunks [b0 b1 b2], [b3], then the remainder alone (its shape
    # differs from the pending chunk's: b3 is flushed first)
    assert [s for s, _ in pc] == [3, 4, 5]
    _close(pc, jc, 1e-5)
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    sizes = sorted((k[1], {n: s for n, s, _ in k[2]}["ids"][0])
                   for k in main._exec_cache)
    assert sizes == [(1, 3), (1, 8), (3, 8)]


def test_bert_from_files_matches_the_jax_trainer(tmp_path, capsys,
                                                 monkeypatch):
    """Phase 12c's program at BERT-tiny width 128 (the JAX qkv-folded
    attention entry needs H % 128 == 0), dropout 0, through both
    packages' default fusion pass."""
    monkeypatch.setattr(cs, "TRAIN_SEQ", 16)
    monkeypatch.setattr(cs, "TRAIN_BATCH", 4)
    jcfg = dataclasses.replace(
        jmodels.BertConfig.tiny(), hidden_size=128, num_heads=4,
        ffn_size=256, num_layers=1, hidden_dropout=0.0, attn_dropout=0.0)
    cfg = pmodels.BertConfig(**dataclasses.asdict(jcfg))
    files = cs.write_bert_parts(tmp_path, 2, 8, 16, cfg.vocab_size)
    jmain, jstartup, jloss, jfeeds = cs.build_dataset_bert(
        jpt, jmodels, jcfg, 16, lr=1e-3)
    jmain._loss_name = jloss.name
    jscope, weights = _jax_weights(jmain, jstartup)
    monkeypatch.setenv("PADDLE_TPU_FUSED_MATMUL_INTERPRET", "1")
    with jpt.scope_guard(jscope):
        jl, jc = _train(jpt, jpt.Executor(), jmain, lambda: _dataset(
            jpt, "QueueDataset", jfeeds, files, 4, 2), jscope, 1, capsys)
    monkeypatch.delenv("PADDLE_TPU_FUSED_MATMUL_INTERPRET")
    main, _, loss, feeds = cs.build_dataset_bert(pt, pmodels, cfg, 16,
                                                 lr=1e-3)
    main._loss_name = loss.name
    scope = _port_scope(weights, main)
    pl, pc = _train(pt, pt.Executor(pt.CPUPlace()), main, lambda: _dataset(
        pt, "QueueDataset", feeds, files, 4, 2), scope, 1, capsys)
    assert [s for s, _ in pc] == [2, 4]
    (loop,) = main._exec_cache.values()
    kinds = sorted(g.kind for g in loop.fusion_plan.groups)
    assert kinds == ["attn", "ffn_chain", "gemm", "gemm"]
    _close(pc, jc, cs.PARITY_LOSS_TOL)
    np.testing.assert_allclose(pl, jl, atol=cs.PARITY_LOSS_TOL)
