"""The sequence tier's programs through the port against the JAX package
on the CPU, from the JAX startup's weights (``io.load_params``): the GRU
seq2seq (``seq2seq_train`` under Adadelta and a global-norm clip, as
``chip_smoke.py`` phase 21a trains it, then its greedy and beam
decoders on the trained weights), the n-gram word2vec, and the book's
sentiment-conv and recommender programs (tests/test_book_extras.py) on
seeded synthetic ids.

Each program has the JAX package's IR (every block, op for op), its
parameter names and the JAX planner's fusion plan, group for group
(word2vec's and the book programs' fcs are GEMM groups; seq2seq has none:
its decoder's fcs live in the StaticRNN sub-block and the encoder's
projection has no bias).  Losses within 2e-3 over 5 steps, parameters
within 1e-3; greedy and beam tokens exactly equal.
"""
import numpy as np
import pytest

import paddle_tpu as jpt
import paddle_tpu_torch as pt
from paddle_tpu.core import fusion as jfusion
from paddle_tpu.models import seq2seq as jseq2seq
from paddle_tpu_torch.core import fusion
from test_torch_fusion import _describe

LOSS_TOL = 2e-3
PARAM_TOL = 1e-3
STEPS = 5
S, T, B, SRC_V, TGT_V, E, H, K = 6, 5, 4, 40, 30, 16, 16, 3


def _ir(program):
    return [[(op.type, op.inputs, op.outputs) for op in blk.ops]
            for blk in program.blocks]


def _params(program):
    return [(p.name, list(p.shape))
            for p in program.global_block().all_parameters()]


def _persistables(main, get):
    return {v.name: np.asarray(get(v.name)).copy()
            for v in main.list_vars() if v.persistable}


def _both(build, feed, steps=STEPS, seed=7):
    """``build(P)`` -> (main, startup, loss, feed names) in each package;
    the JAX run's ``steps`` losses and final persistables beside the
    port's from the same startup weights, with both plans."""
    out = {}
    for tag, P in (("jax", jpt), ("port", pt)):
        main, startup = P.Program(), P.Program()
        startup.random_seed = seed
        with P.program_guard(main, startup), P.unique_name.guard():
            loss, names = build(P)
        planner = jfusion if P is jpt else fusion
        plan = _describe(planner.plan_fusion(
            main, list(main.global_block().ops), names, [loss.name],
            block_patterns=True))
        out[tag] = dict(main=main, loss=loss, plan=plan)
        if P is jpt:
            scope = jpt.Scope()
            with jpt.scope_guard(scope):
                exe = jpt.Executor()
                exe.run(startup)
                init = _persistables(main, scope.find_var)
                losses = [float(exe.run(main, feed=feed,
                                        fetch_list=[loss])[0])
                          for _ in range(steps)]
                final = _persistables(main, scope.find_var)
        else:
            scope = pt.Scope()
            pt.io.load_params(scope, init, "cpu", program=main)
            exe = pt.Executor(pt.CPUPlace())
            losses = [float(exe.run(main, feed=feed, fetch_list=[loss],
                                    scope=scope)[0]) for _ in range(steps)]
            final = {n: scope.find_var(n).detach().numpy()
                     for n in init}
        out[tag].update(losses=np.asarray(losses), final=final)
    return out


def _check(runs, want_groups):
    j, p = runs["jax"], runs["port"]
    assert _ir(p["main"]) == _ir(j["main"])
    assert _params(p["main"]) == _params(j["main"])
    assert p["plan"] == j["plan"]
    groups = [] if p["plan"] is None else p["plan"]["groups"]
    assert [g["pattern"] for g in groups] == want_groups
    assert np.isfinite(p["losses"]).all()
    assert np.abs(p["losses"] - j["losses"]).max() < LOSS_TOL, (
        p["losses"], j["losses"])
    dparam = max(float(np.abs(p["final"][n].astype(np.float64)
                              - np.asarray(j["final"][n], np.float64)).max())
                 for n in j["final"]
                 if np.issubdtype(np.asarray(j["final"][n]).dtype,
                                  np.floating))
    assert dparam < PARAM_TOL, dparam
    assert p["losses"][-1] < p["losses"][0]


# -- seq2seq -----------------------------------------------------------------

def _s2s_feed():
    r = np.random.RandomState(0)
    src = r.randint(2, SRC_V, (B, S)).astype(np.int64)
    tgt = r.randint(2, TGT_V, (B, T)).astype(np.int64)
    return {"src": src, "tgt_out": tgt, "tgt_in": np.concatenate(
        [np.zeros((B, 1), np.int64), tgt[:, :-1]], 1)}


def _s2s_train(P):
    src = P.data("src", [None, S], "int64")
    tgt_in = P.data("tgt_in", [None, T], "int64")
    tgt_out = P.data("tgt_out", [None, T], "int64")
    loss, _ = P.models.seq2seq_train(src, tgt_in, tgt_out, SRC_V, TGT_V,
                                     embed_dim=E, hidden_dim=H)
    P.optimizer.Adadelta(
        1.0, epsilon=1e-6, rho=0.95,
        grad_clip=P.clip.GradientClipByGlobalNorm(1.0)).minimize(loss)
    return loss, ["src", "tgt_in", "tgt_out"]


@pytest.fixture(scope="module")
def s2s_runs():
    return _both(_s2s_train, _s2s_feed())


def test_seq2seq_trains_as_the_jax_package(s2s_runs):
    _check(s2s_runs, [])
    ops = [op.type for op in s2s_runs["port"]["main"].global_block().ops]
    assert {"gru", "static_rnn", "adadelta"} <= set(ops), ops


def _decoder(P, kind):
    models = (P.models if P is pt else jseq2seq)
    main = P.Program()
    with P.program_guard(main, P.Program()), P.unique_name.guard():
        src = P.data("src", [B, S], "int64")
        if kind == "greedy":
            fetch = [models.seq2seq_greedy_infer(
                src, SRC_V, TGT_V, max_len=T, bos_id=0, embed_dim=E,
                hidden_dim=H)]
        else:
            fetch = list(models.seq2seq_beam_search_infer(
                src, SRC_V, TGT_V, max_len=T, beam_size=K, bos_id=0,
                end_id=1, embed_dim=E, hidden_dim=H))
    return main, fetch


@pytest.mark.parametrize("kind", ["greedy", "beam"])
def test_decoders_give_the_jax_tokens(s2s_runs, kind):
    """On the JAX run's trained weights: the same ids, exactly (and the
    beam scores within 1e-5)."""
    weights = s2s_runs["jax"]["final"]
    feed = {"src": _s2s_feed()["src"]}
    jmain, jfetch = _decoder(jpt, kind)
    scope = jpt.Scope()
    with jpt.scope_guard(scope):
        for n in (v.name for v in jmain.list_vars() if v.persistable):
            scope.set_var(n, weights[n])
        want = jpt.Executor().run(jmain, feed=feed, fetch_list=jfetch)
    main, fetch = _decoder(pt, kind)
    assert _ir(main) == _ir(jmain)
    pscope = pt.Scope()
    pt.io.load_params(pscope, {n: weights[n] for n in
                               pt.io.persistable_names(main)}, "cpu",
                      program=main)
    got = pt.Executor(pt.CPUPlace()).run(main, feed=feed, fetch_list=fetch,
                                         scope=pscope)
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    assert got[0].shape == ((T, B, 1) if kind == "greedy" else (T, B, K))
    if kind == "beam":
        np.testing.assert_allclose(got[1], np.asarray(want[1]), rtol=1e-5,
                                   atol=1e-5)


def test_beam_decoder_needs_a_static_batch():
    with pt.new_program_scope():
        src = pt.data("src", [None, S], "int64")
        with pytest.raises(ValueError, match="STATIC batch"):
            pt.models.seq2seq_beam_search_infer(src, SRC_V, TGT_V, 3)


# -- word2vec and the book's text programs ----------------------------------

DICT, N_CTX = 50, 4


def _w2v(P):
    words = [P.data(f"w{i}", [None, 1], "int64") for i in range(N_CTX)]
    target = P.data("target", [None, 1], "int64")
    _, loss = P.models.word2vec_ngram(words, target, DICT, embed_size=8,
                                      hidden_size=36)
    P.optimizer.Adam(0.05).minimize(loss)
    return loss, [f"w{i}" for i in range(N_CTX)] + ["target"]


def test_word2vec_matches_the_jax_package():
    r = np.random.RandomState(0)
    ctx = r.randint(0, DICT, (16, N_CTX)).astype(np.int64)
    feed = {f"w{i}": ctx[:, i:i + 1] for i in range(N_CTX)}
    feed["target"] = (ctx.sum(1, keepdims=True) % DICT).astype(np.int64)
    runs = _both(_w2v, feed)
    _check(runs, ["mul+bias", "mul+bias"])
    assert [n for n, _ in _params(runs["port"]["main"])].count(
        "shared_w") == 1


SENT_T, SENT_V = 10, 60


def _sentiment(P):
    """tests/test_book_extras.py's convolution_net."""
    L = P.layers
    words = P.data("words", [None, SENT_T], "int64")
    seq_len = P.data("seq_len", [None], "int64")
    label = P.data("label", [None, 1], "int64")
    emb = L.embedding(words, [SENT_V, 8])
    conv3 = P.nets.sequence_conv_pool(emb, num_filters=8, filter_size=3,
                                      act="tanh", seq_len=seq_len)
    conv4 = P.nets.sequence_conv_pool(emb, num_filters=8, filter_size=4,
                                      act="tanh", seq_len=seq_len)
    logits = L.fc(L.concat([conv3, conv4], axis=-1), 2)
    loss = L.mean(L.softmax_with_cross_entropy(logits, label))
    P.optimizer.Adam(0.02).minimize(loss)
    return loss, ["words", "seq_len", "label"]


def _ragged_ids(r, n, t, vocab, min_len=1):
    lens = r.randint(min_len, t + 1, (n,)).astype(np.int64)
    ids = r.randint(1, vocab, (n, t)).astype(np.int64)
    ids[np.arange(t)[None, :] >= lens[:, None]] = 0
    return ids, lens


def test_book_sentiment_conv_matches_the_jax_package():
    r = np.random.RandomState(1)
    ids, lens = _ragged_ids(r, 12, SENT_T, SENT_V)
    feed = {"words": ids, "seq_len": lens,
            "label": r.randint(0, 2, (12, 1)).astype(np.int64)}
    _check(_both(_sentiment, feed), ["mul+bias"])


CAT_T, TITLE_T = 4, 6
USR, GENDERS, AGES, JOBS, MOV, CATS, TITLE = 20, 2, 7, 21, 30, 18, 40


def _recommender(P):
    """tests/test_book_extras.py's recommender: a user tower and a movie
    tower (id embedding, category sum-pool, title sequence_conv_pool),
    cos_sim scaled to the rating range, square error."""
    L, N = P.layers, P.nets
    uid = P.data("uid", [None, 1], "int64")
    gender = P.data("gender", [None, 1], "int64")
    age = P.data("age", [None, 1], "int64")
    job = P.data("job", [None, 1], "int64")
    usr = L.fc(L.concat([
        L.fc(L.embedding(uid, [USR, 32]), 32),
        L.fc(L.embedding(gender, [GENDERS, 16]), 16),
        L.fc(L.embedding(age, [AGES, 16]), 16),
        L.fc(L.embedding(job, [JOBS, 16]), 16)], axis=-1), 64, act="tanh")
    mid = P.data("mid", [None, 1], "int64")
    cats = P.data("cats", [None, CAT_T], "int64")
    cats_len = P.data("cats_len", [None], "int64")
    title = P.data("title", [None, TITLE_T], "int64")
    title_len = P.data("title_len", [None], "int64")
    mov = L.fc(L.concat([
        L.fc(L.embedding(mid, [MOV, 32]), 32),
        L.sequence_pool(L.embedding(cats, [CATS, 16]), "sum",
                        seq_len=cats_len),
        N.sequence_conv_pool(L.embedding(title, [TITLE, 16]),
                             num_filters=16, filter_size=3, act="tanh",
                             seq_len=title_len)], axis=-1), 64, act="tanh")
    score = P.data("score", [None, 1])
    sim = L.scale(L.cos_sim(usr, mov), scale=5.0)
    loss = L.mean(L.square_error_cost(sim, score))
    P.optimizer.Adam(0.02).minimize(loss)
    return loss, ["uid", "gender", "age", "job", "mid", "cats", "cats_len",
                  "title", "title_len", "score"]


def test_book_recommender_matches_the_jax_package():
    r = np.random.RandomState(2)
    n = 16
    col = lambda hi: r.randint(0, hi, (n, 1)).astype(np.int64)  # noqa: E731
    cats, cats_len = _ragged_ids(r, n, CAT_T, CATS)
    title, title_len = _ragged_ids(r, n, TITLE_T, TITLE)
    feed = {"uid": col(USR), "gender": col(GENDERS), "age": col(AGES),
            "job": col(JOBS), "mid": col(MOV), "cats": cats,
            "cats_len": cats_len, "title": title, "title_len": title_len,
            "score": (r.rand(n, 1) * 5).astype(np.float32)}
    runs = _both(_recommender, feed)
    _check(runs, ["mul+bias"] * 7)
    ops = {op.type for op in runs["port"]["main"].global_block().ops}
    assert "cos_sim" in ops
