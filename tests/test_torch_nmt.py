"""The Transformer NMT through the port — its ops (label_smooth,
gather_nd, beam_search, beam_search_decode), ``build_nmt_train`` through
``Adam.minimize`` and ``Executor.run``, and ``build_nmt_beam_infer`` —
against the JAX package on the CPU, from the same weights.

* Ops: numpy-seeded inputs through both ops' compute functions, with
  ties among the beam candidates (the lower index first) and finished
  beams (they keep their score and do not fork); outputs within 1e-6,
  ids exactly; label_smooth's gradient within 1e-6.
* Training: d_model 128, 4 heads, FFN 256, 2 + 2 layers, vocab 96, Ts 16
  ≠ Tt 12 with padded rows in both masks, dropout 0, 5 Adam(1e-3)
  steps, with the fusion pass (the JAX kernels in interpret mode,
  ``PADDLE_TPU_FUSED_MATMUL_INTERPRET=1``, at the width their entries
  take) and without; the JAX startup's weights carried into the port
  with ``io.load_params``; every loss within 2e-3 (``_PARITY_TOL``).
* The beam decoder at ``NMTConfig.tiny()`` (B 2, K 3, T 6): ids equal,
  scores within 1e-5.

ResNet under a data mesh (sync-BN) is held in test_torch_sync_bn.py.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as jpt
import paddle_tpu_torch as pt
from paddle_tpu.compiler import BuildStrategy as JBuildStrategy
from paddle_tpu.compiler import CompiledProgram as JCompiledProgram
from paddle_tpu.core.registry import REGISTRY as JREG
from paddle_tpu.core.registry import OpContext as JCtx
from paddle_tpu.models import NMTConfig as JNMTConfig
from paddle_tpu.models import build_nmt_beam_infer as jbeam
from paddle_tpu.models import build_nmt_train as jtrain
from paddle_tpu_torch.core.registry import REGISTRY as PREG
from paddle_tpu_torch.core.registry import OpContext as PCtx
from paddle_tpu_torch.models import NMTConfig, build_nmt_beam_infer, \
    build_nmt_train

LOSS_TOL = 2e-3
OP_TOL = dict(rtol=1e-6, atol=1e-6)


# -- ops ---------------------------------------------------------------------

def _probs(r, *shape):
    e = np.exp(r.randn(*shape).astype(np.float32))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _tied_probs(r):
    """[2, 3, 5] with equal candidates across beams and within a row."""
    p = np.full((2, 3, 5), 0.2, np.float32)
    p[1, 0] = [0.4, 0.1, 0.1, 0.3, 0.1]
    return p


CASES = {
    "label_smooth": ("label_smooth", lambda r: {
        "X": np.eye(7, dtype=np.float32)[r.randint(0, 7, (3, 4))]},
        {"epsilon": 0.1}),
    "label_smooth_prior": ("label_smooth", lambda r: {
        "X": np.eye(5, dtype=np.float32)[r.randint(0, 5, (6,))],
        "PriorDist": _probs(r, 1, 5)}, {"epsilon": 0.25}),
    "gather_nd_rows": ("gather_nd", lambda r: {
        "X": r.randn(4, 3, 2).astype(np.float32),
        "Index": np.array([[2], [0], [3]], np.int32)}, {}),
    "gather_nd_pairs": ("gather_nd", lambda r: {
        "X": r.randn(2, 3, 5).astype(np.float32),
        "Index": np.array([[[0, 2], [1, 1], [0, 0]],
                           [[1, 0], [1, 2], [0, 1]]], np.int32)}, {}),
    "gather_nd_full": ("gather_nd", lambda r: {
        "X": r.randint(0, 50, (3, 4)).astype(np.int64),
        "Index": np.array([[0, 3], [2, 1]], np.int64)}, {}),
    "beam_first_step": ("beam_search", lambda r: {
        "pre_ids": np.zeros((2, 3), np.int64),
        "pre_scores": np.array([[0, -1e30, -1e30]] * 2, np.float32),
        "scores": _probs(r, 2, 3, 7)},
        {"beam_size": 3, "end_id": 1, "is_accumulated": False}),
    "beam_finished": ("beam_search", lambda r: {
        "pre_ids": np.array([[1, 4, 2], [3, 1, 1]], np.int64),
        "pre_scores": np.array([[-0.5, -1.0, -2.0], [-0.7, -0.2, -3.0]],
                               np.float32),
        "scores": _probs(r, 2, 3, 6)},
        {"beam_size": 3, "end_id": 1, "is_accumulated": False}),
    "beam_ties": ("beam_search", lambda r: {
        "pre_ids": np.array([[2, 3, 4], [2, 3, 4]], np.int64),
        "pre_scores": np.zeros((2, 3), np.float32),
        "scores": _tied_probs(r)},
        {"beam_size": 3, "end_id": 1, "is_accumulated": False}),
    "beam_accumulated_ids": ("beam_search", lambda r: {
        "pre_ids": np.array([[5, 1], [2, 3]], np.int64),
        "pre_scores": np.array([[-1.0, -0.5], [-0.2, -0.4]], np.float32),
        "ids": r.randint(10, 99, (2, 2, 4)).astype(np.int64),
        "scores": -r.rand(2, 2, 4).astype(np.float32) * 3},
        {"beam_size": 2, "end_id": 1, "is_accumulated": True}),
    "beam_search_decode": ("beam_search_decode", lambda r: {
        "Ids": r.randint(0, 9, (5, 2, 3)).astype(np.int64),
        "Scores": -r.rand(5, 2, 3).astype(np.float32),
        "ParentIdx": r.randint(0, 3, (5, 2, 3)).astype(np.int32)},
        {"beam_size": 3, "end_id": 1}),
    "beam_search_decode_one_step": ("beam_search_decode", lambda r: {
        "Ids": r.randint(0, 9, (1, 2, 3)).astype(np.int64),
        "Scores": -r.rand(1, 2, 3).astype(np.float32),
        "ParentIdx": r.randint(0, 3, (1, 2, 3)).astype(np.int32)},
        {"beam_size": 3, "end_id": 1}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_matches_the_jax_package(case):
    op_type, make, attrs = CASES[case]
    r = np.random.RandomState(sorted(CASES).index(case))
    inputs = make(r)
    jins = {k: [jnp.asarray(v)] for k, v in inputs.items()}
    pins = {k: [torch.as_tensor(v)] for k, v in inputs.items()}
    jout = JREG.get(op_type).compute(JCtx(attrs=attrs), jins, attrs)
    pout = PREG.get(op_type).compute(PCtx(attrs=attrs, device="cpu"), pins,
                                     attrs)
    assert sorted(jout) == sorted(pout)
    for slot in jout:
        want = np.asarray(jout[slot][0])
        got = pout[slot][0].detach().numpy()
        assert got.shape == want.shape, slot
        if np.issubdtype(want.dtype, np.integer):
            np.testing.assert_array_equal(got, want, err_msg=slot)
        else:
            assert got.dtype == want.dtype, slot
            np.testing.assert_allclose(got, want, err_msg=slot, **OP_TOL)


def test_finished_beams_keep_their_score_and_do_not_fork():
    attrs = {"beam_size": 3, "end_id": 1, "is_accumulated": False}
    pre_ids = torch.tensor([[1, 1, 1]])
    pre_scores = torch.tensor([[-0.5, -1.0, -2.0]])
    scores = torch.full((1, 3, 4), 0.25)
    outs = PREG.get("beam_search").compute(
        PCtx(attrs=attrs), {"pre_ids": [pre_ids], "pre_scores": [pre_scores],
                            "scores": [scores]}, attrs)
    assert outs["selected_ids"][0].tolist() == [[1, 1, 1]]
    assert outs["parent_idx"][0].tolist() == [[0, 1, 2]]
    assert outs["selected_scores"][0].tolist() == [[-0.5, -1.0, -2.0]]


def test_label_smooth_gradient_matches():
    r = np.random.RandomState(5)
    x = r.rand(4, 6).astype(np.float32)
    cot = r.randn(4, 6).astype(np.float32)
    attrs = {"epsilon": 0.2}
    _, vjp = jax.vjp(lambda v: JREG.get("label_smooth").compute(
        JCtx(attrs=attrs), {"X": [v]}, attrs)["Out"][0], jnp.asarray(x))
    (jg,) = vjp(jnp.asarray(cot))
    xt = torch.as_tensor(x).requires_grad_()
    y = PREG.get("label_smooth").compute(PCtx(attrs=attrs), {"X": [xt]},
                                         attrs)["Out"][0]
    (pg,) = torch.autograd.grad(y, xt, torch.as_tensor(cot))
    np.testing.assert_allclose(pg.numpy(), np.asarray(jg), **OP_TOL)


# -- training ----------------------------------------------------------------

TS, TT, BATCH, STEPS = 16, 12, 4, 5


def _train_cfg(cls):
    return dataclasses.replace(
        cls(), vocab_size=96, d_model=128, num_heads=4, ffn_size=256,
        num_encoder_layers=2, num_decoder_layers=2, max_position=32,
        dropout=0.0, attn_dropout=0.0)


def _train_feed(seed=3):
    r = np.random.RandomState(seed)
    src_mask = np.ones((BATCH, TS), np.float32)
    src_mask[0, TS - 5:] = 0.0
    src_mask[2, TS - 2:] = 0.0
    tgt_mask = np.ones((BATCH, TT), np.float32)
    tgt_mask[1, TT - 4:] = 0.0
    tgt_mask[3, TT - 1:] = 0.0
    return {"src_ids": r.randint(2, 96, (BATCH, TS)).astype(np.int64),
            "src_mask": src_mask,
            "tgt_ids": r.randint(2, 96, (BATCH, TT)).astype(np.int64),
            "tgt_mask": tgt_mask,
            "labels": r.randint(2, 96, (BATCH, TT, 1)).astype(np.int64)}


def _persistables(main, get):
    return {v.name: np.asarray(get(v.name)).copy()
            for v in main.list_vars() if v.persistable}


@pytest.fixture(scope="module")
def monkeypatch_module():
    with pytest.MonkeyPatch.context() as mp:
        yield mp


@pytest.fixture(scope="module", params=["fused", "unfused"])
def nmt_runs(request, monkeypatch_module):
    fuse = request.param == "fused"
    feed = _train_feed()
    if fuse:
        monkeypatch_module.setenv("PADDLE_TPU_FUSED_MATMUL_INTERPRET", "1")
    with jpt.new_program_scope():
        main, startup = jpt.Program(), jpt.Program()
        startup.random_seed = 7
        with jpt.program_guard(main, startup), jpt.unique_name.guard():
            loss, _ = jtrain(_train_cfg(JNMTConfig), TS, TT)
            jpt.optimizer.Adam(1e-3).minimize(loss)
        bs = JBuildStrategy()
        bs.fuse_epilogues = fuse
        scope = jpt.Scope()
        with jpt.scope_guard(scope):
            exe = jpt.Executor()
            exe.run(startup)
            weights = _persistables(main, scope.find_var)
            jlosses = [float(exe.run(JCompiledProgram(main,
                                                      build_strategy=bs),
                                     feed=feed, fetch_list=[loss])[0])
                       for _ in range(STEPS)]
    monkeypatch_module.delenv("PADDLE_TPU_FUSED_MATMUL_INTERPRET",
                              raising=False)
    pmain, pstartup = pt.Program(), pt.Program()
    with pt.program_guard(pmain, pstartup), pt.unique_name.guard():
        ploss, _ = build_nmt_train(_train_cfg(NMTConfig), TS, TT)
        pt.optimizer.Adam(1e-3).minimize(ploss)
    pscope = pt.Scope()
    pt.io.load_params(pscope, weights, "cpu", program=pmain)
    pbs = pt.BuildStrategy()
    pbs.fuse_epilogues = fuse
    prog = pt.CompiledProgram(pmain, build_strategy=pbs)
    pexe = pt.Executor(pt.CPUPlace())
    losses = [float(pexe.run(prog, feed=feed, fetch_list=[ploss],
                             scope=pscope)[0]) for _ in range(STEPS)]
    plans = [lowered.fusion_plan for lowered in pmain._exec_cache.values()]
    return dict(fuse=fuse, jmain=main, main=pmain, jlosses=jlosses,
                losses=losses, plans=plans)


def test_nmt_programs_are_the_same_ir(nmt_runs):
    def ir(program):
        return [(op.type, op.inputs, op.outputs)
                for op in program.global_block().ops]

    assert ir(nmt_runs["main"]) == ir(nmt_runs["jmain"])


def test_nmt_losses_match_the_jax_package_every_step(nmt_runs):
    got, want = np.asarray(nmt_runs["losses"]), np.asarray(
        nmt_runs["jlosses"])
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() < LOSS_TOL, (got, want)
    assert got[-1] < got[0]


def test_nmt_fused_run_plans_the_groups(nmt_runs):
    for plan in nmt_runs["plans"]:
        if not nmt_runs["fuse"]:
            assert plan is None
            continue
        pats = [g.pattern for g in plan.groups]
        # 2 + 2 layers: four self-attentions, two cross-attention q/kv
        # pairs, the FFNs with relu, the residual norms
        assert pats.count("mul+bias+slice3+attention") == 4
        assert pats.count("mul+bias") == 4
        assert pats.count(
            "mul+bias+relu+mul+bias+residual+layer_norm") == 4
        assert pats.count("mul+bias+residual+layer_norm") == 6


def test_the_tied_embedding_collects_three_uses():
    """``nmt.word_emb`` gets one gradient term from the source
    embedding, the target embedding and the output projection, summed."""
    with pt.new_program_scope():
        loss, _ = build_nmt_train(NMTConfig.tiny(), 8, 6)
        pt.optimizer.SGD(0.1).minimize(loss)
        ops = pt.default_main_program().global_block().ops
    sums = [op for op in ops if op.type == "sum"
            and op.outputs["Out"] == ["nmt.word_emb@GRAD"]]
    assert len(sums) == 1 and len(sums[0].inputs["X"]) == 3
    table = [op for op in ops if op.type == "assign_value"]
    assert table, "the sinusoid table is an assign constant"


# -- beam decode ---------------------------------------------------------------

BEAM = dict(src_len=8, batch=2, max_out_len=6, beam_size=3)


def _beam_feed():
    r = np.random.RandomState(11)
    mask = np.ones((BEAM["batch"], BEAM["src_len"]), np.float32)
    mask[1, 5:] = 0.0
    return {"src_ids": r.randint(2, 96, (BEAM["batch"], BEAM["src_len"]))
            .astype(np.int64), "src_mask": mask}


def test_beam_decoder_matches_the_jax_package():
    jcfg = dataclasses.replace(JNMTConfig.tiny(), initializer_range=0.5)
    cfg = dataclasses.replace(NMTConfig.tiny(), initializer_range=0.5)
    feed = _beam_feed()
    with jpt.new_program_scope():
        main, startup = jpt.Program(), jpt.Program()
        startup.random_seed = 13
        with jpt.program_guard(main, startup), jpt.unique_name.guard():
            ids, scores = jbeam(jcfg, BEAM["src_len"], BEAM["batch"],
                                BEAM["max_out_len"],
                                beam_size=BEAM["beam_size"])
        scope = jpt.Scope()
        with jpt.scope_guard(scope):
            exe = jpt.Executor()
            exe.run(startup)
            weights = _persistables(main, scope.find_var)
            jids, jscores = exe.run(main, feed=feed,
                                    fetch_list=[ids, scores])
    pmain, pstartup = pt.Program(), pt.Program()
    with pt.program_guard(pmain, pstartup), pt.unique_name.guard():
        ids, scores = build_nmt_beam_infer(
            cfg, BEAM["src_len"], BEAM["batch"], BEAM["max_out_len"],
            beam_size=BEAM["beam_size"])
    pscope = pt.Scope()
    pt.io.load_params(pscope, weights, "cpu", program=pmain)
    pids, pscores = pt.Executor(pt.CPUPlace()).run(
        pmain, feed=feed, fetch_list=[ids, scores], scope=pscope)
    assert pids.shape == (BEAM["max_out_len"], BEAM["batch"],
                          BEAM["beam_size"])
    np.testing.assert_array_equal(pids, np.asarray(jids))
    np.testing.assert_allclose(pscores, np.asarray(jscores), rtol=1e-5,
                               atol=1e-5)
    # a beam search, not a copy of one path: the beams differ
    assert len({tuple(pids[:, 0, k]) for k in range(BEAM["beam_size"])}) > 1
