"""BERT pretraining with the masked-position head (``max_masked``), as
the JAX package's benchmark trains it, against the JAX package on the
CPU from the same weights.

Both packages build ``build_bert_pretrain(cfg, 128, max_masked=20)`` at
dropout 0 and run five ``Adam(1e-3)`` steps on one numpy-seeded batch of
4 whose feeds are built as ``bench.py`` builds them (20 distinct
positions a row as the flat index ``pos + b·L``, labels taken from the
ids there, two slots of one row set to the -1 pad).  Two cases:

* ``unfused``: BERT-tiny with ``BuildStrategy.fuse_epilogues=False``
  in both packages;
* ``fused``: BERT-tiny at hidden 128 with 4 heads (the JAX package's
  qkv-folded attention entry needs it) through each package's default
  executor — the fusion pass with block patterns; the JAX side runs its
  Pallas kernels in interpret mode, the port's groups the plain versions
  of its kernels.

Tolerances: every step's loss within 2e-3 (``_PARITY_TOL`` of the JAX
package's loss-parity checks); first-step gradients within rtol 1e-3 /
atol 1e-5.  The plan is held group for group to the JAX planner's on
the masked program, and the masked head's loss to the dense head's on
the same positions within 1e-5 relative.
"""
import dataclasses

import numpy as np
import pytest

import paddle_tpu as jpt
import paddle_tpu_torch as pt
from paddle_tpu.compiler import BuildStrategy, CompiledProgram
from paddle_tpu.core import fusion as jfusion
from paddle_tpu.models import BertConfig as JaxBertConfig
from paddle_tpu.models import build_bert_pretrain as jax_build
from paddle_tpu_torch.core import fusion
from paddle_tpu_torch.models import BertConfig, build_bert_pretrain

SEQ, BATCH, MASKED, STEPS, LR = 128, 4, 20, 5, 1e-3
LOSS_TOL = 2e-3
GRAD_TOL = dict(rtol=1e-3, atol=1e-5)


def masked_batch(rng, vocab, batch=BATCH, seq=SEQ, masked=MASKED):
    """``bench.py``'s masked-head feeds, with two pad slots."""
    src = rng.randint(0, vocab, (batch, seq)).astype(np.int64)
    pos = np.stack([rng.choice(seq, masked, replace=False)
                    for _ in range(batch)])
    flat = (pos + np.arange(batch)[:, None] * seq).reshape(-1)
    labels = np.take_along_axis(src, pos, 1).reshape(-1, 1)
    labels[[1, 2]] = -1
    mask = np.ones((batch, seq), np.float32)
    mask[0, seq - 9:] = 0.0
    return {"src_ids": src, "input_mask": mask,
            "mask_pos": flat.astype(np.int64),
            "masked_labels": labels.astype(np.int64)}, pos


def _cfgs(case):
    jcfg = dataclasses.replace(JaxBertConfig.tiny(), hidden_dropout=0.0,
                               attn_dropout=0.0)
    if case == "fused":
        jcfg = dataclasses.replace(jcfg, hidden_size=128, num_heads=4,
                                   ffn_size=256)
    return jcfg, BertConfig(**dataclasses.asdict(jcfg))


def _build(P, build, cfg, masked=True):
    main, startup = P.Program(), P.Program()
    startup.random_seed = 7
    with P.program_guard(main, startup), P.unique_name.guard():
        loss, _ = build(cfg, SEQ, max_masked=MASKED if masked else None)
        _, params_grads = P.optimizer.Adam(LR).minimize(loss)
    return main, startup, loss, [g.name for _, g in params_grads]


@pytest.fixture(scope="module")
def monkeypatch_module():
    with pytest.MonkeyPatch.context() as mp:
        yield mp


@pytest.fixture(scope="module", params=["fused", "unfused"])
def runs(request, monkeypatch_module):
    fused = request.param == "fused"
    jcfg, cfg = _cfgs(request.param)
    feed, _ = masked_batch(np.random.RandomState(3), cfg.vocab_size)
    if fused:
        monkeypatch_module.setenv("PADDLE_TPU_FUSED_MATMUL_INTERPRET", "1")
    jmain, jstartup, jloss, grads = _build(jpt, jax_build, jcfg)
    bs = BuildStrategy()
    bs.fuse_epilogues = fused
    jscope, jexe = jpt.Scope(), jpt.Executor()
    with jpt.scope_guard(jscope):
        jexe.run(jstartup)
        weights = {v.name: np.asarray(jscope.find_var(v.name))
                   for v in jmain.list_vars() if v.persistable}
        jlosses, jgrads = [], None
        for step in range(STEPS):
            got = jexe.run(CompiledProgram(jmain, build_strategy=bs),
                           feed=feed,
                           fetch_list=[jloss] + (grads if step == 0 else []))
            jlosses.append(float(got[0]))
            if step == 0:
                jgrads = dict(zip(grads, got[1:]))
    monkeypatch_module.delenv("PADDLE_TPU_FUSED_MATMUL_INTERPRET",
                              raising=False)
    main, _, loss, pgrads = _build(pt, build_bert_pretrain, cfg)
    scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    pt.io.load_params(scope, weights, "cpu", program=main)
    program = main
    if not fused:
        pbs = pt.BuildStrategy()
        pbs.fuse_epilogues = False
        program = pt.CompiledProgram(main, build_strategy=pbs)
    losses, first = [], None
    for step in range(STEPS):
        got = exe.run(program, feed=feed, scope=scope,
                      fetch_list=[loss] + (pgrads if step == 0 else []))
        losses.append(float(got[0]))
        if step == 0:
            first = dict(zip(pgrads, got[1:]))
    return dict(jmain=jmain, main=main, jlosses=jlosses, losses=losses,
                jgrads=jgrads, grads=first, fused=fused,
                plans=[lw.fusion_plan for lw in main._exec_cache.values()])


def test_programs_are_the_same_ir(runs):
    def ir(program):
        return [(op.type, op.inputs, op.outputs)
                for op in program.global_block().ops]

    assert ir(runs["main"]) == ir(runs["jmain"])


def test_losses_match_the_jax_package_every_step(runs):
    got, want = np.asarray(runs["losses"]), np.asarray(runs["jlosses"])
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() < LOSS_TOL, (got, want)
    assert got[-1] < got[0]


def test_first_step_gradients_match(runs):
    assert set(runs["grads"]) == set(runs["jgrads"])
    for name, g in runs["grads"].items():
        np.testing.assert_allclose(g, runs["jgrads"][name], err_msg=name,
                                   **GRAD_TOL)


def test_fused_run_plans_the_masked_head(runs):
    for plan in runs["plans"]:
        if not runs["fused"]:
            assert plan is None
            continue
        kinds = [(g.kind, g.pattern) for g in plan.groups]
        assert kinds.count(("gemm", "mul+bias")) == 1, kinds


def _describe(plan):
    if plan is None:
        return None
    return [dict(kind=g.kind, pattern=g.pattern,
                 members=[m.uid for m in g.members],
                 roles=sorted(g.roles.items()), final_slot=g.final_slot,
                 internal=sorted(g.internal), act=g.act, dropout=g.dropout,
                 norm=g.norm, extra=g.extra) for g in plan.groups], \
        sorted(plan.skip_uids)


@pytest.mark.parametrize("dropout", [0.0, 0.1])
@pytest.mark.parametrize("block", [True, False], ids=["blocks", "chains"])
def test_plan_equals_the_jax_planners(block, dropout):
    jcfg, cfg = _cfgs("fused")
    jcfg = dataclasses.replace(jcfg, hidden_dropout=dropout,
                               attn_dropout=dropout)
    cfg = dataclasses.replace(cfg, hidden_dropout=dropout,
                              attn_dropout=dropout)
    feeds = ("src_ids", "input_mask", "mask_pos", "masked_labels")
    plans = []
    for P, planner, build, c in ((jpt, jfusion, jax_build, jcfg),
                                 (pt, fusion, build_bert_pretrain, cfg)):
        main, _, loss, _ = _build(P, build, c)
        plans.append(_describe(planner.plan_fusion(
            main, list(main.global_block().ops), feeds, [loss.name],
            block_patterns=block)))
    assert plans[1] == plans[0]
    assert plans[1] is not None


def test_masked_head_equals_the_dense_head_on_the_same_positions():
    _, cfg = _cfgs("unfused")
    feed, pos = masked_batch(np.random.RandomState(5), cfg.vocab_size)
    dense_labels = np.full((BATCH, SEQ, 1), -1, np.int64)
    lab = feed["masked_labels"].reshape(BATCH, MASKED)
    for b in range(BATCH):
        keep = lab[b] >= 0
        dense_labels[b, pos[b][keep], 0] = lab[b][keep]
    losses = []
    weights = None
    for masked in (True, False):
        main, startup = pt.Program(), pt.Program()
        startup.random_seed = 9
        with pt.program_guard(main, startup), pt.unique_name.guard():
            loss, _ = build_bert_pretrain(
                cfg, SEQ, is_test=True, max_masked=MASKED if masked else None)
        scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
        if weights is None:
            exe.run(startup, scope=scope)
            weights = {v.name: scope.find_var(v.name).numpy()
                       for v in main.list_vars() if v.persistable}
        else:
            pt.io.load_params(scope, weights, "cpu", program=main)
        f = dict(feed) if masked else {
            "src_ids": feed["src_ids"], "input_mask": feed["input_mask"],
            "masked_labels": dense_labels}
        losses.append(float(exe.run(main, feed=f, fetch_list=[loss],
                                    scope=scope)[0]))
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-5)
