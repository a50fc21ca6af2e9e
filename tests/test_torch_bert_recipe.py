"""BERT pretraining with the published recipe through the port's front end,
against the JAX package on the CPU, from the same weights.

The recipe (Devlin et al. 2018, appendix A.2, with the global-norm clip
of Paddle's BERT ``optimization.py``), its schedule cut to five steps:
``linear_lr_warmup(polynomial_decay(1e-4, decay_steps=12,
end_learning_rate=0.0), warmup_steps=4, start_lr=0.0, end_lr=1e-4)`` and
``AdamW(lr, weight_decay=0.01, grad_clip=GradientClipByGlobalNorm(1.0))``.
BERT-tiny at dropout 0 is built in both packages; the JAX startup's
weights go into the port with ``io.load_params``; both run five steps of
one numpy-seeded batch, through the unfused lowering (``fuse_epilogues``
off) and through the default fusion pass (hidden 128, the JAX package's
Pallas kernels in interpret mode, the port's kernels' plain versions on
the CPU), as ``tests/test_torch_bert_train.py`` does.

Gates: every step's loss within 2e-3 of the JAX package's
(``_PARITY_TOL``), every step's learning rate within 1e-6 relative, the
global-norm scale in (0, 1], and the port's fusion plan equal to the JAX
planner's group for group with the schedule and clip ops in the program.
"""
import dataclasses

import numpy as np
import pytest

import paddle_tpu as jpt
import paddle_tpu_torch as pt
from paddle_tpu.compiler import BuildStrategy, CompiledProgram
from paddle_tpu.core import fusion as jfusion
from paddle_tpu.models import BertConfig as JBertConfig
from paddle_tpu.models import build_bert_pretrain as jbuild
from paddle_tpu_torch.core import fusion
from paddle_tpu_torch.models import BertConfig, build_bert_pretrain
from test_torch_fusion import _describe

SEQ, BATCH, STEPS = 32, 8, 5
LOSS_TOL = 2e-3
LR_RTOL = 1e-6


def _batch(vocab):
    r = np.random.RandomState(3)
    src = r.randint(0, vocab, (BATCH, SEQ)).astype(np.int64)
    mask = np.ones((BATCH, SEQ), np.float32)
    mask[:3, SEQ - 6:] = 0.0
    labels = np.full((BATCH, SEQ, 1), -1, np.int64)
    pick = r.rand(BATCH, SEQ) < 0.15
    labels[pick] = src[pick][:, None]
    return {"src_ids": src, "input_mask": mask, "masked_labels": labels}


def _recipe(P, cfg):
    main, startup = P.Program(), P.Program()
    startup.random_seed = 7
    with P.program_guard(main, startup), P.unique_name.guard():
        loss, _ = (jbuild if P is jpt else build_bert_pretrain)(
            cfg, seq_len=SEQ)
        lr = P.layers.linear_lr_warmup(
            P.layers.polynomial_decay(1e-4, decay_steps=12,
                                      end_learning_rate=0.0),
            warmup_steps=4, start_lr=0.0, end_lr=1e-4)
        clip = P.clip.GradientClipByGlobalNorm(1.0)
        P.optimizer.AdamW(lr, weight_decay=0.01,
                          grad_clip=clip).minimize(loss)
    # the clip's scale: the divisor of every grad's elementwise_mul
    scale = [o for o in main.global_block().ops
             if o.type == "elementwise_div"][-1].outputs["Out"][0]
    return main, startup, loss, lr, scale


def _fetches(exe, program, feed, fetch, **kw):
    out = [exe.run(program, feed=feed, fetch_list=fetch, **kw)
           for _ in range(STEPS)]
    return [np.asarray([float(o[i]) for o in out]) for i in range(3)]


@pytest.fixture(scope="module")
def monkeypatch_module():
    with pytest.MonkeyPatch.context() as mp:
        yield mp


@pytest.fixture(scope="module", params=["unfused", "fused"])
def runs(request, monkeypatch_module):
    fused = request.param == "fused"
    jcfg = dataclasses.replace(JBertConfig.tiny(), hidden_dropout=0.0,
                               attn_dropout=0.0)
    if fused:
        jcfg = dataclasses.replace(jcfg, hidden_size=128, num_heads=4,
                                   ffn_size=256)
        monkeypatch_module.setenv("PADDLE_TPU_FUSED_MATMUL_INTERPRET", "1")
    cfg = BertConfig(**dataclasses.asdict(jcfg))
    feed = _batch(cfg.vocab_size)
    with jpt.new_program_scope():
        jmain, jstartup, jloss, jlr, jscale = _recipe(jpt, jcfg)
        bs = BuildStrategy()
        bs.fuse_epilogues = fused
        exe = jpt.Executor()
        exe.run(jstartup)
        scope = jpt.global_scope()
        weights = {v.name: np.asarray(scope.find_var(v.name))
                   for v in jmain.list_vars() if v.persistable}
        want = _fetches(exe, CompiledProgram(jmain, build_strategy=bs),
                        feed, [jloss, jlr, jscale])
    monkeypatch_module.delenv("PADDLE_TPU_FUSED_MATMUL_INTERPRET",
                              raising=False)
    main, _, loss, lr, scale = _recipe(pt, cfg)
    pscope = pt.Scope()
    pt.io.load_params(pscope, weights, "cpu", program=main)
    bs = pt.BuildStrategy()
    bs.fuse_epilogues = fused
    got = _fetches(pt.Executor(pt.CPUPlace()),
                   pt.CompiledProgram(main, build_strategy=bs), feed,
                   [loss, lr, scale], scope=pscope)
    return dict(fused=fused, main=main, jmain=jmain, loss=loss, jloss=jloss,
                got=got, want=want)


def test_losses_match_the_jax_package_every_step(runs):
    got, want = runs["got"][0], runs["want"][0]
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() < LOSS_TOL, (got, want)


def test_learning_rates_match_every_step(runs):
    got, want = runs["got"][1], runs["want"][1]
    np.testing.assert_allclose(got, want, rtol=LR_RTOL)
    # warmup 0 -> 7.5e-5 over steps 0-3, then the linear decay
    np.testing.assert_allclose(got, [0.0, 2.5e-5, 5e-5, 7.5e-5, 1e-4 * 8 / 12],
                               rtol=1e-6)


def test_global_norm_scale(runs):
    got, want = runs["got"][2], runs["want"][2]
    assert ((got > 0) & (got <= 1)).all(), got
    np.testing.assert_allclose(got, want, rtol=1e-3)


def test_fusion_plan_equals_the_jax_planners(runs):
    """With the schedule's and the clip's ops in the program, the
    planner's groups are the JAX planner's (fused run) — and no group
    holds one of them."""
    types = {o.type for o in runs["main"].global_block().ops}
    assert {"increment", "squared_l2_norm", "adamw"} <= types
    for block in (True, False):
        got = fusion.plan_fusion(runs["main"],
                                 list(runs["main"].global_block().ops),
                                 ["src_ids", "input_mask", "masked_labels"],
                                 [runs["loss"].name], block_patterns=block)
        want = jfusion.plan_fusion(runs["jmain"],
                                   list(runs["jmain"].global_block().ops),
                                   ["src_ids", "input_mask",
                                    "masked_labels"],
                                   [runs["jloss"].name],
                                   block_patterns=block)
        assert _describe(got) == _describe(want)
        member_types = {m.type for g in got.groups for m in g.members}
        assert not member_types & {"increment", "squared_l2_norm",
                                   "elementwise_min", "cast", "adamw"}


def test_schedule_and_clip_ops_are_not_differentiated(runs):
    main = runs["main"]
    by_uid = {o.uid: o for o in main.global_block().ops}
    fwd = {by_uid[o.attrs["fwd_uid"]].type
           for o in main.global_block().ops if o.type == "vjp_grad"}
    assert fwd and not fwd & {"increment", "cast", "less_than",
                              "elementwise_min", "squared_l2_norm"}
