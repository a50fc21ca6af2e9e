"""BERT pretraining through the port's front end — layers ->
``Adam.minimize`` -> ``Executor.run`` — against the JAX package on the
CPU, from the same weights.

Both packages build ``build_bert_pretrain(BertConfig.tiny(), seq_len=32)``
with dropout 0; the JAX startup's weights (its PRNG cannot be repeated
in torch) are carried into the port with ``io.load_params``; both run
five ``Adam(1e-3)`` steps on one numpy-seeded batch of 8.  Three cases:

* ``fused`` / ``unfused`` (``cfg.fused_attention``): both packages run
  the unfused lowering (``BuildStrategy.fuse_epilogues=False`` through a
  ``CompiledProgram``);
* ``blocks``: BERT-tiny at hidden 128 with 4 heads (so the JAX package's
  qkv-folded attention entry takes it) through each package's default
  executor — the GEMM-epilogue fusion pass with block patterns.  The JAX
  side runs its Pallas kernels in interpret mode
  (``PADDLE_TPU_FUSED_MATMUL_INTERPRET=1``); the port's groups run the
  plain versions of its kernels on the CPU.

Tolerances: every step's loss within
2e-3 (``_PARITY_TOL`` of the JAX package's own loss-parity checks);
first-step gradients within rtol 1e-3 / atol 1e-5 — float32 on both
sides, summed in other orders over a vocabulary-wide softmax.
"""
import dataclasses

import numpy as np
import pytest

import paddle_tpu as jpt
import paddle_tpu_torch as pt
from paddle_tpu.compiler import BuildStrategy, CompiledProgram
from paddle_tpu.models import BertConfig as JaxBertConfig
from paddle_tpu.models import build_bert_pretrain as jax_build
from paddle_tpu_torch.models import BertConfig, build_bert_pretrain

SEQ, BATCH, STEPS, LR = 32, 8, 5, 1e-3
LOSS_TOL = 2e-3
GRAD_TOL = dict(rtol=1e-3, atol=1e-5)


def _batch(rng, vocab):
    src = rng.randint(0, vocab, (BATCH, SEQ)).astype(np.int64)
    mask = np.ones((BATCH, SEQ), np.float32)
    mask[:3, SEQ - 6:] = 0.0                    # some padded tails
    labels = np.full((BATCH, SEQ, 1), -1, np.int64)
    pick = rng.rand(BATCH, SEQ) < 0.15
    labels[pick] = src[pick][:, None]
    return {"src_ids": src, "input_mask": mask, "masked_labels": labels}


def _jax_run(cfg, feed, fuse):
    main, startup = jpt.Program(), jpt.Program()
    startup.random_seed = 7
    with jpt.program_guard(main, startup), jpt.unique_name.guard():
        loss, _ = jax_build(cfg, seq_len=SEQ)
        _, params_grads = jpt.optimizer.Adam(LR).minimize(loss)
    scope = jpt.Scope()
    exe = jpt.Executor()
    bs = BuildStrategy()
    bs.fuse_epilogues = fuse
    compiled = CompiledProgram(main, build_strategy=bs)
    grads = [g.name for _, g in params_grads]
    with jpt.scope_guard(scope):
        exe.run(startup)
        weights = {v.name: np.asarray(scope.find_var(v.name))
                   for v in main.list_vars() if v.persistable}
        losses, first_grads = [], None
        for step in range(STEPS):
            fetched = exe.run(compiled, feed=feed,
                              fetch_list=[loss] + (grads if step == 0
                                                   else []))
            losses.append(float(fetched[0]))
            if step == 0:
                first_grads = dict(zip(grads, fetched[1:]))
    return main, weights, losses, first_grads


def _port_program(cfg):
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        loss, _ = build_bert_pretrain(cfg, seq_len=SEQ)
        _, params_grads = pt.optimizer.Adam(LR).minimize(loss)
    return main, startup, loss, [g.name for _, g in params_grads]


@pytest.fixture(scope="module", params=["fused", "unfused", "blocks"])
def runs(request, monkeypatch_module):
    """One JAX and one port run of the same program and weights."""
    blocks = request.param == "blocks"
    jcfg = dataclasses.replace(JaxBertConfig.tiny(), hidden_dropout=0.0,
                               attn_dropout=0.0,
                               fused_attention=request.param != "unfused")
    if blocks:
        jcfg = dataclasses.replace(jcfg, hidden_size=128, num_heads=4,
                                   ffn_size=256)
        monkeypatch_module.setenv("PADDLE_TPU_FUSED_MATMUL_INTERPRET", "1")
    cfg = BertConfig(**dataclasses.asdict(jcfg))
    feed = _batch(np.random.RandomState(3), cfg.vocab_size)
    with jpt.new_program_scope():
        jmain, weights, jlosses, jgrads = _jax_run(jcfg, feed, fuse=blocks)
    monkeypatch_module.delenv("PADDLE_TPU_FUSED_MATMUL_INTERPRET",
                              raising=False)
    main, startup, loss, grads = _port_program(cfg)
    scope = pt.Scope()
    pt.io.load_params(scope, weights, "cpu", program=main)
    exe = pt.Executor(pt.CPUPlace())
    program = main
    if not blocks:
        bs = pt.BuildStrategy()
        bs.fuse_epilogues = False
        program = pt.CompiledProgram(main, build_strategy=bs)
    losses, first = [], None
    for step in range(STEPS):
        fetched = exe.run(program, feed=feed, scope=scope,
                          fetch_list=[loss] + (grads if step == 0 else []))
        losses.append(float(fetched[0]))
        if step == 0:
            first = dict(zip(grads, fetched[1:]))
    plans = [lowered.fusion_plan for lowered in main._exec_cache.values()]
    return dict(jmain=jmain, main=main, jlosses=jlosses, losses=losses,
                jgrads=jgrads, grads=first, blocks=blocks, plans=plans)


@pytest.fixture(scope="module")
def monkeypatch_module():
    with pytest.MonkeyPatch.context() as mp:
        yield mp


def test_programs_are_the_same_ir(runs):
    """Same ops, slots, variable names, @GRAD and accumulator names."""
    def ir(program):
        return [(op.type, op.inputs, op.outputs)
                for op in program.global_block().ops]

    assert ir(runs["main"]) == ir(runs["jmain"])


def test_port_runs_the_fusion_pass_by_default(runs):
    """The ``blocks`` case runs the fused groups (2 layers: attention,
    attn.out and FFN each, plus the MLM head); the others none."""
    for plan in runs["plans"]:     # one lowering per fetch list
        if not runs["blocks"]:
            assert plan is None
            continue
        kinds = [g.kind for g in plan.groups]
        assert kinds.count("attn") == kinds.count("ffn_chain") == 2
        assert kinds.count("gemm") == 3


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


def test_trains_with_dropout():
    """Dropout on (the tiny config's 0.1): masks differ from the JAX
    package's, so only that training runs and memorizes the batch."""
    cfg = BertConfig.tiny()
    with pt.new_program_scope():
        loss, _ = build_bert_pretrain(cfg, seq_len=SEQ)
        pt.optimizer.Adam(LR).minimize(loss)
        pt.default_startup_program().random_seed = 1
        exe = pt.Executor(pt.CPUPlace())
        exe.run(pt.default_startup_program())
        feed = _batch(np.random.RandomState(0), cfg.vocab_size)
        losses = [float(exe.run(feed=feed, fetch_list=[loss])[0])
                  for _ in range(8)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]
