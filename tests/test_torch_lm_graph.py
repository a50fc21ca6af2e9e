"""The causal LM's graph forms in the port — ``build_lm_logits`` and the
uncached StaticRNN greedy decoder ``build_lm_greedy_infer`` — and
``lm_params_from_scope``, against the JAX package on the CPU.

Both packages build the same program (``program_guard`` +
``unique_name.guard``); the JAX startup's weights are carried into the
port with ``io.load_params``.  At ``BertConfig.tiny()`` with
initializer_range 0.2 and dropout 0:

* ``build_lm_logits``: the program desc equals the JAX package's, and
  the logits are within atol 1e-4 (``tests/test_torch_lm.py``'s
  tolerance) of the JAX Executor's, through the port's unfused lowering
  and through its default fusion pass; the fusion plan equals the JAX
  planner's group for group (``tests/test_torch_fusion.py``'s form), for
  the logits program and for the greedy decoder (block 0 only: the
  StaticRNN's sub-block is not planned).
* ``build_lm_greedy_infer`` at B 2, P 8, N 4: token parity 1.0 with the
  JAX graph decoder, and with the port's own ``GenerationEngine`` on
  ``lm_params_from_scope``'s weights (``tests/test_generation.py:313``).
* ``lm_params_from_scope`` returns the JAX one's arrays, bit for bit.
"""
import dataclasses

import numpy as np
import pytest

import paddle_tpu as jpt
import paddle_tpu_torch as pt
from paddle_tpu.core import fusion as jfusion
from paddle_tpu.models import BertConfig as JBertConfig
from paddle_tpu.models import build_lm_greedy_infer as jgreedy
from paddle_tpu.models import build_lm_logits as jlogits
from paddle_tpu.models import lm_params_from_scope as jparams_from_scope
from paddle_tpu_torch.core import fusion
from paddle_tpu_torch.generation import (GenerationConfig, GenerationEngine,
                                         SamplingParams)
from paddle_tpu_torch.models import (BertConfig, build_lm_greedy_infer,
                                     build_lm_logits, lm_param_names,
                                     lm_params_from_numpy,
                                     lm_params_from_scope)
from test_torch_fusion import _describe
from test_torch_tensor_math_ops import narrowed

LOGITS_ATOL = 1e-4
B, P, N = 2, 8, 4
SEQ = 16

JCFG = dataclasses.replace(JBertConfig.tiny(), initializer_range=0.2,
                           hidden_dropout=0.0, attn_dropout=0.0)
CFG = BertConfig(**dataclasses.asdict(JCFG))


def _logits_program(P_, cfg):
    main, startup = P_.Program(), P_.Program()
    startup.random_seed = 7
    with P_.program_guard(main, startup), P_.unique_name.guard():
        src = P_.data("src_ids", [None, SEQ], "int64")
        logits = (jlogits if P_ is jpt else build_lm_logits)(src, cfg)
    return main, startup, logits


def _greedy_program(P_, cfg):
    main, startup = P_.Program(), P_.Program()
    startup.random_seed = 7
    with P_.program_guard(main, startup), P_.unique_name.guard():
        out = (jgreedy if P_ is jpt else build_lm_greedy_infer)(cfg, B, P, N)
    return main, startup, out


def _jax_run(build, feed):
    with jpt.new_program_scope():
        main, startup, out = build(jpt, JCFG)
        exe, scope = jpt.Executor(), jpt.Scope()
        with jpt.scope_guard(scope):
            exe.run(startup)
            weights = {v.name: np.asarray(scope.find_var(v.name))
                       for v in main.list_vars() if v.persistable}
            got, = exe.run(main, feed=feed, fetch_list=[out])
            lm = jparams_from_scope(JCFG, scope)
    return main, weights, np.asarray(got), lm


def _port(build, weights):
    main, startup, out = build(pt, CFG)
    scope = pt.Scope()
    pt.io.load_params(scope, weights, "cpu", program=main)
    return main, out, scope


@pytest.fixture(scope="module")
def logits_runs():
    src = np.random.RandomState(2).randint(
        0, CFG.vocab_size, (3, SEQ)).astype(np.int64)
    jmain, weights, want, _ = _jax_run(_logits_program, {"src_ids": src})
    main, out, scope = _port(_logits_program, weights)
    exe = pt.Executor(pt.CPUPlace())
    bs = pt.BuildStrategy()
    bs.fuse_epilogues = False
    got = {}
    for mode, prog in (("unfused", pt.CompiledProgram(main,
                                                       build_strategy=bs)),
                       ("fused", main)):
        got[mode], = exe.run(prog, feed={"src_ids": src}, fetch_list=[out],
                             scope=scope)
    plans = {lw.fusion_plan is not None: lw.fusion_plan
             for lw in main._exec_cache.values()}
    return dict(jmain=jmain, main=main, want=want, got=got, plans=plans)


def test_logits_program_is_the_jax_packages(logits_runs):
    assert narrowed(logits_runs["main"].to_dict()) == narrowed(
        logits_runs["jmain"].to_dict())


@pytest.mark.parametrize("mode", ["unfused", "fused"])
def test_logits_match_the_jax_package(logits_runs, mode):
    got, want = logits_runs["got"][mode], logits_runs["want"]
    assert got.shape == want.shape == (3, SEQ, CFG.vocab_size)
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGITS_ATOL)
    assert np.abs(want).max() > 1.0       # the check is not vacuous


def test_the_fused_run_used_the_plan(logits_runs):
    plan = logits_runs["plans"][True]
    kinds = sorted({g.kind for g in plan.groups})
    assert kinds == ["attn", "ffn_chain", "gemm"], kinds
    attn = [g for g in plan.groups if g.kind == "attn"]
    assert len(attn) == CFG.num_layers
    # the attention member of every group is causal
    assert all(any(m.attrs.get("causal") for m in g.members) for g in attn)


def _plans(build, cfg_pair):
    out = []
    for (P_, planner), cfg in zip(((jpt, jfusion), (pt, fusion)), cfg_pair):
        with (jpt.new_program_scope() if P_ is jpt
              else pt.new_program_scope()):
            main, _, var = build(P_, cfg)
            feeds = [n for n in ("src_ids", "prompt_ids")
                     if main.global_block().has_var(n)]
            out.append(_describe(planner.plan_fusion(
                main, list(main.global_block().ops), feeds, [var.name],
                block_patterns=True)))
    return out


@pytest.mark.parametrize("name", ["logits", "greedy", "logits_base"])
def test_fusion_plan_equals_the_jax_planners(name):
    build = _greedy_program if name == "greedy" else _logits_program
    cfgs = (JCFG, CFG)
    if name == "logits_base":
        cfgs = (JBertConfig.base(), BertConfig.base())
    want, got = _plans(build, cfgs)
    assert got == want
    if name == "greedy":
        assert got is None      # block 0 holds no GEMM: nothing fuses
    else:
        layers = cfgs[1].num_layers
        kinds = [g["kind"] for g in got["groups"]]
        # per layer: the qkv-folded attention, the out projection's
        # epilogue, the FFN chain; the tied logits GEMM does not fuse
        assert len(kinds) == 3 * layers, kinds
        assert kinds.count("attn") == kinds.count("ffn_chain") == layers


@pytest.fixture(scope="module")
def greedy_runs():
    prompts = np.random.RandomState(12).randint(
        1, CFG.vocab_size, (B, P)).astype(np.int64)
    jmain, weights, want, jlm = _jax_run(_greedy_program,
                                         {"prompt_ids": prompts})
    main, out, scope = _port(_greedy_program, weights)
    exe = pt.Executor(pt.CPUPlace())
    got, = exe.run(main, feed={"prompt_ids": prompts}, fetch_list=[out],
                   scope=scope)
    return dict(jmain=jmain, main=main, prompts=prompts, want=want,
                got=got, jlm=jlm, scope=scope)


def test_greedy_program_is_the_jax_packages(greedy_runs):
    main = greedy_runs["main"]
    assert len(main.blocks) == 2
    assert main.global_block().ops[-1].type == "static_rnn"
    assert narrowed(main.to_dict()) == narrowed(
        greedy_runs["jmain"].to_dict())


def test_greedy_tokens_equal_the_jax_graph_decoder(greedy_runs):
    got, want = greedy_runs["got"], greedy_runs["want"]
    assert got.shape == want.shape == (N, B)
    assert np.mean(got == want) == 1.0, (got, want)
    assert len(np.unique(got)) > 1        # not one repeated token


def test_lm_params_from_scope_equals_the_jax_one(greedy_runs):
    got = lm_params_from_scope(CFG, greedy_runs["scope"])
    want = greedy_runs["jlm"]
    assert list(got) == list(want) == lm_param_names(CFG)
    for n in want:
        assert isinstance(got[n], np.ndarray)
        np.testing.assert_array_equal(got[n], want[n])
    with pytest.raises(KeyError, match="startup"):
        lm_params_from_scope(CFG, pt.Scope())


def test_engine_gives_the_graph_decoders_tokens(greedy_runs):
    """The port's KV-cached engine on the graph's weights decodes the
    uncached StaticRNN decoder's tokens."""
    params = lm_params_from_numpy(
        lm_params_from_scope(CFG, greedy_runs["scope"]), "cpu")
    eng = GenerationEngine(CFG, params, GenerationConfig(
        page_size=8, max_seqs=B, max_seq_len=32), device="cpu")
    res = eng.generate(list(greedy_runs["prompts"]),
                       sampling=SamplingParams(max_new_tokens=N))
    assert [r.tokens for r in res] == greedy_runs["got"].T.tolist()
