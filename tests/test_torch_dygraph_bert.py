"""Phase 20's dygraph BERT encoder (``chip_smoke.dygraph_bert``, one
source built over either package) against the JAX package's, on the CPU
at 2 layers, hidden 128, 2 heads.

* 3 eager Adam steps at dropout 0 from the JAX model's weights (carried
  with ``state_dict()`` → numpy → ``set_state_dict()``; both packages
  name the same parameters): losses within 2e-3 (``__graft_entry__.py
  :26``), every parameter within 1e-4.
* ``TracedLayer.trace`` in eval mode in both packages: the port's fusion
  plan of its traced program equals ``paddle_tpu.core.fusion.
  plan_fusion``'s of the JAX trace, group for group — per layer the
  attention group (#9), the output projection's residual norm (#10)
  and the FFN chain (#11).
* The traced program through the Executor and a Predictor on its
  ``save_inference_model`` within 1e-5 of the eager forward.
"""
import dataclasses

import numpy as np
import pytest

import chip_smoke as cs
import paddle_tpu as jpt
import paddle_tpu_torch as pt
from paddle_tpu.core import fusion as jfusion
from paddle_tpu_torch.core import fusion
from paddle_tpu_torch.models import BertConfig

CFG = dataclasses.replace(BertConfig.tiny(), vocab_size=512, hidden_size=128,
                          num_heads=2, ffn_size=256, num_layers=2,
                          max_position=64, hidden_dropout=0.0,
                          attn_dropout=0.0)
B, T = 4, 32
LOSS_TOL, PARAM_TOL, TRACE_TOL = 2e-3, 1e-4, 1e-5


def _guard(pkg):
    return pkg.dygraph.guard("cpu") if pkg is pt else pkg.dygraph.guard()


def _train(pkg, steps, weights=None):
    arrays = cs.dygraph_arrays(CFG, B, T, seed=3)
    with _guard(pkg), pkg.unique_name.guard():
        pkg.dygraph.seed(0)
        model = cs.dygraph_bert(pkg, CFG)
        if weights is not None:
            assert set(weights) == set(model.state_dict())
            model.set_state_dict(weights)
        w0 = {k: np.asarray(v).copy() for k, v in model.state_dict().items()}
        opt = pkg.optimizer.Adam(1e-3, parameter_list=model.parameters())
        losses = [float(cs.dygraph_step(pkg, model, opt, arrays).numpy())
                  for _ in range(steps)]
        w = {k: np.asarray(v).copy() for k, v in model.state_dict().items()}
    return w0, losses, w


def test_three_adam_steps_against_the_jax_package():
    w0, jlosses, jw = _train(jpt, 3)
    _, losses, w = _train(pt, 3, weights=w0)
    np.testing.assert_allclose(losses, jlosses, rtol=0, atol=LOSS_TOL)
    assert losses[-1] < losses[0]
    assert set(w) == set(jw)
    for k in w:
        np.testing.assert_allclose(w[k], jw[k], rtol=0, atol=PARAM_TOL,
                                   err_msg=k)


def _describe(plan):
    return [dict(kind=g.kind, pattern=g.pattern,
                 types=[m.type for m in g.members],
                 roles=sorted(g.roles.items()), act=g.act,
                 dropout=g.dropout, norm=g.norm)
            for g in plan.groups]


def _trace(pkg, weights=None):
    arrays = cs.dygraph_arrays(CFG, B, T, seed=4)
    with _guard(pkg), pkg.unique_name.guard():
        pkg.dygraph.seed(1)
        model = cs.dygraph_bert(pkg, CFG)
        if weights is not None:
            model.set_state_dict(weights)
        model.eval()
        try:
            ins = [pkg.dygraph.to_variable(arrays[k])
                   for k in ("src", "pos", "sent", "bias")]
            eager, traced = pkg.dygraph.TracedLayer.trace(model, ins)
            eager = eager.numpy()
        finally:
            model.train()
        w = {k: np.asarray(v).copy() for k, v in model.state_dict().items()}
    return w, eager, traced, [x.numpy() for x in ins]


@pytest.fixture(scope="module")
def traces():
    jw, jeager, jtraced, _ = _trace(jpt)
    _, eager, traced, ins = _trace(pt, weights=jw)
    return dict(jeager=jeager, jtraced=jtraced, eager=eager, traced=traced,
                ins=ins)


def test_traced_plan_equals_the_jax_planners(traces):
    plans = []
    for planner, traced in ((jfusion, traces["jtraced"]),
                            (fusion, traces["traced"])):
        prog = traced.program
        plans.append(planner.plan_fusion(
            prog, list(prog.global_block().ops), traced._feed_names,
            traced._fetch_names, block_patterns=True))
    want, got = (_describe(p) for p in plans)
    assert got == want
    kinds = [g["kind"] for g in got]
    assert sorted(kinds) == sorted(["attn", "gemm", "ffn_chain"]
                                   * CFG.num_layers)
    # the eager forwards agree too (the same weights)
    np.testing.assert_allclose(traces["eager"], traces["jeager"], rtol=0,
                               atol=TRACE_TOL)


def test_traced_and_predictor_equal_the_eager_forward(traces, tmp_path):
    traced = traces["traced"]
    with pt.dygraph.guard("cpu"):
        got, = traced(traces["ins"])
        path = str(tmp_path / "traced")
        traced.save_inference_model(path)
    plan = [lw.fusion_plan for lw in traced.program._exec_cache.values()]
    assert plan and plan[0] is not None and len(plan[0].groups) == \
        3 * CFG.num_layers
    np.testing.assert_allclose(got, traces["eager"], rtol=0, atol=TRACE_TOL)
    config = pt.inference.Config(path)
    config.disable_gpu()
    served, = pt.inference.create_predictor(config).run(traces["ins"])
    np.testing.assert_allclose(served, traces["eager"], rtol=0,
                               atol=TRACE_TOL)
