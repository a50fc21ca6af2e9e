"""The port's loss and metric ops — cross_entropy,
sigmoid_cross_entropy_with_logits, smooth_l1_loss, huber_loss, accuracy,
auc — and their layers, against the JAX package on the CPU.

Op level: the inputs ``tests/test_registry_sweep.py`` gives the JAX ops
(numpy-seeded), plus the attribute cases (soft labels, ignore_index,
normalize, sigma, ties in the metrics); every output within 1e-6
relative (plus 1e-6 absolute), and the gradient of ``sum(out · c)`` for a
seeded cotangent ``c`` (``jax.vjp`` against ``torch.autograd``) within
1e-5.  Layer level: an fc program per loss layer trained three SGD steps
in both packages from the JAX startup's weights, losses, metrics and
weights within 1e-5 relative.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as jpt
import paddle_tpu_torch as pt
from paddle_tpu.core.registry import REGISTRY as JREG
from paddle_tpu.core.registry import OpContext as JCtx
from paddle_tpu_torch.core.registry import REGISTRY as PREG
from paddle_tpu_torch.core.registry import OpContext as PCtx


def _s(r, *shape):
    return (r.rand(*shape).astype(np.float32) * 2 - 1)


def _probs(r, n, c):
    e = np.exp(r.randn(n, c).astype(np.float32))
    return e / e.sum(-1, keepdims=True)


def _ties(r):
    x = r.randint(0, 3, (8, 4)).astype(np.float32)
    return x


CASES = {
    "ce_hard": ("cross_entropy", lambda r: {
        "X": _probs(r, 6, 5), "Label": r.randint(0, 5, (6, 1))}, {}, "X"),
    "ce_ignore": ("cross_entropy", lambda r: {
        "X": _probs(r, 6, 5),
        "Label": np.array([[0], [-100], [4], [2], [-100], [1]])},
        {"ignore_index": -100}, "X"),
    "ce_soft": ("cross_entropy", lambda r: {
        "X": _probs(r, 6, 5), "Label": _probs(r, 6, 5)},
        {"soft_label": True}, "X"),
    "ce_3d": ("cross_entropy", lambda r: {
        "X": _probs(r, 6, 5).reshape(2, 3, 5),
        "Label": r.randint(0, 5, (2, 3))}, {}, "X"),
    "sigmoid_ce": ("sigmoid_cross_entropy_with_logits", lambda r: {
        "X": _s(r, 4, 3) * 4, "Label": (r.rand(4, 3) > 0.5)
        .astype(np.float32)}, {}, "X"),
    "sigmoid_ce_ignore_norm": ("sigmoid_cross_entropy_with_logits",
                               lambda r: {
                                   "X": _s(r, 4, 3) * 4,
                                   "Label": np.where(
                                       r.rand(4, 3) > 0.7, 2.0,
                                       (r.rand(4, 3) > 0.5)).astype(
                                       np.float32)},
                               {"ignore_index": 2, "normalize": True}, "X"),
    "smooth_l1": ("smooth_l1_loss", lambda r: {
        "X": _s(r, 5, 3), "Y": _s(r, 5, 3)}, {"sigma": 1.0}, "X"),
    "smooth_l1_sigma3": ("smooth_l1_loss", lambda r: {
        "X": _s(r, 5, 2, 3), "Y": _s(r, 5, 2, 3)}, {"sigma": 3.0}, "X"),
    "smooth_l1_1d": ("smooth_l1_loss", lambda r: {
        "X": _s(r, 7), "Y": _s(r, 7)}, {"sigma": 2.0}, "X"),
    "huber": ("huber_loss", lambda r: {
        "X": _s(r, 5, 1), "Y": _s(r, 5, 1)}, {"delta": 1.0}, "X"),
    "huber_small_delta": ("huber_loss", lambda r: {
        "X": _s(r, 6, 2), "Y": _s(r, 6, 2)}, {"delta": 0.3}, "X"),
    "accuracy": ("accuracy", lambda r: {
        "Out": r.rand(8, 4).astype(np.float32),
        "Label": r.randint(0, 4, (8, 1))}, {"k": 1}, None),
    "accuracy_ties": ("accuracy", lambda r: {
        "Out": _ties(r), "Label": r.randint(0, 4, (8, 1))}, {"k": 1}, None),
    "auc": ("auc", lambda r: {
        "Predict": r.rand(40, 2).astype(np.float32),
        "Label": r.randint(0, 2, (40, 1))}, {}, None),
    "auc_ties_1d": ("auc", lambda r: {
        "Predict": np.round(r.rand(40), 1).astype(np.float32),
        "Label": r.randint(0, 2, 40)}, {}, None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_matches_the_jax_package(case):
    op_type, make, attrs, diff_slot = CASES[case]
    r = np.random.RandomState(sorted(CASES).index(case))
    inputs = make(r)
    jins = {k: [jnp.asarray(v)] for k, v in inputs.items()}
    pins = {k: [torch.as_tensor(v)] for k, v in inputs.items()}
    jop, pop = JREG.get(op_type), PREG.get(op_type)
    jctx = JCtx(rng=None, is_test=False, attrs=attrs)
    pctx = PCtx(rng=None, is_test=False, attrs=attrs, device="cpu")
    jout = jop.compute(jctx, jins, attrs)
    pout = pop.compute(pctx, pins, attrs)
    assert sorted(jout) == sorted(pout)
    for slot in jout:
        want = np.asarray(jout[slot][0])
        got = pout[slot][0].detach().numpy()
        assert got.shape == want.shape, slot
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6,
                                   err_msg=slot)
    if diff_slot is None:
        return
    out_slot = sorted(jout)[0] if op_type != "smooth_l1_loss" else "Out"
    cot = r.randn(*np.asarray(jout[out_slot][0]).shape).astype(np.float32)

    def jf(x):
        ins = dict(jins, **{diff_slot: [x]})
        return jop.compute(jctx, ins, attrs)[out_slot][0]

    _, vjp = jax.vjp(jf, jins[diff_slot][0])
    (jg,) = vjp(jnp.asarray(cot))
    x = pins[diff_slot][0].clone().requires_grad_()
    y = pop.compute(pctx, dict(pins, **{diff_slot: [x]}), attrs)[out_slot][0]
    (pg,) = torch.autograd.grad(y, x, torch.as_tensor(cot))
    np.testing.assert_allclose(pg.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-5)


def _layer_program(P, kind):
    x = P.data("x", [8, 5])
    h = P.layers.fc(x, 4, param_attr=P.ParamAttr(name="w"))
    fetch = []
    if kind == "cross_entropy":
        label = P.data("label", [8, 1], "int64")
        loss = P.layers.mean(P.layers.cross_entropy(
            P.layers.softmax(h), label))
        fetch.append(P.layers.accuracy(P.layers.softmax(h), label))
    elif kind == "sigmoid":
        label = P.data("label", [8, 4])
        loss = P.layers.mean(P.layers.sigmoid_cross_entropy_with_logits(
            h, label))
    elif kind == "huber":
        label = P.data("label", [8, 4])
        loss = P.layers.mean(P.layers.huber_loss(h, label, delta=0.5))
    else:  # auc
        label = P.data("label", [8, 1], "int64")
        loss = P.layers.mean(P.layers.square(h))
        fetch.append(P.layers.auc(P.layers.sigmoid(h), label))
    P.optimizer.SGD(0.2).minimize(loss)
    return loss, fetch


def _layer_feed(kind, step):
    r = np.random.RandomState(30 + step)
    feed = {"x": r.randn(8, 5).astype(np.float32)}
    if kind in ("cross_entropy", "auc"):
        feed["label"] = r.randint(0, 4 if kind != "auc" else 2,
                                  (8, 1)).astype(np.int64)
    else:
        hi = 1.0 if kind == "sigmoid" else 2.0
        feed["label"] = (r.rand(8, 4) * hi).astype(np.float32)
    return feed


@pytest.mark.parametrize("kind", ["cross_entropy", "sigmoid", "huber",
                                  "auc"])
def test_layer_program_matches_the_jax_package(kind):
    results, init = [], None
    for P in (jpt, pt):
        main, startup = P.Program(), P.Program()
        startup.random_seed = 3
        with P.program_guard(main, startup), P.unique_name.guard():
            loss, fetch = _layer_program(P, kind)
        scope = P.Scope()
        if P is jpt:
            exe = P.Executor()
            with P.scope_guard(scope):
                exe.run(startup)
            init = {v.name: np.asarray(scope.find_var(v.name))
                    for v in main.list_vars() if v.persistable}
        else:
            exe = P.Executor(P.CPUPlace())
            P.io.load_params(scope, init, "cpu", program=main)
        with P.scope_guard(scope):
            got = [[np.asarray(v) for v in exe.run(
                main, feed=_layer_feed(kind, s), fetch_list=[loss, *fetch])]
                for s in range(3)]
            got.append([np.array(scope.find_var("w"))])
        results.append(got)
    for a, b in zip(results[1], results[0]):
        for x, y in zip(a, b):
            np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-6)
