"""The port's flat [B, H, T, D] flash attention
(paddle_tpu_torch/ops/flash_attention.py: ``flash_attention``,
``flash_attention_lse`` and the plain versions beside the flat CUDA
kernels) against the JAX package's: ``flash_attention`` /
``flash_attention_lse`` with their Pallas kernels in interpret mode
(``_fwd_kernel``, ``_bwd_dq_kernel``, ``_bwd_dkv_kernel``) and the XLA
composite ``xla_attention``, on the same numpy-seeded inputs; then the
4-D ``fused_attention`` op program of tests/test_pallas_attention.py
through both packages' Executors from the same weights.

Shapes: those of tests/test_pallas_attention.py:22-93 and
tests/test_seq_parallel.py:178-227.  Tolerances (float32 on both sides,
summed in other orders; dropout 0): rtol 2e-4 / atol 2e-5 forward (o and
lse), rtol 1e-3 / atol 1e-4 gradients, every program step's loss within
2e-3 (``_PARITY_TOL``, __graft_entry__.py:26).
The kernels themselves run only on a card (tests/test_torch_cuda_kernels.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as pt
from paddle_tpu.ops.pallas_ops import flash_attention as jax_flash
from paddle_tpu.ops.pallas_ops import flash_attention_lse as jax_flash_lse
from paddle_tpu.ops.pallas_ops import xla_attention
from paddle_tpu_torch.core.registry import REGISTRY, OpContext
from paddle_tpu_torch.ops import attention
from paddle_tpu_torch.ops import flash_attention as fa

FWD_TOL = dict(rtol=2e-4, atol=2e-5)
GRAD_TOL = dict(rtol=1e-3, atol=1e-4)
LOSS_TOL = 2e-3

#: (B, H, Tq, Tk, D, causal, bias): test_pallas_attention.py's forward,
#: padding-bias, backward and uneven cases; test_seq_parallel.py's bias
#: gradient and lse cases; a per-head bias; causal Tq < Tk (end-aligned,
#: taken by the composite in the JAX package)
CASES = {
    "fwd": (2, 3, 128, 128, 32, False, None),
    "fwd_causal": (2, 3, 128, 128, 32, True, None),
    "padding": (2, 2, 128, 128, 16, False, "padding"),
    "bwd": (1, 2, 128, 128, 16, False, None),
    "bwd_causal": (1, 2, 128, 128, 16, True, None),
    "uneven": (2, 2, 128, 256, 32, False, "padding"),
    "bias_grad": (1, 2, 16, 16, 8, False, "random"),
    "lse": (1, 2, 16, 16, 8, False, None),
    "per_head_bias": (2, 3, 32, 48, 8, False, "per_head"),
    "causal_tq_lt_tk": (2, 2, 80, 128, 16, True, "padding"),
}


def _inputs(name):
    B, H, Tq, Tk, D, causal, kind = CASES[name]
    rng = np.random.RandomState(sorted(CASES).index(name))
    q = rng.randn(B, H, Tq, D).astype(np.float32)
    k, v = (rng.randn(B, H, Tk, D).astype(np.float32) for _ in range(2))
    w = rng.randn(B, H, Tq, D).astype(np.float32)
    u = rng.randn(B, H, Tq, 1).astype(np.float32)   # an lse cotangent
    bias = None
    if kind == "padding":
        mask = np.ones((B, Tk), np.float32)
        mask[-1, 3 * Tk // 4:] = 0.0
        bias = ((mask - 1.0) * 1e4)[:, None, None, :]
    elif kind == "random":
        bias = rng.randn(B, 1, 1, Tk).astype(np.float32)
    elif kind == "per_head":
        bias = rng.randn(B, H, 1, Tk).astype(np.float32)
    return dict(q=q, k=k, v=v, w=w, u=u, bias=bias, causal=causal)


def _jax_loss(fn, d, with_lse):
    def loss(q, k, v, b):
        if with_lse:
            o, lse = fn(q, k, v, b)
            return jnp.sum(o * d["w"]) + jnp.sum(lse * d["u"])
        return jnp.sum(fn(q, k, v, b) * d["w"])
    return loss


def _jax_grads(fn, d, with_lse=False):
    args = [jnp.asarray(d[n]) for n in ("q", "k", "v")]
    bias = jnp.zeros((1, 1, 1, 1)) if d["bias"] is None \
        else jnp.asarray(d["bias"])
    argnums = (0, 1, 2) if d["bias"] is None else (0, 1, 2, 3)
    grads = jax.grad(_jax_loss(fn, d, with_lse), argnums=argnums)(*args,
                                                                 bias)
    return [np.asarray(g) for g in grads]


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_flat_forward_and_lse_match_jax(name):
    d = _inputs(name)
    t = {n: torch.from_numpy(d[n]) for n in ("q", "k", "v")}
    tb = None if d["bias"] is None else torch.from_numpy(d["bias"])
    o, lse = fa.flash_ref_forward_flat(t["q"], t["k"], t["v"], bias=tb,
                                       causal=d["causal"])
    bias = None if d["bias"] is None else jnp.asarray(d["bias"])
    jargs = [jnp.asarray(d[n]) for n in ("q", "k", "v")]
    want = np.asarray(xla_attention(*jargs, bias=bias, causal=d["causal"]))
    np.testing.assert_allclose(o.numpy(), want, **FWD_TOL)
    s = jnp.einsum("bhqd,bhkd->bhqk", *jargs[:2]) / np.sqrt(jargs[0].shape[-1])
    if bias is not None:
        s = s + bias
    if d["causal"]:
        Tq, Tk = s.shape[-2:]
        s = jnp.where(jnp.tril(jnp.ones((Tq, Tk), bool), Tk - Tq), s, -1e30)
    np.testing.assert_allclose(lse.numpy(), np.asarray(
        jax.scipy.special.logsumexp(s, axis=-1)), **FWD_TOL)
    if not d["causal"] or CASES[name][2] == CASES[name][3]:
        # the Pallas kernels (start-aligned causal mask: Tq == Tk only)
        o_pl, lse_pl = jax_flash_lse(*jargs, bias=bias, causal=d["causal"],
                                     interpret=True)
        np.testing.assert_allclose(o.numpy(), np.asarray(o_pl), **FWD_TOL)
        np.testing.assert_allclose(lse.numpy()[..., None], np.asarray(lse_pl),
                                   **FWD_TOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_flat_autograd_with_lse_cotangent_matches_jax(name):
    """flash_attention_lse on CPU tensors (the plain versions behind the
    autograd function), differentiated through o AND lse (a nonzero lse
    cotangent folds into delta), against the Pallas custom VJP and the
    composite's autograd; flash_attention's (o only) likewise."""
    d = _inputs(name)
    leaves = [torch.from_numpy(d[n]).requires_grad_() for n in ("q", "k", "v")]
    tb = None if d["bias"] is None \
        else torch.from_numpy(d["bias"]).requires_grad_()
    o, lse = fa.flash_attention_lse(*leaves, bias=tb, causal=d["causal"])
    assert lse.shape == o.shape[:3] + (1,)
    loss = (o * torch.from_numpy(d["w"])).sum() \
        + (lse * torch.from_numpy(d["u"])).sum()
    got = torch.autograd.grad(loss, leaves + ([] if tb is None else [tb]))

    causal = d["causal"]
    D = d["q"].shape[-1]

    def composite_lse(q, k, v, b):
        b = None if d["bias"] is None else b
        s = jnp.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(D)
        if b is not None:
            s = s + b
        if causal:
            Tq, Tk = s.shape[-2:]
            s = jnp.where(jnp.tril(jnp.ones((Tq, Tk), bool), Tk - Tq), s,
                          -1e30)
        return (xla_attention(q, k, v, bias=b, causal=causal),
                jax.scipy.special.logsumexp(s, axis=-1, keepdims=True))

    wants = [_jax_grads(composite_lse, d, with_lse=True)]
    if not causal or CASES[name][2] == CASES[name][3]:
        wants.append(_jax_grads(lambda q, k, v, b: jax_flash_lse(
            q, k, v, bias=None if d["bias"] is None else b, causal=causal,
            interpret=True), d, with_lse=True))
    for want in wants:
        for n, g, r in zip(("dq", "dk", "dv", "dbias"), got, want):
            np.testing.assert_allclose(g.numpy(), r, err_msg=n, **GRAD_TOL)

    # o alone: flash_attention
    o = fa.flash_attention(*leaves, bias=tb, causal=causal)
    got = torch.autograd.grad((o * torch.from_numpy(d["w"])).sum(),
                              leaves + ([] if tb is None else [tb]))
    fns = [xla_attention]
    if not causal or CASES[name][2] == CASES[name][3]:
        fns.append(lambda *a, **kw: jax_flash(*a, interpret=True, **kw))
    for fn in fns:
        want = _jax_grads(lambda q, k, v, b: fn(
            q, k, v, bias=None if d["bias"] is None else b, causal=causal), d)
        for n, g, r in zip(("dq", "dk", "dv", "dbias"), got, want):
            np.testing.assert_allclose(g.numpy(), r, err_msg=n, **GRAD_TOL)


def test_plain_flat_versions_apply_a_given_dropout_mask():
    """With a keep mask, the plain flat forward and backward equal the
    composite with the same mask and its autograd."""
    B, H, T, D, rate = 2, 3, 24, 16, 0.25
    rng = np.random.RandomState(9)
    leaves = [torch.from_numpy(rng.randn(B, H, T, D).astype(np.float32))
              .requires_grad_() for _ in range(3)]
    bias = torch.from_numpy(rng.randn(B, 1, 1, T).astype(np.float32))
    keep = torch.from_numpy(rng.rand(B, H, T, T) >= rate)
    do = torch.from_numpy(rng.randn(B, H, T, D).astype(np.float32))
    o, lse = fa.flash_ref_forward_flat(*leaves, bias=bias,
                                       dropout_rate=rate, keep_mask=keep)
    comp = attention(*leaves, bias=bias, dropout_rate=rate, keep_mask=keep)
    np.testing.assert_allclose(o.detach().numpy(), comp.detach().numpy(),
                               **FWD_TOL)
    want = torch.autograd.grad((comp * do).sum(), leaves)
    got = fa.flash_ref_backward_flat(*(x.detach() for x in leaves), bias,
                                     o.detach(), lse.detach(), do,
                                     dropout_rate=rate, keep_mask=keep)
    for n, g, r in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), r.numpy(), err_msg=n,
                                   **GRAD_TOL)


def test_other_bias_shapes_take_the_composite_on_the_cpu():
    """A full [B, H, Tq, Tk] bias is no key bias: on the CPU
    flash_attention takes the plain composite, flash_attention_lse
    raises (it has no composite to fall to; on the card both raise)."""
    d = _inputs("lse")
    B, H, T, _ = d["q"].shape
    full = np.random.RandomState(2).randn(B, H, T, T).astype(np.float32)
    t = [torch.from_numpy(d[n]) for n in ("q", "k", "v")]
    o = fa.flash_attention(*t, bias=torch.from_numpy(full))
    want = xla_attention(*(jnp.asarray(d[n]) for n in ("q", "k", "v")),
                         bias=jnp.asarray(full))
    np.testing.assert_allclose(o.numpy(), np.asarray(want), **FWD_TOL)
    with pytest.raises(NotImplementedError, match="key bias"):
        fa.flash_attention_lse(*t, bias=torch.from_numpy(full))


def test_fused_attention_op_4d_shape_only_on_meta():
    op = REGISTRY.get(fa.OP)
    q = torch.empty(3, 4, 16, 8, device="meta")
    bias = torch.empty(3, 1, 1, 16, device="meta")
    before = dict(fa._cuda.LAUNCHES)
    got = op.compute(OpContext(rng=0, is_test=True,
                               device=torch.device("meta")),
                     {"Q": [q], "K": [q], "V": [q], "Bias": [bias]},
                     {"dropout_rate": 0.1})["Out"][0]
    assert got.device.type == "meta" and tuple(got.shape) == (3, 4, 16, 8)
    assert dict(fa._cuda.LAUNCHES) == before


def test_fused_attention_op_4d_dropout_on_cpu_is_seeded():
    op = REGISTRY.get(fa.OP)
    d = _inputs("lse")
    ins = {n.upper(): [torch.from_numpy(d[n])] for n in ("q", "k", "v")}

    def run(seed):
        return op.compute(OpContext(rng=seed), ins,
                          {"dropout_rate": 0.5})["Out"][0]

    assert torch.equal(run(11), run(11))
    assert not torch.equal(run(11), run(12))


# -- the 4-D op program through both Executors ------------------------------

def _build(pkg, Tq, Tk, causal, with_bias):
    """test_pallas_attention.py:95's program: q = fc(x), fused attention
    of q over kv (4-D, no num_heads), the mean squared error against y,
    SGD(0.5); causal and a key-padding bias optional."""
    B, H, D = 2, 2, 8
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.data("x", shape=[B, H, Tq, D], dtype="float32")
        kv = pkg.data("kv", shape=[B, H, Tk, D], dtype="float32")
        y = pkg.data("y", shape=[B, H, Tq, D], dtype="float32")
        bias = pkg.data("bias", shape=[B, 1, 1, Tk], dtype="float32") \
            if with_bias else None
        q = pkg.layers.fc(x, size=D, num_flatten_dims=3, bias_attr=False)
        o = pkg.layers.fused_multihead_attention(q, kv, kv, attn_bias=bias,
                                                 causal=causal)
        loss = pkg.layers.reduce_mean(pkg.layers.square_error_cost(o, y))
        pkg.optimizer.SGD(0.5).minimize(loss)
    rng = np.random.RandomState(Tq + Tk)
    feed = {"x": rng.rand(B, H, Tq, D).astype(np.float32),
            "kv": rng.rand(B, H, Tk, D).astype(np.float32),
            "y": rng.rand(B, H, Tq, D).astype(np.float32)}
    if with_bias:
        mask = np.ones((B, Tk), np.float32)
        mask[1, Tk - Tk // 4:] = 0.0
        feed["bias"] = ((mask - 1.0) * 1e4)[:, None, None, :]
    return main, startup, loss, feed


@pytest.mark.parametrize("Tq,Tk,causal,with_bias", [
    (16, 16, False, False),          # test_pallas_attention.py:95
    (16, 16, False, True),
    (12, 16, True, True),            # causal Tq < Tk, end-aligned
])
def test_4d_op_program_trains_like_the_jax_package(Tq, Tk, causal,
                                                   with_bias):
    jmain, jstartup, jloss, feed = _build(jpt, Tq, Tk, causal, with_bias)
    scope = jpt.Scope()
    exe = jpt.Executor()
    with jpt.scope_guard(scope):
        exe.run(jstartup)
        weights = {v.name: np.asarray(scope.find_var(v.name))
                   for v in jmain.list_vars() if v.persistable}
        jlosses = [float(exe.run(jmain, feed=feed, fetch_list=[jloss])[0])
                   for _ in range(5)]
    main, _, loss, _ = _build(pt, Tq, Tk, causal, with_bias)
    pscope = pt.Scope()
    pt.io.load_params(pscope, weights, "cpu", program=main)
    pexe = pt.Executor(pt.CPUPlace())
    losses = [float(pexe.run(main, feed=feed, fetch_list=[loss],
                             scope=pscope)[0]) for _ in range(5)]
    assert losses[-1] < losses[0]
    assert max(abs(a - b) for a, b in zip(losses, jlosses)) < LOSS_TOL, (
        losses, jlosses)
