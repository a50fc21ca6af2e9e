"""The port's flash attention (paddle_tpu_torch/ops/flash_attention.py)
against the JAX package's: the plain forward (o and lse) and backward
(dq, dk, dv, dbias) that stand beside the CUDA kernels, held against the
Pallas kernels run in interpret mode (``flash_attention_packed(...,
interpret=True)``, ``_flash_fwd_packed``) and the XLA composite
``xla_attention_packed``, on the same numpy-seeded inputs.

Tolerances are those of tests/test_pallas_attention.py for the Pallas
kernels against the composite: rtol 1e-4 / atol 1e-5 forward, rtol 1e-3
/ atol 1e-4 gradients — float32 on both sides, summed in other orders.
The kernels themselves run only on a card (tests/test_torch_cuda_kernels.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas_ops import (_flash_fwd_packed,
                                       flash_attention_packed,
                                       xla_attention_packed)
from paddle_tpu_torch.core.registry import REGISTRY, OpContext
from paddle_tpu_torch.ops import attention_packed
from paddle_tpu_torch.ops import flash_attention as fa

FWD_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-3, atol=1e-4)


def _inputs(seed, B, T, nh, D, padded=True):
    rng = np.random.RandomState(seed)
    H = nh * D
    q, k, v, w = (rng.randn(B, T, H).astype(np.float32) for _ in range(4))
    mask = np.ones((B, T), np.float32)
    if padded:
        mask[: B // 2 + 1, 3 * T // 4:] = 0.0   # pad the tail of some rows
    bias = ((mask - 1.0) * 1e4)[:, None, None, :]   # [B, 1, 1, T]
    return q, k, v, bias, w


def _jax_grads(fn, q, k, v, bias, w):
    return jax.grad(lambda q, k, v, b: jnp.sum(fn(q, k, v, b) * w),
                    argnums=(0, 1, 2, 3))(*(jnp.asarray(a)
                                            for a in (q, k, v, bias)))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("D", [64, 32])
def test_plain_flash_matches_pallas_interpret_and_composite(D, causal):
    B, T, nh = 2, 64, 4
    q, k, v, bias, w = _inputs(D + causal, B, T, nh, D)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    tbias = torch.from_numpy(bias.reshape(B, T))

    o, lse = fa.flash_ref_forward(tq, tk, tv, nh, bias=tbias, causal=causal)
    o_pl, lse_pl = _flash_fwd_packed(
        *(jnp.asarray(a) for a in (q, k, v)),
        jnp.asarray(bias.reshape(B, 1, T)), jnp.zeros((1,), jnp.int32),
        causal, 1.0 / np.sqrt(D), 0.0, True, nh)
    o_x = xla_attention_packed(*(jnp.asarray(a) for a in (q, k, v)), nh,
                               bias=jnp.asarray(bias), causal=causal)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_pl), **FWD_TOL)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_x), **FWD_TOL)
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(lse_pl).reshape(B, nh, T),
                               **FWD_TOL)

    do = torch.from_numpy(w)
    got = fa.flash_ref_backward(tq, tk, tv, tbias, o, lse, do, nh,
                                causal=causal)
    want_pl = _jax_grads(lambda *a: flash_attention_packed(
        *a[:3], nh, bias=a[3], causal=causal, interpret=True),
        q, k, v, bias, w)
    want_x = _jax_grads(lambda *a: xla_attention_packed(
        *a[:3], nh, bias=a[3], causal=causal), q, k, v, bias, w)
    for name, g, a, b in zip(("dq", "dk", "dv", "dbias"), got, want_pl,
                             want_x):
        g = g.numpy().reshape(np.shape(a))
        np.testing.assert_allclose(g, np.asarray(a), err_msg=name,
                                   **GRAD_TOL)
        np.testing.assert_allclose(g, np.asarray(b), err_msg=name,
                                   **GRAD_TOL)


@pytest.mark.parametrize("Tq", [48, 64])
def test_flash_attention_packed_autograd_matches_composite(Tq):
    """The autograd function on CPU tensors (the plain versions) against
    the JAX composite, causal with Tq <= Tk (end-aligned), through
    strided views of one packed qkv tensor."""
    B, T, nh, D = 2, 64, 4, 32
    H = nh * D
    rng = np.random.RandomState(Tq)
    qkv = rng.randn(B, T, 3 * H).astype(np.float32)
    w = rng.randn(B, Tq, H).astype(np.float32)
    bias = np.zeros((B, 1, 1, T), np.float32)
    bias[0, ..., -9:] = -1e4
    t = torch.from_numpy(qkv).requires_grad_()
    q, k, v = t[:, T - Tq:, :H], t[..., H:2 * H], t[..., 2 * H:]
    o = fa.flash_attention_packed(q, k, v, nh, bias=torch.from_numpy(bias),
                                  causal=True)
    (o * torch.from_numpy(w)).sum().backward()

    def ref(x):
        return jnp.sum(xla_attention_packed(
            x[:, T - Tq:, :H], x[..., H:2 * H], x[..., 2 * H:], nh,
            bias=jnp.asarray(bias), causal=True) * w)

    want_o = xla_attention_packed(
        jnp.asarray(qkv[:, T - Tq:, :H]), jnp.asarray(qkv[..., H:2 * H]),
        jnp.asarray(qkv[..., 2 * H:]), nh, bias=jnp.asarray(bias),
        causal=True)
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(want_o),
                               **FWD_TOL)
    np.testing.assert_allclose(t.grad.numpy(),
                               np.asarray(jax.grad(ref)(jnp.asarray(qkv))),
                               **GRAD_TOL)


def test_plain_versions_apply_a_given_dropout_mask():
    """With a keep mask, the plain forward and backward equal dropout
    computed by hand: p kept / (1 - rate), the softmax denominator over
    every key, and the backward of exactly that function."""
    B, T, nh, D, rate = 2, 24, 2, 16, 0.25
    q, k, v, bias, w = _inputs(5, B, T, nh, D)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    tbias = torch.from_numpy(bias.reshape(B, T))
    keep = torch.from_numpy(np.random.RandomState(6).rand(B, nh, T, T)
                            >= rate)
    o, lse = fa.flash_ref_forward(tq, tk, tv, nh, bias=tbias,
                                  dropout_rate=rate, keep_mask=keep)

    # by hand, heads unpacked
    def heads(x):
        return x.reshape(B, T, nh, D).transpose(1, 2)

    s = heads(tq) @ heads(tk).transpose(-1, -2) / np.sqrt(D) \
        + tbias[:, None, None, :]
    p = torch.softmax(s, -1) * keep / (1 - rate)
    want = (p @ heads(tv)).transpose(1, 2).reshape(B, T, nh * D)
    np.testing.assert_allclose(o.detach().numpy(), want.detach().numpy(),
                               **FWD_TOL)
    np.testing.assert_allclose(lse.detach().numpy(),
                               torch.logsumexp(s, -1).detach().numpy(),
                               **FWD_TOL)

    do = torch.from_numpy(w)
    grads = torch.autograd.grad((want * do).sum(), (tq, tk, tv))
    got = fa.flash_ref_backward(tq.detach(), tk.detach(), tv.detach(),
                                tbias, o.detach(), lse.detach(), do, nh,
                                dropout_rate=rate, keep_mask=keep)
    for name, g, r in zip(("dq", "dk", "dv"), got, grads):
        np.testing.assert_allclose(g.numpy(), r.numpy(), err_msg=name,
                                   **GRAD_TOL)
    # the composite with the same mask agrees too
    comp = attention_packed(tq, tk, tv, nh, bias=torch.from_numpy(bias),
                            dropout_rate=rate, keep_mask=keep)
    np.testing.assert_allclose(comp.detach().numpy(), o.detach().numpy(),
                               **FWD_TOL)


def test_fused_attention_op_shape_only_on_meta():
    """On meta tensors the op returns the output's shape and launches
    nothing (program-build shape inference)."""
    op = REGISTRY.get(fa.OP)
    q = torch.empty(3, 16, 64, device="meta")
    bias = torch.empty(3, 1, 1, 16, device="meta")
    ctx = OpContext(rng=0, is_test=True, device=torch.device("meta"))
    attrs = {"num_heads": 4, "dropout_rate": 0.1}
    before = dict(fa._cuda.LAUNCHES)
    got = op.compute(ctx, {"Q": [q], "K": [q], "V": [q], "Bias": [bias]},
                     attrs)["Out"][0]
    assert got.device.type == "meta" and tuple(got.shape) == (3, 16, 64)
    assert dict(fa._cuda.LAUNCHES) == before


def test_fused_attention_op_dropout_on_cpu_is_seeded():
    """With dropout on, the CPU path draws its mask from the op's seed:
    the same seed repeats the output, another seed changes it, and about
    the kept fraction of probability mass survives."""
    op = REGISTRY.get(fa.OP)
    q, k, v, bias, _ = _inputs(7, 2, 32, 4, 16)
    ins = {"Q": [torch.from_numpy(q)], "K": [torch.from_numpy(k)],
           "V": [torch.from_numpy(v)], "Bias": [torch.from_numpy(bias)]}
    attrs = {"num_heads": 4, "dropout_rate": 0.5}

    def run(seed):
        return op.compute(OpContext(rng=seed), ins, attrs)["Out"][0]

    assert torch.equal(run(11), run(11))
    assert not torch.equal(run(11), run(12))
