"""The port's fused matmul-epilogue (paddle_tpu_torch/ops/fused_matmul.py)
against the JAX package's Pallas kernel (paddle_tpu/ops/pallas_matmul.py,
run in interpret mode on the CPU), forward and gradients.

The same numpy-seeded x [32, 64], w [64, 128], bias, residual, gamma
and beta go through ``pallas_matmul.fused_matmul`` (interpret=True) and
the port's ``fused_matmul`` — on CPU tensors its plain version, the
arithmetic its CUDA kernel repeats — over the bias / activation /
dropout / residual / norm combinations.  With dropout, the JAX
kernel's mask (interpret mode draws it host-side from the seed) is
handed to the port.  Tolerances: outputs atol 2e-5 / rtol 2e-5,
gradients atol 1e-4 / rtol 1e-4 — float32 on both sides, K = 64 and
M = 32 products summed in other orders, then a row norm over 128.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import pallas_matmul as pm
from paddle_tpu_torch.ops import fused_matmul as fm

M, K, N = 32, 64, 128
FWD = dict(atol=2e-5, rtol=2e-5)
GRAD = dict(atol=1e-4, rtol=1e-4)

# (bias, act, approximate, dropout, residual, norm, gamma, beta)
CASES = {
    "bias": (True, None, False, 0.0, False, None, False, False),
    "bare": (False, None, False, 0.0, False, None, False, False),
    "gelu": (True, "gelu", False, 0.0, False, None, False, False),
    "gelu_tanh": (True, "gelu", True, 0.0, False, None, False, False),
    "relu_dropout": (True, "relu", False, 0.25, False, None, False, False),
    "residual_layer_norm": (True, None, False, 0.0, True, "layer_norm",
                            True, True),
    "attn_out": (True, None, False, 0.1, True, "layer_norm", True, True),
    "layer_norm_no_affine": (True, "gelu", False, 0.0, True, "layer_norm",
                             False, False),
    "rms_norm": (False, "relu", False, 0.0, True, "rms_norm", True, False),
    "dropout_residual": (True, None, False, 0.3, True, None, False, False),
}


def _operands(seed, bias, residual, gamma, beta):
    r = np.random.RandomState(seed)
    return dict(
        x=r.randn(M, K).astype(np.float32),
        w=(r.randn(K, N) / np.sqrt(K)).astype(np.float32),
        bias=(r.randn(N) * 0.1).astype(np.float32) if bias else None,
        residual=r.randn(M, N).astype(np.float32) if residual else None,
        gamma=(1 + 0.1 * r.randn(N)).astype(np.float32) if gamma else None,
        beta=(0.1 * r.randn(N)).astype(np.float32) if beta else None,
        dy=r.randn(M, N).astype(np.float32))


NAMES = ("x", "w", "bias", "residual", "gamma", "beta")


def _jax(ops, spec, seed):
    args = [None if ops[n] is None else jnp.asarray(ops[n]) for n in NAMES]
    live = [i for i, a in enumerate(args) if a is not None]
    seed_arr = jnp.asarray([seed], jnp.int32)

    def f(*xs):
        full = list(args)
        for i, v in zip(live, xs):
            full[i] = v
        return pm.fused_matmul(*full, seed=seed_arr, spec=spec)

    y = f(*[args[i] for i in live])
    grads = jax.grad(lambda *xs: jnp.sum(f(*xs) * ops["dy"]),
                     argnums=tuple(range(len(live))))(
        *[args[i] for i in live])
    return np.asarray(y), {NAMES[i]: np.asarray(g)
                           for i, g in zip(live, grads)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_the_jax_kernel(case, monkeypatch):
    bias, act, approx, rate, residual, norm, gamma, beta = CASES[case]
    ops = _operands(sorted(CASES).index(case), bias, residual, gamma, beta)
    seed = 17
    jspec = pm.EpilogueSpec(act=act, act_approximate=approx,
                            dropout_rate=rate, norm=norm, interpret=True)
    want_y, want_g = _jax(ops, jspec, seed)
    if rate > 0:
        # the JAX kernel's interpret-mode mask, handed to the port's CPU path
        keep = np.array(jax.random.uniform(
            jax.random.PRNGKey(seed), (M, N)) >= rate)
        monkeypatch.setattr(fm, "cpu_keep_mask",
                            lambda s, r, shape: torch.from_numpy(keep))
    spec = fm.EpilogueSpec(act=act, act_approximate=approx,
                           dropout_rate=rate, norm=norm)
    ts = {n: None if ops[n] is None else torch.from_numpy(ops[n])
          .requires_grad_() for n in NAMES}
    y = fm.fused_matmul(*(ts[n] for n in NAMES), seed=seed, spec=spec)
    np.testing.assert_allclose(y.detach().numpy(), want_y, **FWD)
    live = [n for n in NAMES if ts[n] is not None]
    grads = torch.autograd.grad(y, [ts[n] for n in live],
                                torch.from_numpy(ops["dy"]))
    for n, g in zip(live, grads):
        np.testing.assert_allclose(g.numpy(), want_g[n], err_msg=n, **GRAD)


@pytest.mark.parametrize("case", ["gelu", "attn_out", "rms_norm"])
def test_plain_version_matches_the_jax_reference(case):
    """reference_matmul_epilogue (what the kernel is held against on the card)
    equals the JAX package's reference_matmul_epilogue, z0 included."""
    bias, act, approx, rate, residual, norm, gamma, beta = CASES[case]
    ops = _operands(3, bias, residual, gamma, beta)
    keep = (np.random.RandomState(9).rand(M, N) >= rate)
    jspec = pm.EpilogueSpec(act=act, act_approximate=approx,
                            dropout_rate=rate, norm=norm)
    want = np.asarray(pm.reference_matmul_epilogue(
        *[None if ops[n] is None else jnp.asarray(ops[n]) for n in NAMES],
        spec=jspec, mask=jnp.asarray(keep.astype(np.float32))))
    spec = fm.EpilogueSpec(act=act, act_approximate=approx,
                           dropout_rate=rate, norm=norm)
    y, z0 = fm.reference_matmul_epilogue(
        *[None if ops[n] is None else torch.from_numpy(ops[n])
          for n in NAMES], spec=spec, mask=torch.from_numpy(keep))
    np.testing.assert_allclose(y.numpy(), want, **FWD)
    z0_want = ops["x"] @ ops["w"] + (ops["bias"] if bias else 0)
    np.testing.assert_allclose(z0.numpy(), z0_want, **FWD)


def test_affine_epilogue_saves_no_z0():
    """No activation and no norm: backward does not need z0, so the
    autograd function saves none (and still differentiates)."""
    ops = _operands(5, True, True, False, False)
    x = torch.from_numpy(ops["x"]).requires_grad_()
    y = fm.fused_matmul(x, torch.from_numpy(ops["w"]),
                        torch.from_numpy(ops["bias"]),
                        torch.from_numpy(ops["residual"]))
    assert y.grad_fn.saved_tensors[6] is None
    (g,) = torch.autograd.grad(y, [x], torch.ones_like(y))
    np.testing.assert_allclose(g.numpy(), np.ones((M, N), np.float32)
                               @ ops["w"].T, **GRAD)


def test_shape_rule():
    """The kernel's own rule: BERT-base's attention output (4096 x 768 x
    768) and FFN halves fit; the 30522-wide MLM head does not (it
    replays, as on a TPU); K must tile by 8, N by 4; float32, bfloat16
    (AMP) and float16, nothing else."""
    assert fm.fused_shapes_ok(4096, 768, 768)
    assert fm.fused_shapes_ok(4096, 768, 3072)
    assert fm.fused_shapes_ok(4096, 3072, 768)
    assert fm.fused_shapes_ok(1000, 512, 1000)
    assert not fm.fused_shapes_ok(4096, 768, 30522)
    assert not fm.fused_shapes_ok(4096, 768, 8196)
    assert not fm.fused_shapes_ok(4096, 804, 768)
    assert not fm.fused_shapes_ok(4096, 768, 766)
    assert fm.fused_shapes_ok(4096, 768, 768, torch.bfloat16)
    assert fm.fused_shapes_ok(4096, 768, 768, torch.float16)
    assert not fm.fused_shapes_ok(4096, 768, 768, torch.float64)
    assert not fm.fused_shapes_ok(4096, 804, 768, torch.bfloat16)
