"""The port's chained two-GEMM FFN (paddle_tpu_torch/ops/ffn_chain.py)
against the JAX package's Pallas kernel (paddle_tpu/ops/pallas_ffn_chain.py,
run in interpret mode on the CPU), forward and gradients.

The same numpy-seeded x [32, 64], w1 [64, 128], b1, w2 [128, 64], b2 and
tail operands go through ``pallas_ffn_chain.fused_ffn_chain``
(interpret=True) and the port's ``fused_ffn_chain`` — on CPU tensors its
plain version — over activation, b2, dropout, residual and norm.  With
dropout the JAX kernel's interpret-mode mask is handed to the port.
Tolerances: outputs atol 2e-5 / rtol 2e-5, gradients atol 1e-4 / rtol
1e-4 — float32, K = 64 and F = 128 products summed in other orders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import pallas_ffn_chain as pfc
from paddle_tpu.ops import pallas_matmul as pm
from paddle_tpu_torch.ops import ffn_chain as fc
from paddle_tpu_torch.ops.fused_matmul import EpilogueSpec

M, K, F, N = 32, 64, 128, 64
FWD = dict(atol=2e-5, rtol=2e-5)
GRAD = dict(atol=1e-4, rtol=1e-4)
NAMES = ("x", "w1", "b1", "w2", "b2", "residual", "gamma", "beta")

# (act, b2, dropout, residual, norm, gamma, beta)
CASES = {
    "gelu": ("gelu", True, 0.0, False, None, False, False),
    "relu_no_b2": ("relu", False, 0.0, False, None, False, False),
    "gelu_tanh_residual": ("gelu", True, 0.0, True, None, False, False),
    "bert_ffn": ("gelu", True, 0.1, True, "layer_norm", True, True),
    "relu_rms_norm": ("relu", True, 0.0, True, "rms_norm", True, False),
    "dropout_only": ("gelu", False, 0.3, False, None, False, False),
}


def _operands(seed, b2, residual, gamma, beta):
    r = np.random.RandomState(seed)
    return dict(
        x=r.randn(M, K).astype(np.float32),
        w1=(r.randn(K, F) / np.sqrt(K)).astype(np.float32),
        b1=(0.1 * r.randn(F)).astype(np.float32),
        w2=(r.randn(F, N) / np.sqrt(F)).astype(np.float32),
        b2=(0.1 * r.randn(N)).astype(np.float32) if b2 else None,
        residual=r.randn(M, N).astype(np.float32) if residual else None,
        gamma=(1 + 0.1 * r.randn(N)).astype(np.float32) if gamma else None,
        beta=(0.1 * r.randn(N)).astype(np.float32) if beta else None,
        dy=r.randn(M, N).astype(np.float32))


def _jax(ops, spec, seed):
    args = [None if ops[n] is None else jnp.asarray(ops[n]) for n in NAMES]
    live = [i for i, a in enumerate(args) if a is not None]
    seed_arr = jnp.asarray([seed], jnp.int32)

    def f(*xs):
        full = list(args)
        for i, v in zip(live, xs):
            full[i] = v
        return pfc.fused_ffn_chain(*full, seed=seed_arr, spec=spec)

    y = f(*[args[i] for i in live])
    grads = jax.grad(lambda *xs: jnp.sum(f(*xs) * ops["dy"]),
                     argnums=tuple(range(len(live))))(
        *[args[i] for i in live])
    return np.asarray(y), {NAMES[i]: np.asarray(g)
                           for i, g in zip(live, grads)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_the_jax_kernel(case, monkeypatch):
    act, b2, rate, residual, norm, gamma, beta = CASES[case]
    ops = _operands(sorted(CASES).index(case), b2, residual, gamma, beta)
    approx = case == "gelu_tanh_residual"
    seed = 23
    want_y, want_g = _jax(ops, pm.EpilogueSpec(
        act=act, act_approximate=approx, dropout_rate=rate, norm=norm,
        interpret=True), seed)
    if rate > 0:
        keep = np.array(jax.random.uniform(
            jax.random.PRNGKey(seed), (M, N)) >= rate)
        monkeypatch.setattr(fc, "cpu_keep_mask",
                            lambda s, r, shape: torch.from_numpy(keep))
    spec = EpilogueSpec(act=act, act_approximate=approx, dropout_rate=rate,
                        norm=norm)
    ts = {n: None if ops[n] is None else torch.from_numpy(ops[n])
          .requires_grad_() for n in NAMES}
    y = fc.fused_ffn_chain(*(ts[n] for n in NAMES), seed=seed, spec=spec)
    np.testing.assert_allclose(y.detach().numpy(), want_y, **FWD)
    live = [n for n in NAMES if ts[n] is not None]
    grads = torch.autograd.grad(y, [ts[n] for n in live],
                                torch.from_numpy(ops["dy"]))
    for n, g in zip(live, grads):
        np.testing.assert_allclose(g.numpy(), want_g[n], err_msg=n, **GRAD)


def test_plain_version_matches_the_jax_reference():
    ops = _operands(4, True, True, True, True)
    keep = np.random.RandomState(2).rand(M, N) >= 0.2
    jspec = pm.EpilogueSpec(act="gelu", dropout_rate=0.2, norm="layer_norm")
    want = np.asarray(pfc.reference_ffn_chain(
        *[None if ops[n] is None else jnp.asarray(ops[n]) for n in NAMES],
        spec=jspec, mask=jnp.asarray(keep.astype(np.float32))))
    got = fc.reference_ffn_chain(
        *[torch.from_numpy(ops[n]) for n in NAMES],
        spec=EpilogueSpec(act="gelu", dropout_rate=0.2, norm="layer_norm"),
        mask=torch.from_numpy(keep))
    np.testing.assert_allclose(got.numpy(), want, **FWD)


def test_backward_saves_no_intermediate():
    """Only the inputs and the mask are saved: no [M, F] tensor."""
    ops = _operands(1, True, True, True, True)
    ts = [torch.from_numpy(ops[n]).requires_grad_() for n in NAMES]
    y = fc.fused_ffn_chain(*ts, spec=EpilogueSpec(act="gelu",
                                                  norm="layer_norm"))
    shapes = [tuple(t.shape) for t in y.grad_fn.saved_tensors
              if t is not None]
    assert (M, F) not in shapes


def _rule_before_the_cluster_kernel(M, K, F, N):
    """ffn_chain_shapes_ok as it read when one CTA kept x's 32 rows whole
    in shared memory (copied here so the new rule is held against it)."""
    smem = 4 * (K * 32 + 2 * 16 * 128 + 128 * 32 + 2 * 8 * 256 * -(-N // 256))
    return (M >= 1 and K >= 16 and K % 16 == 0 and F >= 128
            and F % 128 == 0 and N >= 4 and N % 4 == 0 and N <= 768
            and smem <= 232448)


@pytest.mark.parametrize("F", range(128, 4097, 128))
def test_shape_rule(F):
    """The kernel's real rule takes every shape the rule before it took
    (K over the multiples of 16 up to 2048, N over those of 4 up to 768,
    at this F), and the K that the whole x rows in shared memory used to
    refuse."""
    for K in range(16, 2049, 16):
        for N in range(4, 769, 4):
            if _rule_before_the_cluster_kernel(4096, K, F, N):
                assert fc.ffn_chain_shapes_ok(4096, K, F, N), (K, F, N)
    assert not _rule_before_the_cluster_kernel(4096, 2048, F, 768)
    assert fc.ffn_chain_shapes_ok(4096, 2048, F, 768)


def test_shape_rule_edges():
    """It takes BERT-base's FFN (M 4096, K 768, F 3072, N 768) and
    BERT-tiny's; N above 768 (each CTA of the pair holds half of the
    accumulator row in registers), F not a multiple of 128, K not of 16
    or a dtype other than float32, bfloat16 and float16 (AMP) do not
    fit.  Shared memory is the same for every shape and within a
    block's."""
    assert fc.ffn_chain_shapes_ok(4096, 768, 3072, 768)
    assert fc.ffn_chain_shapes_ok(256, 128, 128, 128)
    assert fc.ffn_chain_shapes_ok(64, 64, 128, 64)
    assert fc.ffn_chain_shapes_ok(40, 4096, 640, 500)
    assert not fc.ffn_chain_shapes_ok(4096, 1024, 4096, 1024)
    assert not fc.ffn_chain_shapes_ok(4096, 768, 3000, 768)
    assert not fc.ffn_chain_shapes_ok(4096, 760, 3072, 768)
    assert not fc.ffn_chain_shapes_ok(0, 768, 3072, 768)
    assert fc.ffn_chain_shapes_ok(4096, 768, 3072, 768, torch.float16)
    assert fc.ffn_chain_shapes_ok(4096, 768, 3072, 768, torch.bfloat16)
    assert not fc.ffn_chain_shapes_ok(4096, 768, 3072, 768, torch.float64)
    assert fc.ffn_chain_smem_bytes() == 222224 <= fc.SMEM_LIMIT
