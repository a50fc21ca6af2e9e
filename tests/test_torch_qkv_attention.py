"""The port's qkv-folded attention entry (paddle_tpu_torch/ops/
attention_epilogue.py) against the JAX package's (paddle_tpu/ops/
attention_epilogue.py, its Pallas kernel run in interpret mode on the
CPU), forward and gradients.

The same numpy-seeded x [2, 32, 48], w_qkv [48, 384], b_qkv [384] and a
key-padding bias go through ``attention_epilogue.fused_qkv_attention``
(interpret=True) and the port's ``fused_qkv_attention`` — on CPU
tensors its plain versions: the biased q/k/v and the flash reference,
then flash_ref_backward and the bias / GEMM adjoints — with and without
the causal mask and the bias, at 4 and 8 heads, dropout 0 (the JAX
kernel's interpret mode has no dropout).  Dropout is held against the
port's own plain composite with the same mask.  Tolerances: outputs
atol 2e-5 / rtol 2e-4, gradients atol 2e-4 / rtol 2e-3 — the JAX
package's own tolerances for this kernel against its composite
(tests/test_block_fusion.py): float32 online softmax against a plain
softmax, and 64 rows of dqkv summed into dw.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import attention_epilogue as jae
from paddle_tpu_torch.ops import attention_epilogue as ae
from paddle_tpu_torch.ops import flash_attention as fa

B, T, K, H = 2, 32, 48, 128
FWD = dict(atol=2e-5, rtol=2e-4)
GRAD = dict(atol=2e-4, rtol=2e-3)


def _operands(seed, with_bias):
    r = np.random.RandomState(seed)
    bias = None
    if with_bias:
        bias = np.zeros((B, 1, 1, T), np.float32)
        bias[0, ..., T - 8:] = -1e4
    return (r.randn(B, T, K).astype(np.float32),
            (r.randn(K, 3 * H) / np.sqrt(K)).astype(np.float32),
            (0.1 * r.randn(3 * H)).astype(np.float32), bias,
            r.randn(B, T, H).astype(np.float32))


@pytest.mark.parametrize("with_bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("nh", [4, 8])
def test_matches_the_jax_kernel(nh, causal, with_bias):
    x, w, b, bias, do = _operands(nh + 2 * causal + with_bias, with_bias)
    jbias = None if bias is None else jnp.asarray(bias)

    def jf(x_, w_, b_):
        return jae.fused_qkv_attention(x_, w_, b_, nh, attn_bias=jbias,
                                       causal=causal, interpret=True)

    want = np.asarray(jf(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    want_g = jax.grad(lambda *a: jnp.sum(jf(*a) * do), argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, w, b)]
    got = ae.fused_qkv_attention(
        *ts, nh, attn_bias=None if bias is None else torch.from_numpy(bias),
        causal=causal)
    np.testing.assert_allclose(got.detach().numpy(), want, **FWD)
    grads = torch.autograd.grad(got, ts, torch.from_numpy(do))
    for name, g, wg in zip(("x", "w", "b_qkv"), grads, want_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(wg), err_msg=name,
                                   **GRAD)


def test_plain_version_matches_the_jax_composite():
    """plain_qkv_attention (the composite the kernel path is held
    against) equals the JAX package's xla_qkv_attention."""
    x, w, b, bias, _ = _operands(11, True)
    want = np.asarray(jae.xla_qkv_attention(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 4,
        attn_bias=jnp.asarray(bias)))
    got = ae.plain_qkv_attention(torch.from_numpy(x), torch.from_numpy(w),
                                 torch.from_numpy(b), 4,
                                 attn_bias=torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), want, **FWD)


def test_dropout_matches_the_plain_composite():
    """With dropout the entry draws the keep mask the flash op draws for
    its seed; the plain composite given that mask agrees, forward and
    gradients (the grad path runs the flash backward's plain version)."""
    x, w, b, bias, do = _operands(5, True)
    seed, rate, nh = 1234, 0.2, 4
    mask = fa._cpu_keep_mask(seed, rate, (B, nh, T, T))
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, w, b)]
    got = ae.fused_qkv_attention(*ts, nh, attn_bias=torch.from_numpy(bias),
                                 dropout_rate=rate, seed=seed)
    g1 = torch.autograd.grad(got, ts, torch.from_numpy(do))
    ts2 = [torch.from_numpy(a).requires_grad_() for a in (x, w, b)]
    want = ae.plain_qkv_attention(*ts2, nh, attn_bias=torch.from_numpy(bias),
                                  dropout_rate=rate, keep_mask=mask)
    g2 = torch.autograd.grad(want, ts2, torch.from_numpy(do))
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                               **FWD)
    for a, c in zip(g1, g2):
        np.testing.assert_allclose(a.numpy(), c.numpy(), **GRAD)


def test_shape_rule():
    """The port's rule: any head count that splits H into heads of at
    most 128 dims (the TPU's H % 128 lane rule does not carry over);
    float32, bfloat16 and float16 (AMP), no other dtype; a key-padding
    bias only."""
    assert ae.attn_epilogue_shapes_ok(128, 768, 12)
    assert ae.attn_epilogue_shapes_ok(32, 64, 4)       # H % 128 != 0: fine
    assert not ae.attn_epilogue_shapes_ok(128, 768, 5)
    assert not ae.attn_epilogue_shapes_ok(128, 1024, 4)  # d_head 256
    assert ae.attn_epilogue_shapes_ok(128, 768, 12, torch.float16)
    assert ae.attn_epilogue_shapes_ok(128, 768, 12, torch.bfloat16)
    assert not ae.attn_epilogue_shapes_ok(128, 768, 12, torch.float64)
    assert ae.key_padding_ok(torch.zeros(2, 1, 1, 32), 2, 32)
    assert ae.key_padding_ok(torch.zeros(1, 1, 1, 32), 2, 32)
    assert not ae.key_padding_ok(torch.zeros(2, 1, 32, 32), 2, 32)
    with pytest.raises(ValueError, match="key-padding"):
        ae.fused_qkv_attention(torch.zeros(2, 32, 48), torch.zeros(48, 384),
                               torch.zeros(384), 4,
                               attn_bias=torch.zeros(2, 1, 32, 32))
