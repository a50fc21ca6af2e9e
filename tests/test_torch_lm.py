"""The port's causal LM (`paddle_tpu_torch.models`) against the JAX
package's pure-jnp ``lm_*`` functions at BertConfig.tiny() shapes.

The same numpy RandomState makes the same weights in both packages;
``lm_params_from_numpy`` carries them over.  initializer_range 0.2
spreads the logits to O(5) while attention stays soft enough that
float32 rounding is not amplified past the tolerance.  Tolerances:
logits atol 1e-4 (float32, matmuls summed in other orders); per-block
pieces atol 2e-5.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.models import BertConfig as JaxBertConfig
from paddle_tpu.models import transformer as jt
from paddle_tpu.ops.pallas_ops import xla_attention_packed
from paddle_tpu_torch.models import (BertConfig, lm_embed, lm_forward,
                                     lm_layer_finish, lm_layer_qkv,
                                     lm_param_names, lm_params_from_numpy,
                                     lm_random_params)
from paddle_tpu_torch.ops import attention_packed

torch.set_num_threads(2)

CFG = dataclasses.replace(BertConfig.tiny(), initializer_range=0.2)
JCFG = dataclasses.replace(JaxBertConfig.tiny(), initializer_range=0.2)


@pytest.fixture(scope="module")
def params():
    return lm_random_params(CFG, np.random.RandomState(0))


def test_config_and_params_equal_the_reference(params):
    for name in ("base", "large", "tiny", "ernie_base", "ernie_large"):
        assert (dataclasses.asdict(getattr(BertConfig, name)())
                == dataclasses.asdict(getattr(JaxBertConfig, name)()))
    assert lm_param_names(CFG) == jt.lm_param_names(JCFG)
    ref = jt.lm_random_params(JCFG, np.random.RandomState(0))
    assert list(params) == list(ref)
    for n in ref:
        np.testing.assert_array_equal(params[n], ref[n])
    tp = lm_params_from_numpy(params, "cpu")
    assert all(tp[n].dtype == torch.float32 and tp[n].device.type == "cpu"
               and np.array_equal(tp[n].numpy(), params[n]) for n in params)


def test_forward_logits_match_jax(params):
    rng = np.random.RandomState(2)
    tokens = rng.randint(0, CFG.vocab_size, (3, 24)).astype(np.int32)
    want = np.asarray(jt.lm_forward(
        {n: jnp.asarray(p) for n, p in params.items()}, JCFG,
        jnp.asarray(tokens)))
    got = lm_forward(lm_params_from_numpy(params, "cpu"), CFG,
                     torch.from_numpy(tokens).long()).numpy()
    assert got.shape == (3, 24, CFG.vocab_size)
    assert np.abs(want).max() > 1.0          # a spread-out, real test
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_block_pieces_match_jax(params):
    """Embedding + LN (population variance), qkv split, and the
    post-attention half with exact-erf GELU, one layer at a time."""
    rng = np.random.RandomState(4)
    toks = rng.randint(0, CFG.vocab_size, (7,))
    pos = rng.randint(0, CFG.max_position, (7,))
    jp = {n: jnp.asarray(p) for n, p in params.items()}
    tp = lm_params_from_numpy(params, "cpu")
    jx = jt.lm_embed(jp, JCFG, jnp.asarray(toks), jnp.asarray(pos))
    tx = lm_embed(tp, CFG, torch.from_numpy(toks), torch.from_numpy(pos))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=2e-5)
    for a, b in zip(lm_layer_qkv(tp, CFG, 1, tx),
                    jt.lm_layer_qkv(jp, JCFG, 1, jx)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5)
    ctxt = rng.randn(7, CFG.hidden_size).astype(np.float32)
    got = lm_layer_finish(tp, CFG, 0, tx, torch.from_numpy(ctxt))
    want = jt.lm_layer_finish(jp, JCFG, 0, jx, jnp.asarray(ctxt))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("tq,tk,causal", [(9, 9, True), (9, 9, False),
                                          (4, 9, True)])
def test_plain_attention_matches_xla_composite(tq, tk, causal):
    rng = np.random.RandomState(6)
    q = rng.randn(2, tq, 32).astype(np.float32)
    k = rng.randn(2, tk, 32).astype(np.float32)
    v = rng.randn(2, tk, 32).astype(np.float32)
    want = np.asarray(xla_attention_packed(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 4, causal=causal))
    got = attention_packed(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), 4, causal=causal).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)
