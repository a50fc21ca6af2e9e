"""The port's sampler against the JAX package's, bit for bit.

Seeded sampling must draw the JAX engine's tokens: the threefry2x32
hash, ``fold_in``, the random bits, the uniforms and the Gumbel noise of
``paddle_tpu_torch.generation._threefry`` must equal ``jax.random``'s
exactly (compared as uint32 / float32 bit patterns, tolerance 0), and
``sample_tokens_folded`` must pick the same token in every row.  The
truncation (temperature, top-k, top-p) must keep the same sets with the
same values, bit for bit: its softmax and running sums are XLA's CPU
arithmetic, reproduced in ``_xla_math``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.generation import sampler as jsampler
from paddle_tpu_torch.generation import (SamplingParams, _threefry, _xla_math,
                                         batch_sampling_arrays, fold_data_for,
                                         root_key_data, sample_tokens_folded)
from paddle_tpu_torch.generation.sampler import _truncate

torch.set_num_threads(2)

SEEDS = [0, 7, 12345, 2 ** 31 - 1]


def _jkey(data):
    return jax.random.wrap_key_data(jnp.asarray(data, jnp.uint32),
                                    impl="threefry2x32")


def _tkey(data):
    return torch.as_tensor(np.asarray(data, np.uint32).astype(np.int64))


def _bits(x):
    return np.asarray(x).view(np.uint32)


@pytest.mark.parametrize("seed", SEEDS)
def test_root_key_and_fold_in_equal_jax(seed):
    root = root_key_data(seed)
    want_root = np.asarray(jax.random.key_data(
        jax.random.key(seed, impl="threefry2x32")))
    np.testing.assert_array_equal(root, want_root)
    words = np.array([fold_data_for(u, p) for u, p in
                      [(0, 0), (1, 5), (3, 2 ** 20 - 1), (4095, 77),
                       (2 ** 13, 9)]], np.uint32)
    want = np.stack([np.asarray(jax.random.key_data(
        jax.random.fold_in(_jkey(root), int(w)))) for w in words])
    got = _threefry.fold_in(_tkey(root).expand(len(words), 2),
                            _tkey(words)).numpy()
    np.testing.assert_array_equal(got.astype(np.uint32), want)


@pytest.mark.parametrize("seed", SEEDS)
def test_bits_uniform_and_gumbel_equal_jax_bit_for_bit(seed):
    key = root_key_data(seed)
    n = 4099                                  # not a power of two
    want_bits = np.asarray(jax.random.bits(_jkey(key), (n,)))
    got_bits = _threefry.random_bits(_tkey(key), n).numpy()
    np.testing.assert_array_equal(got_bits.astype(np.uint32), want_bits)
    tiny = float(np.finfo(np.float32).tiny)
    want_u = jax.random.uniform(_jkey(key), (n,), minval=tiny)
    got_u = _threefry.uniform(_tkey(key), n, minval=tiny)
    np.testing.assert_array_equal(_bits(got_u.numpy()), _bits(want_u))
    want_g = jax.random.gumbel(_jkey(key), (n,))
    got_g = _threefry.gumbel(_tkey(key), n)
    assert got_g.dtype == torch.float32
    np.testing.assert_array_equal(_bits(got_g.numpy()), _bits(want_g))


def test_gumbel_over_many_folded_keys_equals_jax():
    """Batched keys, as the sampler draws them: one folded key per row."""
    root = root_key_data(3)
    words = np.array([fold_data_for(u, p) for u in range(8)
                      for p in (0, 1, 31, 500)], np.uint32)
    keys = _threefry.fold_in(_tkey(root).expand(len(words), 2),
                             _tkey(words))
    got = _threefry.gumbel(keys, 1024).numpy()
    jroot = _jkey(root)
    want = np.stack([np.asarray(jax.random.gumbel(
        jax.random.fold_in(jroot, int(w)), (1024,))) for w in words])
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_xla_log_edges():
    x = torch.tensor([0.0, -1.0, float("inf"), 1.0, 2.0 ** -126, 3.5,
                      float(np.finfo(np.float32).max)])
    got = _threefry.xla_log(x).numpy()
    want = np.asarray(jax.jit(jnp.log)(jnp.asarray(x.numpy())))
    assert got[0] == -np.inf and np.isnan(got[1]) and got[2] == np.inf
    np.testing.assert_array_equal(_bits(got[3:]), _bits(want[3:]))


def _knobs(rng, R):
    temps = rng.choice([0.0, 0.7, 1.0, 1.3], R).astype(np.float32)
    tks = rng.choice([0, 1, 5, 40], R).astype(np.int32)
    tps = rng.choice([1.0, 0.95, 0.5, 0.1], R).astype(np.float32)
    return temps, tks, tps


def test_truncate_keeps_the_same_sets():
    """The kept sets and the kept values are JAX's exactly: the
    probabilities and their running mass are summed in XLA's order."""
    rng = np.random.RandomState(0)
    R = 24
    for V, scale in ((257, 3), (257, 30), (1024, 10), (4099, 3)):
        logits = (rng.randn(R, V) * scale).astype(np.float32)
        temps, tks, tps = _knobs(rng, R)
        want = np.asarray(jsampler._truncate(
            jnp.asarray(logits), jnp.asarray(temps), jnp.asarray(tks),
            jnp.asarray(tps)))
        got = _truncate(*[torch.from_numpy(a) for a in
                          (logits, temps, tks, tps)]).numpy()
        np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("V", [5, 16, 17, 100, 257, 4099, 30522])
def test_xla_softmax_and_cumsum_equal_jax_bit_for_bit(V):
    """XLA's CPU tree sum and tiled scan, reproduced at sizes below one
    tile, one level, and the BERT vocabulary's four levels."""
    rng = np.random.RandomState(V)
    x = (rng.randn(6, V) * 20).astype(np.float32)
    x[:, ::7] = -1e30                         # masked, as after top-k
    want = np.asarray(jax.jit(lambda a: jax.nn.softmax(a, axis=-1))(x))
    got = _xla_math.xla_softmax(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    p = -np.sort(-want, axis=1)
    want_c = np.asarray(jax.jit(lambda a: jnp.cumsum(a, axis=-1))(p))
    got_c = _xla_math.xla_cumsum(torch.from_numpy(p)).numpy()
    np.testing.assert_array_equal(_bits(got_c), _bits(want_c))
    want_s = np.asarray(jax.jit(lambda a: jnp.sum(a, axis=-1))(p))
    got_s = _xla_math.xla_sum(torch.from_numpy(p)).numpy()
    np.testing.assert_array_equal(_bits(got_s), _bits(want_s))


def test_xla_exp_equals_jax_bit_for_bit():
    """Over the softmax's domain, down into the flushed underflow."""
    rng = np.random.RandomState(2)
    x = np.concatenate([-rng.rand(20000) * 100, rng.randn(20000) * 3,
                        rng.rand(2000) * 88.3]).astype(np.float32)
    want = np.asarray(jax.jit(jnp.exp)(x))
    got = _xla_math.xla_exp(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("greedy_only", [False, True])
def test_sample_tokens_folded_draws_the_jax_tokens(greedy_only):
    rng = np.random.RandomState(1)
    R, V = 32, 1024
    logits = (rng.randn(R, V) * 2).astype(np.float32)
    temps, tks, tps = _knobs(rng, R)
    root = root_key_data(11)
    fold = np.array([fold_data_for(rng.randint(1000), rng.randint(512))
                     for _ in range(R)], np.uint32)
    want = np.asarray(jsampler.sample_tokens_folded(
        jnp.asarray(logits), jnp.asarray(root), jnp.asarray(fold),
        jnp.asarray(temps), jnp.asarray(tks), jnp.asarray(tps),
        greedy_only=greedy_only))
    got = sample_tokens_folded(
        torch.from_numpy(logits), _tkey(root), _tkey(fold),
        torch.from_numpy(temps), torch.from_numpy(tks),
        torch.from_numpy(tps), greedy_only=greedy_only).numpy()
    np.testing.assert_array_equal(got, want)
    if not greedy_only:
        # the draws are real: sampled rows do not all take the argmax
        sampled = temps > 0
        assert (got[sampled] != logits[sampled].argmax(-1)).any()


def test_sampling_params_and_arrays_follow_the_reference():
    sps = [SamplingParams(), SamplingParams(temperature=0.8, top_k=4,
                                            top_p=0.9, eos_id=2)]
    for a, b in zip(batch_sampling_arrays(sps, 5),
                    jsampler.batch_sampling_arrays(
                        [jsampler.SamplingParams(**vars(s)) for s in sps],
                        5)):
        np.testing.assert_array_equal(a, b)
    for bad in (dict(max_new_tokens=0), dict(temperature=-1.0),
                dict(top_p=0.0), dict(top_k=-1)):
        with pytest.raises(ValueError):
            SamplingParams(**bad)
    assert fold_data_for(5, 9) == jsampler.fold_data_for(5, 9)
    assert fold_data_for(2 ** 13, 1) == jsampler.fold_data_for(2 ** 13, 1)
