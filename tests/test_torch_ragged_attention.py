"""The port's ragged paged attention against the JAX package's.

The plain version (`paddle_tpu_torch...ragged_ref_attention`, what CPU
tensors run and what the CUDA kernel is held against on the card) must
match the JAX Pallas kernel in interpret mode and the JAX reference on
decode-only, prefill-only (causal within a chunk) and mixed row batches
across block_rows tilings, with inactive rows exactly zero.  The CUDA
wrapper itself must refuse what it cannot take — never fall back.

Tolerance: atol 2e-6 / rtol 2e-5 (float32 softmax in another summation
order), the same the JAX kernel is held to against its reference.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.generation import gathered_decode_attention as j_gathered
from paddle_tpu.generation import ragged_flash_attention as j_flash
from paddle_tpu.generation import ragged_ref_attention as j_ref
from paddle_tpu_torch.generation import (gathered_decode_attention,
                                         paged_decode_shapes_ok,
                                         ragged_paged_attention,
                                         ragged_ref_attention)
from paddle_tpu_torch.generation.ragged_attention import (
    ragged_kernel_attention)

torch.set_num_threads(2)

RTOL, ATOL = 2e-5, 2e-6


def _case(kind, block_rows, rng):
    """numpy (q, k_pages, v_pages, tables, lens, nh) for one row batch;
    lens encode the kind's row mix with one len-0 inactive row (the
    shape of tests/test_ragged_generation.py's kernel cases)."""
    nh, d, ps, pps = 4, 8, 8, 4
    H = nh * d
    nb = 8 // block_rows if block_rows <= 8 else 1
    R = nb * block_rows
    n_pages = R * pps + 1
    k = rng.randn(n_pages, ps, H).astype(np.float32)
    v = rng.randn(n_pages, ps, H).astype(np.float32)
    q = rng.randn(R, H).astype(np.float32)
    tables = (rng.permutation(np.arange(1, R * pps + 1))[:nb * pps]
              .reshape(nb, pps).astype(np.int32))
    max_len = pps * ps
    if kind == "decode":
        lens = rng.randint(1, max_len + 1, (R,))
    elif kind == "prefill":
        lens = np.concatenate([np.arange(1, block_rows + 1)] * nb)
    else:   # mixed
        lens = rng.randint(1, max_len + 1, (R,))
        lens[R // 2:] = np.arange(1, R - R // 2 + 1)   # causal tail
    lens[0] = 0                                        # inactive row
    return q, k, v, tables, lens.astype(np.int32), nh


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("block_rows", [1, 2, 4])
@pytest.mark.parametrize("kind", ["decode", "prefill", "mixed"])
def test_plain_matches_jax_kernel_and_reference(kind, block_rows):
    q, kp, vp, tables, lens, nh = _case(kind, block_rows,
                                        np.random.RandomState(11))
    jargs = [jnp.asarray(a) for a in (q, kp, vp, tables, lens)]
    want_kernel = np.asarray(j_flash(*jargs, nh, block_rows=block_rows,
                                     interpret=True))
    want_ref = np.asarray(j_ref(*jargs, nh, block_rows=block_rows))
    got = ragged_ref_attention(*_t(q, kp, vp, tables, lens), nh,
                               block_rows=block_rows).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want_kernel, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, want_ref, rtol=RTOL, atol=ATOL)
    # inactive row: exactly zero context, never NaN
    np.testing.assert_array_equal(got[lens == 0], 0.0)
    # the public entry on CPU tensors IS the plain version
    entry = ragged_paged_attention(*_t(q, kp, vp, tables, lens), nh,
                                   block_rows=block_rows).numpy()
    np.testing.assert_array_equal(entry, got)


def test_decode_only_equals_gathered_decode():
    """block_rows=1, one row per sequence: the ragged plain version is
    the gathered decode reference, bit for bit; both match JAX's."""
    rng = np.random.RandomState(3)
    nh, d, ps, pps, S = 4, 8, 8, 4, 6
    H = nh * d
    kp = rng.randn(S * pps + 1, ps, H).astype(np.float32)
    vp = rng.randn(S * pps + 1, ps, H).astype(np.float32)
    q = rng.randn(S, H).astype(np.float32)
    tables = rng.permutation(np.arange(1, S * pps + 1)).reshape(
        S, pps).astype(np.int32)
    lens = np.array([1, 7, 32, 13, 8, 25], np.int32)
    k_ctx = kp[tables].reshape(S, pps * ps, H)
    v_ctx = vp[tables].reshape(S, pps * ps, H)
    dense = gathered_decode_attention(*_t(q, k_ctx, v_ctx, lens), nh)
    ragged = ragged_ref_attention(*_t(q, kp, vp, tables, lens), nh)
    np.testing.assert_array_equal(ragged.numpy(), dense.numpy())
    want = np.asarray(j_gathered(*[jnp.asarray(a) for a in
                                   (q, k_ctx, v_ctx, lens)], nh))
    np.testing.assert_allclose(dense.numpy(), want, rtol=RTOL, atol=ATOL)


def test_shape_gate_matches_jax():
    from paddle_tpu.generation.attention import paged_decode_shapes_ok as j

    for args in [(16, 768, 12), (8, 64, 4), (12, 64, 4), (16, 96, 4),
                 (16, 768, 5), (16, 1024, 4)]:
        assert paged_decode_shapes_ok(*args) == j(*args), args


@pytest.mark.parametrize("bad", ["cpu_tensor", "rows_not_tiled",
                                 "float64", "head_dim"])
def test_kernel_wrapper_refuses_instead_of_falling_back(bad):
    """The CUDA wrapper raises on what it cannot take — a CPU tensor
    included — rather than computing through another path."""
    q, kp, vp, tables, lens, nh = _case("mixed", 2,
                                        np.random.RandomState(5))
    args = _t(q, kp, vp, tables, lens)
    bm = 2
    if bad == "rows_not_tiled":
        bm = 3
    elif bad == "float64":
        args[0] = args[0].double()
    elif bad == "head_dim":
        nh = 1                          # d_head = 32 * 4 > 128
        args = [torch.zeros(8, 256), torch.zeros(5, 8, 256),
                torch.zeros(5, 8, 256), torch.zeros(4, 2, dtype=torch.int32),
                torch.zeros(8, dtype=torch.int32)]
    with pytest.raises((ValueError, TypeError)):
        ragged_kernel_attention(*args, nh, block_rows=bm)
