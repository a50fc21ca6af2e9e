"""The port's paged decode attention against the JAX package's.

The same page pool, tables, lengths and queries (one numpy RandomState)
go through the port's ``paged_decode_attention`` on the CPU (its plain
version, the kernel's function) and through JAX's Pallas kernel in
interpret mode, ``paged_flash_decode_attention(interpret=True)``, and
its jnp reference ``paged_ref_decode_attention``.  Slots of length 0,
1, one page, one page + 1 and the full capacity are among them.

Tolerance: atol 1e-5 / rtol 1e-5 — float32 softmax over at most 128
unit-scale keys, summed in another order.  Empty slots are exactly zero
in the port and in the JAX kernel; the JAX reference averages their
masked keys instead, so it is compared on live slots, and the port's
reference equals it everywhere.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.generation.attention import (
    paged_decode_shapes_ok as j_shapes_ok,
    paged_flash_decode_attention as j_kernel,
    paged_ref_decode_attention as j_ref)
from paddle_tpu_torch import _cuda
from paddle_tpu_torch.generation import (paged_decode_attention,
                                         paged_decode_shapes_ok,
                                         paged_ref_decode_attention)

torch.set_num_threads(2)

ATOL = RTOL = 1e-5


def _case(seed, num_heads=4, head_dim=16, seqs=6, page_size=8,
          pages_per_seq=4, spare=3):
    rng = np.random.RandomState(seed)
    H = num_heads * head_dim
    num_pages = seqs * pages_per_seq + spare
    k = rng.randn(num_pages, page_size, H).astype(np.float32)
    v = rng.randn(num_pages, page_size, H).astype(np.float32)
    q = rng.randn(seqs, H).astype(np.float32)
    tables = rng.permutation(np.arange(1, num_pages))[
        :seqs * pages_per_seq].reshape(seqs, pages_per_seq).astype(np.int32)
    cap = page_size * pages_per_seq
    lens = np.array([0, 1, page_size, page_size + 1, cap,
                     rng.randint(1, cap)][:seqs], np.int32)
    return q, k, v, tables, lens, num_heads


@pytest.mark.parametrize("head_dim", [8, 16, 32])
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_version_matches_the_jax_kernel_and_reference(head_dim, seed):
    q, k, v, tables, lens, nh = _case(seed, head_dim=head_dim)
    got = paged_decode_attention(
        *[torch.from_numpy(a) for a in (q, k, v, tables, lens)], nh).numpy()
    want_kernel = np.asarray(j_kernel(
        *[jnp.asarray(a) for a in (q, k, v, tables, lens)], nh,
        interpret=True))
    want_ref = np.asarray(j_ref(
        *[jnp.asarray(a) for a in (q, k, v, tables, lens)], nh))
    np.testing.assert_allclose(got, want_kernel, atol=ATOL, rtol=RTOL)
    live = lens > 0
    np.testing.assert_allclose(got[live], want_ref[live], atol=ATOL,
                               rtol=RTOL)
    assert (got[~live] == 0).all() and (want_kernel[~live] == 0).all()
    port_ref = paged_ref_decode_attention(
        *[torch.from_numpy(a) for a in (q, k, v, tables, lens)], nh).numpy()
    np.testing.assert_allclose(port_ref, want_ref, atol=ATOL, rtol=RTOL)


def test_sm_scale_and_tight_pool():
    """An explicit softmax scale, and a pool with no spare page beyond the
    tables (every page but scratch owned)."""
    q, k, v, tables, lens, nh = _case(3, spare=1)
    args_t = [torch.from_numpy(a) for a in (q, k, v, tables, lens)]
    args_j = [jnp.asarray(a) for a in (q, k, v, tables, lens)]
    got = paged_decode_attention(*args_t, nh, sm_scale=0.3).numpy()
    want = np.asarray(j_kernel(*args_j, nh, sm_scale=0.3, interpret=True))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_cpu_tensors_take_the_plain_version():
    q, k, v, tables, lens, nh = _case(4)
    _cuda.reset_launches()
    paged_decode_attention(
        *[torch.from_numpy(a) for a in (q, k, v, tables, lens)], nh)
    assert sum(_cuda.LAUNCHES.values()) == 0
    assert _cuda.library_loads() == 0


@pytest.mark.parametrize("page_size,hidden,heads",
                         [(16, 768, 12), (8, 64, 4), (16, 96, 3),
                          (12, 64, 4), (16, 1024, 4), (16, 770, 12)])
def test_shape_gate_follows_the_reference(page_size, hidden, heads):
    assert paged_decode_shapes_ok(page_size, hidden, heads) == \
        j_shapes_ok(page_size, hidden, heads)
