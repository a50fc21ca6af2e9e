"""The port's hand-written CUDA kernels against their plain versions, on
the card.

A CUDA kernel has no CPU mode, so every test here is marked ``cuda`` and
skips on a host without a card.  On a machine with one (no JAX needed):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda_kernels.py

Tolerance: atol 1e-5 / rtol 1e-5 — float32 online softmax against the
plain version's float32 softmax, summed in another order over at most
a few hundred unit-scale keys.  Inactive rows must be exactly zero.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch import _cuda
from paddle_tpu_torch.generation.ragged_attention import (
    ragged_kernel_attention, ragged_paged_attention, ragged_ref_attention)

pytestmark = pytest.mark.cuda

ATOL = RTOL = 1e-5


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernel has no "
                    "CPU mode (its plain version is tested on the CPU)")
    return torch.device("cuda")


def _case(rng, device, kind, block_rows, num_heads, head_dim, page_size=16,
          pages_per_seq=8, blocks=12):
    H = num_heads * head_dim
    R = blocks * block_rows
    num_pages = blocks * pages_per_seq + 1
    k = rng.randn(num_pages, page_size, H).astype(np.float32)
    v = rng.randn(num_pages, page_size, H).astype(np.float32)
    q = rng.randn(R, H).astype(np.float32)
    tables = rng.permutation(np.arange(1, num_pages)).reshape(
        blocks, pages_per_seq).astype(np.int32)
    cap = page_size * pages_per_seq
    if kind == "decode":
        lens = rng.randint(1, cap + 1, R)
    elif kind == "prefill":
        lens = np.arange(R) % cap + 1
    else:   # mixed, with the capacity edge
        lens = rng.randint(1, cap + 1, R)
        lens[R // 2:] = np.arange(1, R - R // 2 + 1)
        lens[1] = cap
    lens[0] = 0                               # inactive row
    lens[-1] = 0
    t = [torch.from_numpy(a).to(device) for a in (q, k, v, tables)]
    return (*t, torch.from_numpy(lens.astype(np.int32)).to(device),
            num_heads)


@pytest.mark.parametrize("head_dim", [32, 64, 128])
@pytest.mark.parametrize("block_rows", [1, 2, 4])
@pytest.mark.parametrize("kind", ["decode", "prefill", "mixed"])
def test_kernel_matches_plain_version(device, kind, block_rows, head_dim):
    args = _case(np.random.RandomState(block_rows * 7 + head_dim), device,
                 kind, block_rows, 768 // 64, head_dim)
    lens = args[4]
    before = _cuda.LAUNCHES["ragged_paged_attention"]
    got = ragged_paged_attention(*args, block_rows=block_rows)
    want = ragged_ref_attention(*args, block_rows=block_rows)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["ragged_paged_attention"] == before + 1
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)
    assert (got[lens == 0] == 0).all()


def test_strided_q_and_sm_scale(device):
    """q as the engine passes it: a column slice of the packed qkv
    projection (row stride 3H), with an explicit softmax scale."""
    q, k, v, tables, lens, nh = _case(np.random.RandomState(3), device,
                                      "mixed", 1, 12, 64)
    qkv = torch.cat([q, torch.randn_like(q), torch.randn_like(q)], dim=1)
    qs = qkv[:, :q.shape[1]]
    assert not qs.is_contiguous()
    got = ragged_kernel_attention(qs, k, v, tables, lens, nh, sm_scale=0.3)
    want = ragged_ref_attention(q, k, v, tables, lens, nh, sm_scale=0.3)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)


def test_wrapper_raises_instead_of_falling_back(device):
    q, k, v, tables, lens, nh = _case(np.random.RandomState(4), device,
                                      "decode", 2, 12, 64)
    with pytest.raises(ValueError, match="contiguous"):
        ragged_kernel_attention(q, k, v, tables.t().contiguous().t(), lens,
                                nh, block_rows=2)
    with pytest.raises(TypeError):
        ragged_kernel_attention(q, k, v, tables.long(), lens, nh,
                                block_rows=2)
    with pytest.raises(ValueError, match="on cpu"):
        ragged_kernel_attention(q, k.cpu(), v, tables, lens, nh,
                                block_rows=2)
    with pytest.raises(ValueError, match="tile"):
        ragged_kernel_attention(q, k, v, tables, lens, nh, block_rows=5)
