"""The split-key design of the serving kernels (``csrc/paged_split.cuh``:
the ragged paged attention and the paged decode attention), modelled in
plain PyTorch on the CPU: each (row, head)'s keys cut into spans of whole
pages by the wrappers' own span rule (``attention.split_spans``), one
softmax state (m, l, acc) per span, a span past the row's length
reporting l = 0, and the live spans merged in rank order as the
cluster's rank 0 merges them.  The model is held against the port's
``ragged_ref_attention`` and the JAX package's.  Also: the span rule's
own properties, and the kernel library's hash over the shared header.

Tolerance: atol 1e-6 against the port's reference — float32 softmax
over at most a few hundred unit-scale keys a span, summed in another
order.  atol 2e-6 against the JAX package's: XLA's CPU float32 einsum is
itself up to 1.3e-6 from the float64 value at head_dim 128 (the model
and the port's reference stay within 4e-7 of it).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.generation.ragged_attention import \
    ragged_ref_attention as jax_ragged_ref
from paddle_tpu_torch import _cuda
from paddle_tpu_torch.generation.attention import (MAX_SPLIT, MIN_SPAN_KEYS,
                                                   paged_plain_decode_attention,
                                                   split_spans)
from paddle_tpu_torch.generation.ragged_attention import ragged_ref_attention

ATOL = 1e-6
JAX_ATOL = 2e-6


def split_model(q, k_pages, v_pages, tables, lens, num_heads, block_rows=1,
                sm_scale=None):
    """The kernels' function in their order of work: spans of whole
    pages, a softmax state per span, the live states merged in rank
    order; zeros for a row of length 0."""
    R, H = q.shape
    _, PS, _ = k_pages.shape
    pps = tables.shape[1]
    D = H // num_heads
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    span, nsplit = split_spans(pps, PS)
    span_keys = span * PS
    out = torch.zeros(R, H)
    for r in range(R):
        n = min(int(lens[r]), pps * PS)
        if n <= 0:
            continue
        page_ids = tables[r // block_rows].long()
        keys = k_pages[page_ids].reshape(pps * PS, num_heads, D)
        vals = v_pages[page_ids].reshape(pps * PS, num_heads, D)
        qr = q[r].reshape(num_heads, D)
        states = []
        for rank in range(nsplit):
            lo, hi = rank * span_keys, min((rank + 1) * span_keys, n)
            if lo >= hi:                       # a span past the length
                states.append((torch.full((num_heads,), -math.inf),
                               torch.zeros(num_heads),
                               torch.zeros(num_heads, D)))
                continue
            s = torch.einsum("hd,khd->hk", qr, keys[lo:hi]) * scale
            m = s.max(dim=1).values
            p = torch.exp(s - m[:, None])
            states.append((m, p.sum(dim=1),
                           torch.einsum("hk,khd->hd", p, vals[lo:hi])))
        live = -(-n // span_keys)
        assert all(float(states[i][1].max()) == 0.0
                   for i in range(live, nsplit))
        gm = torch.stack([m for m, _, _ in states[:live]]).max(dim=0).values
        num = torch.zeros(num_heads, D)
        den = torch.zeros(num_heads)
        for m, l, acc in states[:live]:       # rank order
            w = torch.exp(m - gm)
            num += acc * w[:, None]
            den += l * w
        out[r] = (num / den[:, None]).reshape(H)
    return out


def _case(seed, head_dim, block_rows, page_size, pages_per_seq, lens,
          num_heads=4):
    rng = np.random.RandomState(seed)
    H = num_heads * head_dim
    R = len(lens)
    assert R % block_rows == 0
    blocks = R // block_rows
    num_pages = blocks * pages_per_seq + 1
    k = rng.randn(num_pages, page_size, H).astype(np.float32)
    v = rng.randn(num_pages, page_size, H).astype(np.float32)
    q = rng.randn(R, H).astype(np.float32)
    tables = rng.permutation(np.arange(1, num_pages)).reshape(
        blocks, pages_per_seq).astype(np.int32)
    return q, k, v, tables, np.asarray(lens, np.int32), num_heads


def _edge_lens(page_size, pages_per_seq, rows, rng):
    """0, 1, one page, one page + 1, every span boundary +- 1, the cap
    and above it, then random lengths to fill ``rows``."""
    cap = page_size * pages_per_seq
    span_keys = split_spans(pages_per_seq, page_size)[0] * page_size
    lens = [0, 1, page_size, page_size + 1, cap, cap + 7]
    for b in range(span_keys, cap, span_keys):
        lens += [b - 1, b, b + 1]
    lens = [n for n in lens if n <= cap + 7]
    while len(lens) < rows:
        lens.append(int(rng.randint(0, cap + 1)))
    return lens[:rows]


@pytest.mark.parametrize("head_dim", [32, 64, 128])
@pytest.mark.parametrize("block_rows", [1, 2, 3])
@pytest.mark.parametrize("page_size,pages_per_seq,spans", [
    (8, 128, 8), (4, 128, 4), (16, 16, 2), (16, 8, 1)],
    ids=["8_spans", "4_spans", "2_spans", "1_span"])
def test_split_model_matches_both_references(head_dim, block_rows,
                                             page_size, pages_per_seq,
                                             spans):
    assert split_spans(pages_per_seq, page_size)[1] == spans
    rng = np.random.RandomState(head_dim + block_rows)
    lens = _edge_lens(page_size, pages_per_seq, 30, rng)
    q, k, v, tables, lens, nh = _case(
        head_dim * 10 + block_rows, head_dim, block_rows, page_size,
        pages_per_seq, lens)
    t = [torch.from_numpy(a) for a in (q, k, v, tables, lens)]
    got = split_model(*t, nh, block_rows=block_rows)
    port = ragged_ref_attention(*t, nh, block_rows=block_rows)
    jax = np.asarray(jax_ragged_ref(*[jnp.asarray(a) for a in
                                      (q, k, v, tables, lens)], nh,
                                    block_rows=block_rows))
    np.testing.assert_allclose(got.numpy(), port.numpy(), rtol=0, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), jax, rtol=0, atol=JAX_ATOL)
    assert (got[t[4] == 0] == 0).all()


def test_rows_with_one_live_span():
    """Every span but the first empty (lengths within one span), then
    rows that end on, just past and three spans past a span boundary."""
    page_size, pps = 8, 128
    span_keys = split_spans(pps, page_size)[0] * page_size
    lens = [1, 5, span_keys - 1, span_keys, span_keys + 1, 3 * span_keys]
    q, k, v, tables, lens, nh = _case(3, 64, 1, page_size, pps, lens)
    t = [torch.from_numpy(a) for a in (q, k, v, tables, lens)]
    got = split_model(*t, nh)
    want = ragged_ref_attention(*t, nh)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=ATOL)


def test_decode_is_the_split_with_one_row_per_slot():
    """The paged decode kernel's function is the ragged one with one
    table row per slot (block_rows = 1)."""
    lens = [0, 1, 16, 17, 63, 64, 65, 256]
    q, k, v, tables, lens, nh = _case(4, 32, 1, 16, 16, lens)
    t = [torch.from_numpy(a) for a in (q, k, v, tables, lens)]
    got = split_model(*t, nh)
    want = paged_plain_decode_attention(*t, nh)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=ATOL)


@pytest.mark.parametrize("page_size", [1, 4, 8, 16, 32, 64])
def test_span_rule(page_size):
    """Whole pages, at most MAX_SPLIT spans covering the table, at least
    MIN_SPAN_KEYS keys a span unless the table is shorter, and no span
    that starts past the table."""
    for pps in list(range(0, 40)) + [64, 127, 128, 129, 1000, 4096]:
        span, nsplit = split_spans(pps, page_size)
        assert span >= 1 and 1 <= nsplit <= MAX_SPLIT, (pps, span, nsplit)
        assert span * nsplit >= pps
        assert (nsplit - 1) * span < max(pps, 1)
        if pps * page_size >= MIN_SPAN_KEYS:
            assert span * page_size >= MIN_SPAN_KEYS
        else:
            assert nsplit == 1


def test_kernel_hash_covers_the_shared_header(tmp_path, monkeypatch):
    """A library's name hashes its source and every shared header, so an
    edited header never loads a stale library."""
    (tmp_path / "k.cu").write_text('#include "shared.cuh"\n')
    header = tmp_path / "shared.cuh"
    header.write_text("// one\n")
    monkeypatch.setattr(_cuda, "CSRC", tmp_path)
    _, before = _cuda._target("k")
    assert _cuda._target("k")[1] == before
    header.write_text("// two\n")
    _, after = _cuda._target("k")
    assert after != before
    (tmp_path / "other.cuh").write_text("// a second header\n")
    assert _cuda._target("k")[1] not in (before, after)


def test_the_serving_sources_share_the_header():
    for name in ("ragged_attention", "paged_decode"):
        assert '#include "paged_split.cuh"' in \
            (_cuda.CSRC / f"{name}.cu").read_text()
