"""The port's hand-written CUDA kernels (the ragged paged attention, the
paged decode attention, the three flash-attention kernels of training,
their three counterparts on the flat [B, H, T, D] layout, the qkv-folded
flash forward, the fused matmul epilogue and the FFN chain of the fusion
pass) against their plain versions, on the card.

A CUDA kernel has no CPU mode, so every test here is marked ``cuda`` and
skips on a host without a card.  On a machine with one (no JAX needed):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda_kernels.py

Tolerance: atol 1e-5 / rtol 1e-5 — float32 online softmax against the
plain version's float32 softmax, summed in another order over at most
a few hundred unit-scale keys (2048 for the split-key edge cases).
Inactive rows and empty decode slots must be exactly zero.  Flash
attention: forward atol 1e-5 (o, lse); gradients atol 1e-4 / rtol 1e-4 —
dq, dk, dv and dbias sum up to a few hundred products of unit-scale
values per element (dbias over heads and queries too), in float32, in
another order than the plain version's matmuls; the flat kernels take
the same tolerances, up to 4096 keys (their 3xTF32 products round as
float32 does), and so does the packed backward pair through its 4-byte
copies.  The qkv-folded forward takes the flash forward's
tolerance, its gradients through the dq and dk/dv kernels the flash
gradients'; the tensor-core forwards (#4, #9) hold the forward's at T
4096 and through their 4-byte copies too.  Fused matmul and FFN chain:
atol 1e-4 / rtol 1e-4 — float32 sums over K = 768 (F = 3072) unit-scale
products in another order than cuBLAS's (the fused matmul's as 3xTF32,
which rounds as float32 does), then a norm that divides by a row's
spread.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch import _cuda
from paddle_tpu_torch.generation.attention import (
    paged_decode_attention, paged_kernel_decode_attention,
    paged_ref_decode_attention, split_spans)
from paddle_tpu_torch.generation.ragged_attention import (
    ragged_kernel_attention, ragged_paged_attention, ragged_ref_attention)
from paddle_tpu_torch.ops import attention_epilogue as ae
from paddle_tpu_torch.ops import ffn_chain as fc
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import fused_matmul as fm

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


def _decode_case(rng, device, num_heads, head_dim, seqs=8, page_size=16,
                 pages_per_seq=8, spare=1):
    """The legacy decode step's inputs: ``seqs`` slots over a pool of
    every slot's pages plus ``spare`` (scratch page 0 included)."""
    H = num_heads * head_dim
    num_pages = seqs * pages_per_seq + spare
    k = rng.randn(num_pages, page_size, H).astype(np.float32)
    v = rng.randn(num_pages, page_size, H).astype(np.float32)
    q = rng.randn(seqs, H).astype(np.float32)
    tables = rng.permutation(np.arange(1, num_pages))[
        :seqs * pages_per_seq].reshape(seqs, pages_per_seq).astype(np.int32)
    cap = page_size * pages_per_seq
    lens = rng.randint(0, cap + 1, seqs)
    lens[:5] = [0, 1, page_size, page_size + 1, cap][:seqs]
    t = [torch.from_numpy(a).to(device) for a in (q, k, v, tables)]
    return (*t, torch.from_numpy(lens.astype(np.int32)).to(device),
            num_heads)


@pytest.mark.parametrize("head_dim", [32, 64, 128])
@pytest.mark.parametrize("pages_per_seq", [1, 8, 64])
def test_paged_decode_kernel_matches_plain_version(device, head_dim,
                                                    pages_per_seq):
    args = _decode_case(np.random.RandomState(head_dim + pages_per_seq),
                        device, 768 // 64, head_dim,
                        pages_per_seq=pages_per_seq)
    lens = args[4]
    before = _cuda.LAUNCHES["paged_decode_attention"]
    got = paged_decode_attention(*args)
    want = paged_ref_decode_attention(*args)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["paged_decode_attention"] == before + 1
    assert torch.isfinite(got).all()
    live = lens > 0
    torch.testing.assert_close(got[live], want[live], atol=ATOL, rtol=RTOL)
    assert (got[~live] == 0).all()


def test_paged_decode_strided_q_and_sm_scale(device):
    """q as the engine passes it: a column slice of the packed qkv
    projection (row stride 3H), with an explicit softmax scale."""
    q, k, v, tables, lens, nh = _decode_case(np.random.RandomState(5),
                                             device, 12, 64)
    qkv = torch.cat([q, torch.randn_like(q), torch.randn_like(q)], dim=1)
    qs = qkv[:, :q.shape[1]]
    assert not qs.is_contiguous()
    got = paged_kernel_decode_attention(qs, k, v, tables, lens, nh,
                                        sm_scale=0.3)
    want = paged_ref_decode_attention(q, k, v, tables, lens, nh,
                                      sm_scale=0.3)
    torch.cuda.synchronize()
    live = lens > 0
    torch.testing.assert_close(got[live], want[live], atol=ATOL, rtol=RTOL)


def test_paged_decode_wrapper_raises_instead_of_falling_back(device):
    q, k, v, tables, lens, nh = _decode_case(np.random.RandomState(6),
                                             device, 12, 64)
    with pytest.raises(TypeError):
        paged_kernel_decode_attention(q, k, v, tables.long(), lens, nh)
    with pytest.raises(ValueError, match="on cpu"):
        paged_kernel_decode_attention(q, k.cpu(), v, tables, lens, nh)
    with pytest.raises(ValueError, match="head_dim"):
        paged_kernel_decode_attention(q, k, v, tables, lens, 256)
    with pytest.raises(ValueError, match="rows"):
        paged_kernel_decode_attention(q, k, v, tables[:3], lens, nh)


# -- the split-key design of both serving kernels ---------------------------

def _edge_lens(page_size, pages_per_seq, rows, rng):
    """0, 1, one page, one page + 1, every span boundary +- 1, the cap
    and above it (clipped), then random lengths to fill ``rows``."""
    cap = page_size * pages_per_seq
    span_keys = split_spans(pages_per_seq, page_size)[0] * page_size
    lens = [0, 1, page_size, page_size + 1, cap, cap + 7]
    for b in range(span_keys, cap, span_keys):
        lens += [b - 1, b, b + 1]
    while len(lens) < rows:
        lens.append(int(rng.randint(0, cap + 1)))
    return np.asarray(lens[:rows], np.int32)


def _split_case(device, head_dim, block_rows, rows=30, page_size=16,
                pages_per_seq=128, seed=0):
    rng = np.random.RandomState(seed)
    nh = 768 // 64
    H = nh * head_dim
    blocks = rows // block_rows
    num_pages = blocks * pages_per_seq + 1
    g = torch.Generator(device=device).manual_seed(seed)
    k, v = (torch.randn(num_pages, page_size, H, generator=g, device=device)
            for _ in range(2))
    q = torch.randn(rows, H, generator=g, device=device)
    tables = rng.permutation(np.arange(1, num_pages)).reshape(
        blocks, pages_per_seq).astype(np.int32)
    lens = _edge_lens(page_size, pages_per_seq, rows, rng)
    return (q, k, v, torch.from_numpy(tables).to(device),
            torch.from_numpy(lens).to(device), nh)


@pytest.mark.parametrize("head_dim", [32, 64, 128])
@pytest.mark.parametrize("block_rows", [1, 2, 3])
def test_ragged_split_edge_lengths(device, head_dim, block_rows):
    """Spans of 16 pages (8 a row): lengths on and around every span
    boundary, 0, 1, one page + 1, the cap and past it; one launch a call,
    the same bits from a second launch."""
    args = _split_case(device, head_dim, block_rows, seed=head_dim)
    lens = args[4]
    before = _cuda.LAUNCHES["ragged_paged_attention"]
    got = ragged_paged_attention(*args, block_rows=block_rows)
    assert _cuda.LAUNCHES["ragged_paged_attention"] == before + 1
    again = ragged_paged_attention(*args, block_rows=block_rows)
    want = ragged_ref_attention(*args, block_rows=block_rows)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert torch.equal(got, again)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)
    assert (got[lens == 0] == 0).all()


@pytest.mark.parametrize("head_dim", [32, 64, 128])
def test_paged_decode_split_edge_lengths(device, head_dim):
    args = _split_case(device, head_dim, 1, seed=head_dim + 1)
    lens = args[4]
    before = _cuda.LAUNCHES["paged_decode_attention"]
    got = paged_decode_attention(*args)
    assert _cuda.LAUNCHES["paged_decode_attention"] == before + 1
    again = paged_decode_attention(*args)
    want = paged_ref_decode_attention(*args)
    torch.cuda.synchronize()
    live = lens > 0
    assert torch.isfinite(got).all()
    assert torch.equal(got, again)
    torch.testing.assert_close(got[live], want[live], atol=ATOL, rtol=RTOL)
    assert (got[~live] == 0).all()


# -- flash attention (training) ---------------------------------------------

FLASH_FWD_ATOL = 1e-5
FLASH_GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
#: the kernel-phase cases of chip_smoke.py: (B, Tq, Tk, nh, D, causal,
#: strided qkv, dropout rate)
FLASH_CASES = {
    "step": (32, 128, 128, 12, 64, False, True, 0.0),
    "causal": (4, 128, 128, 12, 64, True, False, 0.0),
    "causal_tq_lt_tk": (4, 80, 128, 12, 64, True, False, 0.0),
    "t100": (4, 100, 100, 12, 64, False, True, 0.0),
    "d32": (4, 128, 128, 8, 32, False, False, 0.0),
    "d128": (4, 128, 128, 4, 128, False, False, 0.0),
    "dropout": (8, 128, 128, 12, 64, False, True, 0.1),
}


def _flash_case(device, B, Tq, Tk, nh, D, causal, strided, rate, seed=0):
    """q, k, v (strided column slices of one [B, T, 3H] tensor when
    ``strided``), the key-padding bias that masks the last quarter of the
    keys of half the batch, an output cotangent."""
    g = torch.Generator().manual_seed(seed)
    H = nh * D
    if strided:
        qkv = torch.randn(B, max(Tq, Tk), 3 * H, generator=g).to(device)
        q, k, v = qkv[:, :Tq, :H], qkv[:, :Tk, H:2 * H], qkv[:, :Tk, 2 * H:]
    else:
        q = torch.randn(B, Tq, H, generator=g).to(device)
        k, v = (torch.randn(B, Tk, H, generator=g).to(device)
                for _ in range(2))
    bias = torch.zeros(B, Tk)
    bias[: B // 2, Tk - Tk // 4:] = -1e4
    do = torch.randn(B, Tq, H, generator=g).to(device)
    return dict(q=q, k=k, v=v, bias=bias.to(device), num_heads=nh,
                causal=causal, dropout_rate=rate, seed=1234 + seed), do


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_kernels_match_plain_versions(device, case):
    c, do = _flash_case(device, *FLASH_CASES[case])
    B, Tq, H = c["q"].shape
    nh, rate = c["num_heads"], c["dropout_rate"]
    mask = None
    if rate > 0:
        mask = fa.flash_kernel_dropout_mask(B, nh, Tq, c["k"].shape[1], rate,
                                            c["seed"], device)
        keep = mask.float().mean().item()
        sigma = (rate * (1 - rate) / mask.numel()) ** 0.5
        assert abs(keep - (1 - rate)) < 4 * sigma, keep
    kw = dict(bias=c["bias"], causal=c["causal"], dropout_rate=rate)
    before = {n: _cuda.LAUNCHES[n] for n in (fa.FWD, fa.DQ, fa.DKV)}
    o, lse = fa.flash_kernel_forward(c["q"], c["k"], c["v"], nh, seed=c["seed"],
                                     **kw)
    o_ref, lse_ref = fa.flash_ref_forward(c["q"], c["k"], c["v"], nh,
                                          keep_mask=mask, **kw)
    grads = fa.flash_kernel_backward(c["q"], c["k"], c["v"], c["bias"], o,
                                     lse, do, nh, causal=c["causal"],
                                     dropout_rate=rate, seed=c["seed"])
    refs = fa.flash_ref_backward(c["q"], c["k"], c["v"], c["bias"], o_ref,
                                 lse_ref, do, nh, causal=c["causal"],
                                 dropout_rate=rate, keep_mask=mask)
    torch.cuda.synchronize()
    assert {n: _cuda.LAUNCHES[n] - before[n] for n in before} == \
        {fa.FWD: 1, fa.DQ: 1, fa.DKV: 1}
    torch.testing.assert_close(o, o_ref, atol=FLASH_FWD_ATOL, rtol=0)
    torch.testing.assert_close(lse, lse_ref, atol=FLASH_FWD_ATOL, rtol=0)
    for name, g, r in zip(("dq", "dk", "dv", "dbias"), grads, refs):
        assert torch.isfinite(g).all(), name
        torch.testing.assert_close(g, r, msg=name, **FLASH_GRAD_TOL)


@pytest.mark.parametrize("B,Tq,Tk,nh,D,causal,rate", [
    (8, 128, 128, 12, 64, False, 0.1),
    (4, 80, 200, 12, 64, True, 0.1),
    (4, 128, 128, 8, 32, False, 0.0),
    (4, 96, 96, 4, 128, False, 0.1),
], ids=["padded_keys", "causal_tq_lt_tk", "d32", "d128"])
def test_packed_forward_is_deterministic_and_matches_plain(device, B, Tq, Tk,
                                                           nh, D, causal,
                                                           rate):
    """#3 runs the tensor-core forward on the packed layout (heads D apart,
    one key-bias row per batch): two launches give the same bits, and o
    and lse match the plain forward under its own dropout mask."""
    c, _ = _flash_case(device, B, Tq, Tk, nh, D, causal, True, rate, seed=4)
    kw = dict(bias=c["bias"], causal=causal, dropout_rate=rate)
    runs = [fa.flash_kernel_forward(c["q"], c["k"], c["v"], nh,
                                    seed=c["seed"], **kw) for _ in range(2)]
    mask = (fa.flash_kernel_dropout_mask(B, nh, Tq, Tk, rate, c["seed"],
                                         device) if rate > 0 else None)
    o_ref, lse_ref = fa.flash_ref_forward(c["q"], c["k"], c["v"], nh,
                                          keep_mask=mask, **kw)
    torch.cuda.synchronize()
    for a, r in zip(*runs):
        assert torch.equal(a, r)
    torch.testing.assert_close(runs[0][0], o_ref, atol=FLASH_FWD_ATOL, rtol=0)
    torch.testing.assert_close(runs[0][1], lse_ref, atol=FLASH_FWD_ATOL,
                               rtol=0)


@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["no_dropout", "dropout"])
def test_packed_backward_is_deterministic(device, rate):
    """Each dq, dk, dv and dbias element of the packed backward pair (#5,
    #6) is written by one CTA (no atomics): two launches give the same
    bits, with and without dropout."""
    c, do = _flash_case(device, 8, 128, 128, 12, 64, False, True, rate,
                        seed=6)
    nh, kw = c["num_heads"], dict(dropout_rate=rate, seed=c["seed"])
    o, lse = fa.flash_kernel_forward(c["q"], c["k"], c["v"], nh,
                                     bias=c["bias"], **kw)
    runs = [fa.flash_kernel_backward(c["q"], c["k"], c["v"], c["bias"], o,
                                     lse, do, nh, **kw) for _ in range(2)]
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), *runs):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("offset", [0, 1], ids=["row_stride", "base"])
def test_packed_backward_four_byte_copies_match_plain(device, offset):
    """The 4-byte copy path of the packed backward pair (16-byte copies
    need D, every stride and every base a multiple of 4 floats): q, k, v
    and do read at a d_head of 36 through views whose row stride (or
    base) is not a multiple of 4 floats, causal over two row tiles, with
    dropout, match the plain backward."""
    B, T, nh, D, rate, seed = 2, 130, 3, 36, 0.1, 23
    H = nh * D
    g = torch.Generator().manual_seed(7)
    wide = torch.randn(B, T, 4 * H + 1, generator=g).to(device)
    q, k, v, do = (wide[..., offset + i * H:offset + (i + 1) * H]
                   for i in range(4))
    bias = torch.zeros(B, T)
    bias[:, T - T // 4:] = -1e4
    bias = bias.to(device)
    mask = fa.flash_kernel_dropout_mask(B, nh, T, T, rate, seed, device)
    kw = dict(causal=True, dropout_rate=rate)
    o, lse = fa.flash_ref_forward(q, k, v, nh, bias, keep_mask=mask, **kw)
    got = fa.flash_kernel_backward(q, k, v, bias, o, lse, do, nh, seed=seed,
                                   **kw)
    want = fa.flash_ref_backward(q, k, v, bias, o, lse, do, nh,
                                 keep_mask=mask, **kw)
    torch.cuda.synchronize()
    for name, a, r in zip(("dq", "dk", "dv", "dbias"), got, want):
        torch.testing.assert_close(a, r, msg=name, **FLASH_GRAD_TOL)


def test_packed_backward_writes_the_slices_of_one_dqkv(device):
    """Given ``out=``, the dq and dk/dv kernels write the three column
    slices of one [B, T, 3H] dqkv (row stride 3H), bit for bit what they
    write into tensors of their own, and nothing else of it."""
    c, do = _flash_case(device, 4, 128, 128, 12, 64, False, True, 0.1,
                        seed=8)
    q, k, v, nh = c["q"], c["k"], c["v"], c["num_heads"]
    kw = dict(dropout_rate=0.1, seed=c["seed"])
    o, lse = fa.flash_kernel_forward(q, k, v, nh, bias=c["bias"], **kw)
    delta = fa.flash_delta(o, do, nh)
    args = (q, k, v, c["bias"], do, lse, delta, nh)
    H = q.shape[-1]
    dqkv = torch.full((4, 128, 3 * H), float("nan"), device=device)
    dq = fa.flash_kernel_dq(*args, out=dqkv[..., :H], **kw)
    dk, dv, dbias = fa.flash_kernel_dkv(
        *args, out=(dqkv[..., H:2 * H], dqkv[..., 2 * H:]), **kw)
    own = (fa.flash_kernel_dq(*args, **kw), *fa.flash_kernel_dkv(*args, **kw))
    torch.cuda.synchronize()
    assert dq.data_ptr() == dqkv.data_ptr()
    for name, a, b in zip(("dq", "dk", "dv", "dbias"),
                          (dq, dk, dv, dbias), own):
        assert torch.equal(a, b), name
    assert torch.equal(dqkv, torch.cat(own[:3], dim=-1))
    with pytest.raises(ValueError, match="out"):
        fa.flash_kernel_dq(*args, out=dqkv[..., :H - 1], **kw)


def test_flash_op_trains_through_the_kernels(device):
    """The autograd function on CUDA tensors launches the three kernels,
    once each per forward + backward, and matches the CPU path."""
    c, do = _flash_case(device, *FLASH_CASES["t100"])
    leaves = [t.detach().requires_grad_() for t in (c["q"], c["k"], c["v"])]
    before = {n: _cuda.LAUNCHES[n] for n in (fa.FWD, fa.DQ, fa.DKV)}
    out = fa.flash_attention_packed(*leaves, c["num_heads"],
                                    bias=c["bias"][:, None, None, :])
    got = torch.autograd.grad(out, leaves, do)
    cpu = [t.detach().cpu().requires_grad_() for t in leaves]
    out_cpu = fa.flash_attention_packed(*cpu, c["num_heads"],
                                        bias=c["bias"].cpu()[:, None, None])
    want = torch.autograd.grad(out_cpu, cpu, do.cpu())
    torch.cuda.synchronize()
    assert {n: _cuda.LAUNCHES[n] - before[n] for n in before} == \
        {fa.FWD: 1, fa.DQ: 1, fa.DKV: 1}
    torch.testing.assert_close(out.cpu(), out_cpu.detach(),
                               atol=FLASH_FWD_ATOL, rtol=0)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, **FLASH_GRAD_TOL)


def test_flash_wrappers_raise_instead_of_falling_back(device):
    c, do = _flash_case(device, *FLASH_CASES["d32"])
    q, k, v, nh = c["q"], c["k"], c["v"], c["num_heads"]
    with pytest.raises(TypeError):
        fa.flash_kernel_forward(q.double(), k, v, nh)
    with pytest.raises(ValueError, match="on cpu"):
        fa.flash_kernel_forward(q, k.cpu(), v, nh)
    with pytest.raises(ValueError, match="128"):
        fa.flash_kernel_forward(q, k, v, 1)
    with pytest.raises(ValueError, match="key-padding"):
        fa.flash_kernel_forward(q, k, v, nh, bias=c["bias"][:, :-1])
    with pytest.raises(NotImplementedError, match="key-padding"):
        fa.flash_attention_packed(q, k, v, nh, bias=torch.zeros(
            q.shape[0], nh, q.shape[1], k.shape[1], device=device))


# -- flash attention on the flat [B, H, T, D] layout --------------------------

#: (B, H, Tq, Tk, D, causal, bias: None | "padding" | "per_head", dropout
#: rate, dlse): chip_smoke.py's phase-2 flat cases at test size
FLAT_CASES = {
    "op_step": (2, 12, 512, 512, 64, False, "padding", 0.1, False),
    "ring_chunk": (1, 4, 1024, 1024, 64, False, "padding", 0.0, True),
    "causal": (2, 4, 256, 256, 64, True, None, 0.0, False),
    "per_head_bias": (2, 4, 128, 128, 64, False, "per_head", 0.0, False),
    "tq128_tk256": (2, 4, 128, 256, 64, False, "padding", 0.0, False),
    "causal_tq_lt_tk": (2, 4, 80, 128, 64, True, "padding", 0.0, False),
    "t100": (2, 4, 100, 100, 64, False, "padding", 0.0, False),
    "d32": (2, 4, 100, 100, 32, False, "padding", 0.0, False),
    "d128": (2, 4, 100, 100, 128, False, "padding", 0.0, False),
    "d128_causal_dropout_tq96_tk160": (2, 4, 96, 160, 128, True, "padding",
                                       0.1, False),
    "t4096_causal": (1, 2, 4096, 4096, 64, True, None, 0.0, False),
    # d_head 20: the flat backward pair's 4-byte copies (16-byte ones need
    # D and every stride a multiple of 4 floats)
    "d20_causal_dropout": (2, 3, 70, 90, 20, True, "padding", 0.1, False),
}


def _flat_case(device, B, H, Tq, Tk, D, causal, bias, rate, dlse, seed=0):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, H, Tq, D, generator=g).to(device)
    k, v = (torch.randn(B, H, Tk, D, generator=g).to(device)
            for _ in range(2))
    b = None
    if bias == "padding":
        b = torch.zeros(B, 1, 1, Tk)
        b[: (B + 1) // 2, ..., Tk - Tk // 4:] = -1e4
    elif bias == "per_head":
        b = torch.randn(B, H, 1, Tk, generator=g)
    do = torch.randn(B, H, Tq, D, generator=g).to(device)
    u = torch.randn(B, H, Tq, generator=g).to(device) if dlse else None
    return (q, k, v, None if b is None else b.to(device).expand(B, H, 1, Tk),
            do, u, causal, rate, 4321 + seed)


@pytest.mark.parametrize("case", sorted(FLAT_CASES))
def test_flat_flash_kernels_match_plain_versions(device, case):
    q, k, v, bias, do, dlse, causal, rate, seed = _flat_case(
        device, *FLAT_CASES[case])
    B, H, Tq, _ = q.shape
    Tk = k.shape[2]
    mask = None
    if rate > 0:
        mask = fa.flash_kernel_dropout_mask(B, H, Tq, Tk, rate, seed, device)
        keep = mask.float().mean().item()
        assert abs(keep - (1 - rate)) < 4 * (rate * (1 - rate)
                                             / mask.numel()) ** 0.5, keep
    kw = dict(causal=causal, dropout_rate=rate)
    names = (fa.FWD_FLAT, fa.DQ_FLAT, fa.DKV_FLAT)
    before = {n: _cuda.LAUNCHES[n] for n in names}
    o, lse = fa.flash_kernel_forward_flat(q, k, v, bias, seed=seed, **kw)
    o_ref, lse_ref = fa.flash_ref_forward_flat(q, k, v, bias, keep_mask=mask,
                                               **kw)
    grads = fa.flash_kernel_backward_flat(q, k, v, bias, o, lse, do,
                                          seed=seed, dlse=dlse, **kw)
    refs = fa.flash_ref_backward_flat(q, k, v, bias, o_ref, lse_ref, do,
                                      keep_mask=mask, dlse=dlse, **kw)
    torch.cuda.synchronize()
    assert {n: _cuda.LAUNCHES[n] - before[n] for n in names} == \
        {n: 1 for n in names}
    torch.testing.assert_close(o, o_ref, atol=FLASH_FWD_ATOL, rtol=0)
    torch.testing.assert_close(lse, lse_ref, atol=FLASH_FWD_ATOL, rtol=0)
    for name, g, r in zip(("dq", "dk", "dv", "dbias"), grads, refs):
        assert torch.isfinite(g).all(), name
        torch.testing.assert_close(g, r, msg=name, **FLASH_GRAD_TOL)


@pytest.mark.parametrize("case", ["op_step", "causal_tq_lt_tk"])
def test_flat_flash_backward_is_deterministic(device, case):
    """Each output element of the dq and dk/dv kernels is written by one
    CTA (no atomics): two launches on the same inputs give the same
    bits."""
    q, k, v, bias, do, dlse, causal, rate, seed = _flat_case(
        device, *FLAT_CASES[case])
    kw = dict(causal=causal, dropout_rate=rate, seed=seed)
    o, lse = fa.flash_kernel_forward_flat(q, k, v, bias, **kw)
    delta = fa.flash_delta_flat(o, do, dlse)
    runs = [(fa.flash_kernel_dq_flat(q, k, v, bias, do, lse, delta, **kw),
             *fa.flash_kernel_dkv_flat(q, k, v, bias, do, lse, delta, **kw))
            for _ in range(2)]
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), *runs):
        assert torch.equal(a, b), name


def test_flat_flash_keep_bits_are_the_dropout_mask_kernels(device):
    """The dq and dk/dv kernels drop exactly the pairs that
    flash_kernel_dropout_mask draws for their seed: the plain backward
    fed that mask matches them, fed the mask of another seed it does
    not."""
    q, k, v, bias, do, dlse, causal, rate, seed = _flat_case(
        device, *FLAT_CASES["op_step"])
    B, H, Tq, _ = q.shape
    Tk = k.shape[2]
    kw = dict(causal=causal, dropout_rate=rate)
    o, lse = fa.flash_kernel_forward_flat(q, k, v, bias, seed=seed, **kw)
    grads = fa.flash_kernel_backward_flat(q, k, v, bias, o, lse, do,
                                          seed=seed, **kw)
    for mask_seed, same in ((seed, True), (seed + 1, False)):
        mask = fa.flash_kernel_dropout_mask(B, H, Tq, Tk, rate, mask_seed,
                                            device)
        refs = fa.flash_ref_backward_flat(q, k, v, bias, o, lse, do,
                                          keep_mask=mask, **kw)
        torch.cuda.synchronize()
        for name, g, r in zip(("dq", "dk", "dv", "dbias"), grads, refs):
            close = torch.allclose(g, r, **FLASH_GRAD_TOL)
            assert close == same, (name, mask_seed)


def test_flat_flash_autograd_launches_the_kernels(device):
    """flash_attention_lse on CUDA tensors launches the three flat
    kernels, once each per forward + backward, and matches the CPU path,
    the bias gradient summed back to its [B, 1, 1, Tk] shape."""
    q, k, v, bias, do, _, _, _, _ = _flat_case(device, *FLAT_CASES["t100"])
    u = torch.randn(q.shape[:3] + (1,), device=device)
    b = bias[:, :1].contiguous()
    names = (fa.FWD_FLAT, fa.DQ_FLAT, fa.DKV_FLAT)

    def run(tensors):
        leaves = [t.detach().clone().requires_grad_() for t in tensors]
        o, lse = fa.flash_attention_lse(*leaves[:3], bias=leaves[3])
        return o, torch.autograd.grad(
            (o * do.to(o.device)).sum() + (lse * u.to(o.device)).sum(),
            leaves)

    before = {n: _cuda.LAUNCHES[n] for n in names}
    o, got = run((q, k, v, b))
    torch.cuda.synchronize()
    assert {n: _cuda.LAUNCHES[n] - before[n] for n in names} == \
        {n: 1 for n in names}
    o_cpu, want = run(t.cpu() for t in (q, k, v, b))
    torch.testing.assert_close(o.cpu(), o_cpu.detach(), atol=FLASH_FWD_ATOL,
                               rtol=0)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, **FLASH_GRAD_TOL)


def test_flat_flash_wrappers_raise_instead_of_falling_back(device):
    q, k, v, bias, *_ = _flat_case(device, *FLAT_CASES["d32"])
    with pytest.raises(TypeError):
        fa.flash_kernel_forward_flat(q.double(), k, v)
    with pytest.raises(ValueError, match="on cpu"):
        fa.flash_kernel_forward_flat(q, k.cpu(), v)
    with pytest.raises(ValueError, match="128"):
        fa.flash_kernel_forward_flat(*(torch.zeros(1, 1, 8, 160,
                                                   device=device),) * 3)
    with pytest.raises(ValueError, match="key bias"):
        fa.flash_kernel_forward_flat(q, k, v, bias[..., :-1])
    with pytest.raises(NotImplementedError, match="key bias"):
        fa.flash_attention(q, k, v, bias=torch.zeros(
            q.shape[0], q.shape[1], q.shape[2], k.shape[2], device=device))


def test_ring_attention_on_the_card_runs_the_flat_kernels_or_raises(device):
    """On CUDA tensors the default ring takes the flash body: a bf16 or
    d_head 160 chunk raises in the flat kernels' wrappers instead of
    running the einsum ring, and an f32 one-rank causal ring launches the
    flat forward once and equals the einsum ring (use_flash=False, which
    launches nothing)."""
    from paddle_tpu_torch.parallel import ring_attention

    q, k, v, *_ = _flat_case(device, 1, 2, 64, 64, 64, True, None, 0.0,
                             False)
    with pytest.raises(TypeError, match="float32"):
        ring_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(), causal=True)
    wide = torch.zeros(1, 2, 64, 160, device=device)
    with pytest.raises(ValueError, match="128"):
        ring_attention(wide, wide, wide)
    names = (fa.FWD_FLAT, fa.DQ_FLAT, fa.DKV_FLAT)
    before = {n: _cuda.LAUNCHES[n] for n in names}
    o = ring_attention(q, k, v, causal=True)
    plain = ring_attention(q, k, v, causal=True, use_flash=False)
    torch.cuda.synchronize()
    assert {n: _cuda.LAUNCHES[n] - before[n] for n in names} == \
        {fa.FWD_FLAT: 1, fa.DQ_FLAT: 0, fa.DKV_FLAT: 0}
    torch.testing.assert_close(o, plain, atol=FLASH_FWD_ATOL, rtol=0)


# -- the tensor-core forwards #4 and #9 ---------------------------------------

def _qkv_inputs(device, B, T, nh, D, pad_cols=0, seed=11):
    """A pre-bias qkv projection [B, T, 3H] (a view of a [B, T, 3H +
    pad_cols] tensor when pad_cols, so its row stride is 3H + pad_cols),
    its bias [3H] and a key-padding bias [B, T]."""
    g = torch.Generator().manual_seed(seed)
    H = nh * D
    qkv = torch.randn(B, T, 3 * H + pad_cols, generator=g).to(device)
    b = (torch.randn(3 * H, generator=g) * 0.1).to(device)
    kp = torch.zeros(B, T)
    kp[: (B + 1) // 2, T - T // 4:] = -1e4
    return qkv[..., :3 * H], b, kp.to(device)


@pytest.mark.parametrize("kernel", ["packed", "qkv"])
def test_decoder_causal_shape_matches_plain(device, kernel):
    """#3 and #9 at the causal LM's shape (8 x 128 tokens, 12 heads of 64,
    no key bias, dropout 0): the packed forward on the strided q/k/v
    slices the StaticRNN decoder's unfused attention op passes, the
    qkv-folded forward on the pre-bias projection the fused
    build_lm_logits passes; one launch each, within the forward atol of
    the plain versions."""
    B, T, nh, D = 8, 128, 12, 64
    qkv, b, _ = _qkv_inputs(device, B, T, nh, D, seed=15)
    H = nh * D
    name = fa.FWD if kernel == "packed" else fa.QKV
    before = _cuda.LAUNCHES[name]
    if kernel == "packed":
        q, k, v = qkv[..., :H], qkv[..., H:2 * H], qkv[..., 2 * H:]
        o, lse = fa.flash_kernel_forward(q, k, v, nh, causal=True)
        o_ref, lse_ref = fa.flash_ref_forward(q, k, v, nh, causal=True)
    else:
        o, lse = fa.flash_kernel_forward_qkv(qkv, b, nh, None, True)
        o_ref, lse_ref = ae.qkv_ref_forward(qkv, b, nh, None, True)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES[name] - before == 1
    torch.testing.assert_close(o, o_ref, atol=FLASH_FWD_ATOL, rtol=0)
    torch.testing.assert_close(lse, lse_ref, atol=FLASH_FWD_ATOL, rtol=0)


@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["no_dropout", "dropout"])
@pytest.mark.parametrize("kernel", ["flat", "qkv"])
def test_tc_forwards_are_deterministic(device, kernel, rate):
    """Each o and lse element of the tensor-core forwards is written by
    one CTA in a fixed order: two launches give the same bits."""
    if kernel == "flat":
        q, k, v, bias, *_ = _flat_case(device, *FLAT_CASES["op_step"])
        runs = [fa.flash_kernel_forward_flat(q, k, v, bias, dropout_rate=rate,
                                             seed=5) for _ in range(2)]
    else:
        qkv, b, kp = _qkv_inputs(device, 8, 128, 12, 64)
        runs = [fa.flash_kernel_forward_qkv(qkv, b, 12, kp, dropout_rate=rate,
                                            seed=5) for _ in range(2)]
    torch.cuda.synchronize()
    for name, a, r in zip(("o", "lse"), *runs):
        assert torch.equal(a, r), name


@pytest.mark.parametrize("offset", [0, 1], ids=["row_stride", "base"])
def test_tc_forwards_four_byte_copies_match_plain(device, offset):
    """The 4-byte copy path of the tensor-core forwards (16-byte copies
    need D, every stride and every base a multiple of 4 floats): a d_head
    of 36 read through views whose row stride (or base) is not a multiple
    of 4 floats, with dropout, matches the plain versions."""
    B, H, T, D, rate, seed = 2, 3, 130, 36, 0.1, 21
    g = torch.Generator().manual_seed(3)
    wide = torch.randn(3, B, H, T, D + 1, generator=g).to(device)
    q, k, v = (x[..., offset:offset + D] for x in wide)
    bias = torch.zeros(B, 1, 1, T)
    bias[..., T - T // 4:] = -1e4
    bias = bias.to(device).expand(B, H, 1, T)
    mask = fa.flash_kernel_dropout_mask(B, H, T, T, rate, seed, device)
    kw = dict(causal=True, dropout_rate=rate)
    o, lse = fa.flash_kernel_forward_flat(q, k, v, bias, seed=seed, **kw)
    o_ref, lse_ref = fa.flash_ref_forward_flat(q, k, v, bias, keep_mask=mask,
                                               **kw)

    qkv, b, kp = _qkv_inputs(device, B, T, H, D, pad_cols=1)
    if offset:   # the projection one float into its storage
        store = torch.randn(B * T * 3 * H * D + 1, device=device)
        store[1:] = qkv.reshape(-1)
        qkv = store[1:].view(B, T, 3 * H * D)
    keep = fa.flash_kernel_dropout_mask(B, H, T, T, rate, seed, device)
    oq, lq = fa.flash_kernel_forward_qkv(qkv, b, H, kp, dropout_rate=rate,
                                         seed=seed)
    oq_ref, lq_ref = ae.qkv_ref_forward(qkv, b, H, kp, dropout_rate=rate,
                                        keep_mask=keep)
    torch.cuda.synchronize()
    for got, want in ((o, o_ref), (lse, lse_ref), (oq, oq_ref),
                      (lq, lq_ref)):
        torch.testing.assert_close(got, want, atol=FLASH_FWD_ATOL, rtol=0)


@pytest.mark.parametrize("shape", [(1, 4, 1000, 4096), (1, 2, 4096, 4096)],
                         ids=["tq1000_tk4096", "t4096"])
def test_tc_forward_skips_causal_tiles_exactly(device, shape):
    """Under the end-aligned causal mask the forward skips the key tiles
    right of a query tile's diagonal (key_end): at Tq < Tk and at T 4096,
    B 1, o and lse match the plain version over every key."""
    B, H, Tq, Tk = shape
    g = torch.Generator().manual_seed(8)
    q = torch.randn(B, H, Tq, 64, generator=g).to(device)
    k, v = (torch.randn(B, H, Tk, 64, generator=g).to(device)
            for _ in range(2))
    o, lse = fa.flash_kernel_forward_flat(q, k, v, causal=True)
    o_ref, lse_ref = fa.flash_ref_forward_flat(q, k, v, causal=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(o, o_ref, atol=FLASH_FWD_ATOL, rtol=0)
    torch.testing.assert_close(lse, lse_ref, atol=FLASH_FWD_ATOL, rtol=0)


# -- the fusion pass's kernels -----------------------------------------------

EPI_TOL = dict(atol=1e-4, rtol=1e-4)


def _rnd(g, device, *shape, scale=1.0, shift=0.0):
    return (torch.randn(*shape, generator=g) * scale + shift).to(device)


@pytest.mark.parametrize("causal,with_bias,rate,shape", [
    (False, True, 0.1, (8, 128, 12, 64)),
    (True, True, 0.0, (4, 128, 12, 64)),
    (False, False, 0.0, (4, 100, 8, 32)),
], ids=["dropout", "causal", "no_bias_t100_d32"])
def test_qkv_folded_forward_matches_plain_version(device, causal, with_bias,
                                                  rate, shape):
    """flash_fwd_qkv against the plain forward over the re-biased qkv
    (dropout through the packed kernels' own mask), then the gradients
    of fused_qkv_attention through the dq and dk/dv kernels against the
    plain composite's."""
    B, T, nh, D = shape
    H = nh * D
    g = torch.Generator().manual_seed(7)
    x = _rnd(g, device, B, T, H)
    w = _rnd(g, device, H, 3 * H, scale=H ** -0.5)
    b = _rnd(g, device, 3 * H, scale=0.1)
    mask4 = None
    if with_bias:
        pad = torch.zeros(B, 1, 1, T)
        pad[: B // 2, ..., T - T // 4:] = -1e4
        mask4 = pad.to(device)
    kp = None if mask4 is None else mask4.reshape(B, T).contiguous()
    seed = 4321
    keep = (fa.flash_kernel_dropout_mask(B, nh, T, T, rate, seed, device)
            if rate > 0 else None)
    qkv = torch.matmul(x, w)
    before = {n: _cuda.LAUNCHES[n] for n in (fa.QKV, fa.FWD, fa.DQ, fa.DKV)}
    o, lse = fa.flash_kernel_forward_qkv(qkv, b, nh, kp, causal,
                                         dropout_rate=rate, seed=seed)
    o_ref, lse_ref = ae.qkv_ref_forward(qkv, b, nh, kp, causal,
                                        dropout_rate=rate, keep_mask=keep)
    torch.testing.assert_close(o, o_ref, atol=FLASH_FWD_ATOL, rtol=0)
    torch.testing.assert_close(lse, lse_ref, atol=FLASH_FWD_ATOL, rtol=0)

    do = _rnd(g, device, B, T, H)
    leaves = [t.detach().requires_grad_() for t in (x, w, b)]
    got = torch.autograd.grad(ae.fused_qkv_attention(
        *leaves, nh, mask4, causal, dropout_rate=rate, seed=seed), leaves, do)
    leaves = [t.detach().requires_grad_() for t in (x, w, b)]
    want = torch.autograd.grad(ae.plain_qkv_attention(
        *leaves, nh, mask4, causal, dropout_rate=rate, keep_mask=keep),
        leaves, do)
    torch.cuda.synchronize()
    assert {n: _cuda.LAUNCHES[n] - before[n] for n in before} == \
        {fa.QKV: 2, fa.FWD: 0, fa.DQ: 1, fa.DKV: 1}
    for name, a, r in zip(("dx", "dw", "db"), got, want):
        assert torch.isfinite(a).all(), name
        torch.testing.assert_close(a, r, msg=name, **FLASH_GRAD_TOL)


GEMM_CASES = {
    "attn_out": (512, 768, 768, dict(residual=True, norm="layer_norm",
                                     dropout_rate=0.1)),
    "relu_no_bias": (256, 768, 3072, dict(bias=False, act="relu")),
    "gelu_tanh": (128, 256, 1024, dict(act="gelu", act_approximate=True)),
    "rms_norm": (300, 512, 1000, dict(residual=True, norm="rms_norm")),
    "affine_only": (256, 768, 768, dict(residual=True, norm=None)),
}


@pytest.mark.parametrize("case", sorted(GEMM_CASES))
def test_gemm_epilogue_matches_plain_version(device, case):
    M, K, N, opts = GEMM_CASES[case]
    opts = dict(opts)
    has_bias, has_res = opts.pop("bias", True), opts.pop("residual", False)
    spec = fm.EpilogueSpec(**opts)
    g = torch.Generator().manual_seed(11)
    x, w = _rnd(g, device, M, K), _rnd(g, device, K, N, scale=K ** -0.5)
    bias = _rnd(g, device, N, scale=0.1) if has_bias else None
    res = _rnd(g, device, M, N) if has_res else None
    gamma, beta = ((_rnd(g, device, N, scale=0.1, shift=1.0),
                    _rnd(g, device, N, scale=0.1))
                   if spec.norm else (None, None))
    args = (x, w, bias, res, gamma, beta)
    before = _cuda.LAUNCHES[fm.LAUNCH]
    y, z0, mask = fm.fused_matmul_kernel(*args, seed=99, spec=spec)
    y_ref, z0_ref = fm.reference_matmul_epilogue(*args, spec=spec, mask=mask)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES[fm.LAUNCH] == before + 1
    assert (z0 is None) == (spec.act is None and spec.norm is None)
    assert (mask is None) == (spec.dropout_rate == 0.0)
    if mask is not None:
        keep = mask.float().mean().item()
        sigma = (spec.dropout_rate * (1 - spec.dropout_rate)
                 / mask.numel()) ** 0.5
        assert abs(keep - (1 - spec.dropout_rate)) < 4 * sigma, keep
    torch.testing.assert_close(y, y_ref, **EPI_TOL)
    if z0 is not None:
        torch.testing.assert_close(z0, z0_ref, **EPI_TOL)

    dy = _rnd(g, device, M, N)
    leaves = [t.detach().requires_grad_() if t is not None else None
              for t in args]
    live = [t for t in leaves if t is not None]
    got = torch.autograd.grad(fm.fused_matmul(*leaves, seed=99, spec=spec),
                              live, dy)
    leaves = [t.detach().requires_grad_() if t is not None else None
              for t in args]
    live = [t for t in leaves if t is not None]
    want = torch.autograd.grad(fm.reference_matmul_epilogue(
        *leaves, spec=spec, mask=mask)[0], live, dy)
    for a, r in zip(got, want):
        torch.testing.assert_close(a, r, **EPI_TOL)


#: the tensor-core GEMM's edges (#10): M, K and N tails of its 64-row
#: clusters, 32-deep stages and 32-column boxes, one row, the widest rows
#: (their norm walks chunks of columns), every M with every N
GEMM_EDGE_SHAPES = [(M, (8, 24, 520)[i % 3], N) for i, (M, N) in enumerate(
    (M, N) for M in (1, 33, 1000) for N in (4, 132, 772, 8192))]


@pytest.mark.parametrize("M,K,N", GEMM_EDGE_SHAPES,
                         ids=[f"m{M}_k{K}_n{N}" for M, K, N in
                              GEMM_EDGE_SHAPES])
def test_gemm_epilogue_edges_match_plain_version(device, M, K, N):
    """The layer-norm epilogue with bias, dropout and residual at the
    edges of the kernel's tiles, against the plain version."""
    spec = fm.EpilogueSpec(dropout_rate=0.1, norm="layer_norm")
    g = torch.Generator().manual_seed(M + K + N)
    x, w = _rnd(g, device, M, K), _rnd(g, device, K, N, scale=K ** -0.5)
    args = (x, w, _rnd(g, device, N, scale=0.1), _rnd(g, device, M, N),
            _rnd(g, device, N, scale=0.1, shift=1.0),
            _rnd(g, device, N, scale=0.1))
    y, z0, mask = fm.fused_matmul_kernel(*args, seed=3, spec=spec)
    y_ref, z0_ref = fm.reference_matmul_epilogue(*args, spec=spec, mask=mask)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, y_ref, **EPI_TOL)
    torch.testing.assert_close(z0, z0_ref, **EPI_TOL)


@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["no_dropout", "dropout"])
def test_gemm_epilogue_is_deterministic(device, rate):
    """Each output element of #10 is summed by one warp in a fixed order
    and each row's norm sums are added in one order: two launches give the
    same bits in y, z0 and the mask."""
    spec = fm.EpilogueSpec(act="gelu", dropout_rate=rate, norm="layer_norm")
    g = torch.Generator().manual_seed(19)
    M, K, N = 1000, 768, 768
    args = (_rnd(g, device, M, K), _rnd(g, device, K, N, scale=K ** -0.5),
            _rnd(g, device, N, scale=0.1), _rnd(g, device, M, N),
            _rnd(g, device, N, scale=0.1, shift=1.0),
            _rnd(g, device, N, scale=0.1))
    runs = [fm.fused_matmul_kernel(*args, seed=23, spec=spec)
            for _ in range(2)]
    torch.cuda.synchronize()
    for name, a, r in zip(("y", "z0", "mask"), *runs):
        assert (a is None) == (r is None) == (name == "mask" and rate == 0)
        if a is not None:
            assert torch.equal(a, r), name


FFN_CASES = {
    "bert_ffn": (512, 768, 3072, 768, dict(act="gelu", dropout_rate=0.1,
                                           norm="layer_norm")),
    "relu": (256, 768, 3072, 768, dict(act="relu", norm="layer_norm")),
    "no_b2_no_norm": (256, 256, 1024, 512, dict(act="gelu", b2=False)),
    "ragged_rms": (300, 256, 512, 500, dict(act="gelu", norm="rms_norm",
                                            dropout_rate=0.1)),
    # the edges of the cluster-pair tiles: fewer rows than a cluster's 64,
    # N 384 (the second CTA's 256 columns half past N) and F 640 (a
    # partial last panel); 1000 rows (not a multiple of 64) with F 128
    # (less than one panel) and N 128 (all in the first CTA's half); a K
    # whose x rows the one-CTA kernel could not hold in shared memory; K
    # 16 (half of one 32-deep TMA stage) with N 4
    "m40_n384": (40, 256, 640, 384, dict(act="gelu", dropout_rate=0.1,
                                         norm="layer_norm")),
    "m1000_f128_n128": (1000, 64, 128, 128, dict(act="relu",
                                                 norm="layer_norm")),
    "k2048": (256, 2048, 1024, 768, dict(act="gelu", dropout_rate=0.1)),
    "k16_n4": (100, 16, 256, 4, dict(act="gelu", norm="layer_norm")),
}


@pytest.mark.parametrize("case", sorted(FFN_CASES))
def test_ffn_chain_matches_plain_version(device, case):
    M, K, F, N, opts = FFN_CASES[case]
    opts = dict(opts)
    has_b2 = opts.pop("b2", True)
    spec = fm.EpilogueSpec(**opts)
    assert fc.ffn_chain_shapes_ok(M, K, F, N)
    g = torch.Generator().manual_seed(13)
    x = _rnd(g, device, M, K)
    w1, b1 = _rnd(g, device, K, F, scale=K ** -0.5), _rnd(g, device, F,
                                                          scale=0.1)
    w2 = _rnd(g, device, F, N, scale=F ** -0.5)
    b2 = _rnd(g, device, N, scale=0.1) if has_b2 else None
    res = _rnd(g, device, M, N) if spec.norm else None
    gamma, beta = ((_rnd(g, device, N, scale=0.1, shift=1.0),
                    _rnd(g, device, N, scale=0.1))
                   if spec.norm else (None, None))
    args = (x, w1, b1, w2, b2, res, gamma, beta)
    before = _cuda.LAUNCHES[fc.LAUNCH]
    y, mask = fc.ffn_chain_kernel(*args, seed=5, spec=spec)
    y_ref = fc.reference_ffn_chain(*args, spec=spec, mask=mask)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES[fc.LAUNCH] == before + 1
    assert (mask is None) == (spec.dropout_rate == 0.0)
    torch.testing.assert_close(y, y_ref, **EPI_TOL)

    dy = _rnd(g, device, M, N)
    leaves = [t.detach().requires_grad_() if t is not None else None
              for t in args]
    live = [t for t in leaves if t is not None]
    got = torch.autograd.grad(fc.fused_ffn_chain(*leaves, seed=5, spec=spec),
                              live, dy)
    leaves = [t.detach().requires_grad_() if t is not None else None
              for t in args]
    live = [t for t in leaves if t is not None]
    want = torch.autograd.grad(fc.reference_ffn_chain(
        *leaves, spec=spec, mask=mask), live, dy)
    for a, r in zip(got, want):
        torch.testing.assert_close(a, r, **EPI_TOL)


@pytest.mark.parametrize("M,N", [(4096, 768), (1000, 500), (40, 384)],
                         ids=["bert_base", "ragged", "m40"])
def test_ffn_chain_mask_is_the_fused_matmul_mask(device, M, N):
    """Both kernels keep an element when Philox-4x32-10 of (column, row)
    under the op's seed clears the rate: at the same seed, rate, M and N
    the chain's keep mask equals fused_matmul_kernel's bit for bit, so
    the cluster-pair tiles left it alone."""
    g = torch.Generator().manual_seed(17)
    K, F = 64, 640
    x = _rnd(g, device, M, K)
    _, keep = fc.ffn_chain_kernel(
        x, _rnd(g, device, K, F), None, _rnd(g, device, F, N), seed=31,
        spec=fm.EpilogueSpec(act="gelu", dropout_rate=0.1))
    _, _, want = fm.fused_matmul_kernel(
        x, _rnd(g, device, K, N), seed=31,
        spec=fm.EpilogueSpec(dropout_rate=0.1))
    torch.cuda.synchronize()
    assert keep.dtype == want.dtype == torch.uint8
    assert torch.equal(keep, want)


def test_bert_ffn_takes_the_chain_and_the_head_replays():
    """The predicates, as the fusion pass reads them at BERT-base: the
    FFN takes the chain kernel, attn.out the fused matmul, the MLM head
    (N = 30522) neither."""
    assert fc.ffn_chain_shapes_ok(4096, 768, 3072, 768)
    assert fm.fused_shapes_ok(4096, 768, 768)
    assert not fm.fused_shapes_ok(4096, 768, 30522)
    assert ae.attn_epilogue_shapes_ok(128, 768, 12)


def test_fusion_wrappers_raise_instead_of_falling_back(device):
    x = torch.zeros(64, 768, device=device)
    w = torch.zeros(768, 768, device=device)
    with pytest.raises(TypeError):
        fm.fused_matmul_kernel(x, w.double())
    with pytest.raises(ValueError, match="fused_shapes_ok"):
        fm.fused_matmul_kernel(x, torch.zeros(768, 30522, device=device))
    with pytest.raises(ValueError, match="on cpu"):
        fm.fused_matmul_kernel(x, w, bias=torch.zeros(768))
    with pytest.raises(ValueError, match="contiguous"):
        fm.fused_matmul_kernel(x, w, residual=torch.zeros(
            768, 64, device=device).t())
    with pytest.raises(ValueError, match="ffn_chain_shapes_ok"):
        fc.ffn_chain_kernel(x, torch.zeros(768, 3072, device=device), None,
                            torch.zeros(3072, 1024, device=device))
    qkv = torch.zeros(2, 16, 3 * 64, device=device)
    with pytest.raises(ValueError, match="b_qkv"):
        fa.flash_kernel_forward_qkv(qkv, torch.zeros(64, device=device), 4)


def test_paged_handoff_round_trip_is_bit_exact(device):
    """The cluster handoff on the card: host K/V imported into a slot's
    pages (spanning page boundaries, after another slot took pages in
    between) and exported again come back bit for bit, through both
    the whole-sequence and the span entries."""
    from paddle_tpu_torch.generation import PagedKVCache

    L, H, page = 12, 768, 16
    cache = PagedKVCache(num_layers=L, hidden=H, page_size=page,
                         num_pages=33, max_seqs=4, max_len=128,
                         device=device)
    rng = np.random.RandomState(13)
    cache.admit(1, 20)
    cache.admit(0, 45)
    k = rng.standard_normal((L, 45, H)).astype(np.float32)
    v = rng.standard_normal((L, 45, H)).astype(np.float32)
    k[0, 0, 0], v[1, 2, 3] = np.float32(-0.0), np.float32(1e-40)
    cache.import_seq(0, k, v)
    got_k, got_v = cache.export_seq(0, 45)
    for got, want in ((got_k, k), (got_v, v)):
        assert got.dtype == np.float32 and got.shape == want.shape
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    cache.import_span(0, 13, k[:, :20] + 1, v[:, :20] + 1)
    got_k, got_v = cache.export_span(0, 13, 33)
    assert np.array_equal(got_k.view(np.uint32),
                          (k[:, :20] + 1).view(np.uint32))
    assert np.array_equal(got_v.view(np.uint32),
                          (v[:, :20] + 1).view(np.uint32))


def _nan_rows(t):
    """Which rows (first axis) of t hold a NaN."""
    return torch.isnan(t.reshape(t.shape[0], -1)).any(dim=1).tolist()


@pytest.mark.parametrize("nan", [0x7FFFFFFF, 0x7FC00000],
                         ids=["canonical", "quiet"])
def test_a_nan_operand_stays_nan_through_the_tensor_core_kernels(device,
                                                                 nan):
    """A NaN in one batch row's input reaches that row's output (and
    only that row's), as in each kernel's plain version: the 3xTF32
    split must not round a NaN into a zero (CUDA arithmetic makes the
    canonical NaN 0x7fffffff, whose rounding add carries through the
    exponent)."""
    nan = torch.tensor([nan], dtype=torch.int64).to(torch.int32) \
        .view(torch.float32).item()
    torch.manual_seed(0)
    B, T, K, H, nh = 2, 128, 768, 768, 12
    x = torch.randn(B, T, K, device=device)
    x[0, 3, 5] = nan
    w = torch.randn(K, 3 * H, device=device) * 0.03
    b = torch.randn(3 * H, device=device) * 0.1
    xg = x.clone().requires_grad_()
    o = ae.fused_qkv_attention(xg, w, b, nh)                # #9
    o.sum().backward()                                       # #5, #6
    want = [True, False]
    assert _nan_rows(o) == want and _nan_rows(xg.grad) == want
    q, k, v = (x @ w + b).split(H, -1)
    assert _nan_rows(fa.flash_attention_packed(q, k, v, nh)) == want  # #3
    q4 = q.reshape(B, T, nh, H // nh).transpose(1, 2)
    assert _nan_rows(fa.flash_attention(q4, q4, q4)) == want          # #4
    x2 = x.reshape(B * T, K)
    wm = torch.randn(K, H, device=device) * 0.03
    y = fm.fused_matmul(x2, wm, spec=fm.EpilogueSpec(norm="layer_norm"))
    assert _nan_rows(y.reshape(B, T, H)) == want                      # #10
    w1 = torch.randn(K, 3072, device=device) * 0.03
    w2 = torch.randn(3072, H, device=device) * 0.03
    y = fc.fused_ffn_chain(x2, w1, None, w2,
                           spec=fm.EpilogueSpec(act="gelu"))
    assert _nan_rows(y.reshape(B, T, H)) == want                      # #11


def test_dataloader_double_buffer_lands_on_the_card(device):
    """The DataLoader's double buffer on a card (pinned host copies on a
    side stream, the consumer's stream waiting on their event): every
    batch arrives on the card equal to its host array, across more
    batches than the queue holds, and is used right away by a kernel."""
    import numpy as np

    import paddle_tpu_torch as pt

    loader = pt.DataLoader.from_generator(feed_list=["x"], capacity=2)
    loader.set_batch_generator(lambda: ({"x": np.full((512, 512), i,
                                                      np.float32)}
                                        for i in range(24)))
    sums = []
    for b in loader:
        assert b["x"].device.type == "cuda"
        sums.append(b["x"].sum())
    assert [float(s) for s in sums] == [i * 512.0 * 512 for i in range(24)]
