"""The numerics the tensor-core flash kernels (the backward pair #7
``flash_bwd_dq_flat`` and #8 ``flash_bwd_dkv_flat``, which #5
``flash_bwd_dq_packed`` and #6 ``flash_bwd_dkv_packed`` run on the packed
layout, and the forwards #4 ``flash_fwd_flat``, #9 ``flash_fwd_qkv`` and
#3 ``flash_fwd_packed``, ``paddle_tpu_torch/csrc/flash_attention.cu``)
rest on, emulated on the CPU: their products run as 3xTF32 on the card's
tensor cores.

Each float32 operand x is split into big = tf32(x) and small =
tf32(x - big), where tf32 is PTX's ``cvt.rna.tf32.f32`` (round to
nearest, ties away from zero, 10 mantissa bits kept), emulated here with
integer bit operations; a product a.b is summed, eight products of k at
a time as one ``mma.sync.m16n8k8`` does, as big.small + small.big +
big.big (small.small is dropped), each MMA adding its exact products to
a float32 accumulator and rounding the sum toward zero, as the tensor
cores do.  The backward recomputed so (S, dP, dQ; S^T, dP^T, dV, dK)
must match the plain float32 backward ``flash_ref_backward_flat`` within
chip_smoke.py's FLASH_GRAD_ATOL / FLASH_GRAD_RTOL (1e-4, 1e-4), the
tolerance the kernels are held to on the card; one TF32 product alone
(big.big) must miss it by at least ten times the 3xTF32 error, which is
why the split is there.  The kernels sum dQ, dK and dV over the whole
sequence in one accumulator each; that must hold the tolerance with at
least twice its error to spare, and so must the qkv projection's weight
and bias gradients that a training step closes from the packed pair's
dq, dk and dv over 4096 rows (against PARITY_GRAD_RTOL), which decides
that the backward needs no per-tile fold into IEEE sums (``fold``, the
alternative the model weighs).
The forward recomputed so (S = Q K^T for each streamed 32-key tile, the
online softmax, each tile's P~ V summed from zero and added to the
rescaled output, for #9 the qkv bias added before the split; #3
``flash_fwd_packed`` runs the same kernel on the packed layout) must
match the plain forwards ``flash_ref_forward_flat``, ``qkv_ref_forward``
and ``flash_ref_forward`` within chip_smoke.py's FLASH_FWD_ATOL (1e-5) in
o and lse, and one TF32 product must again miss it by ten times.
Cases are shaped like chip_smoke.FLAT_CASES at test size: ragged T 100,
Tq 128 with Tk 256, causal Tq 80 with Tk 128, D 32, 64 and 128, key
padding, a dropout mask fed to both sides, and the packed training layer
(T 128, D 64, key padding, dropout 0.1); the forward adds a qkv-folded
case with the qkv bias and a packed case at a training layer's T 128.
"""
import math

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import attention_epilogue as ae
from paddle_tpu_torch.ops import flash_attention as fa

#: chip_smoke.py's FLASH_GRAD_ATOL / FLASH_GRAD_RTOL (unchanged)
GRAD_ATOL = GRAD_RTOL = 1e-4
#: chip_smoke.py's FLASH_FWD_ATOL (unchanged)
FWD_ATOL = 1e-5
#: keys of the forward kernel's streamed K/V tile (csrc kTcKeys)
KEY_TILE = 32
#: 1xTF32 must be at least this many times further from the plain
#: backward than 3xTF32
SPLIT_GAIN = 10.0

#: (B, H, Tq, Tk, D, causal, key padding, dropout rate)
CASES = {
    "t100": (2, 2, 100, 100, 64, False, True, 0.0),
    "tq128_tk256_d32": (2, 2, 128, 256, 32, False, True, 0.0),
    "causal_tq80_tk128": (2, 3, 80, 128, 64, True, True, 0.0),
    "t100_d128": (1, 2, 100, 100, 128, False, True, 0.0),
    "dropout": (2, 2, 128, 128, 64, False, True, 0.1),
    "causal_dropout_d32": (1, 2, 96, 160, 32, True, False, 0.1),
    # the packed training layer (the packed kernels are these kernels over
    # heads D apart): PACKED_CASE's shape, key padding, dropout
    "packed_layer": (2, 3, 128, 128, 64, False, True, 0.1),
}
#: each case's numpy seed, fixed so that a new case leaves the others'
#: data as it was
SEEDS = {"causal_dropout_d32": 0, "causal_tq80_tk128": 1, "dropout": 2,
         "t100": 3, "t100_d128": 4, "tq128_tk256_d32": 5, "qkv_bias": 6,
         "packed_t128": 7, "packed_layer": 8, "qkv_weight_grad": 9}


def tf32_rna(x):
    """PTX cvt.rna.tf32.f32 on a float32 tensor: keep 10 mantissa bits,
    rounding to nearest with ties away from zero (add half a unit of the
    kept last place to the magnitude bits, then clear the 13 dropped
    bits); the result is a float32 whose low 13 bits are zero."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    return bits.to(torch.int32).view(torch.float32)


def split(x):
    """The kernels' split_tf32: a NaN's big part is the canonical NaN
    (tf32_rna's add would carry it into a zero)."""
    big = tf32_rna(x)
    small = tf32_rna(x - big)
    return torch.where(torch.isnan(x), float("nan"), big), small


def round_to_zero(v):
    """float64 -> float32, rounded toward zero (the tensor cores'
    rounding of an MMA's sum)."""
    f = v.float()
    over = f.double().abs() > v.abs()
    f[over] = torch.nextafter(f[over], torch.zeros_like(f[over]))
    return f


def mma(a, b, passes=3, fold=None):
    """a [..., M, K] @ b [..., K, N] as m16n8k8 TF32 MMAs, eight k at a
    time: 3xTF32 (big.small, small.big, then big.big) or, with passes=1,
    big.big alone.  Each MMA adds its eight exact products to its float32
    accumulator and rounds the sum toward zero, as the tensor cores do.
    With ``fold``, every ``fold`` k (a streamed tile) are summed so from
    zero and added to the running float32 sum in IEEE (to nearest); else
    all of K runs in one accumulator."""
    ab, as_ = (t.double() for t in split(a.float()))
    bb, bs = (t.double() for t in split(b.float()))
    terms = ((ab, bs), (as_, bb), (ab, bb)) if passes == 3 else ((ab, bb),)
    K = a.shape[-1]
    span = fold or K
    c = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    for s0 in range(0, K, span):
        t = torch.zeros_like(c) if fold else c
        for k0 in range(s0, min(K, s0 + span), 8):
            for x, y in terms:
                t = round_to_zero(t.double()
                                  + torch.matmul(x[..., k0:k0 + 8],
                                                 y[..., k0:k0 + 8, :]))
        c = c + t if fold else t
    return c


def emulated_backward(q, k, v, bias, lse, delta, do, causal, keep, rate,
                      passes, fold=False):
    """The dq kernel's and the dk/dv kernel's arithmetic with their
    products through ``mma``: (dq, dk, dv, dbias).  S and dP start from
    zero for every streamed tile (their sums run over D); dQ, dV and dK
    sum over the streamed keys or queries, in one accumulator each, or
    with ``fold`` one streamed tile at a time (KEY_TILE keys; the dk/dv
    kernel's query tile, 16 rows at D 128)."""
    D, Tq, Tk = q.shape[-1], q.shape[2], k.shape[2]
    scale = 1.0 / math.sqrt(D)
    key_tile = KEY_TILE if fold else None
    query_tile = (16 if D > 64 else KEY_TILE) if fold else None
    masked = None
    if causal:
        masked = (torch.arange(Tk)[None, :]
                  > torch.arange(Tq)[:, None] + Tk - Tq)

    def probs(s):  # s [B, H, Tq, Tk] -> p
        x = s * scale + (0.0 if bias is None else bias)
        if masked is not None:
            x = x.masked_fill(masked, -1e30)
        return torch.exp(x - lse[..., None])

    def dropped(x):
        return x if keep is None else torch.where(keep, x / (1 - rate), 0.0)

    # dq kernel: S = Q K^T, dP = dO V^T, dQ = dS K
    p = probs(mma(q, k.transpose(-1, -2), passes))
    ds = p * (dropped(mma(do, v.transpose(-1, -2), passes))
              - delta[..., None])
    dq = mma(ds, k, passes, key_tile) * scale
    # dk/dv kernel: S^T = K Q^T, dP^T = V dO^T, dV = P~^T dO, dK = dS^T Q
    pt = probs(mma(k, q.transpose(-1, -2), passes).transpose(-1, -2))
    dst = pt * (dropped(mma(v, do.transpose(-1, -2), passes)
                        .transpose(-1, -2)) - delta[..., None])
    dv = mma(dropped(pt).transpose(-1, -2), do, passes, query_tile)
    dk = mma(dst.transpose(-1, -2), q, passes, query_tile) * scale
    return dq, dk, dv, dst.sum(dim=2)


def _case(name):
    B, H, Tq, Tk, D, causal, padding, rate = CASES[name]
    rng = np.random.RandomState(SEEDS[name])
    q = torch.from_numpy(rng.randn(B, H, Tq, D).astype(np.float32))
    k, v = (torch.from_numpy(rng.randn(B, H, Tk, D).astype(np.float32))
            for _ in range(2))
    do = torch.from_numpy(rng.randn(B, H, Tq, D).astype(np.float32))
    bias = None
    if padding:
        b = np.zeros((B, 1, 1, Tk), np.float32)
        b[..., Tk - Tk // 4:] = -1e4
        bias = torch.from_numpy(b).expand(B, H, 1, Tk)
    keep = None
    if rate:
        keep = torch.from_numpy(rng.rand(B, H, Tq, Tk) >= rate)
    kw = dict(causal=causal, dropout_rate=rate, keep_mask=keep)
    o, lse = fa.flash_ref_forward_flat(q, k, v, bias, **kw)
    delta = fa.flash_delta_flat(o, do)
    want = fa.flash_ref_backward_flat(q, k, v, bias, o, lse, do, **kw)
    return (q, k, v, bias, lse, delta, do, causal, keep, rate), want


def _errors(got, want):
    """Per gradient: (max |got - want|, max (|got - want| - rtol |want|))."""
    return [(float((g - w).abs().max()),
             float(((g - w).abs() - GRAD_RTOL * w.abs()).max()))
            for g, w in zip(got, want)]


@pytest.mark.parametrize("value,rounded", [
    (1.0, 1.0),
    (1.0 + 2 ** -11, 1.0 + 2 ** -10),         # a tie rounds away from zero
    (-(1.0 + 2 ** -11), -(1.0 + 2 ** -10)),
    (1.0 + 2 ** -12, 1.0),                    # below the tie: down
    (1.0 + 2 ** -11 + 2 ** -23, 1.0 + 2 ** -10),
    (1.0 + 3 * 2 ** -11, 1.0 + 2 * 2 ** -10),  # a tie above an odd last bit
    (2.0 - 2 ** -12, 2.0),                    # the carry reaches the exponent
])
def test_tf32_rounding_is_cvt_rna(value, rounded):
    got = tf32_rna(torch.tensor([value], dtype=torch.float32))
    assert got.item() == rounded
    assert got.view(torch.int32).item() & 0x1FFF == 0


@pytest.mark.parametrize("bits", [0x7FFFFFFF, 0xFFFFFFFF, 0x7FC00000,
                                  0x7F800001, 0x7FFFF000])
def test_tf32_rounding_keeps_a_nan(bits):
    """A NaN operand's big part stays a NaN (tf32_rna's add would carry
    the canonical NaN through the exponent into a zero); infinities
    round to themselves."""
    x = torch.tensor([bits - 2 ** 32 if bits >= 2 ** 31 else bits],
                     dtype=torch.int32).view(torch.float32)
    big, small = split(x)
    assert torch.isnan(big).all()
    # the product of the split with any finite value is NaN
    w = torch.tensor([1.5])
    assert torch.isnan(big * w + small * w + big * w).all()
    for inf in (float("inf"), -float("inf")):
        assert tf32_rna(torch.tensor([inf])).item() == inf


def test_split_keeps_float32_accuracy():
    x = torch.from_numpy(np.random.RandomState(0).randn(4096)
                         .astype(np.float32))
    big, small = split(x)
    rel = ((big.double() + small.double() - x.double()).abs()
           / x.double().abs()).max().item()
    assert rel <= 2.0 ** -21, rel
    assert ((big.double() - x.double()).abs()
            / x.double().abs()).max().item() > 2.0 ** -13


@pytest.mark.parametrize("name", sorted(CASES))
def test_3xtf32_backward_holds_the_kernel_tolerance(name):
    args, want = _case(name)
    got = emulated_backward(*args, passes=3)
    for grad, (err, excess) in zip(("dq", "dk", "dv", "dbias"),
                                   _errors(got, want)):
        assert excess <= GRAD_ATOL, (grad, err, excess)
        assert all(bool(torch.isfinite(g).all()) for g in got)


@pytest.mark.parametrize("name", sorted(CASES))
def test_1xtf32_is_ten_times_further_off(name):
    args, want = _case(name)
    three = _errors(emulated_backward(*args, passes=3), want)
    one = _errors(emulated_backward(*args, passes=1), want)
    worst3 = max(err for err, _ in three)
    worst1 = max(err for err, _ in one)
    assert worst1 >= SPLIT_GAIN * worst3, (worst1, worst3)


#: the qkv weight gradient's case: (B, T, nh, D, K, dropout rate): a
#: training layer's 32 x 128 = 4096 rows at test width, the projection's
#: input width K, key padding on half the batch
WGRAD_CASE = (32, 128, 3, 64, 64, 0.1)
#: chip_smoke.py's PARITY_GRAD_RTOL: the relative norm error the training
#: step's first-step gradients are held to (unchanged)
PARITY_GRAD_RTOL = 1e-3
#: the least room a design must leave under a tolerance
ROOM = 2.0


def _qkv_weight_grads(fold):
    """The packed backward carried into the qkv projection's gradients, as
    the fused attention's backward closes them: qkv = x w + b, the
    emulated kernels' dq, dk, dv written as one dqkv [B T, 3H], then
    dw = x^T dqkv and db = dqkv summed over rows (sums over all 4096
    rows), each against the plain backward's -> their relative norm
    errors."""
    B, T, nh, D, K, rate = WGRAD_CASE
    H = nh * D
    rng = np.random.RandomState(SEEDS["qkv_weight_grad"])
    x = torch.from_numpy(rng.randn(B * T, K).astype(np.float32))
    w = torch.from_numpy((rng.randn(K, 3 * H) * K ** -0.5).astype(np.float32))
    b = torch.from_numpy((rng.randn(3 * H) * 0.1).astype(np.float32))
    do = torch.from_numpy(rng.randn(B, nh, T, D).astype(np.float32))
    keep = torch.from_numpy(rng.rand(B, nh, T, T) >= rate)
    pad = torch.zeros(B, 1, 1, T)
    pad[: B // 2, ..., T - T // 4:] = -1e4
    bias = pad.expand(B, nh, 1, T)
    q, k, v = (t.reshape(B, T, nh, D).transpose(1, 2)
               for t in (x @ w + b).split(H, dim=-1))
    kw = dict(dropout_rate=rate, keep_mask=keep)
    o, lse = fa.flash_ref_forward_flat(q, k, v, bias, **kw)
    delta = fa.flash_delta_flat(o, do)
    want = fa.flash_ref_backward_flat(q, k, v, bias, o, lse, do, **kw)[:3]
    got = emulated_backward(q, k, v, bias, lse, delta, do, False, keep, rate,
                            passes=3, fold=fold)[:3]

    def closed(grads):
        dqkv = torch.cat([fa._merge(g) for g in grads], -1).reshape(
            B * T, 3 * H).double()
        return x.double().t() @ dqkv, dqkv.sum(0)

    return [float(torch.linalg.vector_norm(g - r)
                  / torch.linalg.vector_norm(r))
            for g, r in zip(closed(got), closed(want))]


def _room(got, want):
    """The largest |got - want| / (atol + rtol |want|) over the gradients:
    1 is the kernel tolerance's edge."""
    return max(float(((g - w).abs() / (GRAD_ATOL + GRAD_RTOL * w.abs()))
                     .max()) for g, w in zip(got, want))


@pytest.mark.parametrize("name", sorted(CASES))
def test_one_running_sum_holds_the_kernel_tolerance_with_room(name):
    """The backward kernels sum dQ, dK and dV over the whole sequence in
    one tensor-core accumulator each (no per-tile fold): rounded toward
    zero at every MMA, that holds FLASH_GRAD_ATOL / RTOL with at least
    ROOM times to spare."""
    args, want = _case(name)
    ratio = _room(emulated_backward(*args, passes=3), want)
    assert ratio * ROOM <= 1.0, ratio


@pytest.mark.parametrize("fold", [False, True])
def test_qkv_weight_gradient_holds_the_step_tolerance_with_room(fold):
    """Carried into the qkv projection's weight and bias gradients over
    4096 rows, one running sum (the kernels' design) and the per-tile
    fold both hold the training step's PARITY_GRAD_RTOL with at least
    ROOM times to spare: the rounding toward zero does not add up over
    the rows as #10's did over K (tests/test_torch_gemm_tf32x3.py)."""
    errs = _qkv_weight_grads(fold)
    assert max(errs) * ROOM <= PARITY_GRAD_RTOL, errs


# -- the forward (#4, #9) -----------------------------------------------------

#: the qkv-folded forward's case: (B, T, nh, D, causal, key padding,
#: dropout rate), a qkv bias of chip_smoke.QKV_CASES' scale
QKV_CASE = (2, 100, 3, 32, False, True, 0.1)
#: the packed forward's case (#3 runs the flat kernel on [B, T, nh D] with
#: heads D apart and one [Tk] key-bias row per batch): a training layer's
#: T 128 at test size, key padding, dropout
PACKED_CASE = (2, 128, 3, 64, False, True, 0.1)


def emulated_forward(q, k, v, bias, causal, keep, rate, passes,
                     add=(None, None, None)):
    """The forward kernel's arithmetic on [B, H, T, D]: per streamed
    32-key tile, S through ``mma``, the online softmax (a row's running
    maximum and sum), and the tile's P~ V through ``mma`` from zero,
    added to the running output rescaled by exp(m_old - m_new); ``add``:
    the q, k, v bias slices [H, D] (#9), added before the split ->
    (o, lse)."""
    q, k, v = (x if a is None else x + a[None, :, None, :]
               for x, a in zip((q, k, v), add))
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    scale = 1.0 / math.sqrt(D)
    m = torch.full((B, H, Tq), -1e30)
    row_sum = torch.zeros(B, H, Tq)
    o = torch.zeros(B, H, Tq, D)
    for k0 in range(0, Tk, KEY_TILE):
        k1 = min(Tk, k0 + KEY_TILE)
        x = mma(q, k[:, :, k0:k1].transpose(-1, -2), passes) * scale
        if bias is not None:
            x = x + bias[..., k0:k1]
        if causal:
            masked = (torch.arange(k0, k1)[None, :]
                      > torch.arange(Tq)[:, None] + Tk - Tq)
            x = x.masked_fill(masked, -1e30)
        m_new = torch.maximum(m, x.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(x - m_new[..., None])
        row_sum = row_sum * alpha + p.sum(-1)
        if keep is not None:
            p = torch.where(keep[..., k0:k1], p / (1 - rate), 0.0)
        o = o * alpha[..., None] + mma(p, v[:, :, k0:k1], passes)
        m = m_new
    return o / row_sum[..., None], m + torch.log(row_sum)


def _fwd_case(name):
    """(emulated_forward's inputs, its ``add``, the plain forward's (o,
    lse), a function taking the emulation's [B, H, T, D] o to the plain
    one's layout)."""
    if name == "qkv_bias":
        B, T, nh, D, causal, padding, rate = QKV_CASE
        H = nh * D
        rng = np.random.RandomState(SEEDS[name])
        qkv = torch.from_numpy(rng.randn(B, T, 3 * H).astype(np.float32))
        b = torch.from_numpy((rng.randn(3 * H) * 0.1).astype(np.float32))
        kp = None
        if padding:
            kp = torch.zeros(B, T)
            kp[: B // 2, T - T // 4:] = -1e4
        keep = (torch.from_numpy(rng.rand(B, nh, T, T) >= rate)
                if rate else None)
        want = ae.qkv_ref_forward(qkv, b, nh, kp, causal, dropout_rate=rate,
                                  keep_mask=keep)
        q, k, v = (x.reshape(B, T, nh, D).transpose(1, 2)
                   for x in qkv.split(H, dim=-1))
        add = tuple(a.reshape(nh, D) for a in b.split(H))
        bias = None if kp is None else kp[:, None, None, :]
        return (q, k, v, bias, causal, keep, rate), add, want, fa._merge
    if name == "packed_t128":
        B, T, nh, D, causal, padding, rate = PACKED_CASE
        H = nh * D
        rng = np.random.RandomState(SEEDS[name])
        q, k, v = (torch.from_numpy(rng.randn(B, T, H).astype(np.float32))
                   for _ in range(3))
        kp = None
        if padding:
            kp = torch.zeros(B, T)
            kp[: B // 2, T - T // 4:] = -1e4
        keep = (torch.from_numpy(rng.rand(B, nh, T, T) >= rate)
                if rate else None)
        want = fa.flash_ref_forward(q, k, v, nh, bias=kp, causal=causal,
                                    dropout_rate=rate, keep_mask=keep)
        heads = tuple(x.reshape(B, T, nh, D).transpose(1, 2)
                      for x in (q, k, v))
        bias = None if kp is None else kp[:, None, None, :]
        return (*heads, bias, causal, keep, rate), (None,) * 3, want, \
            fa._merge
    (q, k, v, bias, _, _, _, causal, keep, rate), _ = _case(name)
    want = fa.flash_ref_forward_flat(q, k, v, bias, causal=causal,
                                     dropout_rate=rate, keep_mask=keep)
    return ((q, k, v, bias, causal, keep, rate), (None,) * 3, want,
            lambda o: o)


FWD_CASES = sorted(CASES) + ["qkv_bias", "packed_t128"]


def _fwd_errors(name, passes):
    """(max |o - o_plain|, max |lse - lse_plain|) of the emulation."""
    args, add, (o_ref, lse_ref), layout = _fwd_case(name)
    o, lse = emulated_forward(*args, passes=passes, add=add)
    assert bool(torch.isfinite(o).all()) and bool(torch.isfinite(lse).all())
    return (float((layout(o) - o_ref).abs().max()),
            float((lse - lse_ref).abs().max()))


@pytest.mark.parametrize("name", FWD_CASES)
def test_3xtf32_forward_holds_the_kernel_tolerance(name):
    err_o, err_lse = _fwd_errors(name, passes=3)
    assert err_o <= FWD_ATOL and err_lse <= FWD_ATOL, (err_o, err_lse)


@pytest.mark.parametrize("name", FWD_CASES)
def test_1xtf32_forward_is_ten_times_further_off(name):
    worst3 = max(_fwd_errors(name, passes=3))
    worst1 = max(_fwd_errors(name, passes=1))
    assert worst1 >= SPLIT_GAIN * worst3, (worst1, worst3)
