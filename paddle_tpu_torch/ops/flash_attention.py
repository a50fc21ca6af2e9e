"""Flash attention, forward and backward, over packed heads and over the
flat [B, H, T, D] layout (the ``fused_attention`` op over them registers
in ops/nn.py).

Counterpart of paddle_tpu/ops/pallas_ops.py: ``flash_attention_packed``
(its packed-layout custom VJP over the Pallas kernels ``_fwd_kernel_packed``,
``_bwd_dq_kernel_packed`` and ``_bwd_dkv_kernel_packed``),
``flash_attention`` and ``flash_attention_lse`` (the flat custom VJP of
``_make_flash_lse`` over ``_fwd_kernel``, ``_bwd_dq_kernel`` and
``_bwd_dkv_kernel``, whose backward takes an lse cotangent), and the
``fused_attention`` op.  Semantics (the JAX kernels'): f32 scores
``(q . k) * sm_scale + bias`` with a key bias [B, Tk] (packed) or one
row per (batch, head) (flat, from a [B|1, H|1, 1, Tk] bias), an
end-aligned causal mask with the finite value -1e30, dropout on the
probabilities (kept when the pair's random bits exceed rate * 2^32,
scaled by 1 / (1 - rate)), and ``lse`` saved for a backward that
recomputes the probabilities.

Two implementations behind one autograd function, chosen by where the
tensors live and nothing else:

* ``csrc/flash_attention.cuh`` — hand-written CUDA kernels for Hopper
  (sm_90a), float32 (entries in ``flash_attention.cu``):
  ``flash_fwd_packed`` (o and lse),
  ``flash_bwd_dq_packed`` and ``flash_bwd_dkv_packed`` (dk, dv and a
  per-head dbias the wrapper sums over heads, as the JAX wrapper sums
  its lane groups), and the same three on the flat layout,
  ``flash_fwd_flat``, ``flash_bwd_dq_flat`` and ``flash_bwd_dkv_flat``
  (head strides, a bias row per (batch, head), dbias kept per (batch,
  head) as the JAX VJP returns it).  All of them run their products on
  the tensor cores as 3xTF32, float32's accuracy; the packed backward
  pair writes dq, dk and dv through their strides, so a caller may hand
  it the column slices of one [B, T, 3H] dqkv (``out=``).  Each
  wrapper adds one to
  ``_cuda.LAUNCHES[name]`` per launch and raises on anything its kernel
  cannot take (a bias that is not key-padding shaped, d_head > 128, a
  tensor of another dtype); there is no fallback.  The packed entries
  and the qkv entry also run in bfloat16 and float16 (AMP; entries in
  ``flash_attention_amp.cu``, counted under ``<name>_bf16`` and
  ``<name>_f16``): q, k, v, dout and o, dq, dk, dv in that type, lse,
  delta, the key bias and dbias float32, one TF32 product per product
  (a bfloat16/float16 value is exact in TF32) and the JAX kernels'
  rounding points.  The dropout mask comes
  from Philox keyed by the op's seed, regenerated in every kernel;
  ``flash_kernel_dropout_mask`` writes it out so the plain version can
  be handed the same mask.
* ``flash_ref_forward`` / ``flash_ref_backward`` (and ``*_flat``) — the
  same arithmetic in plain PyTorch, given the keep mask, rounding a
  bfloat16/float16 call where its kernel does.  CPU tensors take them
  (their mask from a ``torch.Generator`` seeded by the op's seed);
  ``chip_smoke.py`` holds the kernels against them on the card.

``delta = rowsum(do * o)`` per head (minus the lse cotangent on the flat
path: ``ds = p * (dp - (delta - dlse))``) is a small torch op between the
forward and the backward kernels, as XLA computes it outside the Pallas
kernels.  The op takes the packed layout with ``num_heads`` and the 4-D
[B, H, T, D] layout without it; both run their kernels on the card, their
plain versions on the CPU and shapes alone on ``meta``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .. import _cuda
from .attention import _NEG_INF, _heads, attention, attention_packed

__all__ = ["flash_attention_packed", "flash_ref_forward",
           "flash_ref_backward", "flash_kernel_forward", "flash_delta",
           "flash_kernel_dq", "flash_kernel_dkv", "flash_kernel_backward",
           "flash_kernel_dropout_mask", "flash_kernel_forward_qkv",
           "flash_attention", "flash_attention_lse", "flash_ref_forward_flat",
           "flash_ref_backward_flat", "flash_kernel_forward_flat",
           "flash_delta_flat", "flash_kernel_dq_flat", "flash_kernel_dkv_flat",
           "flash_kernel_backward_flat", "flash_forward_flat",
           "flash_backward_flat", "OP", "KERNEL", "FWD", "DQ", "DKV",
           "QKV", "FWD_FLAT", "DQ_FLAT", "DKV_FLAT", "AMP_KERNEL",
           "PACKED_DTYPES"]

#: the operator type, the kernels' source names (float32; the packed
#: entries in bfloat16 and float16) and their launch-counter keys
OP = "fused_attention"
KERNEL = "flash_attention"
AMP_KERNEL = "flash_attention_amp"
FWD, DQ, DKV = "flash_fwd_packed", "flash_bwd_dq_packed", "flash_bwd_dkv_packed"
#: the qkv-folded forward (ops/attention_epilogue.py)
QKV = "flash_fwd_qkv"
#: the flat [B, H, T, D] layout
FWD_FLAT, DQ_FLAT, DKV_FLAT = ("flash_fwd_flat", "flash_bwd_dq_flat",
                               "flash_bwd_dkv_flat")
_MASK = "flash_dropout_mask"


# -- plain versions ----------------------------------------------------------

def _scores(qh, kh, bias, causal, sm_scale):
    """[B, nh, Tq, Tk] f32 scores with bias [B, Tk] and the causal mask."""
    s = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) * sm_scale
    if bias is not None:
        s = s + bias.float()[:, None, None, :]
    if causal:
        Tq, Tk = s.shape[-2], s.shape[-1]
        mask = torch.ones(Tq, Tk, dtype=torch.bool,
                          device=s.device).tril(Tk - Tq)
        s = s.masked_fill(~mask, _NEG_INF)
    return s


def _merge(xh):
    B, nh, T, D = xh.shape
    return xh.transpose(1, 2).reshape(B, T, nh * D)


def _dropped(x, keep_mask, dropout_rate):
    if dropout_rate <= 0.0:
        return x
    return torch.where(keep_mask, x / (1.0 - dropout_rate),
                       torch.zeros_like(x))


def _rounded(x, dtype):
    """float32 ``x`` rounded to ``dtype`` and widened back: a rounding
    point of the kernels in a bfloat16/float16 variant (none in float32)."""
    return x if dtype == torch.float32 else x.to(dtype).float()


def _attend(s, v, keep_mask, dropout_rate, dtype):
    """o = drop(softmax(s)) v in float32.  In a bfloat16/float16 variant
    the kernels round the unnormalised probabilities exp(s - max) to the
    element type before the product and divide by the row sum after it
    (the JAX kernels' ``p.astype(v.dtype)``)."""
    if dtype == torch.float32:
        return torch.matmul(_dropped(torch.softmax(s, dim=-1), keep_mask,
                                     dropout_rate), v.float())
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    pt = _rounded(_dropped(e, keep_mask, dropout_rate), dtype)
    return torch.matmul(pt, v.float()) / e.sum(dim=-1, keepdim=True)


def flash_ref_forward(q, k, v, num_heads, bias=None, causal=False,
                      sm_scale=None, dropout_rate=0.0, keep_mask=None):
    """Plain forward: q [B, Tq, H], k/v [B, Tk, H], bias [B, Tk] or None,
    keep_mask bool [B, nh, Tq, Tk] (needed when dropout_rate > 0) ->
    (o [B, Tq, H], lse [B, nh, Tq] f32)."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1] // num_heads)
    s = _scores(_heads(q, num_heads), _heads(k, num_heads), bias, causal,
                sm_scale)
    o = _attend(s, _heads(v, num_heads), keep_mask, dropout_rate, q.dtype)
    return _merge(o).to(q.dtype), torch.logsumexp(s, dim=-1)


def flash_ref_backward(q, k, v, bias, o, lse, do, num_heads, causal=False,
                       sm_scale=None, dropout_rate=0.0, keep_mask=None):
    """Plain backward, the kernels' arithmetic: p = exp(s - lse),
    ds = p * (drop(dp) - rowsum(do * o)) -> (dq, dk, dv [B, T, H],
    dbias [B, Tk] summed over heads and queries).  In a bfloat16/float16
    variant ds is rounded to the element type before ds k and ds^T q, and
    drop(p) before drop(p)^T do; dbias sums the float32 ds."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1] // num_heads)
    dt = q.dtype
    qh, kh, vh = (_heads(x, num_heads).float() for x in (q, k, v))
    oh, doh = _heads(o, num_heads).float(), _heads(do, num_heads).float()
    p = torch.exp(_scores(qh, kh, bias, causal, sm_scale) - lse[..., None])
    dp = _dropped(torch.matmul(doh, vh.transpose(-1, -2)), keep_mask,
                  dropout_rate)
    delta = (doh * oh).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta)
    dst = _rounded(ds, dt)
    dq = torch.matmul(dst, kh) * sm_scale
    dk = torch.matmul(dst.transpose(-1, -2), qh) * sm_scale
    dv = torch.matmul(_rounded(_dropped(p, keep_mask, dropout_rate), dt)
                      .transpose(-1, -2), doh)
    return (_merge(dq).to(q.dtype), _merge(dk).to(k.dtype),
            _merge(dv).to(v.dtype), ds.sum(dim=(1, 2)))


# -- the kernels -------------------------------------------------------------

_P, _LL, _I, _F, _U = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_float, ctypes.c_uint)
_QKV = [_P, _LL, _LL] * 3 + [_P]            # q, k, v (ptr, sb, st), bias
_DIMS = [_I, _I, _I, _I, _I, _F, _I, _F, _U, _U, _P]
_ARGTYPES = {
    "flash_fwd_packed_f32": _QKV + [_P, _LL, _LL, _P] + _DIMS,
    "flash_bwd_dq_packed_f32": _QKV + [_P, _LL, _LL, _P, _P, _P, _LL, _LL]
    + _DIMS,
    "flash_bwd_dkv_packed_f32": _QKV + [_P, _LL, _LL, _P, _P]
    + [_P, _LL, _LL] * 2 + [_P] + _DIMS,
    "flash_dropout_mask_u8": [_P, _I, _I, _I, _I, _F, _U, _U, _P],
    "flash_fwd_qkv_f32": [_P, _LL, _LL, _P, _P, _P, _LL, _LL, _P] + _DIMS,
}
# the packed entries and the qkv entry in bfloat16 and float16 (AMP)
for _base in ("flash_fwd_packed", "flash_bwd_dq_packed",
              "flash_bwd_dkv_packed", "flash_fwd_qkv"):
    for _sfx in ("bf16", "f16"):
        _ARGTYPES[f"{_base}_{_sfx}"] = _ARGTYPES[f"{_base}_f32"]
_FLAT = [_P, _LL, _LL, _LL] * 3 + [_P, _LL, _LL]    # q, k, v, bias (strided)
_ARGTYPES.update({
    "flash_fwd_flat_f32": _FLAT + [_P, _LL, _LL, _LL, _P] + _DIMS,
    "flash_bwd_dq_flat_f32": _FLAT + [_P, _LL, _LL, _LL, _P, _P, _P, _LL,
                                      _LL, _LL] + _DIMS,
    "flash_bwd_dkv_flat_f32": _FLAT + [_P, _LL, _LL, _LL, _P, _P, _P, _P,
                                       _P] + _DIMS,
})


def _library(dtype):
    """The library of the entries of ``dtype``."""
    return _cuda.library(KERNEL if dtype == torch.float32 else AMP_KERNEL)


def _fn(lib, name):
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = _I
    return fn


def _seed_words(seed):
    seed = int(seed) & ((1 << 64) - 1)
    return seed & 0xFFFFFFFF, seed >> 32


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


#: the element types of the packed entries (the flat ones: float32)
PACKED_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def _check(q, k, v, num_heads, bias):
    """Shapes, dtypes and layouts the kernels take; raises otherwise.
    q, k and v share one element type of PACKED_DTYPES; the key-padding
    bias is float32."""
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("flash kernels take packed [B, T, H] q, k, v")
    B, Tq, H = q.shape
    Tk = k.shape[1]
    if H % num_heads:
        raise ValueError(f"hidden {H} does not split into {num_heads} heads")
    D = H // num_heads
    if D > 128:
        raise ValueError(f"d_head {D} > 128: the flash kernels hold at most "
                         f"128 dims per head")
    if tuple(k.shape) != (B, Tk, H) or tuple(v.shape) != (B, Tk, H):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype not in PACKED_DTYPES or t.dtype != q.dtype:
            raise TypeError(f"{name} must be float32, bfloat16 or float16 "
                            f"like q ({q.dtype}), got {t.dtype}")
        if t.stride(2) != 1:
            raise ValueError(f"{name}: the head dimension must be "
                             f"contiguous (stride(2) == 1)")
    if bias is not None:
        if (tuple(bias.shape) != (B, Tk) or bias.dtype != torch.float32
                or not bias.is_contiguous() or bias.device != q.device):
            raise ValueError(
                f"the flash kernels take a contiguous float32 key-padding "
                f"bias [B, Tk] = [{B}, {Tk}] on {q.device}; got "
                f"{tuple(bias.shape)} {bias.dtype} on {bias.device}")
    return B, Tq, Tk, H, D


def _strided(t):
    return (t.data_ptr(), t.stride(0), t.stride(1))


def _dims(B, nh, Tq, Tk, D, sm_scale, causal, dropout_rate, seed, device):
    s0, s1 = _seed_words(seed)
    return (B, nh, Tq, Tk, D, float(sm_scale), int(bool(causal)),
            float(dropout_rate), s0, s1, _stream(device))


def flash_kernel_forward(q, k, v, num_heads, bias=None, causal=False,
                         sm_scale=None, dropout_rate=0.0, seed=0):
    """Launch ``flash_fwd_packed`` (CUDA tensors only): -> (o [B, Tq, H],
    lse [B, nh, Tq])."""
    B, Tq, Tk, H, D = _check(q, k, v, num_heads, bias)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    o = torch.empty((B, Tq, H), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, num_heads, Tq), dtype=torch.float32,
                      device=q.device)
    lib = _library(q.dtype)
    with torch.cuda.device(q.device):
        rc = _fn(lib, f"{FWD}_{_cuda.type_suffix(q.dtype)}")(
            *_strided(q), *_strided(k), *_strided(v),
            None if bias is None else bias.data_ptr(), *_strided(o),
            lse.data_ptr(), *_dims(B, num_heads, Tq, Tk, D, sm_scale, causal,
                                   dropout_rate, seed, q.device))
    _cuda.check(lib, rc, "flash_fwd_packed launch")
    _cuda.LAUNCHES[_cuda.launch_key(FWD, q.dtype)] += 1
    return o, lse


def flash_kernel_forward_qkv(qkv, b_qkv, num_heads, bias=None, causal=False,
                             sm_scale=None, dropout_rate=0.0, seed=0):
    """Launch ``flash_fwd_qkv`` (CUDA tensors only): the forward reading
    q, k and v at column offsets 0, H and 2H of the PRE-bias packed
    projection qkv [B, T, 3H] (head dim contiguous), adding the matching
    slice of b_qkv [3H] as it loads them -> (o [B, T, H], lse
    [B, nh, T]), the layout and dropout stream of ``flash_fwd_packed``,
    so the dq and dk/dv kernels differentiate it."""
    if qkv.dim() != 3 or qkv.shape[2] % 3:
        raise ValueError(f"qkv {tuple(qkv.shape)} is not a packed [B, T, 3H] "
                         f"projection")
    H = qkv.shape[2] // 3
    q, k, v = qkv[..., :H], qkv[..., H:2 * H], qkv[..., 2 * H:]
    B, T, _, _, D = _check(q, k, v, num_heads, bias)
    if tuple(b_qkv.shape) != (3 * H,) or b_qkv.dtype != torch.float32 \
            or not b_qkv.is_contiguous() or b_qkv.device != qkv.device:
        raise ValueError(f"b_qkv must be a contiguous float32 [{3 * H}] on "
                         f"{qkv.device}; got {tuple(b_qkv.shape)} "
                         f"{b_qkv.dtype} on {b_qkv.device}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    o = torch.empty((B, T, H), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((B, num_heads, T), dtype=torch.float32,
                      device=qkv.device)
    lib = _library(qkv.dtype)
    with torch.cuda.device(qkv.device):
        rc = _fn(lib, f"{QKV}_{_cuda.type_suffix(qkv.dtype)}")(
            *_strided(qkv), b_qkv.data_ptr(),
            None if bias is None else bias.data_ptr(), *_strided(o),
            lse.data_ptr(), *_dims(B, num_heads, T, T, D, sm_scale, causal,
                                   dropout_rate, seed, qkv.device))
    _cuda.check(lib, rc, "flash_fwd_qkv launch")
    _cuda.LAUNCHES[_cuda.launch_key(QKV, qkv.dtype)] += 1
    return o, lse


def flash_delta(o, do, num_heads):
    """delta = rowsum(do * o) per head: [B, nh, Tq] f32 (a small torch
    op between the forward and the backward kernels)."""
    B, Tq, H = o.shape
    return (do.float() * o.float()).reshape(B, Tq, num_heads, -1).sum(
        -1).transpose(1, 2).contiguous()


def _check_bwd(q, k, v, bias, do, lse, delta, num_heads):
    B, Tq, Tk, H, D = _check(q, k, v, num_heads, bias)
    if tuple(do.shape) != (B, Tq, H) or do.dtype != q.dtype \
            or do.stride(2) != 1 or do.device != q.device:
        raise ValueError(f"do {tuple(do.shape)} {do.dtype} must be "
                         f"{q.dtype} [{B}, {Tq}, {H}] on {q.device} with a "
                         f"contiguous head dim")
    for name, t in (("lse", lse), ("delta", delta)):
        if tuple(t.shape) != (B, num_heads, Tq) or t.dtype != torch.float32 \
                or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"{name} must be contiguous float32 "
                             f"[{B}, {num_heads}, {Tq}] on {q.device}")
    return B, Tq, Tk, H, D


def _out(out, B, T, H, device, name, dtype=torch.float32):
    """The caller's [B, T, H] output of ``dtype`` (any row and batch
    strides, the head dimension contiguous), checked, or a new one."""
    if out is None:
        return torch.empty((B, T, H), dtype=dtype, device=device)
    if tuple(out.shape) != (B, T, H) or out.dtype != dtype \
            or out.stride(2) != 1 or out.device != device:
        raise ValueError(f"{name} must be {dtype} [{B}, {T}, {H}] on "
                         f"{device} with a contiguous head dim; got "
                         f"{tuple(out.shape)} {out.dtype} on {out.device}")
    return out


def flash_kernel_dq(q, k, v, bias, do, lse, delta, num_heads, causal=False,
                    sm_scale=None, dropout_rate=0.0, seed=0, out=None):
    """Launch ``flash_bwd_dq_packed`` (CUDA tensors only) -> dq
    [B, Tq, H], written into ``out`` when given (a strided view, such as
    a column slice of one [B, T, 3H] dqkv)."""
    B, Tq, Tk, H, D = _check_bwd(q, k, v, bias, do, lse, delta, num_heads)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    dq = _out(out, B, Tq, H, q.device, "out", q.dtype)
    lib = _library(q.dtype)
    with torch.cuda.device(q.device):
        rc = _fn(lib, f"{DQ}_{_cuda.type_suffix(q.dtype)}")(
            *_strided(q), *_strided(k), *_strided(v),
            None if bias is None else bias.data_ptr(), *_strided(do),
            lse.data_ptr(), delta.data_ptr(), *_strided(dq),
            *_dims(B, num_heads, Tq, Tk, D, sm_scale, causal, dropout_rate,
                   seed, q.device))
    _cuda.check(lib, rc, "flash_bwd_dq_packed launch")
    _cuda.LAUNCHES[_cuda.launch_key(DQ, q.dtype)] += 1
    return dq


def flash_kernel_dkv(q, k, v, bias, do, lse, delta, num_heads, causal=False,
                     sm_scale=None, dropout_rate=0.0, seed=0, out=None):
    """Launch ``flash_bwd_dkv_packed`` (CUDA tensors only) -> (dk, dv
    [B, Tk, H], dbias per head [B, nh, Tk]); dk and dv are written into
    ``out = (dk, dv)`` when given (strided views, such as column slices of
    one [B, T, 3H] dqkv)."""
    B, Tq, Tk, H, D = _check_bwd(q, k, v, bias, do, lse, delta, num_heads)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    dk, dv = (_out(o, B, Tk, H, q.device, name, q.dtype)
              for o, name in zip(out or (None, None), ("out[0]", "out[1]")))
    dbias_h = torch.empty((B, num_heads, Tk), dtype=torch.float32,
                          device=q.device)
    lib = _library(q.dtype)
    with torch.cuda.device(q.device):
        rc = _fn(lib, f"{DKV}_{_cuda.type_suffix(q.dtype)}")(
            *_strided(q), *_strided(k), *_strided(v),
            None if bias is None else bias.data_ptr(), *_strided(do),
            lse.data_ptr(), delta.data_ptr(), *_strided(dk), *_strided(dv),
            dbias_h.data_ptr(),
            *_dims(B, num_heads, Tq, Tk, D, sm_scale, causal, dropout_rate,
                   seed, q.device))
    _cuda.check(lib, rc, "flash_bwd_dkv_packed launch")
    _cuda.LAUNCHES[_cuda.launch_key(DKV, q.dtype)] += 1
    return dk, dv, dbias_h


def flash_kernel_backward(q, k, v, bias, o, lse, do, num_heads,
                          causal=False, sm_scale=None, dropout_rate=0.0,
                          seed=0):
    """delta, then the dq and dk/dv kernels (CUDA tensors only) ->
    (dq, dk, dv [B, T, H], dbias [B, Tk] summed over heads)."""
    delta = flash_delta(o, do, num_heads)
    kw = dict(causal=causal, sm_scale=sm_scale, dropout_rate=dropout_rate,
              seed=seed)
    dq = flash_kernel_dq(q, k, v, bias, do, lse, delta, num_heads, **kw)
    dk, dv, dbias_h = flash_kernel_dkv(q, k, v, bias, do, lse, delta,
                                       num_heads, **kw)
    return dq, dk, dv, dbias_h.sum(dim=1)


def flash_kernel_dropout_mask(B, num_heads, Tq, Tk, dropout_rate, seed,
                              device):
    """The keep mask bool [B, nh, Tq, Tk] the kernels draw for
    (dropout_rate, seed) — a debug entry, so a plain version can be
    handed the kernels' mask."""
    mask = torch.empty((B, num_heads, Tq, Tk), dtype=torch.uint8,
                       device=device)
    lib = _cuda.library(KERNEL)
    s0, s1 = _seed_words(seed)
    with torch.cuda.device(device):
        rc = _fn(lib, "flash_dropout_mask_u8")(
            mask.data_ptr(), B, num_heads, Tq, Tk, float(dropout_rate), s0,
            s1, _stream(device))
    _cuda.check(lib, rc, "flash_dropout_mask launch")
    _cuda.LAUNCHES[_MASK] += 1
    return mask.bool()


# -- autograd ----------------------------------------------------------------

def _cpu_keep_mask(seed, dropout_rate, shape):
    gen = torch.Generator().manual_seed(int(seed))
    return torch.rand(shape, generator=gen) >= dropout_rate


class _FlashAttention(torch.autograd.Function):
    """The kernels on CUDA tensors, the plain versions on CPU tensors;
    saves (q, k, v, bias, o, lse) and recomputes p in backward."""

    @staticmethod
    def forward(ctx, q, k, v, bias, num_heads, causal, sm_scale,
                dropout_rate, seed):
        mask = None
        if q.device.type == "cuda":
            o, lse = flash_kernel_forward(q, k, v, num_heads, bias, causal,
                                          sm_scale, dropout_rate, seed)
        else:
            if dropout_rate > 0.0:
                mask = _cpu_keep_mask(seed, dropout_rate,
                                      (q.shape[0], num_heads, q.shape[1],
                                       k.shape[1]))
            o, lse = flash_ref_forward(q, k, v, num_heads, bias, causal,
                                       sm_scale, dropout_rate, mask)
        ctx.save_for_backward(q, k, v, bias, o, lse, mask)
        ctx.cfg = (num_heads, causal, sm_scale, dropout_rate, seed)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, o, lse, mask = ctx.saved_tensors
        num_heads, causal, sm_scale, dropout_rate, seed = ctx.cfg
        if do.stride(-1) != 1:
            do = do.contiguous()
        if q.device.type == "cuda":
            dq, dk, dv, dbias = flash_kernel_backward(
                q, k, v, bias, o, lse, do, num_heads, causal, sm_scale,
                dropout_rate, seed)
        else:
            dq, dk, dv, dbias = flash_ref_backward(
                q, k, v, bias, o, lse, do, num_heads, causal, sm_scale,
                dropout_rate, mask)
        if bias is None or not ctx.needs_input_grad[3]:
            dbias = None
        return dq, dk, dv, dbias, None, None, None, None, None


def _key_padding(bias, B, Tk):
    """A [B, 1, 1, Tk]-shaped bias (the 0/-1e4 padding-mask form) as the
    kernels' [B, Tk] float32, or None for any other shape."""
    if bias.dim() == 4 and bias.shape[1] == 1 and bias.shape[2] == 1 \
            and bias.shape[3] == Tk and bias.shape[0] in (1, B):
        return bias.float().expand(B, 1, 1, Tk).reshape(B, Tk).contiguous()
    return None


def flash_attention_packed(q, k, v, num_heads, bias=None, causal=False,
                           sm_scale=None, dropout_rate=0.0, seed=0):
    """Flash attention in the packed layout: q [B, Tq, H], k/v [B, Tk, H]
    (strided views allowed), bias broadcastable to [B, 1, 1, Tk] or None
    -> [B, Tq, H], differentiable.  On CUDA tensors it launches the three
    kernels or raises; on CPU tensors it runs the plain versions (a bias
    of another shape then takes the plain composite)."""
    B, Tq, H = q.shape
    Tk = k.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(H // num_heads)
    kp = None if bias is None else _key_padding(bias, B, Tk)
    if bias is not None and kp is None:
        if q.device.type == "cuda":
            raise NotImplementedError(
                f"the flash kernels take a key-padding bias broadcastable "
                f"to [B, 1, 1, Tk]; got {tuple(bias.shape)}")
        gen = torch.Generator().manual_seed(int(seed))
        return attention_packed(q, k, v, num_heads, causal=causal,
                                sm_scale=sm_scale, bias=bias,
                                dropout_rate=dropout_rate, generator=gen)
    if torch.compiler.is_exporting():
        from . import _library      # the traced forward (ops/_library.py)
        return _library.flash_forward(q, k, v, num_heads, kp, causal,
                                      sm_scale, dropout_rate, seed)[0]
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no flash attention for device {q.device}")
    return _FlashAttention.apply(q, k, v, kp, int(num_heads), bool(causal),
                                 float(sm_scale), float(dropout_rate),
                                 int(seed))


# -- the flat [B, H, T, D] layout --------------------------------------------

def _flat_bias(bias, B, H, Tk):
    """A [B|1, H|1, 1, Tk] bias (one key row per (batch, head)) as a
    float32 [B, H, 1, Tk] view whose broadcast dims have stride 0, or None
    for any other shape."""
    if bias.dim() != 4 or bias.shape[2] != 1 or bias.shape[3] != Tk \
            or bias.shape[0] not in (1, B) or bias.shape[1] not in (1, H):
        return None
    bias = bias.float()
    if Tk > 1 and bias.stride(3) != 1:
        bias = bias.contiguous()
    return bias.expand(B, H, 1, Tk)


def flash_ref_forward_flat(q, k, v, bias=None, causal=False, sm_scale=None,
                           dropout_rate=0.0, keep_mask=None):
    """Plain forward: q [B, H, Tq, D], k/v [B, H, Tk, D], bias
    broadcastable to [B, H, 1, Tk] or None, keep_mask bool [B, H, Tq, Tk]
    (needed when dropout_rate > 0) -> (o [B, H, Tq, D], lse [B, H, Tq]
    f32)."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    s = _scores_flat(q, k, bias, causal, sm_scale)
    p = _dropped(torch.softmax(s, dim=-1), keep_mask, dropout_rate)
    o = torch.matmul(p, v.float())
    return o.to(q.dtype), torch.logsumexp(s, dim=-1)


def _scores_flat(q, k, bias, causal, sm_scale):
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    if bias is not None:
        s = s + bias.float()
    if causal:
        Tq, Tk = s.shape[-2], s.shape[-1]
        mask = torch.ones(Tq, Tk, dtype=torch.bool,
                          device=s.device).tril(Tk - Tq)
        s = s.masked_fill(~mask, _NEG_INF)
    return s


def flash_ref_backward_flat(q, k, v, bias, o, lse, do, causal=False,
                            sm_scale=None, dropout_rate=0.0, keep_mask=None,
                            dlse=None, delta=None):
    """Plain backward, the kernels' arithmetic: p = exp(s - lse),
    ds = p * (drop(dp) - (rowsum(do * o) - dlse)) -> (dq [B, H, Tq, D],
    dk, dv [B, H, Tk, D], dbias [B, H, Tk] per (batch, head), summed over
    queries).  ``delta``: ``flash_delta_flat(o, do, dlse)`` when the
    caller already holds it (o and dlse are then not read)."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if delta is None:
        delta = flash_delta_flat(o, do, dlse)
    qf, kf, vf = q.float(), k.float(), v.float()
    p = torch.exp(_scores_flat(qf, kf, bias, causal, sm_scale)
                  - lse[..., None])
    dp = _dropped(torch.matmul(do.float(), vf.transpose(-1, -2)), keep_mask,
                  dropout_rate)
    ds = p * (dp - delta[..., None])
    dq = torch.matmul(ds, kf) * sm_scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * sm_scale
    dv = torch.matmul(_dropped(p, keep_mask, dropout_rate).transpose(-1, -2),
                      do.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), ds.sum(dim=2)


def flash_delta_flat(o, do, dlse=None):
    """delta = rowsum(do * o) - dlse: [B, H, Tq] f32, contiguous (the
    lse cotangent folds into delta, as ``_flash_bwd`` folds it)."""
    delta = (do.float() * o.float()).sum(-1)
    if dlse is not None:
        delta = delta - dlse.float().reshape(delta.shape)
    return delta.contiguous()


def _check_flat(q, k, v, bias):
    """Shapes, dtypes and layouts the flat kernels take; raises
    otherwise.  Returns (B, H, Tq, Tk, D)."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("the flat flash kernels take [B, H, T, D] q, k, v")
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    if D > 128:
        raise ValueError(f"d_head {D} > 128: the flash kernels hold at most "
                         f"128 dims per head")
    if tuple(k.shape) != (B, H, Tk, D) or tuple(v.shape) != (B, H, Tk, D):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.stride(3) != 1:
            raise ValueError(f"{name}: the head dimension must be "
                             f"contiguous (stride(3) == 1)")
    if bias is not None:
        if (tuple(bias.shape) != (B, H, 1, Tk) or bias.dtype != torch.float32
                or (Tk > 1 and bias.stride(3) != 1)
                or bias.device != q.device):
            raise ValueError(
                f"the flat flash kernels take a float32 key bias "
                f"[B, H, 1, Tk] = [{B}, {H}, 1, {Tk}] (a broadcast view "
                f"is fine) with contiguous keys on {q.device}; got "
                f"{tuple(bias.shape)} {bias.dtype} on {bias.device}")
    return B, H, Tq, Tk, D


def _strided4(t):
    return (t.data_ptr(), t.stride(0), t.stride(1), t.stride(2))


def _bias_args(bias):
    if bias is None:
        return (None, 0, 0)
    return (bias.data_ptr(), bias.stride(0), bias.stride(1))


def flash_kernel_forward_flat(q, k, v, bias=None, causal=False,
                              sm_scale=None, dropout_rate=0.0, seed=0):
    """Launch ``flash_fwd_flat`` (CUDA tensors only): q [B, H, Tq, D],
    k/v [B, H, Tk, D], bias [B, H, 1, Tk] (a broadcast view) or None ->
    (o [B, H, Tq, D], lse [B, H, Tq])."""
    B, H, Tq, Tk, D = _check_flat(q, k, v, bias)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    o = torch.empty((B, H, Tq, D), dtype=torch.float32, device=q.device)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    lib = _cuda.library(KERNEL)
    with torch.cuda.device(q.device):
        rc = _fn(lib, "flash_fwd_flat_f32")(
            *_strided4(q), *_strided4(k), *_strided4(v), *_bias_args(bias),
            *_strided4(o), lse.data_ptr(),
            *_dims(B, H, Tq, Tk, D, sm_scale, causal, dropout_rate, seed,
                   q.device))
    _cuda.check(lib, rc, "flash_fwd_flat launch")
    _cuda.LAUNCHES[FWD_FLAT] += 1
    return o, lse


def _check_bwd_flat(q, k, v, bias, do, lse, delta):
    B, H, Tq, Tk, D = _check_flat(q, k, v, bias)
    if tuple(do.shape) != (B, H, Tq, D) or do.dtype != torch.float32 \
            or do.stride(3) != 1 or do.device != q.device:
        raise ValueError(f"do {tuple(do.shape)} {do.dtype} must be float32 "
                         f"[{B}, {H}, {Tq}, {D}] on {q.device} with a "
                         f"contiguous head dim")
    for name, t in (("lse", lse), ("delta", delta)):
        if tuple(t.shape) != (B, H, Tq) or t.dtype != torch.float32 \
                or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"{name} must be contiguous float32 "
                             f"[{B}, {H}, {Tq}] on {q.device}")
    return B, H, Tq, Tk, D


def flash_kernel_dq_flat(q, k, v, bias, do, lse, delta, causal=False,
                         sm_scale=None, dropout_rate=0.0, seed=0):
    """Launch ``flash_bwd_dq_flat`` (CUDA tensors only) -> dq
    [B, H, Tq, D].  ``delta`` is ``flash_delta_flat(o, do, dlse)``."""
    B, H, Tq, Tk, D = _check_bwd_flat(q, k, v, bias, do, lse, delta)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    dq = torch.empty((B, H, Tq, D), dtype=torch.float32, device=q.device)
    lib = _cuda.library(KERNEL)
    with torch.cuda.device(q.device):
        rc = _fn(lib, "flash_bwd_dq_flat_f32")(
            *_strided4(q), *_strided4(k), *_strided4(v), *_bias_args(bias),
            *_strided4(do), lse.data_ptr(), delta.data_ptr(), *_strided4(dq),
            *_dims(B, H, Tq, Tk, D, sm_scale, causal, dropout_rate, seed,
                   q.device))
    _cuda.check(lib, rc, "flash_bwd_dq_flat launch")
    _cuda.LAUNCHES[DQ_FLAT] += 1
    return dq


def flash_kernel_dkv_flat(q, k, v, bias, do, lse, delta, causal=False,
                          sm_scale=None, dropout_rate=0.0, seed=0):
    """Launch ``flash_bwd_dkv_flat`` (CUDA tensors only) -> (dk, dv
    [B, H, Tk, D], dbias [B, H, Tk] per (batch, head))."""
    B, H, Tq, Tk, D = _check_bwd_flat(q, k, v, bias, do, lse, delta)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    dk = torch.empty((B, H, Tk, D), dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    dbias = torch.empty((B, H, Tk), dtype=torch.float32, device=q.device)
    lib = _cuda.library(KERNEL)
    with torch.cuda.device(q.device):
        rc = _fn(lib, "flash_bwd_dkv_flat_f32")(
            *_strided4(q), *_strided4(k), *_strided4(v), *_bias_args(bias),
            *_strided4(do), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), dbias.data_ptr(),
            *_dims(B, H, Tq, Tk, D, sm_scale, causal, dropout_rate, seed,
                   q.device))
    _cuda.check(lib, rc, "flash_bwd_dkv_flat launch")
    _cuda.LAUNCHES[DKV_FLAT] += 1
    return dk, dv, dbias


def flash_kernel_backward_flat(q, k, v, bias, o, lse, do, causal=False,
                               sm_scale=None, dropout_rate=0.0, seed=0,
                               dlse=None):
    """delta (with the lse cotangent folded in), then the flat dq and
    dk/dv kernels (CUDA tensors only) -> (dq, dk, dv, dbias [B, H, Tk])."""
    delta = flash_delta_flat(o, do, dlse)
    kw = dict(causal=causal, sm_scale=sm_scale, dropout_rate=dropout_rate,
              seed=seed)
    dq = flash_kernel_dq_flat(q, k, v, bias, do, lse, delta, **kw)
    dk, dv, dbias = flash_kernel_dkv_flat(q, k, v, bias, do, lse, delta, **kw)
    return dq, dk, dv, dbias


def flash_forward_flat(q, k, v, bias=None, causal=False, sm_scale=None,
                       dropout_rate=0.0, seed=0, keep_mask=None):
    """(o, lse [B, H, Tq]) of the flat layout: the kernel on CUDA tensors
    (raising on what it cannot take), its plain version under
    ``keep_mask`` on CPU tensors."""
    if q.device.type == "cuda":
        return flash_kernel_forward_flat(q, k, v, bias, causal, sm_scale,
                                         dropout_rate, seed)
    return flash_ref_forward_flat(q, k, v, bias, causal, sm_scale,
                                  dropout_rate, keep_mask)


def flash_backward_flat(q, k, v, bias, do, lse, delta, causal=False,
                        sm_scale=None, dropout_rate=0.0, seed=0,
                        keep_mask=None):
    """(dq, dk, dv, dbias [B, H, Tk]) from a given ``delta``
    (``flash_delta_flat``): the dq and dk/dv kernels on CUDA tensors, the
    plain backward on CPU tensors."""
    kw = dict(causal=causal, sm_scale=sm_scale, dropout_rate=dropout_rate)
    if q.device.type == "cuda":
        dq = flash_kernel_dq_flat(q, k, v, bias, do, lse, delta, seed=seed,
                                  **kw)
        return (dq, *flash_kernel_dkv_flat(q, k, v, bias, do, lse, delta,
                                           seed=seed, **kw))
    return flash_ref_backward_flat(q, k, v, bias, None, lse, do,
                                   keep_mask=keep_mask, delta=delta, **kw)


class _FlashAttentionLse(torch.autograd.Function):
    """The flat counterpart of ``_make_flash_lse``: outputs (o, lse
    [B, H, Tq]); backward takes (do, dlse) and folds dlse into delta.  The
    kernels on CUDA tensors, the plain versions on CPU tensors; the bias
    is the [B, H, 1, Tk] view of ``_flat_bias`` (autograd sums its
    gradient back to the caller's broadcast shape)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, causal, sm_scale, dropout_rate, seed):
        ctx.set_materialize_grads(False)
        mask = None
        if q.device.type != "cuda" and dropout_rate > 0.0:
            mask = _cpu_keep_mask(seed, dropout_rate,
                                  tuple(q.shape[:3]) + (k.shape[2],))
        o, lse = flash_forward_flat(q, k, v, bias, causal, sm_scale,
                                    dropout_rate, seed, mask)
        ctx.save_for_backward(q, k, v, bias, o, lse, mask)
        ctx.cfg = (causal, sm_scale, dropout_rate, seed)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, bias, o, lse, mask = ctx.saved_tensors
        causal, sm_scale, dropout_rate, seed = ctx.cfg
        if do is None:
            do = torch.zeros_like(o)
        elif do.stride(-1) != 1:
            do = do.contiguous()
        dq, dk, dv, dbias = flash_backward_flat(
            q, k, v, bias, do, lse, flash_delta_flat(o, do, dlse), causal,
            sm_scale, dropout_rate, seed, mask)
        if bias is None or not ctx.needs_input_grad[3]:
            dbias = None
        else:
            dbias = dbias[:, :, None, :]
        return dq, dk, dv, dbias, None, None, None, None


def _flash_call(q, k, v, bias, causal, sm_scale, dropout_rate, seed):
    """Default sm_scale and seed, the bias as its [B, H, 1, Tk] view, then
    the autograd function -> (o [B, H, Tq, D], lse [B, H, Tq]).  A bias of
    another shape raises."""
    B, H, _, D = q.shape
    Tk = k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    bias_v = None
    if bias is not None:
        bias_v = _flat_bias(bias, B, H, Tk)
        if bias_v is None:
            raise NotImplementedError(
                f"the flat flash kernels take a key bias broadcastable to "
                f"[B, H, 1, Tk] = [{B}, {H}, 1, {Tk}]; got "
                f"{tuple(bias.shape)}")
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no flash attention for device {q.device}")
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    return _FlashAttentionLse.apply(q, k, v, bias_v, bool(causal),
                                    float(sm_scale), float(dropout_rate),
                                    int(seed or 0))


def flash_attention_lse(q, k, v, bias=None, causal=False, sm_scale=None):
    """Flash attention returning (out [B, H, Tq, D], lse [B, H, Tq, 1]
    f32), differentiable in both: the lse makes per-chunk results
    mergeable (ring attention) and the backward takes its cotangent.  No
    dropout on this path, as in the JAX package.  bias: broadcastable to
    [B, H, 1, Tk] or None.  There is no ``interpret`` switch: CUDA
    tensors launch the kernels, CPU tensors run the plain versions."""
    o, lse = _flash_call(q, k, v, bias, causal, sm_scale, 0.0, None)
    return o, lse[..., None]


def flash_attention(q, k, v, bias=None, causal=False, sm_scale=None,
                    dropout_rate=0.0, seed=None):
    """Tiled flash attention: q [B, H, Tq, D], k/v [B, H, Tk, D], bias
    broadcastable to [B, H, 1, Tk] (e.g. the 0 / -1e4 input mask as
    [B, 1, 1, Tk]) or None -> [B, H, Tq, D], differentiable.  On CUDA
    tensors it launches the three flat kernels or raises; on CPU tensors
    it runs their plain versions (a bias of another shape then takes the
    plain composite)."""
    if bias is not None and q.device.type != "cuda" \
            and _flat_bias(bias, q.shape[0], q.shape[1], k.shape[2]) is None:
        gen = torch.Generator().manual_seed(int(seed or 0))
        return attention(q, k, v, bias=bias, causal=causal,
                         sm_scale=sm_scale, dropout_rate=dropout_rate,
                         generator=gen)
    o, _ = _flash_call(q, k, v, bias, causal, sm_scale, dropout_rate, seed)
    return o
