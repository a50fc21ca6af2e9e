"""The attention entry with the qkv bias and the softmax scale folded into
the flash-attention forward.

Counterpart of paddle_tpu/ops/attention_epilogue.py (its Pallas TPU
kernel ``_qkv_fwd_kernel`` and the custom VJP around it).  The encoder's
attention front half lowers as

    mul(x, w_qkv) -> elementwise_add(b_qkv) -> slice x3 -> fused_attention

The qkv GEMM stays ``torch.matmul`` (the JAX package leaves it to XLA);
everything after it is one kernel: ``flash_fwd_qkv`` (csrc/
flash_attention.cuh, beside ``flash_fwd_packed``) reads q, k and v at
column offsets 0, H and 2H of the PRE-bias [B, T, 3H] projection, adds
the matching slice of b_qkv as it loads them, and applies the scale on
the scores, so neither the biased qkv nor its three slices are written.
Its dropout is ``flash_fwd_packed``'s Philox stream under the op's seed,
and its lse the same layout, so the packed backward kernels
(``flash_bwd_dq_packed``, ``flash_bwd_dkv_packed``) differentiate it.

Backward (the JAX VJP's): re-bias the saved pre-bias qkv, run the dq and
dk/dv kernels on its three strided views, writing dq, dk and dv straight
into the three column slices of one [B, T, 3H] dqkv, and close the bias
and GEMM adjoints with torch ops.  CPU tensors take the plain versions
(``qkv_ref_forward`` and ops/flash_attention.py's ``flash_ref_backward``)
with a keep mask from a ``torch.Generator``.

Under AMP x and w come in bfloat16 or float16 (b_qkv and the key bias
float32), and the entry rounds where the JAX one does: the projection
sums in float32 and is stored in the element type, the bias is added in
float32 and q, k, v rounded back (in the kernel as they land), and the
GEMM adjoints sum in float32 and are rounded to the element type
(``matmul_f32``); the qkv bias's gradient stays float32.
"""
from __future__ import annotations

import math

import torch

from .flash_attention import (PACKED_DTYPES, _key_padding, _cpu_keep_mask,
                              flash_delta,
                              flash_kernel_dkv, flash_kernel_dq,
                              flash_kernel_forward_qkv, flash_ref_backward,
                              flash_ref_forward)
from .fused_matmul import matmul_f32

__all__ = ["attn_epilogue_shapes_ok", "key_padding_ok", "qkv_ref_forward",
           "plain_qkv_attention", "fused_qkv_attention"]


def attn_epilogue_shapes_ok(T, H, num_heads, dtype=torch.float32):
    """The port's rule: float32, bfloat16 or float16, heads that split H,
    at most 128 dims a head (the packed flash kernels read each head by
    offset through strided views, so the TPU's H % 128 lane rule does
    not apply)."""
    if dtype not in PACKED_DTYPES or T < 1 or num_heads <= 0 \
            or H % num_heads:
        return False
    return 0 < H // num_heads <= 128


def key_padding_ok(bias, B, T):
    """An attention bias the kernels take: [B or 1, 1, 1, T]."""
    return (bias.dim() == 4 and bias.shape[1] == 1 and bias.shape[2] == 1
            and bias.shape[3] == T and bias.shape[0] in (1, B))


def _split(qkv, b_qkv):
    """The biased q, k, v views of the pre-bias qkv: the bias added in
    float32 and rounded to qkv's element type, as the kernel adds it as
    each tile lands."""
    H = qkv.shape[-1] // 3
    qb = (qkv.float() + b_qkv.float()).to(qkv.dtype)
    return qb[..., :H], qb[..., H:2 * H], qb[..., 2 * H:]



def qkv_ref_forward(qkv, b_qkv, num_heads, bias=None, causal=False,
                    sm_scale=None, dropout_rate=0.0, keep_mask=None):
    """Plain version of ``flash_fwd_qkv``: qkv [B, T, 3H] pre-bias, b_qkv
    [3H], bias [B, T] or None, keep mask [B, nh, T, T] when dropout is
    live -> (o [B, T, H], lse [B, nh, T])."""
    q, k, v = _split(qkv, b_qkv)
    return flash_ref_forward(q, k, v, num_heads, bias, causal, sm_scale,
                             dropout_rate, keep_mask)


def plain_qkv_attention(x, w, b_qkv, num_heads, attn_bias=None,
                        causal=False, sm_scale=None, dropout_rate=0.0,
                        keep_mask=None):
    """The unfused composition (the JAX package's xla_qkv_attention): qkv
    GEMM + bias, split, packed attention.  Differentiable by autograd."""
    B, T, _ = x.shape
    kp = None if attn_bias is None else _key_padding(attn_bias, B, T)
    return qkv_ref_forward(matmul_f32(x, w), b_qkv, num_heads, kp, causal,
                           sm_scale, dropout_rate, keep_mask)[0]


class _QKVAttention(torch.autograd.Function):
    """Saves (x, w, b_qkv, bias, pre-bias qkv, o, lse); backward
    recomputes p in the flash backward kernels."""

    @staticmethod
    def forward(ctx, x, w, b_qkv, bias, num_heads, causal, sm_scale,
                dropout_rate, seed):
        qkv = matmul_f32(x, w)                         # [B, T, 3H]
        mask = None
        if x.device.type == "cuda":
            o, lse = flash_kernel_forward_qkv(
                qkv, b_qkv.contiguous(), num_heads, bias, causal, sm_scale,
                dropout_rate, seed)
        else:
            if dropout_rate > 0.0:
                B, T, _ = x.shape
                mask = _cpu_keep_mask(seed, dropout_rate,
                                      (B, num_heads, T, T))
            o, lse = qkv_ref_forward(qkv, b_qkv, num_heads, bias, causal,
                                     sm_scale, dropout_rate, mask)
        ctx.save_for_backward(x, w, b_qkv, bias, qkv, o, lse, mask)
        ctx.cfg = (num_heads, causal, sm_scale, dropout_rate, seed)
        return o

    @staticmethod
    def backward(ctx, do):
        x, w, b_qkv, bias, qkv, o, lse, mask = ctx.saved_tensors
        num_heads, causal, sm_scale, dropout_rate, seed = ctx.cfg
        if do.stride(-1) != 1:
            do = do.contiguous()
        q, k, v = _split(qkv, b_qkv)      # rebias: strided [B, T, H] views
        if x.device.type == "cuda":
            # the kernels write dq, dk and dv into dqkv's column slices
            H = q.shape[-1]
            dqkv = torch.empty_like(qkv)              # [B, T, 3H]
            delta = flash_delta(o, do, num_heads)
            kw = dict(causal=causal, sm_scale=sm_scale,
                      dropout_rate=dropout_rate, seed=seed)
            flash_kernel_dq(q, k, v, bias, do, lse, delta, num_heads,
                            out=dqkv[..., :H], **kw)
            dbias = flash_kernel_dkv(
                q, k, v, bias, do, lse, delta, num_heads,
                out=(dqkv[..., H:2 * H], dqkv[..., 2 * H:]), **kw)[2].sum(1)
        else:
            dq, dk, dv, dbias = flash_ref_backward(
                q, k, v, bias, o, lse, do, num_heads, causal, sm_scale,
                dropout_rate, mask)
            dqkv = torch.cat([dq, dk, dv], dim=-1)    # [B, T, 3H]
        B, T, K = x.shape
        d2 = dqkv.reshape(B * T, -1)
        needs = ctx.needs_input_grad
        dx = matmul_f32(dqkv, w.t()) if needs[0] else None
        dw = matmul_f32(x.reshape(B * T, K).t(), d2) if needs[1] else None
        db = d2.float().sum(dim=0).to(b_qkv.dtype) if needs[2] else None
        if bias is None or not needs[3]:
            dbias = None
        return dx, dw, db, dbias, None, None, None, None, None


def fused_qkv_attention(x, w, b_qkv, num_heads, attn_bias=None,
                        causal=False, sm_scale=None, dropout_rate=0.0,
                        seed=0):
    """Differentiable qkv projection + flash attention with the bias add
    and the softmax scale folded into the forward kernel.  x [B, T, K],
    w [K, 3H], b_qkv [3H]; attn_bias broadcastable to [B, 1, 1, T] or
    None; ``seed`` keys the dropout mask -> [B, T, H].  The kernels on
    CUDA tensors (or a raise), the plain versions on CPU tensors."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no qkv attention for device {x.device}")
    B, T, _ = x.shape
    H = w.shape[1] // 3
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(H // num_heads)
    kp = None
    if attn_bias is not None:
        if not key_padding_ok(attn_bias, B, T):
            raise ValueError(f"the qkv-folded flash entry takes a "
                             f"key-padding bias [B, 1, 1, T]; got "
                             f"{tuple(attn_bias.shape)}")
        kp = _key_padding(attn_bias, B, T)
    if torch.compiler.is_exporting():
        from . import _library      # the traced forward (ops/_library.py)
        return _library.flash_forward_qkv(torch.matmul(x, w), b_qkv,
                                          num_heads, kp, causal, sm_scale,
                                          dropout_rate, seed)[0]
    return _QKVAttention.apply(x, w, b_qkv, kp, int(num_heads), bool(causal),
                               float(sm_scale), float(dropout_rate),
                               int(seed))
