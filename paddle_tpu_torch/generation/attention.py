"""Paged decode attention: one query token per sequence attends over
that sequence's page list — the attention of the legacy scheduler's
decode step.

Counterpart of paddle_tpu/generation/attention.py.  Two implementations
behind one entry point, ``paged_decode_attention``, chosen by where the
tensors live and nothing else:

* ``csrc/paged_decode.cu`` — the hand-written CUDA kernel for Hopper
  (sm_90a): the split-key design of ``csrc/paged_split.cuh`` (each
  slot's keys cut into spans of whole pages by ``split_spans``, the
  spans of a (slot, head) one thread-block cluster that merges them),
  shared with the ragged kernel, with float32, bfloat16 and float16
  pages (q and the output float32).  ``paged_kernel_decode_attention``
  launches it for CUDA tensors, adds one to
  ``_cuda.LAUNCHES["paged_decode_attention"]`` per launch (16-bit pages:
  ``"paged_decode_attention_bf16"`` / ``"_f16"``), and raises on
  anything it cannot take; there is no fallback.
* ``paged_ref_decode_attention`` — plain PyTorch, the JAX reference:
  gather a page list into the contiguous layout, then
  ``gathered_decode_attention``, the one masked-softmax function every
  plain attention of the generation path reduces to (f32 scores and
  softmax whatever the input dtype).  ``paged_plain_decode_attention``
  zeroes its empty slots as the kernel does; CPU tensors take it, and
  ``chip_smoke.py`` holds the float32 kernel against it on the card.

Two rounding contracts hold for a 16-bit cache (T = the pages' dtype),
as in the JAX package.  The reference (``gathered_decode_attention``)
rounds p to T, sums P.V in float32, rounds the context to T and widens
it to q's float32: what the JAX engine computes on the CPU, so the
port's CPU engine keeps its tokens.  The TPU kernel rounds p to T for
P.V only, divides by the sum of the unrounded p and does not round the
context; the CUDA kernel keeps that contract, and
``paged_flash_plain_decode_attention`` is its plain version, which
``chip_smoke.py`` holds the 16-bit kernels against.  The two differ by
at most about one T-ulp of the context.

Shapes (packed head layout, H = num_heads * d_head):
  q [S, H]; k_pages/v_pages [num_pages, page_size, H];
  page_table [S, pages_per_seq] int; eff_lens [S] int (keys
  0..len-1 are visible).
"""
from __future__ import annotations

import ctypes
import math

import torch

from .. import _cuda
from ..ops.attention import _NEG_INF

__all__ = ["paged_decode_shapes_ok", "split_spans",
           "gathered_decode_attention", "gathered_flash_attention",
           "paged_ref_decode_attention", "paged_plain_decode_attention",
           "paged_flash_plain_decode_attention",
           "paged_kernel_decode_attention", "paged_decode_attention",
           "check_pages", "contract_bound", "KERNEL", "PAGE_DTYPES",
           "PAGE_UNIT_ROUNDOFF", "F32_ATOL"]

#: source name of the kernel (csrc/paged_decode.cu)
KERNEL = "paged_decode"
_COUNTER = "paged_decode_attention"
#: the split-key kernels' spans: at most MAX_SPLIT a (row, head) (one
#: thread-block cluster; 8 CTAs is the portable most), at least
#: MIN_SPAN_KEYS keys each where the table holds them (a span costs a
#: cluster's launch and merge; a CTA streams 16-64 keys a stage)
MAX_SPLIT, MIN_SPAN_KEYS = 8, 128
#: the pages' dtypes the kernels take (q and the output are float32)
PAGE_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
#: unit roundoff (half an ulp at 1) of the 16-bit page types
PAGE_UNIT_ROUNDOFF = {torch.bfloat16: 2.0 ** -8, torch.float16: 2.0 ** -11}
#: float32 rounding of the kernels against a plain version: both sum up
#: to a few thousand keys in float32, in different orders, over
#: unit-scale inputs
F32_ATOL = 1e-5


def contract_bound(plain, q, k_pages, v_pages, *args, **kwargs):
    """The per-element bound of |kernel - plain| where ``plain`` is the
    plain version on the kernel's own rounding contract
    (``paged_flash_plain_decode_attention``,
    ``ragged_flash_plain_attention``; same arguments): F32_ATOL, plus,
    for 16-bit pages, 2u (u = PAGE_UNIT_ROUNDOFF) times ``plain`` over
    |V|, i.e. sum_j p_j |v_j| / l.  Both round each p_j to T, each
    relative to its own running maximum, so a term may differ by up to
    2u of p_j |v_j| between them."""
    bound = torch.full((q.shape[0], q.shape[1]), F32_ATOL,
                       device=q.device)
    u = PAGE_UNIT_ROUNDOFF.get(k_pages.dtype)
    if u is not None:
        bound = bound + 2 * u * plain(q, k_pages, v_pages.abs(), *args,
                                      **kwargs)
    return bound


def split_spans(pages_per_seq, page_size):
    """(pages per span, spans) of the split-key kernels, from the table's
    width and the page size alone: the grid depends only on the engine's
    fixed shapes, never on the lengths."""
    span = max(-(-pages_per_seq // MAX_SPLIT), -(-MIN_SPAN_KEYS // page_size))
    span = max(1, min(span, pages_per_seq))
    return span, max(1, -(-pages_per_seq // span))


def paged_decode_shapes_ok(page_size, hidden, num_heads):
    """Shapes the decode kernels take: whole heads of at most 128 that
    divide 128 (the TPU's lane tile; on the card, whole float4 lane
    groups), and pages of a multiple of 8 tokens."""
    if hidden % num_heads:
        return False
    d = hidden // num_heads
    return d <= 128 and 128 % d == 0 and page_size % 8 == 0


def gathered_decode_attention(q, k_ctx, v_ctx, eff_lens, num_heads,
                              sm_scale=None):
    """Decode attention over CONTIGUOUS per-slot KV:
    q [S, H], k_ctx/v_ctx [S, L, H], eff_lens [S] -> [S, H]."""
    S, L, H = k_ctx.shape
    D = H // num_heads
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    qh = q.reshape(S, num_heads, D)
    kh = k_ctx.reshape(S, L, num_heads, D)
    vh = v_ctx.reshape(S, L, num_heads, D)
    # a 16-bit K is widened to q's float32 for the scores, as jnp.einsum
    # promotes it; P.V sums float32 products of T values and rounds once
    s = torch.einsum("snd,slnd->snl", qh, kh.to(qh.dtype)).float() * sm_scale
    mask = (torch.arange(L, device=q.device)[None, None, :]
            < eff_lens.to(q.device)[:, None, None])
    s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1)
    ctx = torch.einsum("snl,slnd->snd", p.to(vh.dtype).float(),
                       vh.float()).to(vh.dtype)
    return ctx.reshape(S, H).to(q.dtype)


def gathered_flash_attention(q, k_ctx, v_ctx, eff_lens, num_heads,
                             sm_scale=None):
    """The TPU kernel's contract over CONTIGUOUS per-slot KV (the plain
    version the 16-bit CUDA kernels are held against): float32 scores
    with K widened, p = exp(s - max) summed unrounded into l, P.V over p
    rounded to T with float32 sums, the context ``acc / l`` in float32
    (not rounded to T), zeros where no key is visible.
    q [S, H] float32, k_ctx/v_ctx [S, L, H] T, eff_lens [S] -> [S, H]."""
    S, L, H = k_ctx.shape
    D = H // num_heads
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    qh = q.reshape(S, num_heads, D).float()
    kh = k_ctx.reshape(S, L, num_heads, D).float()
    vh = v_ctx.reshape(S, L, num_heads, D)
    s = torch.einsum("snd,slnd->snl", qh, kh) * sm_scale
    mask = (torch.arange(L, device=q.device)[None, None, :]
            < eff_lens.to(q.device)[:, None, None])
    s = torch.where(mask, s, torch.full_like(s, -math.inf))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)                      # 0 for a masked key
    l = p.sum(dim=-1)
    acc = torch.einsum("snl,slnd->snd", p.to(vh.dtype).float(), vh.float())
    ctx = acc / torch.where(l > 0, l, torch.ones_like(l))[..., None]
    return ctx.reshape(S, H).to(q.dtype)


def paged_ref_decode_attention(q, k_pages, v_pages, page_table, eff_lens,
                               num_heads, sm_scale=None):
    """Gather each slot's pages into the contiguous layout, then the
    shared masked-softmax math."""
    S = q.shape[0]
    H = k_pages.shape[-1]
    idx = page_table.long()
    k_ctx = k_pages[idx].reshape(S, -1, H)
    v_ctx = v_pages[idx].reshape(S, -1, H)
    return gathered_decode_attention(q, k_ctx, v_ctx, eff_lens, num_heads,
                                     sm_scale=sm_scale)


def paged_flash_plain_decode_attention(q, k_pages, v_pages, page_table,
                                       eff_lens, num_heads, sm_scale=None):
    """The kernel's function on the TPU kernel's rounding contract, in
    plain PyTorch (see the module doc): each slot's pages gathered, then
    ``gathered_flash_attention``; empty slots give zeros."""
    S = q.shape[0]
    H = k_pages.shape[-1]
    idx = page_table.long()
    return gathered_flash_attention(
        q, k_pages[idx].reshape(S, -1, H), v_pages[idx].reshape(S, -1, H),
        eff_lens, num_heads, sm_scale=sm_scale)


def paged_plain_decode_attention(q, k_pages, v_pages, page_table, eff_lens,
                                 num_heads, sm_scale=None):
    """The kernel's function in plain PyTorch, wherever the tensors
    live: the reference, with empty slots zeroed (the reference alone
    averages their masked keys)."""
    out = paged_ref_decode_attention(q, k_pages, v_pages, page_table,
                                     eff_lens, num_heads, sm_scale=sm_scale)
    active = (eff_lens.to(out.device) > 0)[:, None]
    return torch.where(active, out, torch.zeros_like(out))


def _bind(lib, dtype):
    fn = getattr(lib, f"paged_decode_attention_{_cuda.type_suffix(dtype)}")
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, ctypes.c_longlong, p, p, p, p, p,
                       i, i, i, i, i, i, i, ctypes.c_float, p]
        fn.restype = i
    return fn


def check_pages(q, k_pages, v_pages, num_heads):
    """The checks the two kernels share: q float32 [rows, H], K/V pages
    [num_pages, page_size, H] of one dtype in PAGE_DTYPES, whole heads
    the kernels take (head_dim 4..128 dividing 128; 16-bit pages from 8,
    a 16-byte vector of 8 values a lane).  Returns head_dim."""
    H = q.shape[1]
    if H % num_heads:
        raise ValueError(f"hidden {H} does not split into {num_heads} heads")
    D = H // num_heads
    if D < 4 or D > 128 or 128 % D:
        raise ValueError(
            f"head_dim {D}: the kernel takes head_dim in "
            f"{{4, 8, 16, 32, 64, 128}}")
    if k_pages.dtype not in PAGE_DTYPES or v_pages.dtype != k_pages.dtype:
        raise TypeError(
            f"k_pages / v_pages must be one of {PAGE_DTYPES}, got "
            f"{k_pages.dtype} / {v_pages.dtype}")
    if k_pages.element_size() == 2 and D < 8:
        raise ValueError(
            f"head_dim {D}: 16-bit pages take head_dim in "
            f"{{8, 16, 32, 64, 128}}")
    return D


def paged_kernel_decode_attention(q, k_pages, v_pages, page_table,
                                  eff_lens, num_heads, sm_scale=None):
    """Launch the CUDA kernel (CUDA tensors only; see module doc)."""
    S, H = q.shape
    NP, PS, Hk = k_pages.shape
    D = check_pages(q, k_pages, v_pages, num_heads)
    if S > 65535:
        raise ValueError(f"{S} sequences exceed the kernel's grid (65535)")
    if Hk != H or v_pages.shape != k_pages.shape:
        raise ValueError(
            f"q [.., {H}] does not match pages {tuple(k_pages.shape)} / "
            f"{tuple(v_pages.shape)}")
    if page_table.dim() != 2 or page_table.shape[0] != S:
        raise ValueError(
            f"page_table {tuple(page_table.shape)} must have {S} rows")
    if tuple(eff_lens.shape) != (S,):
        raise ValueError(f"eff_lens {tuple(eff_lens.shape)} must be [{S}]")
    for name, t, dt in (("q", q, torch.float32),
                        ("k_pages", k_pages, k_pages.dtype),
                        ("v_pages", v_pages, k_pages.dtype),
                        ("page_table", page_table, torch.int32),
                        ("eff_lens", eff_lens, torch.int32)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if name != "q" and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.stride(1) != 1:
        raise ValueError("q rows must be contiguous (stride(1) == 1)")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("k_pages / v_pages must be 16-byte aligned")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    out = torch.empty((S, H), dtype=q.dtype, device=q.device)
    lib = _cuda.library(KERNEL)
    fn = _bind(lib, k_pages.dtype)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), q.stride(0), k_pages.data_ptr(),
                v_pages.data_ptr(), page_table.data_ptr(),
                eff_lens.data_ptr(), out.data_ptr(), S, H, num_heads, PS,
                NP, page_table.shape[1],
                split_spans(page_table.shape[1], PS)[0], float(sm_scale),
                stream)
    _cuda.check(lib, rc, "paged_decode_attention launch")
    _cuda.LAUNCHES[_cuda.launch_key(_COUNTER, k_pages.dtype)] += 1
    return out


def paged_decode_attention(q, k_pages, v_pages, page_table, eff_lens,
                           num_heads, sm_scale=None):
    """Public entry: the CUDA kernel for tensors on a CUDA device, the
    plain version for tensors on the CPU."""
    if q.device.type == "cuda":
        return paged_kernel_decode_attention(
            q, k_pages, v_pages, page_table, eff_lens, num_heads,
            sm_scale=sm_scale)
    if q.device.type == "cpu":
        return paged_plain_decode_attention(
            q, k_pages, v_pages, page_table, eff_lens, num_heads,
            sm_scale=sm_scale)
    raise ValueError(f"no paged decode attention for device {q.device}")
