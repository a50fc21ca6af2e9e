"""Unified ragged paged attention: prefill-chunk rows and decode rows in
ONE fixed-shape launch.

Counterpart of paddle_tpu/generation/ragged_attention.py.  The step
carries R token ROWS; row r has one query token and attends over keys
0..row_lens[r]-1 of the page list ``block_tables[r // block_rows]`` —
the one rule that is causal masking inside a prefill chunk and ragged
decode masking.  A row with length 0 is INACTIVE and yields exact zeros.

Two implementations behind one entry point, chosen by where the tensors
live and nothing else:

* ``csrc/ragged_attention.cu`` — the hand-written CUDA kernel for
  Hopper (sm_90a), float32.  ``ragged_paged_attention`` launches it for
  CUDA tensors, adds one to ``_cuda.LAUNCHES["ragged_paged_attention"]``
  per launch, and raises on anything it cannot take; there is no
  fallback.
* ``ragged_ref_attention`` — plain PyTorch: expand the block tables to
  per-row page lists, gather, and run the decode reference's masked
  softmax.  CPU tensors take it; ``chip_smoke.py`` holds the kernel
  against it on the card.

Shapes (packed head layout, H = num_heads * d_head):
  q [R, H]; k_pages/v_pages [num_pages, page_size, H];
  block_tables [R // block_rows, pages_per_seq] int32;
  row_lens [R] int32.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .. import _cuda
from .attention import paged_ref_decode_attention

__all__ = ["ragged_paged_attention", "ragged_ref_attention",
           "ragged_kernel_attention", "KERNEL"]

#: launch-counter key and source name of the kernel
KERNEL = "ragged_attention"
_COUNTER = "ragged_paged_attention"


def ragged_ref_attention(q, k_pages, v_pages, block_tables, row_lens,
                         num_heads, block_rows=1, sm_scale=None):
    """Plain version: per-row page lists (each block's table repeated
    over its rows), the decode reference's gather + masked softmax, and
    zeros for inactive rows."""
    rows = block_tables.repeat_interleave(block_rows, dim=0)   # [R, pps]
    out = paged_ref_decode_attention(
        q, k_pages, v_pages, rows, row_lens, num_heads, sm_scale=sm_scale)
    active = (row_lens.to(out.device) > 0)[:, None]
    return torch.where(active, out, torch.zeros_like(out))


def _bind(lib):
    fn = lib.ragged_paged_attention_f32
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, ctypes.c_longlong, p, p, p, p, p,
                       i, i, i, i, i, i, i, ctypes.c_float, p]
        fn.restype = i
    return fn


def ragged_kernel_attention(q, k_pages, v_pages, block_tables, row_lens,
                            num_heads, block_rows=1, sm_scale=None):
    """Launch the CUDA kernel (CUDA tensors only; see module doc)."""
    R, H = q.shape
    NP, PS, Hk = k_pages.shape
    if H % num_heads or H // num_heads > 128:
        raise ValueError(
            f"hidden {H} must split into {num_heads} heads of <= 128")
    if block_rows < 1 or R % block_rows:
        raise ValueError(f"{R} rows do not tile by block_rows={block_rows}")
    if R > 65535:
        raise ValueError(f"{R} rows exceed the kernel's grid (65535)")
    if Hk != H or v_pages.shape != k_pages.shape:
        raise ValueError(
            f"q [.., {H}] does not match pages {tuple(k_pages.shape)} / "
            f"{tuple(v_pages.shape)}")
    if block_tables.dim() != 2 or block_tables.shape[0] != R // block_rows:
        raise ValueError(
            f"block_tables {tuple(block_tables.shape)} must have "
            f"{R // block_rows} rows")
    if tuple(row_lens.shape) != (R,):
        raise ValueError(f"row_lens {tuple(row_lens.shape)} must be [{R}]")
    for name, t, dt in (("q", q, torch.float32),
                        ("k_pages", k_pages, torch.float32),
                        ("v_pages", v_pages, torch.float32),
                        ("block_tables", block_tables, torch.int32),
                        ("row_lens", row_lens, torch.int32)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if name != "q" and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.stride(1) != 1:
        raise ValueError("q rows must be contiguous (stride(1) == 1)")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(H // num_heads)
    out = torch.empty((R, H), dtype=q.dtype, device=q.device)
    lib = _cuda.library(KERNEL)
    fn = _bind(lib)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), q.stride(0), k_pages.data_ptr(),
                v_pages.data_ptr(), block_tables.data_ptr(),
                row_lens.data_ptr(), out.data_ptr(), R, H, num_heads, PS,
                NP, block_tables.shape[1], block_rows, float(sm_scale),
                stream)
    _cuda.check(lib, rc, "ragged_paged_attention launch")
    _cuda.LAUNCHES[_COUNTER] += 1
    return out


def ragged_paged_attention(q, k_pages, v_pages, block_tables, row_lens,
                           num_heads, block_rows=1, sm_scale=None):
    """Public entry: the CUDA kernel for tensors on a CUDA device, the
    plain version for tensors on the CPU."""
    if q.device.type == "cuda":
        return ragged_kernel_attention(
            q, k_pages, v_pages, block_tables, row_lens, num_heads,
            block_rows=block_rows, sm_scale=sm_scale)
    if q.device.type == "cpu":
        return ragged_ref_attention(
            q, k_pages, v_pages, block_tables, row_lens, num_heads,
            block_rows=block_rows, sm_scale=sm_scale)
    raise ValueError(f"no ragged attention for device {q.device}")
