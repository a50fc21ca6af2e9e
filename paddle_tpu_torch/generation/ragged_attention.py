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
  Hopper (sm_90a): the split-key design of ``csrc/paged_split.cuh``
  (each row's keys cut into spans of whole pages by
  ``attention.split_spans``, the spans of a (row, head) one
  thread-block cluster that merges them), shared with the paged decode
  kernel, with float32, bfloat16 and float16 pages (q and the output
  float32).  ``ragged_paged_attention`` launches it for CUDA tensors,
  adds one to ``_cuda.LAUNCHES["ragged_paged_attention"]`` per launch
  (16-bit pages: ``"ragged_paged_attention_bf16"`` / ``"_f16"``), and
  raises on anything it cannot take; there is no fallback.
* ``ragged_ref_attention`` — plain PyTorch: expand the block tables to
  per-row page lists, gather, and run the decode reference's masked
  softmax (the JAX reference's rounding contract for a 16-bit cache;
  attention.py's module doc).  CPU tensors take it; ``chip_smoke.py``
  holds the float32 kernel against it on the card, and the 16-bit
  kernels against ``ragged_flash_plain_attention``, the plain version on
  the TPU kernel's contract.

``resolve_block_rows`` picks the chunked engine's rows per page-table
binding: the ``PADDLE_TPU_RAGGED_BM`` override, then the tuning store's
searched value for the card (ops/autotune.py), then 1.

Shapes (packed head layout, H = num_heads * d_head):
  q [R, H]; k_pages/v_pages [num_pages, page_size, H];
  block_tables [R // block_rows, pages_per_seq] int32;
  row_lens [R] int32.
"""
from __future__ import annotations

import ctypes
import math
import os

import torch

from .. import _cuda
from .attention import (check_pages, paged_flash_plain_decode_attention,
                        paged_ref_decode_attention, split_spans)

__all__ = ["ragged_paged_attention", "ragged_ref_attention",
           "ragged_flash_plain_attention", "ragged_kernel_attention",
           "resolve_block_rows", "KERNEL"]

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


def ragged_flash_plain_attention(q, k_pages, v_pages, block_tables,
                                 row_lens, num_heads, block_rows=1,
                                 sm_scale=None):
    """Plain version on the TPU kernel's rounding contract (what the
    16-bit kernels are held against): per-row page lists, then
    ``attention.gathered_flash_attention``; inactive rows give zeros."""
    rows = block_tables.repeat_interleave(block_rows, dim=0)   # [R, pps]
    return paged_flash_plain_decode_attention(
        q, k_pages, v_pages, rows, row_lens, num_heads, sm_scale=sm_scale)


def _bind(lib, dtype):
    fn = getattr(lib, f"ragged_paged_attention_{_cuda.type_suffix(dtype)}")
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, ctypes.c_longlong, p, p, p, p, p,
                       i, i, i, i, i, i, i, i, ctypes.c_float, p]
        fn.restype = i
    return fn


def ragged_kernel_attention(q, k_pages, v_pages, block_tables, row_lens,
                            num_heads, block_rows=1, sm_scale=None):
    """Launch the CUDA kernel (CUDA tensors only; see module doc)."""
    R, H = q.shape
    NP, PS, Hk = k_pages.shape
    D = check_pages(q, k_pages, v_pages, num_heads)
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
                        ("k_pages", k_pages, k_pages.dtype),
                        ("v_pages", v_pages, k_pages.dtype),
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
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("k_pages / v_pages must be 16-byte aligned")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    out = torch.empty((R, H), dtype=q.dtype, device=q.device)
    lib = _cuda.library(KERNEL)
    fn = _bind(lib, k_pages.dtype)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), q.stride(0), k_pages.data_ptr(),
                v_pages.data_ptr(), block_tables.data_ptr(),
                row_lens.data_ptr(), out.data_ptr(), R, H, num_heads, PS,
                NP, block_tables.shape[1], block_rows,
                split_spans(block_tables.shape[1], PS)[0], float(sm_scale),
                stream)
    _cuda.check(lib, rc, "ragged_paged_attention launch")
    _cuda.LAUNCHES[_cuda.launch_key(_COUNTER, k_pages.dtype)] += 1
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


def resolve_block_rows(num_rows, num_heads, d_head, page_size,
                       dtype="float32", device=None):
    """Row-tile (block_rows) resolution for the chunked engine, as the
    JAX package's:

      1. ``PADDLE_TPU_RAGGED_BM`` env override (explicit operator
         intent),
      2. the tuning store (ops.autotune, keyed by ``device``'s kind and
         the ragged geometry; written by a search timed on the card),
      3. default 1 — fully mixed rows, no block-granularity waste.

    Each resolution publishes the tuning plane's harvest series
    (``tuning.observe.record_resolution``) with its source."""
    def _harvest(source, bm):
        try:
            from ..tuning.observe import record_resolution

            record_resolution(
                "ragged",
                f"r{num_rows}h{num_heads}d{d_head}p{page_size}",
                source, str(bm), dtype=str(dtype))
        except Exception:  # noqa: BLE001 — telemetry never raises
            pass

    env = os.environ.get("PADDLE_TPU_RAGGED_BM")
    if env:
        try:
            bm = max(1, int(env))
            _harvest("env", bm)
            return bm
        except ValueError:
            pass
    try:
        from ..ops import autotune as at

        bm = at.cached_ragged_block_rows(
            num_rows, num_heads, d_head, page_size, dtype=dtype,
            device=device)
        if bm:
            _harvest("cache", int(bm))
            return int(bm)
    except Exception:  # noqa: BLE001 — cache trouble is just a miss
        pass
    _harvest("heuristic", 1)
    return 1
