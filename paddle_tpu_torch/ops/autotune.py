"""Kernel tuning for Hopper: the tuning store's lookups and the searches.

Counterpart of paddle_tpu/ops/autotune.py.  Each kernel family keeps
the JAX module's store key, its cached lookup and its resolution order
(an env override, then the store, then the default), so the two
packages read and write one file format (``tuning.store``): the same
``PADDLE_TPU_AUTOTUNE_CACHE`` variable and default path.  The device
kind in a key is ``torch.cuda.get_device_name()`` on the card and
``"cpu"`` on the CPU, so neither a TPU entry nor one written by a CPU
run ever matches the card's key.

The searches are the Hopper ones:

* ``ragged`` — :func:`autotune_ragged` searches ``block_rows`` (rows
  per page-table binding, :data:`RAGGED_BM_CANDIDATES`) on kernel #1,
  ``csrc/ragged_attention.cu``, over a mixed probe step (ragged decode
  rows, a causal prefill chunk, an inactive row).  Every candidate must
  match ``ragged_ref_attention`` on the same inputs before its time
  counts (the parity attestation); times are device milliseconds from
  CUDA events around calls queued behind a ``torch.cuda._sleep`` spin.
* ``matmul``, ``ffn``, ``attn_epilogue`` — the keys and the cached
  lookups round-trip through the store; the tile searches raise
  ``NotImplementedError``: the Hopper #10, #11 and #9 fix their tiles
  at compile time (ops/ffn_chain.py's BLOCK_* constants, the flash and
  GEMM kernels' CTA shapes), so there is no runtime tile to search
  until a kernel redesign makes one (ROADMAP.md, Queue 2: the tile
  search for #9, #10 and #11).  The FFN's other dimension, the fusion
  plan (the chain against two GEMM epilogues), is searched by
  ``tuning.plans``.

On the CPU a search runs the plain versions: parity holds by
construction and times mean nothing, so nothing is persisted and the
report says ``parity_only`` (``force_time`` times the host calls for a
rehearsal; the tuning service persists those only when asked).
"""
from __future__ import annotations

import functools
import json
import os
import time

import numpy as np

__all__ = ["cache_path", "device_kind", "dtype_name", "cached_block_sizes",
           "cached_ffn_block_sizes", "cached_ragged_block_rows",
           "cached_attn_block_sizes", "ragged_cache_key", "ffn_cache_key",
           "attn_cache_key", "autotune", "autotune_ffn", "autotune_attn",
           "autotune_ragged", "time_ms", "RAGGED_BM_CANDIDATES",
           "NO_TILE_SEARCH"]

DEFAULT_CACHE = os.path.join(
    os.path.expanduser("~"), ".cache", "paddle_tpu", "autotune.json")

#: row-tile candidates for the ragged serving kernel (rows per
#: page-table binding); only divisors of the step's row count survive
RAGGED_BM_CANDIDATES = (8, 4, 2, 1)

NO_TILE_SEARCH = (
    "the Hopper kernels #9 (flash_fwd_qkv), #10 (gemm_epilogue) and #11 "
    "(ffn_chain) fix their tiles at compile time (ops/ffn_chain.py "
    "BLOCK_*, the kernels' CTA shapes): there is no runtime tile to "
    "search.  A tile search comes with a redesign of those kernels "
    "(ROADMAP.md, Queue 2: the tile search for #9, #10 and #11); the "
    "FFN's fusion plan is searched by tuning.plans.autotune_fusion_plan")

# in-process cache of the parsed file: path -> (mtime, flat entries)
_LOADED = {}


def cache_path():
    return os.environ.get("PADDLE_TPU_AUTOTUNE_CACHE", DEFAULT_CACHE)


def device_kind(device=None):
    """The store's device kind: the card's name for a CUDA device,
    ``"cpu"`` for the CPU.  ``None`` is the card (``resolve_device``:
    it raises without one)."""
    import torch

    from .._device import resolve_device

    device = resolve_device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def dtype_name(dtype):
    """"float32" for torch.float32, np.float32 or "float32"."""
    return str(dtype).replace("torch.", "")


def _cache_key(kind, M, K, N, dtype):
    return f"{kind}|{M}x{K}x{N}|{dtype}"


def ffn_cache_key(kind, M, K, F, N, dtype):
    return f"ffn|{kind}|{M}x{K}x{F}x{N}|{dtype}"


def ragged_cache_key(kind, rows, num_heads, d_head, page_size, dtype):
    return (f"ragged|{kind}|r{rows}h{num_heads}d{d_head}"
            f"p{page_size}|{dtype}")


def attn_cache_key(kind, T, H, num_heads, dtype):
    return f"attn|{kind}|t{T}h{H}nh{num_heads}|{dtype}"


def _load(path):
    """{key: flat entry} of the store file (either format), cached on
    the file's mtime; a missing or corrupt file is an empty store."""
    try:
        mtime = os.path.getmtime(path)
    except OSError:
        return {}
    hit = _LOADED.get(path)
    if hit is not None and hit[0] == mtime:
        return hit[1]
    try:
        with open(path) as f:
            data = json.load(f)
        from ..tuning import store as _ts

        data = {k: _ts.flatten(e)
                for k, e in _ts._parse_file(data).items()}
    except Exception:  # noqa: BLE001 — a corrupt cache is just a miss
        data = {}
    _LOADED[path] = (mtime, data)
    return data


def _lookup(key, fields):
    entry = _load(cache_path()).get(key)
    if not entry:
        return None
    try:
        vals = tuple(int(entry[f]) for f in fields)
    except (KeyError, TypeError, ValueError):
        return None
    return vals if len(vals) > 1 else vals[0]


def _kind(kind, device):
    return kind if kind is not None else device_kind(device)


def cached_block_sizes(M, K, N, dtype="float32", device_kind=None,
                       device=None):
    """(block_m, block_k) of a GEMM-epilogue geometry from the store, or
    None."""
    return _lookup(_cache_key(_kind(device_kind, device), M, K, N,
                              dtype_name(dtype)), ("bm", "bk"))


def cached_ffn_block_sizes(M, K, F, N, dtype="float32", device_kind=None,
                           device=None):
    """(block_m, block_f) of an FFN-chain geometry from the store, or
    None."""
    return _lookup(ffn_cache_key(_kind(device_kind, device), M, K, F, N,
                                 dtype_name(dtype)), ("bm", "bf"))


def cached_ragged_block_rows(rows, num_heads, d_head, page_size,
                             dtype="float32", device_kind=None,
                             device=None):
    """block_rows of a ragged-attention geometry from the store, or
    None (consumed by ``generation.ragged_attention.resolve_block_rows``
    below the ``PADDLE_TPU_RAGGED_BM`` override)."""
    return _lookup(ragged_cache_key(_kind(device_kind, device), rows,
                                    num_heads, d_head, page_size,
                                    dtype_name(dtype)), ("block_rows",))


def cached_attn_block_sizes(T, H, num_heads, dtype="float32",
                            device_kind=None, device=None):
    """(block_q, block_k) of a qkv-folded flash geometry from the store,
    or None."""
    return _lookup(attn_cache_key(_kind(device_kind, device), T, H,
                                  num_heads, dtype_name(dtype)),
                   ("bq", "bk"))


def _store(key, entry):
    """Persist one search winner through the versioned store (a merge
    against a fresh re-read under an exclusive lock)."""
    from ..tuning.store import TuningStore

    path = cache_path()
    config = {k: v for k, v in entry.items()
              if k not in ("ms", "parity_checked")}
    attestation = None
    if entry.get("parity_checked"):
        attestation = {"parity": True, "ref": "local_search"}
    TuningStore(path).put(key, config, ms=entry.get("ms"),
                          attestation=attestation)
    _LOADED.pop(path, None)


@functools.cache
def _spin_cycles_per_ms(index):
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(20_000_000)
    end.record()
    torch.cuda.synchronize()
    return 20_000_000 / start.elapsed_time(end)


def time_ms(fn, device, reps=200, warm=10):
    """Mean milliseconds per call.  On the card, device time: the calls
    queue behind a spin kernel three times as long as the host takes to
    enqueue them, so the CUDA events around them time back-to-back
    execution, not the host's dispatch.  On the CPU, host time."""
    import torch

    for _ in range(warm):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(3 * host_ms * _spin_cycles_per_ms(device.index)))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / reps


def autotune(M, K, N, dtype="float32", **kwargs):
    """The GEMM-epilogue (#10) tile search: not on Hopper (see
    :data:`NO_TILE_SEARCH`)."""
    raise NotImplementedError(NO_TILE_SEARCH)


def autotune_ffn(M, K, F, N, dtype="float32", **kwargs):
    """The FFN-chain (#11) tile search: not on Hopper (see
    :data:`NO_TILE_SEARCH`)."""
    raise NotImplementedError(NO_TILE_SEARCH)


def autotune_attn(T, H, num_heads, dtype="float32", **kwargs):
    """The qkv-folded flash (#9) tile search: not on Hopper (see
    :data:`NO_TILE_SEARCH`)."""
    raise NotImplementedError(NO_TILE_SEARCH)


def ragged_probe(rows, num_heads, d_head, page_size, pages_per_seq, device,
                 seed=0, dtype="float32"):
    """The search's probe step, from a numpy seed: q [rows, H] float32,
    K/V pages in ``dtype`` (the engine's cache dtype) and row lengths —
    ragged decode rows in the head, a causal prefill chunk (len =
    position + 1) in the tail, row 0 inactive."""
    import torch

    H = num_heads * d_head
    num_pages = rows * pages_per_seq + 1
    rng = np.random.RandomState(seed)
    q = rng.standard_normal((rows, H)).astype(np.float32)
    k = rng.standard_normal((num_pages, page_size, H)).astype(np.float32)
    v = rng.standard_normal((num_pages, page_size, H)).astype(np.float32)
    max_len = page_size * pages_per_seq
    lens = rng.randint(1, max_len + 1, size=rows).astype(np.int32)
    chunk = max(1, rows // 4)
    lens[rows - chunk:] = np.arange(1, chunk + 1)
    lens[0] = 0
    on = [torch.from_numpy(a).to(device) for a in (q, k, v, lens)]
    page_dtype = getattr(torch, dtype_name(dtype))
    on[1], on[2] = on[1].to(page_dtype), on[2].to(page_dtype)
    return (*on, num_pages, rng)


def autotune_ragged(rows, num_heads, d_head, page_size, pages_per_seq,
                    dtype="float32", reps=10, seed=0, write=True, rtol=2e-5,
                    atol=2e-6, force_time=False, device=None):
    """Search block_rows for one ragged-attention geometry on kernel #1.

    Every candidate that tiles ``rows`` runs the kernel's wrapper and
    its plain version on the same probe step (its own page tables: one
    per block of rows), its K/V pages in ``dtype``; a candidate that
    raises or disagrees beyond (rtol, atol) — for 16-bit pages, beyond
    ``attention.contract_bound`` against the plain version on the
    kernel's rounding contract — is skipped, the others are timed
    (:func:`time_ms`, ``reps`` calls).  Returns {"block_rows", "ms",
    "parity_only", "candidates": [...]} and, on the card with ``write``,
    persists the winner under the card's device kind."""
    from .._device import resolve_device
    from ..generation import ragged_attention as ra
    from ..generation.attention import contract_bound

    device = resolve_device(device)
    on_card = device.type == "cuda"
    parity_only = not on_card and not force_time
    q, k_pages, v_pages, lens, num_pages, rng = ragged_probe(
        rows, num_heads, d_head, page_size, pages_per_seq, device, seed,
        dtype)
    sixteen = k_pages.element_size() == 2

    import torch

    results = []
    for bm in RAGGED_BM_CANDIDATES:
        if rows % bm:
            continue
        tables = torch.from_numpy(rng.randint(
            1, num_pages, size=(rows // bm, pages_per_seq)).astype(
                np.int32)).to(device)
        args = (q, k_pages, v_pages, tables, lens, num_heads)
        if sixteen and on_card:
            plain = ra.ragged_flash_plain_attention
            ref = plain(*args, block_rows=bm)
            bound = contract_bound(plain, *args, block_rows=bm)
        else:
            ref = ra.ragged_ref_attention(*args, block_rows=bm)
            bound = atol + rtol * ref.abs()

        def run(bm=bm, tables=tables):
            return ra.ragged_paged_attention(
                q, k_pages, v_pages, tables, lens, num_heads,
                block_rows=bm)

        try:
            got = run()
        except Exception as e:  # noqa: BLE001 — candidate is unusable
            results.append({"block_rows": bm, "error": repr(e)})
            continue
        err = float((got - ref).abs().max())
        if not bool(((got - ref).abs() <= bound).all()):
            results.append({"block_rows": bm, "error": "parity mismatch",
                            "max_abs_err": err})
            continue
        entry = {"block_rows": bm, "parity": True, "max_abs_err": err}
        if not parity_only:
            entry["ms"] = time_ms(run, device, reps=reps)
        results.append(entry)

    ok = [r for r in results if r.get("parity")]
    if not ok:
        return {"block_rows": None, "parity_only": parity_only,
                "candidates": results}
    best = min(ok, key=lambda r: r.get("ms", 0.0))
    out = {"block_rows": best["block_rows"], "ms": best.get("ms"),
           "parity_only": parity_only, "candidates": results}
    if write and on_card:
        _store(ragged_cache_key(device_kind(device), rows, num_heads,
                                d_head, page_size, dtype_name(dtype)),
               {"block_rows": best["block_rows"], "ms": best.get("ms"),
                "parity_checked": True})
    return out
