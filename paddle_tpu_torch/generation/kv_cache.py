"""Block-paged KV cache for autoregressive decoding.

Counterpart of paddle_tpu/generation/kv_cache.py ``PagedKVCache``.  The
KV memory of every live sequence is scattered over fixed-size PAGES
drawn from one preallocated pool, so admitting and retiring sequences of
different lengths never fragments device memory and never changes a
step's shape.  Per sequence there is a PAGE TABLE row (int32 page ids)
and a length; attention reads through the table, writes go to
(table[pos // page_size], pos % page_size).

Layout: one pool per cache, shared by all layers —
``k/v: [num_layers, num_pages, page_size, H]`` with H the packed
num_heads * d_head axis.  Page 0 is RESERVED scratch: unallocated
page-table entries point at it, so inactive rows of a fixed-shape step
scatter their writes there without branching (never read — attention
only sees positions < the row's length).

Unlike the JAX cache, whose buffers are immutable and returned from
every write, this cache preallocates ``k``/``v`` on its device once and
``write_token`` updates them IN PLACE (``index_put_``).  Inactive rows
all write to page 0, slot 0: duplicate indices occur only there, so the
order the scatter applies them in does not matter.

Allocation is host-side (a free-page stack; the table and lengths are
small int32 numpy arrays shipped with each step).  The prefix cache,
the dense cache and the cross-process export/import come with the
prefix-cache and cluster slices of the port.
"""
from __future__ import annotations

import numpy as np
import torch

from .ragged_attention import ragged_paged_attention, ragged_ref_attention

__all__ = ["CacheFullError", "PagedKVCache"]


class CacheFullError(RuntimeError):
    """Admission would exceed the page pool / slot capacity."""


def _cdiv(a, b):
    return -(-a // b)


class PagedKVCache:
    def __init__(self, num_layers, hidden, page_size, num_pages, max_seqs,
                 max_len, dtype=torch.float32, device="cpu",
                 prefix_cache=False):
        if prefix_cache:
            raise NotImplementedError(
                "prefix_cache=True comes with the prefix-cache slice of "
                "the port")
        if max_len % page_size:
            raise ValueError(
                f"max_len {max_len} must be a multiple of page_size "
                f"{page_size}")
        if num_pages < 2:
            raise ValueError("num_pages must be >= 2 (page 0 is scratch)")
        self.num_layers = int(num_layers)
        self.hidden = int(hidden)
        self.max_seqs = int(max_seqs)
        self.max_len = int(max_len)
        self.page_size = int(page_size)
        self.num_pages = int(num_pages)
        self.pages_per_seq = max_len // page_size
        self.k = torch.zeros(
            (num_layers, num_pages, page_size, hidden), dtype=dtype,
            device=device)
        self.v = torch.zeros_like(self.k)
        self.seq_lens = np.zeros(self.max_seqs, np.int32)
        self._active = [False] * self.max_seqs
        # page 0 = scratch; never handed out
        self._free = list(range(num_pages - 1, 0, -1))
        self._owned = {s: [] for s in range(self.max_seqs)}
        self.page_table = np.zeros((self.max_seqs, self.pages_per_seq),
                                   np.int32)

    # -- slot bookkeeping --------------------------------------------------
    def free_slots(self):
        return [s for s in range(self.max_seqs) if not self._active[s]]

    def advance(self, slot):
        self.seq_lens[slot] += 1

    # -- allocator ---------------------------------------------------------
    def pages_needed(self, length):
        return _cdiv(length, self.page_size)

    def free_pages(self):
        return len(self._free)

    def can_admit(self, prompt_len):
        return (self.free_pages() >= self.pages_needed(prompt_len + 1)
                and prompt_len < self.max_len)

    def _alloc_page(self, slot, length):
        if self._free:
            return self._free.pop()
        raise CacheFullError(
            f"page pool exhausted growing slot {slot} to {length} tokens")

    def admit(self, slot, prompt_len, tokens=None):
        """Allocate pages to hold the prompt PLUS the first generated
        token (so the decode step right after prefill never allocates).
        Returns the number of leading positions whose KV is already
        resident: always 0 without the prefix cache."""
        prompt_len = int(prompt_len)
        need = self.pages_needed(prompt_len + 1)
        if self.free_pages() < need:
            raise CacheFullError(
                f"need {need} new pages for a {prompt_len}-token prompt, "
                f"{self.free_pages()} allocatable")
        owned = self._owned[slot]
        for j in range(need):
            page = self._alloc_page(slot, prompt_len + 1)
            owned.append(page)
            self.page_table[slot, j] = page
        self._active[slot] = True
        self.seq_lens[slot] = prompt_len
        return 0

    def ensure(self, slot, length):
        """Grow slot capacity to `length` tokens (decode-time append)."""
        length = int(length)
        owned = self._owned[slot]
        need = self.pages_needed(length)
        while len(owned) < need:
            page = self._alloc_page(slot, length)
            self.page_table[slot, len(owned)] = page
            owned.append(page)

    def release(self, slot):
        # deepest page back first, as the JAX cache does, so the pages a
        # later admission receives are the same in both packages
        for page in reversed(self._owned[slot]):
            self._free.append(page)
        self._owned[slot] = []
        self.page_table[slot, :] = 0
        self._active[slot] = False
        self.seq_lens[slot] = 0

    def occupancy(self):
        """Fraction of the allocatable pool owned by live sequences."""
        total = self.num_pages - 1
        return (total - self.free_pages()) / total if total else 0.0

    def check_invariants(self):
        """Audit the allocator: every page is in exactly one of
        {scratch, free, owned}, and the page table mirrors ownership.
        Raises AssertionError on violation, returns True otherwise."""
        def fail(msg):
            raise AssertionError(f"PagedKVCache invariant violated: {msg}")

        owned_all = []
        for s in range(self.max_seqs):
            pages = self._owned[s]
            if pages and not self._active[s]:
                fail(f"inactive slot {s} owns pages {pages}")
            for j, p in enumerate(pages):
                if p == 0:
                    fail(f"slot {s} owns scratch page 0")
                if int(self.page_table[s, j]) != p:
                    fail(f"page_table[{s},{j}]={self.page_table[s, j]} "
                         f"!= owned {p}")
            for j in range(len(pages), self.pages_per_seq):
                if int(self.page_table[s, j]) != 0:
                    fail(f"stale page_table[{s},{j}]="
                         f"{self.page_table[s, j]} beyond owned range")
            owned_all.extend(pages)
        owned_set, free_set = set(owned_all), set(self._free)
        if len(owned_set) != len(owned_all):
            fail("a page is owned twice")
        if len(free_set) != len(self._free):
            fail("duplicate pages in free list")
        if owned_set & free_set:
            fail(f"pages both owned and free: {owned_set & free_set}")
        expected = set(range(1, self.num_pages))
        if owned_set | free_set != expected:
            fail(f"page accounting mismatch: missing "
                 f"{expected - (owned_set | free_set)}, extra "
                 f"{(owned_set | free_set) - expected}")
        return True

    # -- step tables -------------------------------------------------------
    def rows_for(self, slots_or_none=None):
        """int32 [n, pages_per_seq] page-table rows; None -> all slots.
        Entries of a list may be None (inactive rows) -> scratch."""
        if slots_or_none is None:
            return self.page_table.copy()
        out = np.zeros((len(slots_or_none), self.pages_per_seq), np.int32)
        for i, s in enumerate(slots_or_none):
            if s is not None:
                out[i] = self.page_table[s]
        return out

    # -- device side -------------------------------------------------------
    def write_token(self, layer, k_new, v_new, rows, pos):
        """Scatter one token per row IN PLACE: k_new/v_new [R, H] at
        positions ``pos`` [R] of the page lists ``rows`` [R, pps]."""
        pos = pos.long()
        page_ids = rows.long().gather(
            1, (pos // self.page_size)[:, None])[:, 0]
        off = pos % self.page_size
        self.k[layer].index_put_((page_ids, off), k_new.to(self.k.dtype))
        self.v[layer].index_put_((page_ids, off), v_new.to(self.v.dtype))

    def attend_rows(self, q, layer, tables, row_lens, num_heads, sm_scale,
                    block_rows=1, reference=False):
        """Unified ragged attention over token ROWS (mixed prefill chunk
        + decode): q [R, H], tables [R // block_rows, pages_per_seq],
        row_lens [R] (0 = inactive row).  ``reference=True`` runs the
        plain version wherever the tensors live (the parity oracle)."""
        fn = ragged_ref_attention if reference else ragged_paged_attention
        return fn(q, self.k[layer], self.v[layer], tables, row_lens,
                  num_heads, block_rows=block_rows, sm_scale=sm_scale)
