"""KV caches for autoregressive decoding: block-paged (with a global
prefix cache) and dense.

Counterpart of paddle_tpu/generation/kv_cache.py.  The KV memory of
every live sequence is scattered over fixed-size PAGES drawn from one
preallocated pool, so admitting and retiring sequences of different
lengths never fragments device memory and never changes a step's shape.
Per sequence there is a PAGE TABLE row (int32 page ids) and a length;
attention reads through the table, writes go to
(table[pos // page_size], pos % page_size).

Layout: one pool per cache, shared by all layers —
``k/v: [num_layers, num_pages, page_size, H]`` with H the packed
num_heads * d_head axis.  Page 0 is RESERVED scratch: unallocated
page-table entries point at it, so inactive rows of a fixed-shape step
scatter their writes there without branching (never read — attention
only sees positions < the row's length).

Unlike the JAX caches, whose buffers are immutable and returned from
every write, these preallocate ``k``/``v`` on their device once and
write them IN PLACE (``index_put_``, ``copy_``).  Inactive rows all
write to scratch: duplicate indices occur only there, so the order the
scatter applies them in does not matter.

`DenseKVCache` keeps per-slot contiguous [max_len] rows (row
``max_seqs`` is the scratch row, mirroring page 0).  Both caches expose
the same write/attend surface so the engine is layout-blind.

Prefix cache (``prefix_cache=True``, paged only): full page_size-aligned
token blocks of each fully-fed prompt are published into a pool-level
`PrefixIndex` under a rolling chain hash (key_i commits to ALL tokens
up to block i's end).  A later admit with a matching prefix SPLICES the
indexed pages into its page table with a refcount bump and starts
prefill at the first miss.  A write landing in a shared or registered
page triggers copy-on-write / deregistration via `_privatize`.
Registered pages whose refcount drops to zero are RETAINED on an LRU
clock instead of freed; allocation evicts the coldest retained page
only once the free list is empty, so `CacheFullError` means "nothing
evictable remains".

Allocation is host-side (a free-page stack; the table and lengths are
small int32 numpy arrays shipped with each step).

Cross-process handoff (the cluster's prefill/decode split): both caches
``export_span`` a slot's positions [start, end) as host numpy arrays
[L, end - start, H] — gathered from the slot's own pages, then one copy
to the host — and ``import_span`` such arrays back into a slot's pages
— one copy to the device, then one index-put.  Neither computes, and
arrays of the cache's dtype (what an export gives) are not cast: the
bits that leave one pool are the bits that land in the other.

The arrays are the cache's own words (``kv_to_host``): float32 and
float16 as numpy arrays of that dtype, bfloat16 — which numpy lacks —
as its raw 16-bit words, uint16 under the one-field record dtype
``BF16_WORDS`` whose field is named "bfloat16".  So every array names
its own dtype, through slices, concatenation and pickling, and the
cluster passes it on without knowing it; ``import_span`` reads the
words back by it (``kv_from_host``).  Nothing is widened on the wire:
a 16-bit cache ships half the bytes of a float32 one.
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch

from .._device import resolve_device
from .attention import (gathered_decode_attention, paged_decode_attention,
                        paged_plain_decode_attention)
from .ragged_attention import ragged_paged_attention, ragged_ref_attention

__all__ = ["CacheFullError", "PagedKVCache", "DenseKVCache", "PrefixIndex",
           "BF16_WORDS", "kv_to_host", "kv_from_host"]


class CacheFullError(RuntimeError):
    """Admission would exceed the page pool / slot capacity."""


def _block_keys(tokens, page_size, n_blocks):
    """Rolling chain hash over page-aligned token blocks: key_i =
    sha256(key_{i-1} || tokens of block i) commits to the whole prefix
    up to block i's end, and equals the JAX cache's key for it."""
    flat = np.ascontiguousarray(np.asarray(tokens, np.int64).reshape(-1))
    keys = []
    h = b"paddle_tpu-prefix:"
    for i in range(n_blocks):
        block = flat[i * page_size:(i + 1) * page_size]
        h = hashlib.sha256(h + block.tobytes()).digest()
        keys.append(h)
    return keys


class PrefixIndex:
    """Pool-level bidirectional map: chain-hash block key <-> page id.
    Registration is first-writer-wins per key and at most one key per
    page; deregistration happens on eviction or privatization."""

    def __init__(self):
        self._by_key = {}          # key bytes -> page id
        self._key_of = {}          # page id -> key bytes

    def __len__(self):
        return len(self._by_key)

    def get(self, key):
        return self._by_key.get(key)

    def key_of(self, page):
        return self._key_of.get(page)

    def register(self, key, page):
        if key in self._by_key or page in self._key_of:
            return False
        self._by_key[key] = page
        self._key_of[page] = key
        return True

    def deregister(self, page):
        key = self._key_of.pop(page, None)
        if key is None:
            return False
        del self._by_key[key]
        return True


def _cdiv(a, b):
    return -(-a // b)


#: bfloat16 K/V on the host: its raw 16-bit words, under a record dtype
#: whose one field names the type
BF16_WORDS = np.dtype([("bfloat16", np.uint16)])


def kv_to_host(t):
    """A host numpy copy of cache K/V ``t`` in the cache's own words,
    never aliasing the cache (on the CPU ``.cpu()`` would hand back the
    tensor itself): float32/float16 as themselves, bfloat16 as its raw
    16-bit words (``BF16_WORDS``)."""
    t = t.to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(BF16_WORDS)
    return t.numpy()


def kv_from_host(a, device, dtype):
    """The words of ``kv_to_host`` as a tensor of ``dtype`` on
    ``device``: the bits as they left, cast only where the receiving
    cache's dtype differs from theirs.  Float arrays of another
    precision are cast, as the JAX cache's import casts them; anything
    else (a bare uint16 array among them) raises."""
    a = np.ascontiguousarray(a)
    if a.dtype == BF16_WORDS:
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    elif a.dtype.kind == "f":
        t = torch.from_numpy(a)
    else:
        raise TypeError(f"K/V words must be a float array or BF16_WORDS, "
                        f"got {a.dtype}")
    return t.to(device=device, dtype=dtype)


class _CacheBase:
    """Shared host-side bookkeeping: slots and lengths."""

    def __init__(self, num_layers, hidden, max_seqs, max_len):
        self.num_layers = int(num_layers)
        self.hidden = int(hidden)
        self.max_seqs = int(max_seqs)
        self.max_len = int(max_len)
        self.seq_lens = np.zeros(self.max_seqs, np.int32)
        self._active = [False] * self.max_seqs

    def free_slots(self):
        return [s for s in range(self.max_seqs) if not self._active[s]]

    def admitted(self, slot, length):
        self._active[slot] = True
        self.seq_lens[slot] = length

    def advance(self, slot):
        self.seq_lens[slot] += 1

    def release(self, slot):
        self._active[slot] = False
        self.seq_lens[slot] = 0

    def buffers(self):
        return self.k, self.v

    def set_buffers(self, k, v):
        self.k, self.v = k, v

    # -- cross-process handoff (cluster prefill/decode split) --------------
    def export_seq(self, slot, length):
        """Host copies of the slot's K/V for positions < ``length``: two
        arrays [L, length, H] of the cache's words (``kv_to_host``) —
        what a prefill worker ships."""
        return self.export_span(slot, 0, length)

    def import_seq(self, slot, k_seq, v_seq):
        """Scatter host K/V [L, T, H] (``kv_to_host`` words) into the
        (already admitted) slot at positions 0..T-1 — the receiving half
        of a prefill handoff."""
        self.import_span(slot, 0, k_seq, v_seq)

    def export_span(self, slot, start, end):
        """Host copies of the slot's K/V for positions [start, end) — the
        chunk-granular unit the cluster streams as each prefill chunk
        retires: two arrays [L, end - start, H] of the cache's words
        (``kv_to_host``)."""
        index = self._span_index(slot, int(start), int(end))
        return kv_to_host(self.k[index]), kv_to_host(self.v[index])

    def import_span(self, slot, start, k_seq, v_seq):
        """Scatter host K/V [L, T, H] — ``kv_to_host`` words, as an
        export gives them — into the slot at positions start..start+T-1:
        the receiving half of one streamed chunk."""
        T = k_seq.shape[1]
        if T == 0:
            return
        index = self._span_index(slot, int(start), int(start) + T)
        self.k[index] = kv_from_host(k_seq, self.k.device, self.k.dtype)
        self.v[index] = kv_from_host(v_seq, self.k.device, self.k.dtype)


class PagedKVCache(_CacheBase):
    kind = "paged"

    def __init__(self, num_layers, hidden, page_size, num_pages, max_seqs,
                 max_len, dtype=torch.float32, device=None,
                 prefix_cache=False):
        if max_len % page_size:
            raise ValueError(
                f"max_len {max_len} must be a multiple of page_size "
                f"{page_size}")
        if num_pages < 2:
            raise ValueError("num_pages must be >= 2 (page 0 is scratch)")
        super().__init__(num_layers, hidden, max_seqs, max_len)
        self.page_size = int(page_size)
        self.num_pages = int(num_pages)
        self.pages_per_seq = max_len // page_size
        self.prefix_cache = bool(prefix_cache)
        self.k = torch.zeros(
            (num_layers, num_pages, page_size, hidden), dtype=dtype,
            device=resolve_device(device))
        self.v = torch.zeros_like(self.k)
        # page 0 = scratch; never handed out
        self._free = list(range(num_pages - 1, 0, -1))
        self._owned = {s: [] for s in range(self.max_seqs)}
        self.page_table = np.zeros((self.max_seqs, self.pages_per_seq),
                                   np.int32)
        # refcounts for every owned page (shared pages have ref > 1);
        # retained = registered pages at ref 0, evictable, LRU by tick
        self._ref = {}
        self._index = PrefixIndex()
        self._retained = {}
        self._tick = 0
        self._prefix_counters = dict(
            lookups=0, hits=0, pages_reused=0, pages_evicted=0,
            cow_copies=0)

    # -- allocator ---------------------------------------------------------
    def pages_needed(self, length):
        return _cdiv(length, self.page_size)

    def free_pages(self):
        """Pages allocatable right now: the free list plus retained
        (refcount-0 prefix) pages an allocation may evict."""
        return len(self._free) + len(self._retained)

    def can_admit(self, prompt_len):
        return (self.free_pages() >= self.pages_needed(prompt_len + 1)
                and prompt_len < self.max_len)

    def _alloc_page(self, slot, length):
        if self._free:
            return self._free.pop()
        if self._retained:
            # evict the coldest retained prefix page; deeper blocks of a
            # chain carry older ticks, so a chain unwinds tail-first
            page = min(self._retained, key=self._retained.get)
            del self._retained[page]
            self._index.deregister(page)
            self._prefix_counters["pages_evicted"] += 1
            return page
        raise CacheFullError(
            f"page pool exhausted growing slot {slot} to {length} tokens "
            "(no free pages and no evictable retained prefixes)")

    def _ref_page(self, page):
        n = self._ref.get(page)
        if n is None:
            # reviving a retained page (or first ref after alloc)
            self._retained.pop(page, None)
            self._ref[page] = 1
        else:
            self._ref[page] = n + 1

    def _deref(self, page):
        n = self._ref[page] - 1
        if n > 0:
            self._ref[page] = n
            return
        del self._ref[page]
        if self._index.key_of(page) is not None:
            self._tick += 1
            self._retained[page] = self._tick
        else:
            self._free.append(page)

    def _match_prefix(self, tokens, prompt_len):
        """Longest run of indexed pages covering leading full blocks,
        clamped to (prompt_len - 1) // page_size blocks so the final
        prompt token is always prefilled for real (its logits give the
        first token, and decode then never writes into a shared page)."""
        n_full = (prompt_len - 1) // self.page_size
        if n_full <= 0:
            return []
        flat = np.asarray(tokens, np.int64).reshape(-1)
        if flat.size < prompt_len:
            return []
        hits = []
        for key in _block_keys(flat[:prompt_len], self.page_size, n_full):
            page = self._index.get(key)
            if page is None:
                break
            hits.append(page)
        return hits

    def admit(self, slot, prompt_len, tokens=None):
        """Allocate pages to hold the prompt PLUS the first generated
        token (so the decode step right after prefill never allocates).

        With `tokens` and the prefix cache enabled, leading full token
        blocks found in the prefix index are spliced in by reference
        instead of allocated.  Returns cached_len — leading positions
        whose KV is already resident (0 without the cache; always
        < prompt_len)."""
        prompt_len = int(prompt_len)
        hits = []
        looked_up = False
        if self.prefix_cache and tokens is not None and prompt_len > 0:
            hits = self._match_prefix(tokens, prompt_len)
            looked_up = True
        need = self.pages_needed(prompt_len + 1)
        retained_hits = sum(1 for p in hits if p in self._retained)
        if self.free_pages() - retained_hits < need - len(hits):
            raise CacheFullError(
                f"need {need - len(hits)} new pages for a "
                f"{prompt_len}-token prompt ({len(hits)} cached), "
                f"{self.free_pages() - retained_hits} allocatable")
        owned = self._owned[slot]
        for j in range(need):
            if j < len(hits):
                page = hits[j]
                self._ref_page(page)
            else:
                page = self._alloc_page(slot, prompt_len + 1)
                self._ref[page] = 1
            owned.append(page)
            self.page_table[slot, j] = page
        self.admitted(slot, prompt_len)
        if looked_up:
            self._prefix_counters["lookups"] += 1
            if hits:
                self._prefix_counters["hits"] += 1
                self._prefix_counters["pages_reused"] += len(hits)
        return len(hits) * self.page_size

    def register_prefix(self, slot, tokens):
        """Publish the slot's fully-fed prompt blocks into the prefix
        index (idempotent; first writer wins per key).  Call only once
        every position of `tokens` has final KV in the slot's pages."""
        if not self.prefix_cache or tokens is None:
            return 0
        flat = np.asarray(tokens, np.int64).reshape(-1)
        owned = self._owned[slot]
        n_full = min(flat.size // self.page_size, len(owned))
        new = 0
        for i, key in enumerate(_block_keys(flat, self.page_size, n_full)):
            if self._index.get(key) is not None:
                continue
            if self._index.register(key, owned[i]):
                new += 1
        return new

    def _privatize(self, slot, block):
        """Make `slot`'s page at `block` safe to write into: a
        registered page with no other owner is simply deregistered (its
        content is about to diverge from its key); a shared page is
        copied to a fresh private page (copy-on-write, in place on the
        device) and deref'd."""
        owned = self._owned[slot]
        page = owned[block]
        if self._ref.get(page, 1) <= 1:
            self._index.deregister(page)
            self._retained.pop(page, None)
            return
        new = self._alloc_page(slot, (block + 1) * self.page_size)
        self.k[:, new].copy_(self.k[:, page])
        self.v[:, new].copy_(self.v[:, page])
        self._ref[new] = 1
        owned[block] = new
        self.page_table[slot, block] = new
        self._deref(page)
        self._prefix_counters["cow_copies"] += 1

    def ensure(self, slot, length):
        """Grow slot capacity to `length` tokens (decode-time append).
        Pages about to receive writes (blocks from the current seq_len
        through length-1) are privatized first — a no-op in the normal
        flow, where shared pages only cover fully-fed prompt blocks
        below the write position."""
        length = int(length)
        have = len(self._owned[slot])
        need = self.pages_needed(length)
        if self.prefix_cache and have:
            first = int(self.seq_lens[slot]) // self.page_size
            for b in range(first, min(have, need)):
                self._privatize(slot, b)
        while have < need:
            page = self._alloc_page(slot, length)
            self._ref[page] = 1
            self._owned[slot].append(page)
            self.page_table[slot, have] = page
            have += 1

    def truncate_to(self, slot, length):
        """Shrink slot capacity back to `length` tokens — the KV
        rollback after a speculative verify window whose tail tokens
        were rejected.  Surplus pages are deref'd, not blindly freed: a
        page another sequence (or the prefix index) still references
        stays alive for its other owners.  A kept partial tail block is
        privatized, because rejected positions in it will be rewritten.
        Rejected positions need no zeroing: attention never reads past
        the committed seq_len."""
        length = max(0, int(length))
        keep = self.pages_needed(length)
        owned = self._owned[slot]
        while len(owned) > keep:
            page = owned.pop()
            self.page_table[slot, len(owned)] = 0
            self._deref(page)
        # the rollback may ask for seq_len + 1 headroom one page past the
        # chain; the partial tail needs COW only where the chain covers it
        if (self.prefix_cache and keep and keep <= len(owned)
                and length % self.page_size):
            self._privatize(slot, keep - 1)

    def release(self, slot):
        # deref deepest-first, as the JAX cache does: the pages a later
        # admission receives are the same in both packages, and a
        # retained chain's tail gets the oldest LRU ticks
        for page in reversed(self._owned[slot]):
            self._deref(page)
        self._owned[slot] = []
        self.page_table[slot, :] = 0
        super().release(slot)

    def occupancy(self):
        """Fraction of the allocatable pool hard-owned by live
        sequences (retained prefix pages count as free)."""
        total = self.num_pages - 1
        return (total - self.free_pages()) / total if total else 0.0

    def retained_pages(self):
        """Number of refcount-0 registered pages held for reuse."""
        return len(self._retained)

    def prefix_counters(self):
        """Monotonic host-side counters for stats syncing."""
        return dict(self._prefix_counters)

    def check_invariants(self):
        """Audit the allocator: every page is in exactly one of
        {scratch, free, retained, owned}; refcounts equal the number of
        page-table references; the index maps registered pages
        bijectively and never points at a free page.  Raises
        AssertionError on violation, returns True otherwise."""
        def fail(msg):
            raise AssertionError(f"PagedKVCache invariant violated: {msg}")

        ref_seen = {}
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
                ref_seen[p] = ref_seen.get(p, 0) + 1
            for j in range(len(pages), self.pages_per_seq):
                if int(self.page_table[s, j]) != 0:
                    fail(f"stale page_table[{s},{j}]="
                         f"{self.page_table[s, j]} beyond owned range")
        free_set = set(self._free)
        if len(free_set) != len(self._free):
            fail("duplicate pages in free list")
        retained_set = set(self._retained)
        owned_set = set(ref_seen)
        if owned_set & free_set:
            fail(f"pages both owned and free: {owned_set & free_set}")
        if owned_set & retained_set:
            fail(f"pages both owned and retained: "
                 f"{owned_set & retained_set}")
        if free_set & retained_set:
            fail(f"pages both free and retained: {free_set & retained_set}")
        universe = owned_set | free_set | retained_set
        expected = set(range(1, self.num_pages))
        if universe != expected:
            fail(f"page accounting mismatch: missing "
                 f"{expected - universe}, extra {universe - expected}")
        if set(self._ref) != owned_set:
            fail("refcount table out of sync with ownership")
        for p, n in ref_seen.items():
            if self._ref[p] != n:
                fail(f"page {p} refcount {self._ref[p]} != {n} references")
        for p in retained_set:
            if self._index.key_of(p) is None:
                fail(f"retained page {p} not registered in the index")
        for p in list(self._index._key_of):
            if p in free_set:
                fail(f"registered page {p} is on the free list")
            if self._index.get(self._index.key_of(p)) != p:
                fail(f"index maps are inconsistent for page {p}")
        return True

    # -- step tables -------------------------------------------------------
    def scratch_row(self):
        """The rows_for() entry that routes writes to scratch (page 0 for
        every position)."""
        return np.zeros(self.pages_per_seq, np.int32)

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

    def _span_index(self, slot, start, end):
        """Index of positions [start, end) of ``slot`` into k/v: the
        pages and in-page offsets of the slot's own page table."""
        pos = np.arange(start, end)
        pages = self.page_table[slot, pos // self.page_size]
        dev = self.k.device
        return (slice(None),
                torch.from_numpy(pages.astype(np.int64)).to(dev),
                torch.from_numpy(pos % self.page_size).to(dev))

    # -- device side -------------------------------------------------------
    def write_prompt(self, layer, k_new, v_new, rows):
        """Scatter whole prompts IN PLACE: k_new/v_new [B, T, H] at
        positions 0..T-1 of each row's page list ``rows`` [B, pps]."""
        pos = torch.arange(k_new.shape[1], device=rows.device)
        page_ids = rows.long()[:, pos // self.page_size]      # [B, T]
        off = (pos % self.page_size).expand_as(page_ids)
        self.k[layer].index_put_((page_ids, off), k_new.to(self.k.dtype))
        self.v[layer].index_put_((page_ids, off), v_new.to(self.v.dtype))

    def write_token(self, layer, k_new, v_new, rows, pos):
        """Scatter one token per row IN PLACE: k_new/v_new [R, H] at
        positions ``pos`` [R] of the page lists ``rows`` [R, pps]."""
        pos = pos.long()
        page_ids = rows.long().gather(
            1, (pos // self.page_size)[:, None])[:, 0]
        off = pos % self.page_size
        self.k[layer].index_put_((page_ids, off), k_new.to(self.k.dtype))
        self.v[layer].index_put_((page_ids, off), v_new.to(self.v.dtype))

    def attend(self, q, layer, rows, eff_lens, num_heads, sm_scale,
               reference=False):
        """Decode attention, one query per slot: q [S, H], rows [S, pps],
        eff_lens [S].  On the card, one launch of the paged decode
        kernel; ``reference=True`` runs the plain version wherever the
        tensors live (the parity oracle)."""
        fn = (paged_plain_decode_attention if reference
              else paged_decode_attention)
        return fn(q, self.k[layer], self.v[layer], rows, eff_lens,
                  num_heads, sm_scale=sm_scale)

    def attend_rows(self, q, layer, tables, row_lens, num_heads, sm_scale,
                    block_rows=1, reference=False):
        """Unified ragged attention over token ROWS (mixed prefill chunk
        + decode): q [R, H], tables [R // block_rows, pages_per_seq],
        row_lens [R] (0 = inactive row).  ``reference=True`` runs the
        plain version wherever the tensors live (the parity oracle)."""
        fn = ragged_ref_attention if reference else ragged_paged_attention
        return fn(q, self.k[layer], self.v[layer], tables, row_lens,
                  num_heads, block_rows=block_rows, sm_scale=sm_scale)


class DenseKVCache(_CacheBase):
    """Contiguous layout: k/v [num_layers, max_seqs + 1, max_len, H]
    (row max_seqs is the scratch row — the dense analog of page 0).
    Its attention is plain PyTorch on every device, as the JAX cache's
    is an XLA composite."""

    kind = "dense"

    def __init__(self, num_layers, hidden, max_seqs, max_len,
                 dtype=torch.float32, device=None, page_size=None,
                 num_pages=None, prefix_cache=False):
        if prefix_cache:
            raise ValueError(
                "prefix_cache requires the paged cache (use_paged=True): "
                "dense rows cannot be shared between sequences")
        super().__init__(num_layers, hidden, max_seqs, max_len)
        self.prefix_cache = False
        self.k = torch.zeros(
            (num_layers, self.max_seqs + 1, self.max_len, hidden),
            dtype=dtype, device=resolve_device(device))
        self.v = torch.zeros_like(self.k)

    # dense admission never fragments: a free slot is all it needs
    def can_admit(self, prompt_len):
        return prompt_len < self.max_len

    def admit(self, slot, prompt_len, tokens=None):
        self.admitted(slot, prompt_len)
        return 0

    def register_prefix(self, slot, tokens):
        return 0

    def prefix_counters(self):
        return dict(lookups=0, hits=0, pages_reused=0, pages_evicted=0,
                    cow_copies=0)

    def check_invariants(self):
        """Dense rows are statically owned by their slots."""
        return True

    def ensure(self, slot, length):
        if length > self.max_len:
            raise CacheFullError(
                f"sequence in slot {slot} exceeds max_len {self.max_len}")

    def truncate_to(self, slot, length):
        """Rollback is pure bookkeeping: nothing to free, and attention
        never reads past the committed seq_len."""
        if length > self.max_len:
            raise CacheFullError(
                f"sequence in slot {slot} exceeds max_len {self.max_len}")

    def occupancy(self):
        used = sum(int(n) for n in self.seq_lens)
        return used / (self.max_seqs * self.max_len)

    def scratch_row(self):
        """Dense scratch is row max_seqs (NOT 0 — that is slot 0's
        live KV)."""
        return np.int32(self.max_seqs)

    def _span_index(self, slot, start, end):
        return (slice(None), int(slot), slice(start, end))

    def rows_for(self, slots_or_none=None):
        """Dense 'rows' are slot indices (scratch for None entries)."""
        if slots_or_none is None:
            return np.arange(self.max_seqs, dtype=np.int32)
        return np.asarray(
            [self.max_seqs if s is None else s for s in slots_or_none],
            np.int32)

    def write_prompt(self, layer, k_new, v_new, rows):
        T = k_new.shape[1]
        rows = rows.long()
        self.k[layer, :, :T].index_put_((rows,), k_new.to(self.k.dtype))
        self.v[layer, :, :T].index_put_((rows,), v_new.to(self.v.dtype))

    def write_token(self, layer, k_new, v_new, rows, pos):
        idx = (rows.long(), pos.long())
        self.k[layer].index_put_(idx, k_new.to(self.k.dtype))
        self.v[layer].index_put_(idx, v_new.to(self.v.dtype))

    def attend(self, q, layer, rows, eff_lens, num_heads, sm_scale,
               reference=False):
        S = q.shape[0]
        return gathered_decode_attention(
            q, self.k[layer, :S], self.v[layer, :S], eff_lens, num_heads,
            sm_scale=sm_scale)

    def attend_rows(self, q, layer, tables, row_lens, num_heads, sm_scale,
                    block_rows=1, reference=False):
        """Dense analog of the paged ragged read: tables [R//block_rows]
        slot ids -> per-row KV gather, then the shared masked softmax."""
        row_ids = tables.long().repeat_interleave(block_rows)    # [R]
        return gathered_decode_attention(
            q, self.k[layer, row_ids], self.v[layer, row_ids], row_lens,
            num_heads, sm_scale=sm_scale)
