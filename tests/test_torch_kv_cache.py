"""The port's PagedKVCache against the JAX package's.

The allocator is host-side in both: the same admit / ensure / release
sequence must hand out the same pages, keep the same page tables and
occupancy, and pass the invariant audit at every step.  The device
side differs by design (the port writes its preallocated buffers in
place): after the same writes both pools must hold the same bits, and
``attend_rows`` must agree within the ragged attention's tolerance
(atol 2e-6 / rtol 2e-5).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.generation.kv_cache import CacheFullError as JCacheFull
from paddle_tpu.generation.kv_cache import PagedKVCache as JCache
from paddle_tpu_torch.generation import CacheFullError, PagedKVCache

torch.set_num_threads(2)

GEOM = dict(num_layers=2, hidden=16, page_size=4, num_pages=13,
            max_seqs=3, max_len=16)


def _both():
    return JCache(**GEOM), PagedKVCache(**GEOM, device="cpu")


def _same_state(j, t):
    np.testing.assert_array_equal(t.page_table, j.page_table)
    np.testing.assert_array_equal(t.seq_lens, j.seq_lens)
    assert t.free_pages() == j.free_pages()
    assert t.occupancy() == j.occupancy()
    assert t.free_slots() == j.free_slots()
    assert t.check_invariants() and j.check_invariants()


def test_allocator_follows_the_reference():
    j, t = _both()
    ops = [("admit", 0, 5), ("admit", 1, 3), ("ensure", 0, 9),
           ("ensure", 1, 4), ("ensure", 1, 5), ("release", 0),
           ("admit", 2, 11), ("admit", 0, 2), ("ensure", 2, 13),
           ("release", 1), ("release", 2), ("admit", 1, 14)]
    for op, slot, *n in ops:
        assert t.can_admit(n[0]) == j.can_admit(n[0]) if n else True
        getattr(j, op)(slot, *n)
        getattr(t, op)(slot, *n)
        _same_state(j, t)
    assert t.rows_for([2, None, 0]).tolist() == \
        j.rows_for([2, None, 0]).tolist()
    np.testing.assert_array_equal(t.rows_for(), j.rows_for())


def test_exhaustion_raises_like_the_reference():
    j, t = _both()
    for c in (j, t):
        c.admit(0, 15)              # 4 pages
        c.admit(1, 15)
        c.admit(2, 11)              # 3 pages: 1 page left
        assert not c.can_admit(4)
    with pytest.raises(JCacheFull):
        j.ensure(2, 13)
        j.ensure(2, 17)
    with pytest.raises(CacheFullError):
        t.ensure(2, 13)
        t.ensure(2, 17)
    with pytest.raises(CacheFullError):
        t.admit(0, 15)              # slot 0 still holds its pages


def test_audit_catches_corruption():
    t = PagedKVCache(**GEOM, device="cpu")
    t.admit(0, 6)
    t.page_table[1, 0] = 5          # a stale entry beyond owned range
    with pytest.raises(AssertionError, match="stale"):
        t.check_invariants()
    t.page_table[1, 0] = 0
    t._free.append(t._owned[0][0])  # a page both owned and free
    with pytest.raises(AssertionError, match="owned and free"):
        t.check_invariants()


def test_write_token_and_attend_rows_match_the_reference():
    rng = np.random.RandomState(0)
    j, t = _both()
    for c in (j, t):
        c.admit(0, 6)
        c.admit(1, 9)
    nh, H, R = 4, GEOM["hidden"], 6
    kj, vj = j.buffers()
    # rows: slot 0 at positions 3..5, slot 1 at 7, 8; one inactive row
    slots = [0, 0, 0, 1, 1, None]
    pos = np.array([3, 4, 5, 7, 8, 0], np.int32)
    rows = j.rows_for(slots)
    for layer in range(GEOM["num_layers"]):
        k_new = rng.randn(R, H).astype(np.float32)
        v_new = rng.randn(R, H).astype(np.float32)
        kj, vj = j.write_token(kj, vj, layer, jnp.asarray(k_new),
                               jnp.asarray(v_new), jnp.asarray(rows),
                               jnp.asarray(pos))
        t.write_token(layer, torch.from_numpy(k_new),
                      torch.from_numpy(v_new), torch.from_numpy(rows),
                      torch.from_numpy(pos))
    # scratch page 0 takes the inactive row's write; every other page
    # must hold exactly the reference's bits
    np.testing.assert_array_equal(t.k.numpy()[:, 1:], np.asarray(kj)[:, 1:])
    np.testing.assert_array_equal(t.v.numpy()[:, 1:], np.asarray(vj)[:, 1:])
    q = rng.randn(R, H).astype(np.float32)
    lens = np.where(np.array([s is not None for s in slots]),
                    pos + 1, 0).astype(np.int32)
    for bm, tab in ((1, rows), (2, j.rows_for([0, 1, None]))):
        want = np.asarray(j.attend_rows(
            jnp.asarray(q), kj, vj, 1, jnp.asarray(tab), jnp.asarray(lens),
            nh, 0.5, block_rows=bm))
        for reference in (False, True):
            got = t.attend_rows(torch.from_numpy(q), 1,
                                torch.from_numpy(tab),
                                torch.from_numpy(lens), nh, 0.5,
                                block_rows=bm, reference=reference)
            np.testing.assert_allclose(got.numpy(), want, rtol=2e-5,
                                       atol=2e-6)


def test_prefix_cache_is_a_later_slice():
    """The prefix cache came with the second slice of the port, the
    cross-process page export/import of the cluster handoff with a later
    one: on a prefix-cache pool an import then export gives the JAX
    cache's arrays and pools (tests/test_torch_handoff.py holds the
    handoff fully)."""
    j, t = JCache(**GEOM, prefix_cache=True), PagedKVCache(
        **GEOM, prefix_cache=True, device="cpu")
    assert t.prefix_cache and t.prefix_counters()["lookups"] == 0
    kv = np.random.RandomState(5).standard_normal(
        (2, GEOM["num_layers"], 5, GEOM["hidden"])).astype(np.float32)
    for c in (j, t):
        c.admit(0, 5, tokens=np.arange(5))
        c.import_span(0, 0, kv[0], kv[1])
    for got, want in zip(t.export_seq(0, 5), j.export_seq(0, 5)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(t.k.numpy(), np.asarray(j.k))
    assert t.prefix_counters() == j.prefix_counters()


def test_cache_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    """``device=None`` is the card, as for the engine: with no card
    visible the cache raises rather than build CPU tensors silently."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PagedKVCache(**GEOM)
    assert PagedKVCache(**GEOM, device="cpu").k.device.type == "cpu"
