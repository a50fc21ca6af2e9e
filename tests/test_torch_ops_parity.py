"""Ops and constructors where the port once parted from the JAX package,
held against it on the CPU: a reduce over an empty ``dim``, a squeeze of
an axis whose size is not 1, and the constructor keywords
``NgramDrafter(max_seqs=...)`` and ``AdamOptimizer(lazy_mode=...)``
(its lazy mode on dense and sparse gradients).

Tolerance: exact — the reductions here are identities or sums of a few
small integers in float32.
"""
import numpy as np
import pytest

import paddle_tpu as jpt
import paddle_tpu_torch as pt
from paddle_tpu.generation.drafter import NgramDrafter as JNgramDrafter
from paddle_tpu_torch.generation.drafter import NgramDrafter


def _run(pkg, build, feed):
    """Build ``build(pkg, x)`` on a data var shaped like ``feed``, run it
    through the package's Executor on the CPU; (declared shape, value)."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.data("x", list(feed.shape))
        y = build(pkg, x)
    if pkg is pt:
        exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
        (got,) = exe.run(main, feed={"x": feed}, fetch_list=[y],
                         scope=scope)
    else:
        with jpt.scope_guard(jpt.Scope()):
            (got,) = jpt.Executor().run(main, feed={"x": feed},
                                        fetch_list=[y])
    return tuple(y.shape), np.asarray(got)


X = np.arange(12, dtype=np.float32).reshape(3, 4)


@pytest.mark.parametrize("keep_dim", [False, True])
@pytest.mark.parametrize("op", ["reduce_sum", "reduce_mean"])
@pytest.mark.parametrize("dim", [[], [0], [-1], [0, 1]],
                         ids=["empty", "0", "-1", "both"])
def test_reduce_matches_the_jax_package(op, dim, keep_dim):
    def build(pkg, x):
        return getattr(pkg.layers, op)(x, dim=dim, keep_dim=keep_dim)

    shape, got = _run(pt, build, X)
    jshape, want = _run(jpt, build, X)
    if not dim:                  # an empty dim reduces nothing
        np.testing.assert_array_equal(got, X)
        assert shape == X.shape
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert shape == jshape


@pytest.mark.parametrize("shape,axes", [
    ((2, 1, 4), [1]), ((1, 3, 1), [0, 2]), ((1, 3, 1), [-1]),
    ((1, 3, 1), None)], ids=["middle", "two", "negative", "all"])
def test_squeeze_matches_the_jax_package(shape, axes):
    x = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)

    def build(pkg, v):
        return pkg.layers.squeeze(v, axes=axes)

    got_shape, got = _run(pt, build, x)
    want_shape, want = _run(jpt, build, x)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert got_shape == want_shape


@pytest.mark.parametrize("axes", [[0], [2], [0, 1]])
def test_squeeze_of_an_axis_not_one_raises_in_both(axes):
    x = np.zeros((2, 1, 4), np.float32)

    def build(pkg, v):
        return pkg.layers.squeeze(v, axes=axes)

    with pytest.raises(ValueError):
        _run(jpt, build, x)
    with pytest.raises(ValueError, match=r"axis \d has size [24]"):
        _run(pt, build, x)


def test_ngram_drafter_takes_max_seqs_like_the_jax_package():
    history = [5, 6, 7, 5, 6]
    drafts = []
    for cls in (NgramDrafter, JNgramDrafter):
        d = cls(max_n=2, max_seqs=4)
        assert d.max_n == 2
        d.admit(0, history)
        drafts.append(list(d.draft(0, 2)))
    assert drafts[0] == drafts[1] == [7, 5]


@pytest.mark.parametrize("lazy_mode", [False, None])
def test_adam_takes_lazy_mode_false_like_the_jax_package(lazy_mode):
    kw = {} if lazy_mode is None else {"lazy_mode": lazy_mode}
    feed = np.random.RandomState(0).randn(5, 6).astype(np.float32)
    ops = []
    for pkg in (pt, jpt):
        main, startup = pkg.Program(), pkg.Program()
        startup.random_seed = 3
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            x = pkg.data("x", [None, 6])
            loss = pkg.layers.mean(pkg.layers.fc(x, 3))
            pkg.optimizer.AdamOptimizer(0.01, **kw).minimize(loss)
        ops.append([o.type for o in main.global_block().ops])
    assert ops[0] == ops[1]


def test_adam_lazy_mode_true_is_refused_until_sparse_gradients():
    """``lazy_mode=True`` is taken as the JAX package takes it: on a
    dense gradient it changes nothing (the same ``adam`` ops as
    ``lazy_mode=False``); on an ``is_sparse`` table it marks the
    ``adam_sparse`` op lazy."""
    for sparse in (False, True):
        ops = []
        for pkg in (pt, jpt):
            main, startup = pkg.Program(), pkg.Program()
            with pkg.program_guard(main, startup), pkg.unique_name.guard():
                ids = pkg.data("ids", [4, 1], "int64")
                emb = pkg.layers.embedding(ids, (10, 6), is_sparse=sparse)
                loss = pkg.layers.mean(pkg.layers.fc(emb, 3))
                pkg.optimizer.AdamOptimizer(0.01, lazy_mode=True) \
                    .minimize(loss)
            ops.append([(o.type, o.attrs.get("lazy_mode"))
                        for o in main.global_block().ops
                        if o.type.startswith("adam")])
        assert ops[0] == ops[1]
        assert ops[0][0] == (("adam_sparse", True) if sparse
                             else ("adam", None))
