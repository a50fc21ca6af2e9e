"""The port's sequence ops (ops/sequence.py, all 15) and ``cos_sim``
against the JAX package on the CPU, and the host-side ``lod`` copy.

Each case of ``chip_smoke.SEQ_OP_CASES`` (the table phase 21c runs on
the card) goes through both registries on the same numpy-seeded inputs:
outputs within 1e-5 (integers equal), and the gradients of every float
input under the same output cotangents within 1e-4 (``jax.vjp`` against
``torch.autograd.grad``).  The edge cases: a MAX tie (jnp.max splits the
gradient evenly between tied maxima) and a length-0 row (finfo.min), a
window of 4 (contextStart -2), scatter ids repeated, negative and out of
range (dropped), slices that start past the row.  Then the sequence
layers build the JAX package's program, op for op and name for name.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke as cs
import paddle_tpu as jpt
import paddle_tpu_torch as pt
from paddle_tpu.core.registry import REGISTRY as JREG
from paddle_tpu.core.registry import OpContext as JCtx

FWD = dict(rtol=cs.SEQ_OP_FWD_TOL, atol=cs.SEQ_OP_FWD_TOL)
GRAD = dict(rtol=cs.SEQ_OP_GRAD_TOL, atol=cs.SEQ_OP_GRAD_TOL)


def _listed(v):
    return v if isinstance(v, list) else [v]


def jax_op_run(name):
    """The case through the JAX package's op: outputs (numpy, slot ->
    list) and the gradient of each differentiated input slot under the
    case's cotangents (cs.seq_cotangent), as cs.seq_op_run gives the
    port's."""
    op_type, _, attrs, grad_slots, cot_slots = cs.SEQ_OP_CASES[name]
    arrays = cs.seq_case_arrays(name)
    keys = [(slot, i) for slot, v in arrays.items() if slot in grad_slots
            for i in range(len(_listed(v)))]

    def inputs(vals):
        got = dict(zip(keys, vals))
        return {slot: [got.get((slot, i), jnp.asarray(a))
                       for i, a in enumerate(_listed(v))]
                for slot, v in arrays.items()}

    def compute(*vals):
        return JREG.get(op_type).compute(JCtx(attrs=attrs), inputs(vals),
                                         attrs)

    primals = [jnp.asarray(_listed(arrays[s])[i]) for s, i in keys]
    shapes = jax.eval_shape(compute, *primals)
    picked = [(slot, i) for slot in sorted(shapes)
              if cot_slots is None or slot in cot_slots
              for i, t in enumerate(shapes[slot])
              if jnp.issubdtype(t.dtype, jnp.floating)]
    cots = tuple(jnp.asarray(cs.seq_cotangent(
        name, s, i, shapes[s][i].shape)) for s, i in picked)

    def forward_and_pullback(*v):
        if not (keys and picked):
            return compute(*v), ()
        res, vjp = jax.vjp(compute, *v)
        full = jax.tree_util.tree_map(jnp.zeros_like, res)
        for (s, i), c in zip(picked, cots):
            full[s][i] = c
        return res, vjp(full)

    res, grads = jax.jit(forward_and_pullback)(*primals)
    fwd = {slot: [np.asarray(t) for t in ts] for slot, ts in res.items()}
    back = {}
    for (slot, _), g in zip(keys, grads):
        back.setdefault(slot, []).append(np.asarray(g))
    return fwd, back


def check_against_jax(name):
    fwd, back = cs.seq_op_run(name, torch.device("cpu"))
    jfwd, jback = jax_op_run(name)
    assert sorted(fwd) == sorted(jfwd)
    for slot in jfwd:
        for got, want in zip(fwd[slot], jfwd[slot]):
            assert got.shape == want.shape, (slot, got.shape, want.shape)
            if np.issubdtype(want.dtype, np.floating):
                np.testing.assert_allclose(got, want, err_msg=slot, **FWD)
            else:
                np.testing.assert_array_equal(got, want, err_msg=slot)
    assert sorted(back) == sorted(jback)
    for slot in jback:
        for got, want in zip(back[slot], jback[slot]):
            np.testing.assert_allclose(got, want, err_msg=f"d{slot}",
                                       **GRAD)


SEQ_CASES = sorted(n for n, c in cs.SEQ_OP_CASES.items()
                   if c[0].startswith("sequence_") or c[0] == "cos_sim")


@pytest.mark.parametrize("name", SEQ_CASES)
def test_op_matches_the_jax_package(name):
    check_against_jax(name)


def test_the_table_covers_every_sequence_op_and_cos_sim():
    from paddle_tpu.ops import sequence as jseq

    names = {c[0] for c in cs.SEQ_OP_CASES.values()}
    want = {n for n in JREG._ops if JREG.get(n).compute.__module__
            == jseq.__name__} | {"cos_sim"}
    assert len(want) == 16 and want <= names


def test_max_pool_tie_and_empty_row():
    """Row 0's steps 0 and 2 tie at 5.0: each takes half the gradient;
    row 1 (length 0) pools to finfo.min and takes none."""
    fwd, back = cs.seq_op_run("sequence_pool_max", torch.device("cpu"))
    out = fwd["Out"][0]
    assert np.all(out[0] == 5.0)
    assert np.all(out[1] == np.finfo(np.float32).min)
    cot = cs.seq_cotangent("sequence_pool_max", "Out", 0, out.shape)
    dx = back["X"][0]
    np.testing.assert_allclose(dx[0, 0], cot[0] / 2, rtol=1e-6)
    np.testing.assert_allclose(dx[0, 2], cot[0] / 2, rtol=1e-6)
    assert not dx[1].any()


def test_window_of_four_starts_two_back():
    """contextStart defaults to -(4 - 1) // 2 = -2: step t's window is
    t-2 .. t+1, the filter's first block reading two steps back."""
    op = cs.SEQ_OP_CASES["sequence_conv_4"]
    x = np.zeros((1, 5, 1), np.float32)
    x[0, 0, 0] = 1.0
    ins = {"X": [torch.as_tensor(x)], "SeqLen": [torch.tensor([5])],
           "Filter": [torch.tensor([[1.0], [0.0], [0.0], [0.0]])]}
    from paddle_tpu_torch.core import REGISTRY

    y = REGISTRY.get(op[0]).compute(None, ins, op[2])["Out"][0]
    assert y[0, :, 0].tolist() == [0.0, 0.0, 1.0, 0.0, 0.0]


def test_scatter_drops_out_of_range_ids():
    fwd, _ = cs.seq_op_run("sequence_scatter", torch.device("cpu"))
    arr = cs.seq_case_arrays("sequence_scatter")
    want = arr["X"].copy()
    T = want.shape[1]
    for b in range(want.shape[0]):
        for k, i in enumerate(arr["Ids"][b]):
            if -T <= i < T:
                want[b, i] += arr["Updates"][b, k]
    np.testing.assert_allclose(fwd["Out"][0], want, rtol=1e-6)


# -- layers ------------------------------------------------------------------

def _seq_program(pkg):
    """Every sequence layer of both packages over one padded batch."""
    L = pkg.layers
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.data("x", [None, 6, 4])
        n = pkg.data("n", [None], "int64")
        ids = pkg.data("ids", [None, 6], "int64")
        outs = [L.sequence_pool(x, p, seq_len=n)
                for p in ("sum", "average", "sqrt", "max")]
        outs += [L.sequence_first_step(x, seq_len=n),
                 L.sequence_last_step(x, seq_len=n),
                 L.sequence_reverse(x, seq_len=n),
                 L.sequence_conv(x, 3, filter_size=4, seq_len=n,
                                 act="tanh"),
                 L.sequence_softmax(L.reduce_sum(x, dim=2), seq_len=n),
                 L.sequence_expand_as(L.reduce_sum(x, dim=1), x, seq_len=n),
                 L.sequence_concat(x, n, x, n)[0],
                 L.sequence_mask(n, 6),
                 L.sequence_pad(x, L.fill_constant([1], "float32", 0.5),
                                length=n)[0],
                 L.sequence_unpad(x, n),
                 L.sequence_reshape(x, 8),
                 L.sequence_expand(L.reduce_sum(x, dim=1), x),
                 L.sequence_enumerate(ids, 3),
                 L.sequence_erase(ids, [1, 2]),
                 L.cos_sim(L.reduce_sum(x, dim=1), L.reduce_max(x, dim=1))]
        loss = L.mean(L.concat([L.reshape(o, [-1]) for o in outs
                                if o.dtype == "float32"], axis=0))
    return main, startup, loss, outs


def test_sequence_layers_build_the_jax_program_and_run():
    def ir(program):
        return [(op.type, op.inputs, op.outputs, sorted(op.attrs))
                for op in program.global_block().ops]

    jmain, jstartup, jloss, _ = _seq_program(jpt)
    main, startup, loss, outs = _seq_program(pt)
    assert ir(main) == ir(jmain)
    r = np.random.RandomState(3)
    feed = {"x": r.randn(3, 6, 4).astype(np.float32),
            "n": np.array([6, 2, 1], np.int64),
            "ids": r.randint(0, 5, (3, 6)).astype(np.int64)}
    jscope = jpt.Scope()
    with jpt.scope_guard(jscope):
        jexe = jpt.Executor()
        jexe.run(jstartup)
        weights = {v.name: np.asarray(jscope.find_var(v.name))
                   for v in jmain.list_vars() if v.persistable}
        want = float(jexe.run(jmain, feed=feed, fetch_list=[jloss])[0])
    scope = pt.Scope()
    pt.io.load_params(scope, weights, "cpu", program=main)
    got = float(pt.Executor(pt.CPUPlace()).run(
        main, feed=feed, fetch_list=[loss], scope=scope)[0])
    assert abs(got - want) <= 1e-5, (got, want)


def test_sequence_conv_pool_runs():
    """nets.sequence_conv_pool no longer raises: the JAX package's
    sequence_conv, bias, sigmoid and max sequence_pool ops."""
    types = {}
    for P in (jpt, pt):
        with P.new_program_scope():
            x = P.data("x", [None, 5, 3])
            n = P.data("n", [None], "int64")
            y = P.nets.sequence_conv_pool(x, 4, 3, seq_len=n)
            types[P] = [op.type for op in
                        P.default_main_program().global_block().ops]
            if P is pt:
                exe = pt.Executor(pt.CPUPlace())
                exe.run(pt.default_startup_program())
                out, = exe.run(feed={"x": np.ones((2, 5, 3), np.float32),
                                     "n": np.array([5, 2], np.int64)},
                               fetch_list=[y])
    assert types[pt] == types[jpt] and len(types[pt]) == 4
    assert out.shape == (2, 4) and np.isfinite(out).all()


# -- lod ---------------------------------------------------------------------

def test_lod_matches_the_jax_copy():
    from paddle_tpu import lod as jlod
    from paddle_tpu_torch import lod

    seqs = [np.arange(3), np.arange(5) + 10, np.arange(1) + 20]
    for fn, args in (("pack_sequences", (seqs,)),
                     ("pad_sequences", (seqs,)),
                     ("pad_sequences", (seqs, 4, -1.0)),
                     ("lengths_to_offsets", ([3, 5, 1],)),
                     ("offsets_to_lengths", ([0, 3, 8, 9],))):
        got, want = getattr(lod, fn)(*args), getattr(jlod, fn)(*args)
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            np.testing.assert_array_equal(g, w)
    values = np.arange(18).reshape(9, 2)
    got = lod.create_lod_tensor(values, [[2, 1], [3, 5, 1]])
    want = jlod.create_lod_tensor(values, [[2, 1], [3, 5, 1]])
    np.testing.assert_array_equal(got[0], want[0])
    for g, w in zip(got[1], want[1]):
        np.testing.assert_array_equal(g, w)
    nested = lod.unpack_nested(*got)
    assert [[len(s) for s in outer] for outer in nested] == [[3, 5], [1]]
    placed, offs = lod.create_lod_tensor(values, [[3, 5, 1]],
                                         place=pt.CPUPlace())
    assert torch.is_tensor(placed) and placed.device.type == "cpu"
    np.testing.assert_array_equal(lod.unpack_nested(placed, offs)[1],
                                  values[3:8])
    dense, lens = lod.pad_sequences(seqs)
    for a, b in zip(lod.unpad_sequences(dense, lens), seqs):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="LoD level 0"):
        lod.create_lod_tensor(values, [[2, 2], [3, 5, 1]])
