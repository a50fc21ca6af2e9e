"""The port's recurrent ops (ops/rnn.py ``lstm`` and ``gru``), the 21 ops
of ops/fused.py, and the RNN layers against the JAX package on the CPU.

* Ops: each rnn and fused case of ``chip_smoke.SEQ_OP_CASES`` through both
  registries on the same numpy-seeded inputs (peepholes in a [1, 7H]
  bias, SequenceLength masks with a length-0 row, ``is_reverse``,
  ``origin_mode``, cudnn_lstm's packed blob at two layers): outputs within
  1e-5, gradients within 1e-4.  The refusals stay: cudnn_lstm's
  ``is_bidirec`` and fused_embedding_seq_pool's non-sum combiner.
* Layers: ``dynamic_lstm``, ``dynamic_gru`` and the 2-layer bidirectional
  ``layers.lstm`` build the JAX package's program (op for op, the same
  parameter names, shapes and init ops), and a loss over their outputs
  matches from the JAX startup's weights.
"""
import numpy as np
import pytest
import torch

import chip_smoke as cs
import paddle_tpu as jpt
import paddle_tpu_torch as pt
from paddle_tpu_torch.core import REGISTRY
from paddle_tpu_torch.core.registry import OpContext
from test_torch_sequence_ops import check_against_jax

RNN_CASES = sorted(n for n, c in cs.SEQ_OP_CASES.items()
                   if not (c[0].startswith("sequence_") or c[0] == "cos_sim"))


@pytest.mark.parametrize("name", RNN_CASES)
def test_op_matches_the_jax_package(name):
    check_against_jax(name)


def test_the_table_covers_every_rnn_and_fused_op():
    from paddle_tpu.core.registry import REGISTRY as JREG
    from paddle_tpu.ops import fused as jfused
    from paddle_tpu.ops import rnn as jrnn

    names = {c[0] for c in cs.SEQ_OP_CASES.values()}
    want = {n for n in JREG._ops if JREG.get(n).compute.__module__
            in (jfused.__name__, jrnn.__name__)}
    assert len(want) == 23 and want <= names


def test_padded_steps_carry_the_state():
    """Past a row's length Hidden holds the carried state (not zeros),
    and LastHidden is the state at the row's last live step; reversed,
    LastHidden is the state after time step 0."""
    r = np.random.RandomState(0)
    x = torch.as_tensor(r.randn(2, 5, 16).astype(np.float32))
    w = torch.as_tensor(r.randn(4, 16).astype(np.float32) * 0.5)
    lens = torch.tensor([5, 2])
    for reverse in (False, True):
        attrs = {"is_reverse": reverse}
        res = REGISTRY.get("lstm").compute(
            OpContext(attrs=attrs), {"Input": [x], "Weight": [w],
                                     "SequenceLength": [lens]}, attrs)
        h, last = res["Hidden"][0], res["LastHidden"][0]
        if reverse:
            assert torch.equal(last, h[:, 0])
            # row 1's steps 2.. run first and never start: zero state
            assert not h[1, 2:].any()
        else:
            assert torch.equal(last[1], h[1, 1])
            assert torch.equal(h[1, 4], h[1, 1]) and h[1, 1].abs().sum() > 0


def test_refusals_are_kept():
    x = torch.zeros(2, 1, 3)
    attrs = {"hidden_size": 2, "num_layers": 1, "is_bidirec": True}
    with pytest.raises(NotImplementedError, match="is_bidirec"):
        REGISTRY.get("cudnn_lstm").compute(
            OpContext(attrs=attrs), {"Input": [x], "InitH": [x],
                                     "InitC": [x], "W": [x]}, attrs)
    attrs = {"combiner": "mean"}
    with pytest.raises(NotImplementedError, match="combiner"):
        REGISTRY.get("fused_embedding_seq_pool").compute(
            OpContext(attrs=attrs), {"W": [torch.zeros(3, 2)],
                                     "Ids": [torch.zeros(1, 2).long()]},
            attrs)


# -- layers ------------------------------------------------------------------

B, T, D, H = 3, 6, 5, 4


def _rnn_program(pkg):
    L = pkg.layers
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = 5
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.data("x", [None, T, D])
        n = pkg.data("n", [None], "int64")
        out, last_h, last_c = L.lstm(x, hidden_size=H, num_layers=2,
                                     is_bidirec=True, sequence_length=n)
        proj = L.fc(x, 4 * H, num_flatten_dims=2)
        hid, cell = L.dynamic_lstm(proj, 4 * H, sequence_length=n)
        gproj = L.fc(x, 3 * H, num_flatten_dims=2)
        g = L.dynamic_gru(gproj, H, is_reverse=True, origin_mode=True,
                          sequence_length=n)
        loss = L.mean(L.concat([
            L.reshape(v, [-1]) for v in (out, last_h, last_c, hid, cell,
                                         g)], axis=0))
    return main, startup, loss


def _feed():
    r = np.random.RandomState(9)
    return {"x": r.randn(B, T, D).astype(np.float32),
            "n": np.array([6, 3, 0], np.int64)}


def test_rnn_layers_match_the_jax_package():
    jmain, jstartup, jloss = _rnn_program(jpt)
    main, startup, loss = _rnn_program(pt)

    def ir(program):
        return [(op.type, op.inputs, op.outputs, sorted(op.attrs))
                for op in program.global_block().ops]

    def params(program):
        return [(p.name, list(p.shape))
                for p in program.global_block().all_parameters()]

    assert ir(main) == ir(jmain)
    assert ir(startup) == ir(jstartup)
    assert params(main) == params(jmain)
    names = [p for p, _ in params(main)]
    # layers.lstm's per-layer names, letter for letter
    assert "cudnn_lstm_0.l0.proj_0.w_0" in names
    assert "cudnn_lstm_0.l1_1.w_0" in names, names
    jscope = jpt.Scope()
    with jpt.scope_guard(jscope):
        jexe = jpt.Executor()
        jexe.run(jstartup)
        weights = {v.name: np.asarray(jscope.find_var(v.name))
                   for v in jmain.list_vars() if v.persistable}
        want = jexe.run(jmain, feed=_feed(), fetch_list=[jloss])
    scope = pt.Scope()
    pt.io.load_params(scope, weights, "cpu", program=main)
    got = pt.Executor(pt.CPUPlace()).run(main, feed=_feed(),
                                         fetch_list=[loss], scope=scope)
    np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=1e-5,
                               atol=1e-5)
