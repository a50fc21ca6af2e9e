"""The math and tensor ops the port added for the rest of training, each
against the JAX package's op on the CPU.

Every case feeds the same numpy-seeded inputs to the registered compute
function of both packages (``paddle_tpu.core.registry.REGISTRY`` and the
port's) and compares every output:

* float results within 1e-6 relative: ``|got - want| <= 1e-6 * |want| +
  1e-6 * max|want|`` (the second term covers entries near zero, where a
  relative bound alone would ask for more than float32 carries);
* int and bool results exactly, with an integer dtype on both sides for
  an integer result (the JAX package holds int64 in 32 bits, the port in
  64) and bool for bool.

The cases cover broadcasting ``axis``, ``keep_dim``, ``reduce_all``, an
empty ``dim`` and negative axes.  A last test builds the new layers into
one program in both packages and compares the two ``to_dict`` descs.
"""
import json
import zlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as jpt
import paddle_tpu_torch as pt
from paddle_tpu.core.registry import REGISTRY as JREG
from paddle_tpu.core.registry import OpContext as JCtx
from paddle_tpu_torch.core.registry import REGISTRY as PREG
from paddle_tpu_torch.core.registry import OpContext as PCtx

RTOL = 1e-6


def _f(r, *shape, lo=-1.0, hi=1.0):
    return (lo + (hi - lo) * r.rand(*shape)).astype(np.float32)


def _i(r, *shape, hi=5):
    return r.randint(0, hi, shape).astype(np.int64)


def _x(fn):
    """A one-input (slot X) case builder."""
    return lambda r: {"X": [fn(r)]}


def _xy(fx, fy):
    return lambda r: {"X": [fx(r)], "Y": [fy(r)]}


def _pos(r):
    return _f(r, 3, 4, 5, lo=0.2, hi=3.0)


def _unit(r):
    return _f(r, 3, 4, 5, lo=-0.95, hi=0.95)


def _wide(r):
    return _f(r, 3, 4, 5, lo=-4.0, hi=4.0)


# name -> (op type, inputs builder, attrs)
CASES = {}

# -- elementwise binary ops, broadcasting axis and scalar operands ---------
for _op in ("min", "pow", "mod", "floordiv"):
    _lo = 0.5 if _op == "pow" else -3.0
    CASES[f"elementwise_{_op}"] = (
        f"elementwise_{_op}",
        _xy(lambda r, lo=_lo: _f(r, 3, 4, 5, lo=lo, hi=3.0),
            lambda r: _f(r, 3, 4, 5, lo=0.5, hi=2.0)), {"axis": -1})
    CASES[f"elementwise_{_op}_axis1"] = (
        f"elementwise_{_op}",
        _xy(lambda r, lo=_lo: _f(r, 3, 4, 5, lo=lo, hi=3.0),
            lambda r: _f(r, 4, lo=0.5, hi=2.0)), {"axis": 1})
    CASES[f"elementwise_{_op}_scalar"] = (
        f"elementwise_{_op}", _x(lambda r, lo=_lo: _f(r, 3, 4, lo=lo,
                                                      hi=3.0)),
        {"axis": -1, "scalar_y": 1.5})
for _op in ("min", "mod", "floordiv"):
    CASES[f"elementwise_{_op}_int"] = (
        f"elementwise_{_op}",
        _xy(lambda r: r.randint(-9, 9, (4, 6)).astype(np.int64),
            lambda r: r.randint(1, 4, (6,)).astype(np.int64)), {"axis": -1})
CASES["elementwise_pow_int"] = (
    "elementwise_pow", _xy(lambda r: _i(r, 4, 6, hi=6),
                           lambda r: _i(r, 4, 6, hi=4)), {"axis": -1})

# -- clipping and norms ----------------------------------------------------
CASES["clip"] = ("clip", _x(_wide), {"min": -1.5, "max": 2.0})
CASES["clip_max_only"] = ("clip", _x(_wide), {"max": 0.5})
CASES["clip_by_norm_clipped"] = ("clip_by_norm", _x(_wide),
                                 {"max_norm": 1.0})
CASES["clip_by_norm_kept"] = ("clip_by_norm", _x(_unit), {"max_norm": 1e3})
CASES["squared_l2_norm"] = ("squared_l2_norm", _x(_wide), {})
CASES["frobenius_norm"] = ("frobenius_norm", _x(_wide), {})
CASES["maximum_eps"] = ("maximum_eps", _x(lambda r: _f(r, 4, 6) * 1e-11),
                        {"eps": 1e-12})

# -- reductions ------------------------------------------------------------
_REDUCE_ATTRS = {
    "all_axes": {"reduce_all": True, "keep_dim": False},
    "all_axes_keep": {"reduce_all": True, "keep_dim": True},
    "dim1": {"dim": [1], "keep_dim": False},
    "dim_neg1_keep": {"dim": [-1], "keep_dim": True},
    "dims_0_2": {"dim": [0, 2], "keep_dim": False},
    "dims_neg": {"dim": [-3, -1], "keep_dim": True},
    "dim_empty": {"dim": [], "keep_dim": False},
}
for _op in ("max", "min", "prod"):
    for _k, _a in _REDUCE_ATTRS.items():
        CASES[f"reduce_{_op}_{_k}"] = (
            f"reduce_{_op}", _x(lambda r: _f(r, 3, 4, 5, lo=0.5, hi=1.5)),
            _a)
for _op in ("all", "any"):
    for _k in ("all_axes", "dim1", "dims_neg", "dim_empty"):
        CASES[f"reduce_{_op}_{_k}"] = (
            f"reduce_{_op}", _x(lambda r: r.rand(3, 4, 5) < 0.8),
            _REDUCE_ATTRS[_k])
    CASES[f"reduce_{_op}_float"] = (
        f"reduce_{_op}",
        _x(lambda r: (r.rand(3, 4) < 0.7).astype(np.float32)),
        {"dim": [1], "keep_dim": False})

# -- unary math and activations --------------------------------------------
_DOMAIN = {"log": _pos, "log2": _pos, "log10": _pos, "log1p": _pos,
           "sqrt": _pos, "rsqrt": _pos, "reciprocal": _pos, "asin": _unit,
           "acos": _unit}
_UNARY_ATTRS = {"leaky_relu": {"alpha": 0.1}, "elu": {"alpha": 0.7},
                "relu6": {"threshold": 2.0}, "swish": {"beta": 1.3},
                "hard_sigmoid": {"slope": 0.3, "offset": 0.4},
                "thresholded_relu": {"threshold": 0.5},
                "hard_shrink": {"threshold": 0.7},
                "soft_shrink": {"lambda": 0.3},
                "stanh": {"scale_a": 0.5, "scale_b": 1.2},
                "gelu": {"approximate": True}}
for _op in ("sigmoid", "tanh", "exp", "log", "log2", "log10", "log1p",
            "sqrt", "rsqrt", "square", "abs", "ceil", "floor", "round",
            "reciprocal", "sign", "sin", "cos", "tan", "asin", "acos",
            "atan", "sinh", "cosh", "erf", "leaky_relu", "elu", "softplus",
            "softsign", "relu6", "swish", "hard_sigmoid", "hard_swish",
            "logsigmoid", "thresholded_relu", "hard_shrink", "soft_shrink",
            "stanh"):
    CASES[_op] = (_op, _x(_DOMAIN.get(_op, _wide)), {})
    if _op in _UNARY_ATTRS:
        CASES[f"{_op}_attrs"] = (_op, _x(_wide), _UNARY_ATTRS[_op])
CASES["gelu_tanh"] = ("gelu", _x(_wide), {"approximate": True})
CASES["softplus_large"] = ("softplus", _x(lambda r: _f(r, 4, 6, lo=-40.,
                                                       hi=40.)), {})
CASES["round_halves"] = ("round", _x(lambda r: np.array(
    [-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 3.5], np.float32)), {})
CASES["pow"] = ("pow", _x(_pos), {"factor": 2.5})

# -- comparisons, logical ops, isfinite ------------------------------------
_ints = _xy(lambda r: _i(r, 4, 6, hi=4), lambda r: _i(r, 4, 6, hi=4))
for _op in ("equal", "not_equal", "less_than", "less_equal",
            "greater_than", "greater_equal"):
    CASES[_op] = (_op, _ints, {})
    CASES[f"{_op}_float_scalar"] = (_op, _x(lambda r: np.round(
        _f(r, 4, 6, lo=-2., hi=2.) * 2) / 2), {"scalar_y": 0.5})
_bools = _xy(lambda r: r.rand(4, 6) < 0.5, lambda r: r.rand(4, 6) < 0.5)
for _op in ("logical_and", "logical_or", "logical_xor"):
    CASES[_op] = (_op, _bools, {})
CASES["logical_not"] = ("logical_not", _x(lambda r: r.rand(4, 6) < 0.5), {})
CASES["isfinite_true"] = ("isfinite", _x(_wide), {})
CASES["isfinite_false"] = ("isfinite", _x(lambda r: np.where(
    r.rand(4, 6) < 0.1, np.inf, _f(r, 4, 6)).astype(np.float32)), {})

# -- softmax family and index ops ------------------------------------------
CASES["log_softmax"] = ("log_softmax", _x(_wide), {"axis": -1})
CASES["log_softmax_axis1"] = ("log_softmax", _x(_wide), {"axis": 1})
_ties = _x(lambda r: _i(r, 4, 7, hi=3).astype(np.float32))
for _op in ("arg_max", "arg_min"):
    CASES[f"{_op}"] = (_op, _x(_wide), {"axis": 1})
    CASES[f"{_op}_neg_ties"] = (_op, _ties, {"axis": -1})
CASES["top_k"] = ("top_k", _x(lambda r: _f(r, 5, 9)), {"k": 3})
for _k, _a in {"axis0": {"axis": 0}, "axis_neg1": {"axis": -1},
               "exclusive": {"axis": 1, "exclusive": True},
               "reverse": {"axis": -1, "reverse": True},
               "exclusive_reverse": {"axis": 0, "exclusive": True,
                                     "reverse": True}}.items():
    CASES[f"cumsum_{_k}"] = ("cumsum", _x(lambda r: _f(r, 4, 6)), _a)

# -- tensor ops ------------------------------------------------------------
_three = lambda r: {"X": [_f(r, 2, 3), _f(r, 2, 3), _f(r, 2, 3)]}  # noqa
CASES["concat_axis0"] = ("concat", lambda r: {"X": [_f(r, 2, 3),
                                                    _f(r, 4, 3)]},
                         {"axis": 0})
CASES["concat_axis_neg1"] = ("concat", lambda r: {"X": [_f(r, 2, 3),
                                                        _f(r, 2, 1)]},
                             {"axis": -1})
CASES["split_num"] = ("split", _x(lambda r: _f(r, 4, 6)),
                      {"num": 3, "axis": 1})
CASES["split_sections_neg"] = ("split", _x(lambda r: _f(r, 4, 6)),
                               {"sections": [1, 3, 2], "axis": -1})
CASES["stack_axis0"] = ("stack", _three, {"axis": 0})
CASES["stack_axis_neg1"] = ("stack", _three, {"axis": -1})
CASES["unstack_axis1"] = ("unstack", _x(lambda r: _f(r, 2, 3, 4)),
                          {"axis": 1})
CASES["unstack_axis_neg1"] = ("unstack", _x(lambda r: _f(r, 2, 3, 4)),
                              {"axis": -1})
CASES["expand"] = ("expand", _x(lambda r: _f(r, 2, 1, 3)),
                   {"expand_times": [1, 4, 2]})
CASES["gather_axis0"] = ("gather", lambda r: {
    "X": [_f(r, 5, 3)], "Index": [np.array([4, 0, 2, 2], np.int32)]},
    {"axis": 0})
CASES["gather_axis1_2d_index"] = ("gather", lambda r: {
    "X": [_f(r, 2, 5, 3)], "Index": [np.array([[1, 3], [0, 4]], np.int32)]},
    {"axis": 1})
CASES["gather_scalar_index"] = ("gather", lambda r: {
    "X": [_f(r, 5)], "Index": [np.array(3, np.int32)]}, {"axis": 0})
CASES["gather_int"] = ("gather", lambda r: {
    "X": [_i(r, 6, 2, hi=50)], "Index": [np.array([5, 1], np.int32)]}, {})
CASES["scatter_overwrite"] = ("scatter", lambda r: {
    "X": [_f(r, 6, 3)], "Ids": [np.array([4, 0, 2], np.int32)],
    "Updates": [_f(r, 3, 3)]}, {"overwrite": True})
CASES["scatter_add"] = ("scatter", lambda r: {
    "X": [_f(r, 6, 3)], "Ids": [np.array([4, 0, 4], np.int32)],
    "Updates": [_f(r, 3, 3)]}, {"overwrite": False})
CASES["one_hot"] = ("one_hot", _x(lambda r: _i(r, 6, 1, hi=4)),
                    {"depth": 5})
CASES["one_hot_out_of_range"] = ("one_hot", _x(lambda r: np.array(
    [[0], [4], [7], [-1]], np.int64)), {"depth": 5})
CASES["shape"] = ("shape", lambda r: {"Input": [_f(r, 2, 3, 4)]}, {})
CASES["fill_constant_batch_size_like"] = (
    "fill_constant_batch_size_like", lambda r: {"Input": [_f(r, 7, 3)]},
    {"shape": [-1, 4], "dtype": "float32", "value": 2.5,
     "input_dim_idx": 0, "output_dim_idx": 0})
CASES["fill_constant_batch_size_like_int"] = (
    "fill_constant_batch_size_like", lambda r: {"Input": [_f(r, 2, 7)]},
    {"shape": [3, -1], "dtype": "int64", "value": 9,
     "input_dim_idx": 1, "output_dim_idx": 1})
for _k, _a in {"lower": {"lower": True, "diagonal": 0},
               "lower_diag_neg1": {"lower": True, "diagonal": -1},
               "upper_diag1": {"lower": False, "diagonal": 1}}.items():
    CASES[f"tril_triu_{_k}"] = ("tril_triu", _x(lambda r: _f(r, 2, 4, 5)),
                                _a)
CASES["pad"] = ("pad", _x(lambda r: _f(r, 2, 3)),
                {"paddings": [1, 0, 2, 3], "pad_value": -1.5})
CASES["where"] = ("where", lambda r: {
    "Condition": [r.rand(4, 5) < 0.5], "X": [_f(r, 4, 5)],
    "Y": [_f(r, 4, 5)]}, {})
CASES["increment_int"] = ("increment", _x(lambda r: np.array(
    41, np.int64)), {"step": 1.0})
CASES["increment_float"] = ("increment", _x(lambda r: _f(r, 3)),
                            {"step": 0.25})
CASES["sum_three"] = ("sum", _three, {})
CASES["assign_value"] = ("assign_value", lambda r: {}, {
    "shape": [2, 3], "dtype": "float32",
    "values": _f(np.random.RandomState(5), 2, 3)})
CASES["assign_value_int"] = ("assign_value", lambda r: {}, {
    "shape": [4], "dtype": "int32", "values": [3, 1, 4, 1]})


def _jax_compute(op, ins, attrs):
    if op == "assign_value":
        import paddle_tpu.initializer  # noqa: F401  (registers it)
    ctx = JCtx(rng=None, is_test=False, attrs=attrs)
    jins = {s: [jnp.asarray(v) for v in vals] for s, vals in ins.items()}
    return JREG.get(op).compute(ctx, jins, attrs)


def _port_compute(op, ins, attrs):
    ctx = PCtx(rng=None, is_test=False, attrs=attrs,
               device=torch.device("cpu"))
    pins = {s: [torch.from_numpy(np.array(v)) for v in vals]
            for s, vals in ins.items()}
    with torch.no_grad():
        return PREG.get(op).compute(ctx, pins, attrs)


def _check(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.dtype == np.bool_:
        assert got.dtype == np.bool_, (what, got.dtype)
        np.testing.assert_array_equal(got, want, err_msg=what)
    elif np.issubdtype(want.dtype, np.integer):
        assert np.issubdtype(got.dtype, np.integer), (what, got.dtype)
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
        scale = float(np.abs(want).max()) if want.size else 0.0
        np.testing.assert_allclose(got, want, rtol=RTOL,
                                   atol=RTOL * scale, err_msg=what)


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_matches_the_jax_op(name):
    op, build, attrs = CASES[name]
    ins = build(np.random.RandomState(zlib.crc32(name.encode())))
    want = _jax_compute(op, ins, attrs)
    got = _port_compute(op, ins, attrs)
    assert set(got) == set(want), (set(got), set(want))
    for slot in want:
        assert len(got[slot]) == len(want[slot]), slot
        for j, (g, w) in enumerate(zip(got[slot], want[slot])):
            _check(g.numpy(), w, f"{name}:{slot}[{j}]")


def _layers_program(P):
    """The new layers, their generated unary/binary siblings and the
    Variable operators, in one program."""
    main, startup = P.Program(), P.Program()
    with P.program_guard(main, startup), P.unique_name.guard():
        L = P.layers
        x = P.data("x", [4, 6])
        ids = P.data("ids", [4, 1], "int64")
        a, b = L.split(x, 2, dim=-1)
        c = L.concat([a, b], axis=1)
        s = L.stack([a, b], axis=0)
        u = L.unstack(s, axis=0)
        e = L.expand(a, [1, 2])
        v, i = L.topk(x, 2)
        am = L.argmax(x, axis=-1)
        L.argmin(x, axis=0)
        oh = L.one_hot(ids, 5)
        g = L.gather(x, L.cast(am, "int32"))
        L.scatter(x, L.assign(np.array([0, 2], np.int32)),
                  L.slice(x, [0], [1], [3]))
        L.clip(c, -0.5, 0.5)
        L.clip_by_norm(e, 1.0)
        L.cumsum(x, axis=-1, exclusive=True)
        L.pad(x, [0, 1, 1, 0])
        L.where(L.greater_than(x, 0.0), x, L.zeros_like(x))
        L.ones_like(x)
        L.shape(x)
        L.pow(L.abs(x), 2.0)
        L.fill_constant_batch_size_like(x, [-1, 3], "float32", 1.0)
        L.reduce_max(x, dim=[1], keep_dim=True)
        L.reduce_prod(u[0], dim=-1)
        L.reduce_any(L.less_than(x, 0.0))
        L.elementwise_min(x, g)
        L.elementwise_pow(L.sqrt(L.abs(x)), 2.0)
        y = (x + 1.0) * 2.0 - x / 3.0
        y = -(y ** 2.0) + 1.0 / (x * x + 1.0)
        L.log_softmax(y)
        L.logical_and(x > y, x <= 2.0 * y)
        L.ones([2], "float32")
        L.zeros([2], "int64")
        L.uniform_random([2, 3], min=-0.5, max=0.5)
        L.gaussian_random_batch_size_like(x, [-1, 2], std=0.5)
        L.increment(L.fill_constant([], "int64", 0))
        L.reduce_sum(oh)
        L.cast(i, "float32")
    return main


def narrowed(desc):
    """A program desc with int64 variables read as int32: shape inference
    declares an op's int64 result int32 in the JAX package (its runtime
    dtype there), int64 in the port."""
    desc = json.loads(json.dumps(desc))
    for blk in desc["blocks"]:
        for v in blk["vars"]:
            if v["dtype"] == "int64":
                v["dtype"] = "int32"
    return desc


def test_layers_build_the_jax_packages_program():
    """Same ops, slots, attrs, variable names, shapes and dtypes (the
    JSON descs of both packages' programs are equal, up to the int64
    narrowing)."""
    want = _layers_program(jpt).to_dict()
    got = _layers_program(pt).to_dict()
    assert narrowed(got) == narrowed(want)


def test_variable_bool_raises():
    with pt.new_program_scope():
        x = pt.data("x", [2])
        with pytest.raises(TypeError, match="undefined in a static graph"):
            bool(x > 0.0)


# -- the faults closed against the reference: ties, NaN, out-of-range
# indices, integer means, saturating casts, gradients at kinks ----------
#
# Each case fed the port a value the earlier random cases never did (a
# tie, a NaN, an index out of range, a point on a kink).  Values are
# compared as above, NaN equal to NaN; the sign of a zero is compared
# too; gradients within 1e-6.

_NAN, _INF = float("nan"), float("inf")

FAULT_CASES = {
    "top_k_ties": ("top_k", {"X": [np.array([[0, 0, 0, 0], [1, 1, 2, 2]],
                                            np.float32)]}, {"k": 2}),
    "top_k_ties_int32": ("top_k", {"X": [np.array([[5, 5, 5, 1]],
                                                  np.int32)]}, {"k": 3}),
    "gather_wraps_and_fills": ("gather", {
        "X": [np.arange(8, dtype=np.float32).reshape(4, 2)],
        "Index": [np.array([-1, 5, -5, 0, -4], np.int32)]}, {"axis": 0}),
    "gather_fills_axis1": ("gather", {
        "X": [np.arange(12, dtype=np.float32).reshape(2, 3, 2)],
        "Index": [np.array([[3, -3], [-4, 2]], np.int64)]}, {"axis": 1}),
    "gather_fills_int32": ("gather", {
        "X": [np.arange(8, dtype=np.int32).reshape(4, 2)],
        "Index": [np.array([-1, 5, -5, 0], np.int32)]}, {"axis": 0}),
    "gather_fills_uint8": ("gather", {
        "X": [np.arange(8, dtype=np.uint8).reshape(4, 2)],
        "Index": [np.array([5, 1], np.int32)]}, {"axis": 0}),
    "gather_fills_bool": ("gather", {
        "X": [np.array([True, False, False])],
        "Index": [np.array([4, 1, -1], np.int32)]}, {"axis": 0}),
    "lookup_table_wraps_and_fills": ("lookup_table", {
        "W": [np.arange(12, dtype=np.float32).reshape(4, 3)],
        "Ids": [np.array([[-1], [4], [0], [-5], [2]], np.int64)]}, {}),
    "lookup_table_fills_padding_idx": ("lookup_table", {
        "W": [np.arange(12, dtype=np.float32).reshape(4, 3)],
        "Ids": [np.array([[1, 7], [-2, 1]], np.int64)]}, {"padding_idx": 1}),
    "sign_nan_and_signed_zero": ("sign", {"X": [np.array(
        [_NAN, -0.0, 0.0, -2.5, 3.0, -_INF], np.float32)]}, {}),
    "mean_int32": ("mean", {"X": [np.array([[1, 2], [3, 5]], np.int32)]},
                   {}),
    "mean_bool": ("mean", {"X": [np.array([True, False, True])]}, {}),
    "reduce_mean_int32": ("reduce_mean", {"X": [np.array([[1, 2]],
                                                         np.int32)]},
                          {"dim": [1], "keep_dim": False}),
    "reduce_mean_int64_all": ("reduce_mean", {"X": [np.array(
        [[1, 2], [4, 4]], np.int64)]}, {"reduce_all": True}),
    "cast_to_int32_saturates": ("cast", {"X": [np.array(
        [_NAN, _INF, -_INF, 1e10, -1e10, -1.0, 300.0, 2.7, -2.7],
        np.float32)]}, {"out_dtype": "int32"}),
    "cast_to_uint8_saturates": ("cast", {"X": [np.array(
        [_NAN, _INF, -_INF, 1e10, -1.0, 300.0, 255.5, 2.7], np.float32)]},
        {"out_dtype": "uint8"}),
    # float32's values next to int32's ends: 2^31 - 128 converts exactly,
    # 2^31 and past it saturate, -2^31 is the end itself
    "cast_to_int32_at_its_ends": ("cast", {"X": [np.array(
        [2147483520.0, 2147483648.0, -2147483648.0, -2147483904.0],
        np.float32)]}, {"out_dtype": "int32"}),
    # float16 cannot hold int32's ends: only its infinities reach them
    "cast_half_to_int32_saturates": ("cast", {"X": [np.array(
        [_NAN, _INF, -_INF, 65504.0, -65504.0, 2.5, -2.5], np.float16)]},
        {"out_dtype": "int32"}),
    "gelu_infinities": ("gelu", {"X": [np.array([_INF, -_INF, _NAN, 1.0,
                                                 -1.0], np.float32)]}, {}),
    "gelu_tanh_infinities": ("gelu", {"X": [np.array(
        [_INF, 1.0, -1.0], np.float32)]}, {"approximate": True}),
}


@pytest.mark.parametrize("name", sorted(FAULT_CASES))
def test_fault_case_matches_the_jax_op(name):
    op, ins, attrs = FAULT_CASES[name]
    want = _jax_compute(op, ins, attrs)
    got = _port_compute(op, ins, attrs)
    for slot in want:
        for j, (g, w) in enumerate(zip(got[slot], want[slot])):
            g, w = g.numpy(), np.asarray(w)
            if not np.issubdtype(w.dtype, np.floating):
                _check(g, w, f"{name}:{slot}[{j}]")
                continue
            # _check's scale over the finite entries (an infinity in
            # want would make its atol NaN)
            finite = np.isfinite(w)
            scale = float(np.abs(w[finite]).max()) if finite.any() else 0.
            assert g.dtype == w.dtype and g.shape == w.shape, name
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=RTOL * scale,
                                       err_msg=f"{name}:{slot}[{j}]")
            zero = w == 0
            if zero.any():
                np.testing.assert_array_equal(
                    np.signbit(g[zero]), np.signbit(w[zero]),
                    err_msg=f"{name}: the sign of a zero")


# (op, attrs, points): each op's gradient at its kinks, and beside them
KINK_CASES = {
    "clip": ("clip", {"min": -1.5, "max": 2.0}, [-1.5, 2.0, 0.3, -3.0]),
    "clip_min_only": ("clip", {"min": 0.5}, [0.5, 1.0, -1.0]),
    "relu6": ("relu6", {}, [0.0, 6.0, 3.0, 7.0, -1.0]),
    "relu6_threshold": ("relu6", {"threshold": 2.0}, [0.0, 2.0]),
    "abs": ("abs", {}, [0.0, -0.0, 1.5, -2.0]),
    "leaky_relu": ("leaky_relu", {}, [0.0, -1.0, 2.0]),
    "leaky_relu_alpha": ("leaky_relu", {"alpha": 0.1}, [0.0, -0.0, -3.0]),
    "hard_sigmoid": ("hard_sigmoid", {}, [-2.5, 2.5, 0.0, 3.0]),
    "hard_swish": ("hard_swish", {}, [-3.0, 3.0, 0.0, -4.0, 4.0]),
    "sign": ("sign", {}, [0.0, 1.0, -1.0]),
}


def _jax_grad(op, x, attrs):
    import jax

    ctx = JCtx(rng=None, is_test=False, attrs=attrs)
    fn = JREG.get(op).compute
    return np.asarray(jax.grad(lambda v: fn(ctx, {"X": [v]}, attrs)[
        "Out"][0].sum())(jnp.asarray(x)))


def _port_grad(op, x, attrs):
    ctx = PCtx(rng=None, is_test=False, attrs=attrs,
               device=torch.device("cpu"))
    t = torch.tensor(x, requires_grad=True)
    y = PREG.get(op).compute(ctx, {"X": [t]}, attrs)["Out"][0]
    (g,) = torch.autograd.grad(y.sum(), t)
    return g.numpy()


@pytest.mark.parametrize("name", sorted(KINK_CASES))
def test_gradient_at_kinks_matches_jax(name):
    op, attrs, points = KINK_CASES[name]
    x = np.array(points, np.float32)
    np.testing.assert_allclose(_port_grad(op, x, attrs),
                               _jax_grad(op, x, attrs), rtol=1e-6,
                               atol=1e-6, err_msg=name)


def _floordiv_program(P):
    main, startup = P.Program(), P.Program()
    with P.program_guard(main, startup), P.unique_name.guard():
        x = P.data("x", [2, 3])
        x.stop_gradient = False
        y = P.layers.elementwise_floordiv(x, P.layers.fill_constant(
            [2, 3], "float32", 2.0))
        loss = P.layers.mean(P.layers.elementwise_add(y, x * 3.0))
        P.append_backward(loss)
    return main, loss


def test_floordiv_gradient_is_zero_as_in_jax():
    """A loss through elementwise_floordiv trains: the floordiv adds a
    zero gradient (jnp.floor_divide's), only x * 3 reaches x@GRAD."""
    xv = np.array([[0.5, -1.5, 3.0], [4.5, -0.25, 7.0]], np.float32)
    res = []
    for P, place in ((jpt, jpt.CPUPlace()), (pt, pt.CPUPlace())):
        main, loss = _floordiv_program(P)
        with P.scope_guard(P.Scope()):
            res.append(P.Executor(place).run(
                main, feed={"x": xv}, fetch_list=[loss, "x@GRAD"]))
    (jl, jg), (pl, pg) = res
    np.testing.assert_allclose(pl, jl, rtol=1e-6)
    np.testing.assert_allclose(pg, jg, rtol=1e-6)
    np.testing.assert_allclose(pg, np.full((2, 3), 0.5, np.float32))


def test_pad_refuses_negative_paddings_as_jax():
    x = {"X": [np.ones((2, 3), np.float32)]}
    attrs = {"paddings": [0, -1, 1, 0]}
    with pytest.raises(ValueError):
        _jax_compute("pad", x, attrs)
    with pytest.raises(ValueError, match="negative paddings"):
        _port_compute("pad", x, attrs)


def test_out_of_range_ids_never_reach_the_gather():
    """The lookup gradient of a filled row is zero and the table's other
    rows get theirs (no index past the table reaches F.embedding).  The
    gradient flows from every row of the output, filled ones included;
    the out-of-range ids 4 and -6 wrap onto rows 0 and 2, which no valid
    id reaches, so those rows must get nothing."""
    ctx = PCtx(rng=None, is_test=False, attrs={},
               device=torch.device("cpu"))
    w = torch.arange(12, dtype=torch.float32).reshape(4, 3).requires_grad_()
    ids = torch.tensor([[4], [1], [-1], [-6]])
    y = PREG.get("lookup_table").compute(ctx, {"W": [w], "Ids": [ids]},
                                         {})["Out"][0]
    assert torch.isnan(y[0]).all() and torch.isnan(y[3]).all()
    (g,) = torch.autograd.grad(y, w, torch.ones_like(y))
    want = np.zeros((4, 3), np.float32)
    want[1] = want[3] = 1.0
    np.testing.assert_array_equal(g.numpy(), want)
