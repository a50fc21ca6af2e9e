"""Tensor-manipulation layers the ported training path emits: a subset of
paddle_tpu/layers/tensor.py, copied close to verbatim (parity:
fluid/layers/tensor.py + parts of nn.py)."""
from __future__ import annotations

from .helper import LayerHelper


def _simple(helper, op_type, inputs, attrs, dtype=None, stop_gradient=False):
    out = helper.create_variable_for_type_inference(dtype or "float32",
                                                    stop_gradient)
    helper.append_op(
        type=op_type,
        inputs=inputs,
        outputs={"Out": [out.name]},
        attrs=attrs,
    )
    return out


def reshape(x, shape, name=None):
    helper = LayerHelper("reshape", name=name)
    x = helper.input(x)
    return _simple(helper, "reshape", {"X": [x.name]},
                   {"shape": list(shape)}, x.dtype)


def transpose(x, perm, name=None):
    helper = LayerHelper("transpose", name=name)
    x = helper.input(x)
    return _simple(helper, "transpose", {"X": [x.name]},
                   {"axis": list(perm)}, x.dtype)


def cast(x, dtype, name=None):
    helper = LayerHelper("cast", name=name)
    x = helper.input(x)
    return _simple(helper, "cast", {"X": [x.name]}, {"out_dtype": dtype},
                   dtype)


def mean(x, name=None):
    helper = LayerHelper("mean", name=name)
    x = helper.input(x)
    return _simple(helper, "mean", {"X": [x.name]}, {}, x.dtype)


def _reduce(op_type):
    def layer(input, dim=None, keep_dim=False, name=None):
        helper = LayerHelper(op_type, name=name)
        x = helper.input(input)
        attrs = {"keep_dim": keep_dim, "reduce_all": dim is None}
        if dim is not None:
            attrs["dim"] = dim if isinstance(dim, (list, tuple)) else [dim]
        return _simple(helper, op_type, {"X": [x.name]}, attrs, x.dtype)

    layer.__name__ = op_type
    return layer


reduce_sum = _reduce("reduce_sum")
reduce_mean = _reduce("reduce_mean")


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0, name=None):
    helper = LayerHelper("matmul", name=name)
    x, y = helper.input(x), helper.input(y)
    return _simple(
        helper, "matmul", {"X": [x.name], "Y": [y.name]},
        {"transpose_X": transpose_x, "transpose_Y": transpose_y,
         "alpha": alpha},
        x.dtype,
    )


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    helper = LayerHelper("scale", name=name)
    x = helper.input(x)
    out = _simple(helper, "scale", {"X": [x.name]},
                  {"scale": scale, "bias": bias,
                   "bias_after_scale": bias_after_scale}, x.dtype)
    return helper.append_activation(out, act)


def slice(input, axes, starts, ends, name=None):
    helper = LayerHelper("slice", name=name)
    x = helper.input(input)
    return _simple(helper, "slice", {"Input": [x.name]},
                   {"axes": list(axes), "starts": list(starts),
                    "ends": list(ends)}, x.dtype)


def squeeze(input, axes=None, name=None):
    helper = LayerHelper("squeeze", name=name)
    x = helper.input(input)
    return _simple(helper, "squeeze", {"X": [x.name]},
                   {"axes": list(axes) if axes else []}, x.dtype)


def unsqueeze(input, axes, name=None):
    helper = LayerHelper("unsqueeze", name=name)
    x = helper.input(input)
    return _simple(helper, "unsqueeze", {"X": [x.name]},
                   {"axes": list(axes)}, x.dtype)


def range(start, end, step=1, dtype="int32", name=None):
    helper = LayerHelper("range", name=name)
    return _simple(helper, "range", {},
                   {"start": start, "end": end, "step": step, "dtype": dtype},
                   dtype, stop_gradient=True)
