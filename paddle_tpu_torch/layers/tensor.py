"""Tensor-manipulation layers: a copy of paddle_tpu/layers/tensor.py
(parity: fluid/layers/tensor.py + parts of nn.py: reshape/transpose/
concat/split/cast/fill_constant/...), so both packages build the same ops
under the same names."""
from __future__ import annotations

import builtins

from .helper import LayerHelper


def _simple(helper, op_type, inputs, attrs, dtype=None, n_out=1,
            out_slot="Out", stop_gradient=False):
    outs = [helper.create_variable_for_type_inference(
        dtype or "float32", stop_gradient) for _ in builtins.range(n_out)]
    helper.append_op(
        type=op_type,
        inputs=inputs,
        outputs={out_slot: [o.name for o in outs]},
        attrs=attrs,
    )
    return outs[0] if n_out == 1 else outs


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


def concat(input, axis=0, name=None):
    helper = LayerHelper("concat", name=name)
    xs = [helper.input(x) for x in input]
    return _simple(helper, "concat", {"X": [x.name for x in xs]},
                   {"axis": axis}, xs[0].dtype)


def split(input, num_or_sections, dim=-1, name=None):
    helper = LayerHelper("split", name=name)
    x = helper.input(input)
    axis = dim % len(x.shape)
    if isinstance(num_or_sections, int):
        n = num_or_sections
        attrs = {"num": n, "axis": axis}
    else:
        n = len(num_or_sections)
        attrs = {"sections": list(num_or_sections), "axis": axis}
    return _simple(helper, "split", {"X": [x.name]}, attrs, x.dtype, n_out=n)


def cast(x, dtype, name=None):
    helper = LayerHelper("cast", name=name)
    x = helper.input(x)
    return _simple(helper, "cast", {"X": [x.name]}, {"out_dtype": dtype},
                   dtype)


def fill_constant(shape, dtype, value, name=None):
    helper = LayerHelper("fill_constant", name=name)
    return _simple(helper, "fill_constant", {},
                   {"shape": list(shape), "dtype": dtype, "value": value},
                   dtype, stop_gradient=True)


def fill_constant_batch_size_like(input, shape, dtype, value,
                                  input_dim_idx=0, output_dim_idx=0,
                                  name=None):
    """Constant whose batch dim copies ``input``'s (parity:
    layers/tensor.py fill_constant_batch_size_like)."""
    helper = LayerHelper("fill_constant_batch_size_like", name=name)
    x = helper.input(input)
    return _simple(helper, "fill_constant_batch_size_like",
                   {"Input": [x.name]},
                   {"shape": list(shape), "dtype": dtype, "value": value,
                    "input_dim_idx": input_dim_idx,
                    "output_dim_idx": output_dim_idx}, dtype,
                   stop_gradient=True)


def zeros(shape, dtype="float32", name=None):
    return fill_constant(shape, dtype, 0.0, name=name)


def ones(shape, dtype="float32", name=None):
    return fill_constant(shape, dtype, 1.0, name=name)


def zeros_like(x, name=None):
    helper = LayerHelper("zeros_like", name=name)
    x = helper.input(x)
    return _simple(helper, "scale", {"X": [x.name]}, {"scale": 0.0}, x.dtype)


def ones_like(x, name=None):
    helper = LayerHelper("ones_like", name=name)
    x = helper.input(x)
    return _simple(helper, "scale", {"X": [x.name]},
                   {"scale": 0.0, "bias": 1.0}, x.dtype)


def assign(input, output=None, name=None):
    import numpy as np

    helper = LayerHelper("assign", name=name)
    if isinstance(input, (np.ndarray, list, tuple, float, int)):
        # numpy -> baked-in constant (parity: assign accepts ndarray via
        # assign_value_op, fluid/layers/tensor.py assign)
        arr = np.asarray(input)
        if output is None:
            output = helper.create_variable_for_type_inference(
                str(arr.dtype))
        helper.append_op(
            type="assign_value",
            inputs={},
            outputs={"Out": [output.name]},
            attrs={"shape": list(arr.shape), "dtype": str(arr.dtype),
                   "values": arr},
        )
        return output
    x = helper.input(input)
    if output is None:
        return _simple(helper, "assign", {"X": [x.name]}, {}, x.dtype)
    helper.append_op(
        type="assign",
        inputs={"X": [x.name]},
        outputs={"Out": [output.name]},
        attrs={},
    )
    return output


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
reduce_max = _reduce("reduce_max")
reduce_min = _reduce("reduce_min")
reduce_prod = _reduce("reduce_prod")
reduce_all = _reduce("reduce_all")
reduce_any = _reduce("reduce_any")


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0, name=None):
    helper = LayerHelper("matmul", name=name)
    x, y = helper.input(x), helper.input(y)
    return _simple(
        helper, "matmul", {"X": [x.name], "Y": [y.name]},
        {"transpose_X": transpose_x, "transpose_Y": transpose_y,
         "alpha": alpha},
        x.dtype,
    )


def mul(x, y, x_num_col_dims=1, y_num_col_dims=1, name=None):
    helper = LayerHelper("mul", name=name)
    x, y = helper.input(x), helper.input(y)
    return _simple(
        helper, "mul", {"X": [x.name], "Y": [y.name]},
        {"x_num_col_dims": x_num_col_dims, "y_num_col_dims": y_num_col_dims},
        x.dtype,
    )


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    helper = LayerHelper("scale", name=name)
    x = helper.input(x)
    out = _simple(helper, "scale", {"X": [x.name]},
                  {"scale": scale, "bias": bias,
                   "bias_after_scale": bias_after_scale}, x.dtype)
    return helper.append_activation(out, act)


def clip(x, min, max, name=None):
    helper = LayerHelper("clip", name=name)
    x = helper.input(x)
    return _simple(helper, "clip", {"X": [x.name]},
                   {"min": min, "max": max}, x.dtype)


def clip_by_norm(x, max_norm, name=None):
    helper = LayerHelper("clip_by_norm", name=name)
    x = helper.input(x)
    return _simple(helper, "clip_by_norm", {"X": [x.name]},
                   {"max_norm": max_norm}, x.dtype)


def topk(input, k=1, name=None):
    helper = LayerHelper("top_k", name=name)
    x = helper.input(input)
    vals = helper.create_variable_for_type_inference(x.dtype)
    idx = helper.create_variable_for_type_inference("int32", True)
    helper.append_op(
        type="top_k",
        inputs={"X": [x.name]},
        outputs={"Out": [vals.name], "Indices": [idx.name]},
        attrs={"k": k},
    )
    return vals, idx


def argmax(x, axis=-1, name=None):
    helper = LayerHelper("arg_max", name=name)
    x = helper.input(x)
    return _simple(helper, "arg_max", {"X": [x.name]}, {"axis": axis},
                   "int32", stop_gradient=True)


def argmin(x, axis=-1, name=None):
    helper = LayerHelper("arg_min", name=name)
    x = helper.input(x)
    return _simple(helper, "arg_min", {"X": [x.name]}, {"axis": axis},
                   "int32", stop_gradient=True)


def one_hot(input, depth, name=None):
    helper = LayerHelper("one_hot", name=name)
    x = helper.input(input)
    return _simple(helper, "one_hot", {"X": [x.name]}, {"depth": depth},
                   "float32")


def gather(input, index, axis=0, name=None):
    helper = LayerHelper("gather", name=name)
    x, idx = helper.input(input), helper.input(index)
    return _simple(helper, "gather",
                   {"X": [x.name], "Index": [idx.name]}, {"axis": axis},
                   x.dtype)


def scatter(input, index, updates, overwrite=True, name=None):
    helper = LayerHelper("scatter", name=name)
    x = helper.input(input)
    return _simple(
        helper, "scatter",
        {"X": [x.name], "Ids": [helper.input(index).name],
         "Updates": [helper.input(updates).name]},
        {"overwrite": overwrite}, x.dtype)


def slice(input, axes, starts, ends, name=None):
    helper = LayerHelper("slice", name=name)
    x = helper.input(input)
    return _simple(helper, "slice", {"Input": [x.name]},
                   {"axes": list(axes), "starts": list(starts),
                    "ends": list(ends)}, x.dtype)


def stack(x, axis=0, name=None):
    helper = LayerHelper("stack", name=name)
    xs = [helper.input(v) for v in x]
    return _simple(helper, "stack", {"X": [v.name for v in xs]},
                   {"axis": axis}, xs[0].dtype)


def unstack(x, axis=0, num=None, name=None):
    helper = LayerHelper("unstack", name=name)
    x = helper.input(x)
    n = num if num is not None else x.shape[axis]
    outs = [helper.create_variable_for_type_inference(x.dtype)
            for _ in builtins.range(n)]
    helper.append_op(
        type="unstack",
        inputs={"X": [x.name]},
        outputs={"Y": [o.name for o in outs]},
        attrs={"axis": axis},
    )
    return outs


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


def expand(x, expand_times, name=None):
    helper = LayerHelper("expand", name=name)
    x = helper.input(x)
    return _simple(helper, "expand", {"X": [x.name]},
                   {"expand_times": list(expand_times)}, x.dtype)


def pad(x, paddings, pad_value=0.0, name=None):
    helper = LayerHelper("pad", name=name)
    x = helper.input(x)
    return _simple(helper, "pad", {"X": [x.name]},
                   {"paddings": list(paddings), "pad_value": pad_value},
                   x.dtype)


def where(condition, x, y, name=None):
    helper = LayerHelper("where", name=name)
    c = helper.input(condition)
    x, y = helper.input(x), helper.input(y)
    return _simple(helper, "where",
                   {"Condition": [c.name], "X": [x.name], "Y": [y.name]},
                   {}, x.dtype)


def cumsum(x, axis=-1, exclusive=False, reverse=False, name=None):
    helper = LayerHelper("cumsum", name=name)
    x = helper.input(x)
    return _simple(helper, "cumsum", {"X": [x.name]},
                   {"axis": axis, "exclusive": exclusive, "reverse": reverse},
                   x.dtype)


def shape(input, name=None):
    helper = LayerHelper("shape", name=name)
    x = helper.input(input)
    return _simple(helper, "shape", {"Input": [x.name]}, {}, "int32",
                   stop_gradient=True)


def range(start, end, step=1, dtype="int32", name=None):
    helper = LayerHelper("range", name=name)
    return _simple(helper, "range", {},
                   {"start": start, "end": end, "step": step, "dtype": dtype},
                   dtype, stop_gradient=True)


def pow(x, factor=1.0, name=None):
    helper = LayerHelper("pow", name=name)
    x = helper.input(x)
    return _simple(helper, "pow", {"X": [x.name]}, {"factor": factor},
                   x.dtype)


def uniform_random(shape, dtype="float32", min=-1.0, max=1.0, name=None):
    helper = LayerHelper("uniform_random", name=name)
    return _simple(helper, "uniform_random", {},
                   {"shape": list(shape), "dtype": dtype, "min": min,
                    "max": max}, dtype, stop_gradient=True)


def gaussian_random(shape, dtype="float32", mean=0.0, std=1.0, name=None):
    helper = LayerHelper("gaussian_random", name=name)
    return _simple(helper, "gaussian_random", {},
                   {"shape": list(shape), "dtype": dtype, "mean": mean,
                    "std": std}, dtype, stop_gradient=True)


def uniform_random_batch_size_like(input, shape, dtype="float32",
                                   input_dim_idx=0, output_dim_idx=0,
                                   min=-1.0, max=1.0, seed=0, name=None):
    """Uniform noise whose batch dim copies ``input``'s (parity:
    uniform_random_batch_size_like_op.cc)."""
    helper = LayerHelper("uniform_random_batch_size_like", name=name)
    x = helper.input(input)
    return _simple(helper, "uniform_random_batch_size_like",
                   {"Input": [x.name]},
                   {"shape": list(shape), "dtype": dtype, "min": min,
                    "max": max, "seed": seed,
                    "input_dim_idx": input_dim_idx,
                    "output_dim_idx": output_dim_idx}, dtype,
                   stop_gradient=True)


def gaussian_random_batch_size_like(input, shape, dtype="float32",
                                    input_dim_idx=0, output_dim_idx=0,
                                    mean=0.0, std=1.0, seed=0, name=None):
    """Gaussian noise whose batch dim copies ``input``'s (parity:
    gaussian_random_batch_size_like_op.cc)."""
    helper = LayerHelper("gaussian_random_batch_size_like", name=name)
    x = helper.input(input)
    return _simple(helper, "gaussian_random_batch_size_like",
                   {"Input": [x.name]},
                   {"shape": list(shape), "dtype": dtype, "mean": mean,
                    "std": std, "seed": seed,
                    "input_dim_idx": input_dim_idx,
                    "output_dim_idx": output_dim_idx}, dtype,
                   stop_gradient=True)
