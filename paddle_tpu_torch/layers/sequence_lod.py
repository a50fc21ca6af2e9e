"""Sequence layers of the port over (padded, lengths) batches (parity:
python/paddle/fluid/layers/sequence_lod.py — sequence_pool/first_step/
last_step/softmax/reverse/expand_as/concat/conv + sequence_mask).

Counterpart of paddle_tpu/layers/sequence_lod.py, copied close to
verbatim.  Every function takes the dense padded tensor plus a lengths
Variable (int) instead of the reference's implicit LoD."""
from __future__ import annotations

from .helper import LayerHelper

__all__ = [
    "sequence_mask", "sequence_pool", "sequence_first_step",
    "sequence_last_step", "sequence_softmax", "sequence_reverse",
    "sequence_expand_as", "sequence_concat", "sequence_conv",
]


def _require_seq_len(helper, seq_len):
    if seq_len is None:
        raise ValueError(
            f"layers.{helper.layer_type} requires seq_len= (the lengths "
            f"Variable); unlike the reference there is no implicit LoD — "
            f"sequence batches are dense padded + lengths")
    return helper.input(seq_len)


def _simple(helper, op_type, inputs, attrs, dtype, n_out=1,
            out_slots=("Out",), stop_gradient=False):
    outs = [helper.create_variable_for_type_inference(dtype, stop_gradient)
            for _ in range(n_out)]
    helper.append_op(
        type=op_type,
        inputs=inputs,
        outputs={slot: [o.name] for slot, o in zip(out_slots, outs)},
        attrs=attrs,
    )
    return outs[0] if n_out == 1 else outs


def sequence_mask(x, maxlen, dtype="float32", name=None):
    """lengths [B] -> [B, maxlen] 0/1 mask (parity: layers.sequence_mask)."""
    helper = LayerHelper("sequence_mask", name=name)
    x = helper.input(x)
    return _simple(helper, "sequence_mask", {"X": [x.name]},
                   {"maxlen": int(maxlen), "out_dtype": dtype}, dtype,
                   out_slots=("Y",), stop_gradient=True)


def sequence_pool(input, pool_type, seq_len=None, name=None):
    """pool_type: sum/average/sqrt/max/last/first (parity:
    layers.sequence_pool; ``seq_len`` replaces the LoD)."""
    helper = LayerHelper("sequence_pool", name=name)
    x = helper.input(input)
    sl = _require_seq_len(helper, seq_len)
    return _simple(helper, "sequence_pool",
                   {"X": [x.name], "SeqLen": [sl.name]},
                   {"pooltype": pool_type.upper()}, x.dtype)


def sequence_first_step(input, seq_len=None, name=None):
    return sequence_pool(input, "first", seq_len, name)


def sequence_last_step(input, seq_len=None, name=None):
    return sequence_pool(input, "last", seq_len, name)


def sequence_softmax(input, seq_len=None, name=None):
    helper = LayerHelper("sequence_softmax", name=name)
    x = helper.input(input)
    sl = _require_seq_len(helper, seq_len)
    return _simple(helper, "sequence_softmax",
                   {"X": [x.name], "SeqLen": [sl.name]}, {}, x.dtype)


def sequence_reverse(x, seq_len=None, name=None):
    helper = LayerHelper("sequence_reverse", name=name)
    x = helper.input(x)
    sl = _require_seq_len(helper, seq_len)
    return _simple(helper, "sequence_reverse",
                   {"X": [x.name], "SeqLen": [sl.name]}, {}, x.dtype,
                   out_slots=("Y",))


def sequence_expand_as(x, y, seq_len=None, name=None):
    helper = LayerHelper("sequence_expand_as", name=name)
    x, y = helper.input(x), helper.input(y)
    sl = _require_seq_len(helper, seq_len)
    return _simple(helper, "sequence_expand_as",
                   {"X": [x.name], "Y": [y.name], "SeqLen": [sl.name]},
                   {}, x.dtype)


def sequence_concat(x, x_len, y, y_len, name=None):
    """Returns (out, out_len) (parity: layers.sequence_concat over two
    inputs)."""
    helper = LayerHelper("sequence_concat", name=name)
    x, y = helper.input(x), helper.input(y)
    xl, yl = helper.input(x_len), helper.input(y_len)
    out = helper.create_variable_for_type_inference(x.dtype)
    out_len = helper.create_variable_for_type_inference(xl.dtype, True)
    helper.append_op(
        type="sequence_concat",
        inputs={"X": [x.name], "XLen": [xl.name], "Y": [y.name],
                "YLen": [yl.name]},
        outputs={"Out": [out.name], "OutLen": [out_len.name]},
        attrs={},
    )
    return out, out_len


def sequence_conv(input, num_filters, filter_size=3, filter_stride=1,
                  padding=True, seq_len=None, param_attr=None,
                  bias_attr=None, act=None, name=None):
    """Context-window projection over time (parity: layers.sequence_conv)."""
    assert filter_stride == 1, "sequence_conv supports stride 1"
    helper = LayerHelper("sequence_conv", name=name)
    x = helper.input(input)
    sl = _require_seq_len(helper, seq_len)
    d = x.shape[-1]
    filt = helper.create_parameter(
        param_attr, [int(filter_size) * d, num_filters], x.dtype)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="sequence_conv",
        inputs={"X": [x.name], "SeqLen": [sl.name],
                "Filter": [filt.name]},
        outputs={"Out": [out.name]},
        attrs={"contextLength": int(filter_size),
               "contextStart": -(int(filter_size) - 1) // 2},
    )
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, [num_filters], x.dtype,
                                    is_bias=True)
        biased = helper.create_variable_for_type_inference(x.dtype)
        helper.append_op(type="elementwise_add",
                         inputs={"X": [out.name], "Y": [b.name]},
                         outputs={"Out": [biased.name]}, attrs={})
        out = biased
    return helper.append_activation(out, act)
