"""Layers: graph-building functions over the op registry.

Counterpart of paddle_tpu/layers/nn.py, copied close to verbatim so that
both packages build the same ops under the same names (``layers``
exports the comparisons of layers/control_flow.py, which take
``cond=``, over the plain binary ones generated here).
Each layer creates parameters through LayerHelper and appends ops
(parity: python/paddle/fluid/layers/nn.py + fluid/layer_helper.py).
Ported: the layers the BERT builders, a small fc program and the 4-D
attention program (``square_error_cost``) emit, the conv, pool and
batch-norm layers of the vision models, the loss and metric layers,
``moe``, and every generated unary and binary layer of the JAX file.
The other norms wait (ROADMAP.md Queue 1 item 6).
"""
from __future__ import annotations

import numpy as np

from ..initializer import (ConstantInitializer, NormalInitializer,
                           XavierInitializer)
from .helper import LayerHelper


def _prod(dims):
    p = 1
    for d in dims:
        p *= int(d)
    return p


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, name=None):
    """Fully-connected layer: ``mul`` + ``elementwise_add`` + the
    activation (parity: layers/nn.py fc)."""
    helper = LayerHelper("fc", name=name)
    input = helper.input(input)
    in_features = _prod(input.shape[num_flatten_dims:])
    w = helper.create_parameter(param_attr, [in_features, size], input.dtype)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="mul",
        inputs={"X": [input.name], "Y": [w.name]},
        outputs={"Out": [out.name]},
        attrs={"x_num_col_dims": num_flatten_dims, "y_num_col_dims": 1},
    )
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, [size], input.dtype,
                                    is_bias=True)
        tmp = helper.create_variable_for_type_inference(input.dtype)
        helper.append_op(
            type="elementwise_add",
            inputs={"X": [out.name], "Y": [b.name]},
            outputs={"Out": [tmp.name]},
            attrs={"axis": num_flatten_dims},
        )
        out = tmp
    return helper.append_activation(out, act)


def embedding(input, size, is_sparse=False, padding_idx=None,
              param_attr=None, dtype="float32", name=None):
    """Embedding lookup (parity: layers/nn.py embedding).

    is_sparse=True requests the SelectedRows gradient path: the table's
    gradient materializes as (rows, values) — O(batch·dim) memory
    regardless of vocab size — and SGD/Adam apply row updates.  Falls
    back to the dense grad when the table has multiple grad-relevant
    uses (the aggregation sum needs dense terms)."""
    helper = LayerHelper("embedding", name=name)
    input = helper.input(input)
    w = helper.create_parameter(
        param_attr, list(size), dtype,
        default_initializer=XavierInitializer())
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="lookup_table",
        inputs={"W": [w.name], "Ids": [input.name]},
        outputs={"Out": [out.name]},
        attrs={"padding_idx": -1 if padding_idx is None else padding_idx,
               "is_sparse": bool(is_sparse)},
    )
    return out


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=1, param_attr=None, bias_attr=None, act=None, name=None):
    """2-D convolution, NCHW (parity: layers/nn.py conv2d)."""
    helper = LayerHelper("conv2d", name=name)
    input = helper.input(input)
    c_in = input.shape[1]
    fsize = filter_size if isinstance(filter_size, (list, tuple)) \
        else (filter_size, filter_size)
    filter_shape = [num_filters, c_in // groups, fsize[0], fsize[1]]
    fan_in = (c_in // groups) * fsize[0] * fsize[1]
    w = helper.create_parameter(
        param_attr, filter_shape, input.dtype,
        default_initializer=NormalInitializer(0.0, np.sqrt(2.0 / fan_in)),
    )
    # reference dispatch (layers/nn.py conv2d l_type): a conv whose
    # groups == input channels is the depthwise op
    l_type = "conv2d"
    if groups > 1 and groups == c_in and num_filters % c_in == 0:
        l_type = "depthwise_conv2d"
    inputs = {"Input": [input.name], "Filter": [w.name]}
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, [num_filters], input.dtype,
                                    is_bias=True)
        inputs["Bias"] = [b.name]
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type=l_type,
        inputs=inputs,
        outputs={"Output": [out.name]},
        attrs={
            "strides": list(stride) if isinstance(stride, (list, tuple))
            else [stride, stride],
            "paddings": list(padding) if isinstance(padding, (list, tuple))
            else [padding, padding],
            "dilations": list(dilation) if isinstance(dilation, (list, tuple))
            else [dilation, dilation],
            "groups": groups,
        },
    )
    return helper.append_activation(out, act)


def conv2d_transpose(input, num_filters, filter_size, stride=1, padding=0,
                     param_attr=None, bias_attr=None, act=None, name=None):
    helper = LayerHelper("conv2d_transpose", name=name)
    input = helper.input(input)
    c_in = input.shape[1]
    fsize = filter_size if isinstance(filter_size, (list, tuple)) \
        else (filter_size, filter_size)
    w = helper.create_parameter(
        param_attr, [c_in, num_filters, fsize[0], fsize[1]], input.dtype,
        default_initializer=XavierInitializer())
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="conv2d_transpose",
        inputs={"Input": [input.name], "Filter": [w.name]},
        outputs={"Output": [out.name]},
        attrs={
            "strides": list(stride) if isinstance(stride, (list, tuple))
            else [stride, stride],
            "paddings": list(padding) if isinstance(padding, (list, tuple))
            else [padding, padding],
        },
    )
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, [num_filters], input.dtype,
                                    is_bias=True)
        tmp = helper.create_variable_for_type_inference(input.dtype)
        helper.append_op(
            type="elementwise_add",
            inputs={"X": [out.name], "Y": [b.name]},
            outputs={"Out": [tmp.name]},
            attrs={"axis": 1},
        )
        out = tmp
    return helper.append_activation(out, act)


def pool2d(input, pool_size=2, pool_type="max", pool_stride=None,
           pool_padding=0, global_pooling=False, exclusive=True,
           adaptive=False, name=None):
    helper = LayerHelper("pool2d", name=name)
    input = helper.input(input)
    if pool_stride is None:
        pool_stride = pool_size
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="pool2d",
        inputs={"X": [input.name]},
        outputs={"Out": [out.name]},
        attrs={
            "pooling_type": pool_type,
            "ksize": list(pool_size) if isinstance(pool_size, (list, tuple))
            else [pool_size, pool_size],
            "strides": list(pool_stride)
            if isinstance(pool_stride, (list, tuple))
            else [pool_stride, pool_stride],
            "paddings": list(pool_padding)
            if isinstance(pool_padding, (list, tuple))
            else [pool_padding, pool_padding],
            "global_pooling": global_pooling,
            "exclusive": exclusive,
            "adaptive": adaptive,
        },
    )
    return out


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW",
               moving_mean_name=None, moving_variance_name=None,
               use_global_stats=False, name=None):
    """BatchNorm with persistable running stats (parity: layers/nn.py
    batch_norm + operators/batch_norm_op.cc)."""
    helper = LayerHelper("batch_norm", name=name)
    input = helper.input(input)
    c = input.shape[1] if data_layout == "NCHW" else input.shape[-1]
    scale = helper.create_parameter(
        param_attr, [c], input.dtype,
        default_initializer=ConstantInitializer(1.0))
    bias = helper.create_parameter(bias_attr, [c], input.dtype, is_bias=True)

    def _stat_var(nm, init):
        main_block = helper.main_program.global_block()
        v = main_block.create_var(name=nm, shape=[c], dtype=input.dtype,
                                  persistable=True, stop_gradient=True)
        sb = helper.startup_program.global_block()
        sv = sb.create_var(name=nm, shape=[c], dtype=input.dtype,
                           persistable=True, stop_gradient=True)
        ConstantInitializer(init).append_op(sv, sb)
        return v

    from ..core import unique_name

    mean = _stat_var(
        moving_mean_name or unique_name.generate(f"{helper.name}.mean"), 0.0)
    var = _stat_var(
        moving_variance_name
        or unique_name.generate(f"{helper.name}.var"), 1.0)
    y = helper.create_variable_for_type_inference(input.dtype)
    saved_mean = helper.create_variable_for_type_inference(
        input.dtype, stop_gradient=True)
    saved_var = helper.create_variable_for_type_inference(
        input.dtype, stop_gradient=True)
    helper.append_op(
        type="batch_norm",
        inputs={"X": [input.name], "Scale": [scale.name],
                "Bias": [bias.name], "Mean": [mean.name],
                "Variance": [var.name]},
        outputs={"Y": [y.name], "MeanOut": [mean.name],
                 "VarianceOut": [var.name], "SavedMean": [saved_mean.name],
                 "SavedVariance": [saved_var.name]},
        attrs={"momentum": momentum, "epsilon": epsilon,
               "is_test": is_test, "data_layout": data_layout,
               "use_global_stats": use_global_stats},
    )
    return helper.append_activation(y, act)


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               name=None):
    helper = LayerHelper("layer_norm", name=name)
    input = helper.input(input)
    norm_shape = [_prod(input.shape[begin_norm_axis:])]
    inputs = {"X": [input.name]}
    if scale:
        s = helper.create_parameter(
            param_attr, norm_shape, input.dtype,
            default_initializer=ConstantInitializer(1.0))
        inputs["Scale"] = [s.name]
    if shift:
        b = helper.create_parameter(bias_attr, norm_shape, input.dtype,
                                    is_bias=True)
        inputs["Bias"] = [b.name]
    y = helper.create_variable_for_type_inference(input.dtype)
    mean = helper.create_variable_for_type_inference(input.dtype, True)
    var = helper.create_variable_for_type_inference(input.dtype, True)
    helper.append_op(
        type="layer_norm",
        inputs=inputs,
        outputs={"Y": [y.name], "Mean": [mean.name], "Variance": [var.name]},
        attrs={"begin_norm_axis": begin_norm_axis, "epsilon": epsilon},
    )
    return helper.append_activation(y, act)


def dropout(x, dropout_prob, is_test=False, seed=None,
            dropout_implementation="downgrade_in_infer", name=None):
    helper = LayerHelper("dropout", name=name)
    x = helper.input(x)
    out = helper.create_variable_for_type_inference(x.dtype)
    mask = helper.create_variable_for_type_inference(x.dtype, True)
    helper.append_op(
        type="dropout",
        inputs={"X": [x.name]},
        outputs={"Out": [out.name], "Mask": [mask.name]},
        attrs={"dropout_prob": dropout_prob, "is_test": is_test,
               "dropout_implementation": dropout_implementation},
    )
    return out


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, axis=-1,
                               return_softmax=False, name=None):
    helper = LayerHelper("softmax_with_cross_entropy", name=name)
    logits, label = helper.input(logits), helper.input(label)
    softmax_out = helper.create_variable_for_type_inference(logits.dtype)
    loss = helper.create_variable_for_type_inference(logits.dtype)
    helper.append_op(
        type="softmax_with_cross_entropy",
        inputs={"Logits": [logits.name], "Label": [label.name]},
        outputs={"Softmax": [softmax_out.name], "Loss": [loss.name]},
        attrs={"soft_label": soft_label, "ignore_index": ignore_index,
               "axis": axis},
    )
    if return_softmax:
        return loss, softmax_out
    return loss


def cross_entropy(input, label, soft_label=False, ignore_index=-100,
                  name=None):
    helper = LayerHelper("cross_entropy", name=name)
    input, label = helper.input(input), helper.input(label)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="cross_entropy",
        inputs={"X": [input.name], "Label": [label.name]},
        outputs={"Y": [out.name]},
        attrs={"soft_label": soft_label, "ignore_index": ignore_index},
    )
    return out


def sigmoid_cross_entropy_with_logits(x, label, ignore_index=-100,
                                      normalize=False, name=None):
    helper = LayerHelper("sigmoid_cross_entropy_with_logits", name=name)
    x, label = helper.input(x), helper.input(label)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="sigmoid_cross_entropy_with_logits",
        inputs={"X": [x.name], "Label": [label.name]},
        outputs={"Out": [out.name]},
        attrs={"ignore_index": ignore_index, "normalize": normalize},
    )
    return out


def huber_loss(input, label, delta=1.0, name=None):
    helper = LayerHelper("huber_loss", name=name)
    input, label = helper.input(input), helper.input(label)
    out = helper.create_variable_for_type_inference(input.dtype)
    residual = helper.create_variable_for_type_inference(input.dtype, True)
    helper.append_op(
        type="huber_loss",
        inputs={"X": [input.name], "Y": [label.name]},
        outputs={"Out": [out.name], "Residual": [residual.name]},
        attrs={"delta": delta},
    )
    return out


def accuracy(input, label, k=1, name=None):
    helper = LayerHelper("accuracy", name=name)
    input, label = helper.input(input), helper.input(label)
    acc = helper.create_variable_for_type_inference("float32", True)
    helper.append_op(
        type="accuracy",
        inputs={"Out": [input.name], "Label": [label.name]},
        outputs={"Accuracy": [acc.name]},
        attrs={"k": k},
    )
    return acc


def auc(input, label, name=None):
    helper = LayerHelper("auc", name=name)
    input, label = helper.input(input), helper.input(label)
    a = helper.create_variable_for_type_inference("float32", True)
    helper.append_op(
        type="auc",
        inputs={"Predict": [input.name], "Label": [label.name]},
        outputs={"AUC": [a.name]},
        attrs={},
    )
    return a


def square_error_cost(input, label, name=None):
    helper = LayerHelper("square_error_cost", name=name)
    input, label = helper.input(input), helper.input(label)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="mse_loss",
        inputs={"X": [input.name], "Y": [label.name]},
        outputs={"Out": [out.name]},
        attrs={},
    )
    return out


def moe(input, num_experts, hidden_size, top_k=2, capacity_factor=2.0,
        act="gelu", param_attr=None, name=None):
    """Mixture-of-Experts FFN layer over stacked expert weights (see
    ops/moe.py; beyond-reference — SURVEY.md §7 expert axis).

    Returns (out, aux_loss).  Add ``aux_loss`` (scaled) to the training
    loss to balance expert load.  For expert parallelism, shard the
    stacked parameters over the ``expert`` mesh axis with
    ``parallel.moe_sharding_rules()``."""
    from ..core import unique_name
    from ..initializer import NormalInitializer
    from ..param_attr import ParamAttr

    helper = LayerHelper("moe", name=name)
    x = helper.input(input)
    d = x.shape[-1]
    e, h = int(num_experts), int(hidden_size)
    if int(top_k) > e:
        raise ValueError(
            f"moe top_k={top_k} cannot exceed num_experts={e}")
    base = ParamAttr._to_attr(param_attr)

    def _named(suffix, is_bias=False):
        # ".expert_" in the name marks expert-stacked params so
        # parallel.moe_sharding_rules() can shard dim 0 over the
        # ``expert`` mesh axis; regularizer/trainable/lr propagate from
        # the user's param_attr (initializer applies to weights only)
        return ParamAttr(
            name=unique_name.generate(f"{helper.name}.expert_{suffix}"),
            initializer=(base.initializer
                         if base is not None and not is_bias else None),
            regularizer=base.regularizer if base is not None else None,
            trainable=base.trainable if base is not None else True,
            learning_rate=base.learning_rate if base is not None else 1.0)

    gate_w = helper.create_parameter(
        param_attr, [d, e], x.dtype,
        default_initializer=NormalInitializer(0.0, 0.02))
    w1 = helper.create_parameter(_named("w1"), [e, d, h], x.dtype,
                                 default_initializer=XavierInitializer())
    b1 = helper.create_parameter(_named("b1", is_bias=True), [e, h],
                                 x.dtype, is_bias=True)
    w2 = helper.create_parameter(_named("w2"), [e, h, d], x.dtype,
                                 default_initializer=XavierInitializer())
    b2 = helper.create_parameter(_named("b2", is_bias=True), [e, d],
                                 x.dtype, is_bias=True)
    out_var = helper.create_variable_for_type_inference(x.dtype)
    # aux must be differentiable: its gradient is what trains the gate
    # toward balanced expert load
    aux = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="moe_ffn",
        inputs={"X": [x.name], "GateW": [gate_w.name], "W1": [w1.name],
                "B1": [b1.name], "W2": [w2.name], "B2": [b2.name]},
        outputs={"Out": [out_var.name], "AuxLoss": [aux.name]},
        attrs={"top_k": top_k, "capacity_factor": capacity_factor,
               "act": act},
    )
    return out_var, aux


def fused_multihead_attention(q, k, v, attn_bias=None, dropout_rate=0.0,
                              causal=False, sm_scale=None, is_test=False,
                              num_heads=None, name=None):
    """Fused scaled-dot-product attention (parity:
    operators/fused/multihead_matmul_op.cu, but trainable).

    Two layouts: [B, H, T, D] tensors (num_heads=None), or the packed
    [B, T, H·D] layout with num_heads set.  Both run the hand-written
    flash-attention kernels of their layout on the card
    (ops/flash_attention.py) and their plain versions on the CPU.
    attn_bias: optional additive bias broadcastable to [B, 1, 1, Tk]."""
    helper = LayerHelper("fused_attention", name=name)
    out_var = helper.create_variable_for_type_inference(q.dtype)
    ins = {"Q": [q.name], "K": [k.name], "V": [v.name]}
    if attn_bias is not None:
        ins["Bias"] = [attn_bias.name]
    attrs = {"causal": causal, "dropout_rate": dropout_rate,
             "is_test": is_test}
    if num_heads is not None:
        attrs["num_heads"] = int(num_heads)
    if sm_scale is not None:
        attrs["sm_scale"] = float(sm_scale)
    helper.append_op(
        type="fused_attention",
        inputs=ins,
        outputs={"Out": [out_var.name]},
        attrs=attrs,
    )
    return out_var


# ---------------------------------------------------------------------------
# generic builders
# ---------------------------------------------------------------------------

def _unary_layer(op_type):
    def layer(x, name=None, **attrs):
        helper = LayerHelper(op_type, name=name)
        x = helper.input(x)
        out = helper.create_variable_for_type_inference(x.dtype)
        helper.append_op(
            type=op_type,
            inputs={"X": [x.name]},
            outputs={"Out": [out.name]},
            attrs=attrs,
        )
        return out

    layer.__name__ = op_type
    return layer


def _binary_layer(op_type):
    def layer(x, y, axis=-1, act=None, name=None, **attrs):
        helper = LayerHelper(op_type, name=name)
        x = helper.input(x)
        attrs["axis"] = axis
        inputs = {"X": [x.name]}
        if isinstance(y, (int, float)):
            attrs["scalar_y"] = float(y)
        else:
            inputs["Y"] = [helper.input(y).name]
        out = helper.create_variable_for_type_inference(x.dtype)
        helper.append_op(
            type=op_type,
            inputs=inputs,
            outputs={"Out": [out.name]},
            attrs=attrs,
        )
        return helper.append_activation(out, act)

    layer.__name__ = op_type
    return layer


# unary activations & math
_UNARY_OPS = [
    "relu", "sigmoid", "tanh", "exp", "log", "log2", "log10", "log1p",
    "sqrt", "rsqrt", "square", "abs", "ceil", "floor", "round",
    "reciprocal", "sign", "sin", "cos", "tan", "asin", "acos", "atan",
    "sinh", "cosh", "erf", "gelu", "leaky_relu", "elu", "softplus",
    "softsign", "relu6", "swish", "hard_sigmoid", "hard_swish",
    "logsigmoid", "thresholded_relu", "hard_shrink", "soft_shrink",
    "stanh", "softmax", "log_softmax", "logical_not",
]
for _op in _UNARY_OPS:
    globals()[_op] = _unary_layer(_op)

_BINARY_OPS = [
    "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "elementwise_max", "elementwise_min",
    "elementwise_pow", "elementwise_mod", "elementwise_floordiv",
    "equal", "not_equal", "less_than", "less_equal", "greater_than",
    "greater_equal", "logical_and", "logical_or", "logical_xor",
]
for _op in _BINARY_OPS:
    globals()[_op] = _binary_layer(_op)
