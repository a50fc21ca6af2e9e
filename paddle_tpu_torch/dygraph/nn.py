"""Class-style dygraph layers (parity: python/paddle/fluid/dygraph/nn.py —
Conv2D, Linear, Pool2D, BatchNorm, Embedding, LayerNorm, Dropout, ...).

Counterpart of paddle_tpu/dygraph/nn.py.  Each forward dispatches the
same registered ops as the static layer functions, executed eagerly
(engine.run_eager_op) — on the card, the port's kernels where those ops
launch them."""
from __future__ import annotations

import numpy as np
import torch

from ..initializer import (
    ConstantInitializer,
    NormalInitializer,
    XavierInitializer,
)
from .engine import run_eager_op, run_inline_op
from .layers import Layer

__all__ = ["Linear", "Conv2D", "Pool2D", "BatchNorm", "Embedding",
           "LayerNorm", "Dropout", "GRUUnit"]


def _pair(v):
    return list(v) if isinstance(v, (list, tuple)) else [v, v]


def _act(x, act):
    if act is None:
        return x
    return run_eager_op(act, {"X": [x]}, {})["Out"][0]


class Linear(Layer):
    """y = act(x W + b) (parity: dygraph/nn.py Linear)."""

    def __init__(self, input_dim, output_dim, param_attr=None,
                 bias_attr=None, act=None, dtype="float32"):
        super().__init__(dtype=dtype)
        self._act = act
        self.weight = self.create_parameter(
            [input_dim, output_dim], attr=param_attr, dtype=dtype)
        self.bias = None if bias_attr is False else self.create_parameter(
            [output_dim], attr=bias_attr, dtype=dtype, is_bias=True)

    def forward(self, input):
        out = run_eager_op("matmul", {"X": [input], "Y": [self.weight]},
                           {})["Out"][0]
        if self.bias is not None:
            out = run_eager_op("elementwise_add",
                               {"X": [out], "Y": [self.bias]}, {})["Out"][0]
        return _act(out, self._act)


class Conv2D(Layer):
    """NCHW conv (parity: dygraph/nn.py Conv2D)."""

    def __init__(self, num_channels, num_filters, filter_size, stride=1,
                 padding=0, dilation=1, groups=1, param_attr=None,
                 bias_attr=None, act=None, dtype="float32"):
        super().__init__(dtype=dtype)
        self._attrs = {
            "strides": _pair(stride), "paddings": _pair(padding),
            "dilations": _pair(dilation), "groups": groups,
        }
        self._act = act
        fsize = _pair(filter_size)
        fan_in = (num_channels // groups) * fsize[0] * fsize[1]
        self.weight = self.create_parameter(
            [num_filters, num_channels // groups, fsize[0], fsize[1]],
            attr=param_attr, dtype=dtype,
            default_initializer=NormalInitializer(
                0.0, float(np.sqrt(2.0 / fan_in))))
        self.bias = None if bias_attr is False else self.create_parameter(
            [num_filters], attr=bias_attr, dtype=dtype, is_bias=True)

    def forward(self, input):
        ins = {"Input": [input], "Filter": [self.weight]}
        if self.bias is not None:
            ins["Bias"] = [self.bias]
        return _act(
            run_eager_op("conv2d", ins, dict(self._attrs))["Output"][0],
            self._act)


class Pool2D(Layer):
    """max/avg pooling (parity: dygraph/nn.py Pool2D)."""

    def __init__(self, pool_size=-1, pool_type="max", pool_stride=1,
                 pool_padding=0, global_pooling=False, ceil_mode=False,
                 exclusive=True):
        super().__init__()
        self._attrs = {
            "pooling_type": pool_type, "ksize": _pair(pool_size),
            "strides": _pair(pool_stride), "paddings": _pair(pool_padding),
            "global_pooling": global_pooling, "ceil_mode": ceil_mode,
            "exclusive": exclusive,
        }

    def forward(self, input):
        return run_eager_op("pool2d", {"X": [input]},
                            dict(self._attrs))["Out"][0]


class BatchNorm(Layer):
    """Batch normalization with running stats (parity: dygraph/nn.py
    BatchNorm; op parity operators/batch_norm_op.cc)."""

    def __init__(self, num_channels, act=None, momentum=0.9, epsilon=1e-5,
                 param_attr=None, bias_attr=None, data_layout="NCHW",
                 use_global_stats=False, dtype="float32"):
        super().__init__(dtype=dtype)
        self._attrs = {
            "momentum": momentum, "epsilon": epsilon,
            "data_layout": data_layout,
            "use_global_stats": use_global_stats,
        }
        self._act = act
        self.weight = self.create_parameter(
            [num_channels], attr=param_attr, dtype=dtype,
            default_initializer=ConstantInitializer(1.0))
        self.bias = self.create_parameter(
            [num_channels], attr=bias_attr, dtype=dtype, is_bias=True)
        self._mean = self.create_parameter(
            [num_channels], attr=None, dtype=dtype,
            default_initializer=ConstantInitializer(0.0))
        self._mean.trainable = False
        self._mean.stop_gradient = True
        self._variance = self.create_parameter(
            [num_channels], attr=None, dtype=dtype,
            default_initializer=ConstantInitializer(1.0))
        self._variance.trainable = False
        self._variance.stop_gradient = True

    def parameters(self, include_sublayers=True):
        return [p for p in super().parameters(include_sublayers)
                if p.trainable]

    def forward(self, input):
        outs = run_eager_op(
            "batch_norm",
            {"X": [input], "Scale": [self.weight], "Bias": [self.bias],
             "Mean": [self._mean], "Variance": [self._variance]},
            dict(self._attrs),
            out_targets={("MeanOut", 0): self._mean,
                         ("VarianceOut", 0): self._variance},
        )
        return _act(outs["Y"][0], self._act)


class Embedding(Layer):
    """Lookup table (parity: dygraph/nn.py Embedding)."""

    def __init__(self, size, is_sparse=False, padding_idx=None,
                 param_attr=None, dtype="float32"):
        super().__init__(dtype=dtype)
        self._padding_idx = -1 if padding_idx is None else padding_idx
        self.weight = self.create_parameter(
            list(size), attr=param_attr, dtype=dtype,
            default_initializer=XavierInitializer())

    def forward(self, input):
        return run_eager_op(
            "lookup_table", {"W": [self.weight], "Ids": [input]},
            {"padding_idx": self._padding_idx})["Out"][0]


class LayerNorm(Layer):
    """Layer normalization (parity: dygraph/nn.py LayerNorm)."""

    def __init__(self, normalized_shape, scale=True, shift=True,
                 epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
                 dtype="float32"):
        super().__init__(dtype=dtype)
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._shape = list(normalized_shape)
        self._epsilon = epsilon
        self._act = act
        self.weight = self.create_parameter(
            self._shape, attr=param_attr, dtype=dtype,
            default_initializer=ConstantInitializer(1.0)) if scale else None
        self.bias = self.create_parameter(
            self._shape, attr=bias_attr, dtype=dtype,
            is_bias=True) if shift else None

    def forward(self, input):
        ins = {"X": [input]}
        if self.weight is not None:
            ins["Scale"] = [self.weight]
        if self.bias is not None:
            ins["Bias"] = [self.bias]
        outs = run_eager_op(
            "layer_norm", ins,
            {"epsilon": self._epsilon,
             "begin_norm_axis": len(input.shape) - len(self._shape)})
        return _act(outs["Y"][0], self._act)


class Dropout(Layer):
    """Dropout honoring global train/eval mode (parity: dygraph Dropout)."""

    def __init__(self, p=0.5, dropout_implementation="downgrade_in_infer"):
        super().__init__()
        self._attrs = {"dropout_prob": p,
                       "dropout_implementation": dropout_implementation}

    def forward(self, input):
        return run_eager_op("dropout", {"X": [input]},
                            dict(self._attrs),
                            is_test=not self.training)["Out"][0]


class GRUUnit(Layer):
    """Single GRU step (parity: dygraph/nn.py GRUUnit): the JAX package's
    step as one torch function recorded through ``run_inline_op``."""

    def __init__(self, size, param_attr=None, bias_attr=None,
                 activation="tanh", gate_activation="sigmoid",
                 dtype="float32"):
        super().__init__(dtype=dtype)
        # size is 3*hidden (fluid convention)
        hidden = size // 3
        self._hidden = hidden
        self._act, self._gate_act = activation, gate_activation
        self.weight = self.create_parameter(
            [hidden, hidden * 3], attr=param_attr, dtype=dtype)
        self.bias = None if bias_attr is False else self.create_parameter(
            [hidden * 3], attr=bias_attr, dtype=dtype, is_bias=True)

    def forward(self, input, hidden):
        """input: [B, 3H] (pre-projected x), hidden: [B, H] prev state."""
        h = self._hidden
        gate = (torch.sigmoid if self._gate_act == "sigmoid"
                else torch.tanh)
        act = torch.tanh if self._act == "tanh" else torch.relu

        def step(x, hprev, w, b=None):
            gates_h = hprev @ w
            g = x + gates_h if b is None else x + gates_h + b
            u = gate(g[:, :h])
            r = gate(g[:, h:2 * h])
            # candidate uses r * (hprev @ w_c) per fluid gru_unit semantics
            c = act(x[:, 2 * h:] + (r * hprev) @ w[:, 2 * h:]
                    + (0 if b is None else b[2 * h:]))
            return u * hprev + (1 - u) * c

        ins = [input, hidden, self.weight] + (
            [self.bias] if self.bias is not None else [])
        return run_inline_op(step, ins), None, None
