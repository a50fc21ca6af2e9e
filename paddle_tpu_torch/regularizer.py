"""Weight-decay regularizers: a copy of paddle_tpu/regularizer.py
(parity: python/paddle/fluid/regularizer.py).

As in the reference, regularization is appended to the gradient as ops
(grad += coeff * penalty'(param)) before the optimizer op consumes it.
A SelectedRows gradient is densified first (``sparse_to_dense_grad``,
from ``Optimizer._append_regularization``), so the decay term is dense,
as the reference's sum op makes it (regularizer.py:42)."""
from __future__ import annotations

from .layers.helper import LayerHelper


class WeightDecayRegularizer:
    def append_regularization_op(self, param, grad):
        raise NotImplementedError


class L2DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self.coeff = regularization_coeff

    def append_regularization_op(self, param, grad):
        helper = LayerHelper("l2_decay")
        decay = helper.create_variable_for_type_inference(param.dtype, True)
        helper.append_op(
            type="scale",
            inputs={"X": [param.name]},
            outputs={"Out": [decay.name]},
            attrs={"scale": self.coeff},
        )
        out = helper.create_variable_for_type_inference(param.dtype, True)
        helper.append_op(
            type="sum",
            inputs={"X": [grad.name, decay.name]},
            outputs={"Out": [out.name]},
            attrs={},
        )
        return out


class L1DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self.coeff = regularization_coeff

    def append_regularization_op(self, param, grad):
        helper = LayerHelper("l1_decay")
        sign = helper.create_variable_for_type_inference(param.dtype, True)
        helper.append_op(
            type="sign",
            inputs={"X": [param.name]},
            outputs={"Out": [sign.name]},
            attrs={},
        )
        decay = helper.create_variable_for_type_inference(param.dtype, True)
        helper.append_op(
            type="scale",
            inputs={"X": [sign.name]},
            outputs={"Out": [decay.name]},
            attrs={"scale": self.coeff},
        )
        out = helper.create_variable_for_type_inference(param.dtype, True)
        helper.append_op(
            type="sum",
            inputs={"X": [grad.name, decay.name]},
            outputs={"Out": [out.name]},
            attrs={},
        )
        return out


L1Decay = L1DecayRegularizer
L2Decay = L2DecayRegularizer
