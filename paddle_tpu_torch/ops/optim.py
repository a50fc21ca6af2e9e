"""Optimizer update ops of the port: ``sgd`` and ``adam``.

Counterpart of paddle_tpu/ops/optim.py (parity: operators/optimizers/
sgd_op.cc, adam_op.cc).  As in the reference, parameter updates are ops
INSIDE the program; each returns the updated parameter and accumulators
as new tensors and the Executor writes them back to the scope.
"""
from __future__ import annotations

import torch

from ..core.registry import out, register_op, single


@register_op("sgd", inputs=("Param", "Grad", "LearningRate"),
             outputs=("ParamOut",))
def sgd(ctx, inputs, attrs):
    p = single(inputs, "Param")
    g = single(inputs, "Grad")
    lr = single(inputs, "LearningRate")
    return {"ParamOut": [p - lr.to(p.dtype) * g.to(p.dtype)]}


@register_op("adam",
             inputs=("Param", "Grad", "Moment1", "Moment2", "LearningRate",
                     "Beta1Pow", "Beta2Pow"),
             outputs=("ParamOut", "Moment1Out", "Moment2Out", "Beta1PowOut",
                      "Beta2PowOut"))
def adam(ctx, inputs, attrs):
    p = single(inputs, "Param")
    g = single(inputs, "Grad").to(p.dtype)
    m1 = single(inputs, "Moment1")
    m2 = single(inputs, "Moment2")
    lr = single(inputs, "LearningRate").to(p.dtype)
    b1p = single(inputs, "Beta1Pow")
    b2p = single(inputs, "Beta2Pow")
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    m1_out = b1 * m1 + (1.0 - b1) * g
    m2_out = b2 * m2 + (1.0 - b2) * g * g
    lr_t = lr * torch.sqrt(1.0 - b2p) / (1.0 - b1p)
    p_out = p - lr_t * m1_out / (torch.sqrt(m2_out) + eps)
    return out(ParamOut=p_out, Moment1Out=m1_out, Moment2Out=m2_out,
               Beta1PowOut=b1p * b1, Beta2PowOut=b2p * b2)
