"""Neural-net ops of the ported training path: layer norm, dropout,
softmax with cross entropy, the squared error.

Counterpart of paddle_tpu/ops/nn.py (parity: operators/layer_norm_op.cc,
dropout_op.cc, softmax_with_cross_entropy_op.cc), with its numerics:
layer norm over the trailing axes with the population variance and eps
1e-5; cross entropy with ``ignore_index``.  Dropout draws its mask from a
``torch.Generator`` seeded with the op's seed, so it cannot repeat the
JAX package's mask: parity runs at dropout 0.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.registry import out, register_op, single


@register_op("layer_norm", inputs=("X", "Scale", "Bias"),
             outputs=("Y", "Mean", "Variance"))
def layer_norm(ctx, inputs, attrs):
    x = single(inputs, "X")
    scale = single(inputs, "Scale")
    bias = single(inputs, "Bias")
    begin = attrs.get("begin_norm_axis", 1)
    eps = attrs.get("epsilon", 1e-5)
    norm_shape = tuple(x.shape[begin:])
    y = F.layer_norm(
        x, norm_shape,
        None if scale is None else scale.reshape(norm_shape),
        None if bias is None else bias.reshape(norm_shape), eps)
    # the statistics are outputs of the op but feed no gradient
    var, mean = torch.var_mean(x.detach(), dim=tuple(range(begin, x.dim())),
                               correction=0)
    return out(Y=y, Mean=mean, Variance=var)


@register_op("dropout", inputs=("X",), outputs=("Out", "Mask"),
             needs_rng=True)
def dropout(ctx, inputs, attrs):
    x = single(inputs, "X")
    p = attrs.get("dropout_prob", 0.5)
    impl = attrs.get("dropout_implementation", "downgrade_in_infer")
    if ctx.is_test or p == 0.0:
        # Reference (dropout_op.cc): at inference, downgrade_in_infer scales
        # by (1-p); upscale_in_train is identity.
        y = x * (1.0 - p) if impl == "downgrade_in_infer" else x
        return out(Out=y, Mask=torch.ones_like(x))
    if p >= 1.0:
        z = torch.zeros_like(x)
        return out(Out=z, Mask=z)
    keep_prob = 1.0 - p
    gen = torch.Generator(device=x.device).manual_seed(ctx.rng)
    m = (torch.rand(x.shape, generator=gen, device=x.device)
         < keep_prob).to(x.dtype)
    y = x * m / keep_prob if impl == "upscale_in_train" else x * m
    return out(Out=y, Mask=m)


@register_op("softmax_with_cross_entropy", inputs=("Logits", "Label"),
             outputs=("Softmax", "Loss"), no_grad_slots=("Label",))
def softmax_with_cross_entropy(ctx, inputs, attrs):
    logits = single(inputs, "Logits")
    label = single(inputs, "Label")
    axis = attrs.get("axis", -1) % logits.dim()
    logp = torch.log_softmax(logits, dim=axis)
    if attrs.get("soft_label", False):
        loss = -(label * logp).sum(dim=axis, keepdim=True)
    else:
        label_sq = label.squeeze(axis) if label.dim() == logits.dim() \
            else label
        label_sq = label_sq.long()
        ignore = attrs.get("ignore_index", -100)
        n_class = logits.shape[axis]
        safe = label_sq.clamp(0, n_class - 1).unsqueeze(axis)
        valid = (label_sq != ignore).unsqueeze(axis)
        picked = torch.take_along_dim(logp, safe, dim=axis)
        loss = torch.where(valid, -picked, torch.zeros_like(picked))
    return out(Softmax=logp.exp(), Loss=loss)


@register_op("mse_loss", inputs=("X", "Y"), outputs=("Out",))
def mse_loss(ctx, inputs, attrs):
    x = single(inputs, "X")
    y = single(inputs, "Y")
    return out(Out=(x - y) ** 2)
