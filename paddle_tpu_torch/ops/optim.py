"""Optimizer update ops of the port: every dense update op of the JAX
package (sgd, momentum, adam, adamw, adagrad, decayed_adagrad, rmsprop,
adadelta, adamax, lamb, lars_momentum, ftrl, dpsgd).

Counterpart of paddle_tpu/ops/optim.py, formula for formula (parity:
operators/optimizers/).  As in the reference, parameter updates are ops
INSIDE the program; each returns the updated parameter and accumulators
as new tensors (never writing an input in place) and the Executor
writes them back to the scope.  ``sgd_sparse`` and ``adam_sparse``
take a SelectedRows gradient (Values, Rows): duplicate rows merge in a
fixed order and the scatter drops padding and out-of-range rows
(ops/misc2.py).  The JAX package's bf16-moment switch (``acc_dtype``) is
not carried over.
"""
from __future__ import annotations

import torch

from ..core.registry import out, register_op, single
from .misc2 import merge_table_rows, scatter_rows


@register_op("sgd", inputs=("Param", "Grad", "LearningRate"),
             outputs=("ParamOut",))
def sgd(ctx, inputs, attrs):
    p = single(inputs, "Param")
    g = single(inputs, "Grad")
    lr = single(inputs, "LearningRate")
    return {"ParamOut": [p - lr.to(p.dtype) * g.to(p.dtype)]}


@register_op("sgd_sparse", inputs=("Param", "Values", "Rows",
                                   "LearningRate"),
             outputs=("ParamOut",))
def sgd_sparse(ctx, inputs, attrs):
    """SGD over a SelectedRows gradient (parity: sgd_op.cc's
    SelectedRows branch): the merged rows' updates are added to their
    rows — no dense [vocab, dim] gradient ever exists; duplicate rows
    add up as the dense sum would."""
    p = single(inputs, "Param")
    lr = single(inputs, "LearningRate").to(p.dtype)
    merged, idx = merge_table_rows(single(inputs, "Values").to(p.dtype),
                                   single(inputs, "Rows"), p.shape[0])
    return {"ParamOut": [scatter_rows(p, idx, -lr * merged, True)]}


@register_op("adam_sparse",
             inputs=("Param", "Values", "Rows", "Moment1", "Moment2",
                     "LearningRate", "Beta1Pow", "Beta2Pow"),
             outputs=("ParamOut", "Moment1Out", "Moment2Out", "Beta1PowOut",
                      "Beta2PowOut"))
def adam_sparse(ctx, inputs, attrs):
    """Adam over a SelectedRows gradient (parity: adam_op.cc
    SelectedRows branch).

    Default (lazy_mode=False, the reference's default): EVERY row's
    moments decay each step and every param row updates — dense Adam on
    the scattered gradient.

    lazy_mode=True (adam_op.cc lazy_mode): moments and parameters update
    ONLY on the merged, touched rows; padding and out-of-range rows
    touch none."""
    p = single(inputs, "Param")
    m1 = single(inputs, "Moment1")
    m2 = single(inputs, "Moment2")
    lr = single(inputs, "LearningRate").to(p.dtype)
    b1p = single(inputs, "Beta1Pow")
    b2p = single(inputs, "Beta2Pow")
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    n = p.shape[0]
    merged, idx = merge_table_rows(single(inputs, "Values").to(p.dtype),
                                   single(inputs, "Rows"), n)
    lr_t = lr * torch.sqrt(1.0 - b2p) / (1.0 - b1p)
    pows = {"Beta1PowOut": [b1p * b1], "Beta2PowOut": [b2p * b2]}
    if not attrs.get("lazy_mode", False):
        g = scatter_rows(torch.zeros_like(p), idx, merged, False)
        m1_out = b1 * m1 + (1.0 - b1) * g
        m2_out = b2 * m2 + (1.0 - b2) * g * g
        p_out = p - lr_t * m1_out / (torch.sqrt(m2_out) + eps)
        return {"ParamOut": [p_out], "Moment1Out": [m1_out],
                "Moment2Out": [m2_out], **pows}
    # the dropped row n reads as row 0 here; its update is sliced off
    safe = idx.clamp(max=n - 1)
    m1r = b1 * m1[safe] + (1.0 - b1) * merged
    m2r = b2 * m2[safe] + (1.0 - b2) * merged * merged
    upd = -lr_t * m1r / (torch.sqrt(m2r) + eps)
    return {"ParamOut": [scatter_rows(p, idx, upd, True)],
            "Moment1Out": [scatter_rows(m1, idx, m1r, False)],
            "Moment2Out": [scatter_rows(m2, idx, m2r, False)], **pows}


@register_op("momentum",
             inputs=("Param", "Grad", "Velocity", "LearningRate"),
             outputs=("ParamOut", "VelocityOut"))
def momentum(ctx, inputs, attrs):
    p = single(inputs, "Param")
    g = single(inputs, "Grad").to(p.dtype)
    v = single(inputs, "Velocity")
    lr = single(inputs, "LearningRate").to(p.dtype)
    mu = attrs.get("mu", 0.9)
    v_out = mu * v + g
    if attrs.get("use_nesterov", False):
        p_out = p - (g + mu * v_out) * lr
    else:
        p_out = p - lr * v_out
    return out(ParamOut=p_out, VelocityOut=v_out)


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


@register_op("adamw",
             inputs=("Param", "Grad", "Moment1", "Moment2", "LearningRate",
                     "Beta1Pow", "Beta2Pow"),
             outputs=("ParamOut", "Moment1Out", "Moment2Out", "Beta1PowOut",
                      "Beta2PowOut"))
def adamw(ctx, inputs, attrs):
    """Adam with decoupled weight decay: ``- lr * weight_decay * p``."""
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
    wd = attrs.get("weight_decay", 0.01)
    m1_out = b1 * m1 + (1.0 - b1) * g
    m2_out = b2 * m2 + (1.0 - b2) * g * g
    lr_t = lr * torch.sqrt(1.0 - b2p) / (1.0 - b1p)
    p_out = p - lr_t * m1_out / (torch.sqrt(m2_out) + eps) - lr * wd * p
    return out(ParamOut=p_out, Moment1Out=m1_out, Moment2Out=m2_out,
               Beta1PowOut=b1p * b1, Beta2PowOut=b2p * b2)


@register_op("adagrad", inputs=("Param", "Grad", "Moment", "LearningRate"),
             outputs=("ParamOut", "MomentOut"))
def adagrad(ctx, inputs, attrs):
    p = single(inputs, "Param")
    g = single(inputs, "Grad").to(p.dtype)
    m = single(inputs, "Moment")
    lr = single(inputs, "LearningRate").to(p.dtype)
    eps = attrs.get("epsilon", 1e-6)
    m_out = m + g * g
    p_out = p - lr * g / (torch.sqrt(m_out) + eps)
    return out(ParamOut=p_out, MomentOut=m_out)


@register_op("decayed_adagrad",
             inputs=("Param", "Grad", "Moment", "LearningRate"),
             outputs=("ParamOut", "MomentOut"))
def decayed_adagrad(ctx, inputs, attrs):
    p = single(inputs, "Param")
    g = single(inputs, "Grad").to(p.dtype)
    m = single(inputs, "Moment")
    lr = single(inputs, "LearningRate").to(p.dtype)
    decay = attrs.get("decay", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    m_out = decay * m + (1.0 - decay) * g * g
    p_out = p - lr * g / (torch.sqrt(m_out) + eps)
    return out(ParamOut=p_out, MomentOut=m_out)


@register_op("rmsprop",
             inputs=("Param", "Grad", "MeanSquare", "MeanGrad", "Moment",
                     "LearningRate"),
             outputs=("ParamOut", "MeanSquareOut", "MeanGradOut",
                      "MomentOut"))
def rmsprop(ctx, inputs, attrs):
    p = single(inputs, "Param")
    g = single(inputs, "Grad").to(p.dtype)
    ms = single(inputs, "MeanSquare")
    mg = single(inputs, "MeanGrad")
    mom = single(inputs, "Moment")
    lr = single(inputs, "LearningRate").to(p.dtype)
    rho = attrs.get("decay", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    momentum = attrs.get("momentum", 0.0)
    ms_out = rho * ms + (1.0 - rho) * g * g
    if attrs.get("centered", False):
        mg_out = rho * mg + (1.0 - rho) * g
        denom = ms_out - mg_out * mg_out + eps
    else:
        mg_out = mg
        denom = ms_out + eps
    mom_out = momentum * mom + lr * g / torch.sqrt(denom)
    p_out = p - mom_out
    return out(ParamOut=p_out, MeanSquareOut=ms_out, MeanGradOut=mg_out,
               MomentOut=mom_out)


@register_op("adadelta",
             inputs=("Param", "Grad", "AvgSquaredGrad", "AvgSquaredUpdate"),
             outputs=("ParamOut", "AvgSquaredGradOut", "AvgSquaredUpdateOut"))
def adadelta(ctx, inputs, attrs):
    p = single(inputs, "Param")
    g = single(inputs, "Grad").to(p.dtype)
    ag = single(inputs, "AvgSquaredGrad")
    au = single(inputs, "AvgSquaredUpdate")
    rho = attrs.get("rho", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    ag_out = rho * ag + (1.0 - rho) * g * g
    update = -torch.sqrt((au + eps) / (ag_out + eps)) * g
    au_out = rho * au + (1.0 - rho) * update * update
    return out(ParamOut=p + update, AvgSquaredGradOut=ag_out,
               AvgSquaredUpdateOut=au_out)


@register_op("adamax",
             inputs=("Param", "Grad", "Moment", "InfNorm", "LearningRate",
                     "Beta1Pow"),
             outputs=("ParamOut", "MomentOut", "InfNormOut"))
def adamax(ctx, inputs, attrs):
    p = single(inputs, "Param")
    g = single(inputs, "Grad").to(p.dtype)
    m = single(inputs, "Moment")
    inf = single(inputs, "InfNorm")
    lr = single(inputs, "LearningRate").to(p.dtype)
    b1p = single(inputs, "Beta1Pow")
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    m_out = b1 * m + (1.0 - b1) * g
    inf_out = torch.maximum(b2 * inf, torch.abs(g) + eps)
    p_out = p - (lr / (1.0 - b1p)) * (m_out / inf_out)
    return out(ParamOut=p_out, MomentOut=m_out, InfNormOut=inf_out)


@register_op("lamb",
             inputs=("Param", "Grad", "Moment1", "Moment2", "LearningRate",
                     "Beta1Pow", "Beta2Pow"),
             outputs=("ParamOut", "Moment1Out", "Moment2Out", "Beta1PowOut",
                      "Beta2PowOut"))
def lamb(ctx, inputs, attrs):
    """LAMB layer-wise adaptive optimizer (parity:
    operators/optimizers/lamb_op.cc)."""
    p = single(inputs, "Param")
    g = single(inputs, "Grad").to(p.dtype)
    m1 = single(inputs, "Moment1")
    m2 = single(inputs, "Moment2")
    lr = single(inputs, "LearningRate").to(p.dtype)
    b1p = single(inputs, "Beta1Pow")
    b2p = single(inputs, "Beta2Pow")
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-6)
    wd = attrs.get("weight_decay", 0.01)
    m1_out = b1 * m1 + (1.0 - b1) * g
    m2_out = b2 * m2 + (1.0 - b2) * g * g
    m1_hat = m1_out / (1.0 - b1p)
    m2_hat = m2_out / (1.0 - b2p)
    r = m1_hat / (torch.sqrt(m2_hat) + eps) + wd * p
    p_norm = torch.sqrt(torch.sum(p * p))
    r_norm = torch.sqrt(torch.sum(r * r))
    one = torch.ones((), dtype=p.dtype, device=p.device)
    trust = torch.where((p_norm > 0.0) & (r_norm > 0.0), p_norm / r_norm,
                        one)
    p_out = p - lr * trust * r
    return out(ParamOut=p_out, Moment1Out=m1_out, Moment2Out=m2_out,
               Beta1PowOut=b1p * b1, Beta2PowOut=b2p * b2)


@register_op("lars_momentum",
             inputs=("Param", "Grad", "Velocity", "LearningRate"),
             outputs=("ParamOut", "VelocityOut"))
def lars_momentum(ctx, inputs, attrs):
    p = single(inputs, "Param")
    g = single(inputs, "Grad").to(p.dtype)
    v = single(inputs, "Velocity")
    lr = single(inputs, "LearningRate").to(p.dtype)
    mu = attrs.get("mu", 0.9)
    coeff = attrs.get("lars_coeff", 0.001)
    wd = attrs.get("lars_weight_decay", 0.0005)
    p_norm = torch.sqrt(torch.sum(p * p))
    g_norm = torch.sqrt(torch.sum(g * g))
    local_lr = torch.where(
        (p_norm > 0.0) & (g_norm > 0.0),
        lr * coeff * p_norm / (g_norm + wd * p_norm),
        lr,
    )
    v_out = mu * v + local_lr * (g + wd * p)
    return out(ParamOut=p - v_out, VelocityOut=v_out)


@register_op("ftrl",
             inputs=("Param", "Grad", "SquaredAccumulator",
                     "LinearAccumulator", "LearningRate"),
             outputs=("ParamOut", "SquaredAccumOut", "LinearAccumOut"))
def ftrl(ctx, inputs, attrs):
    p = single(inputs, "Param")
    g = single(inputs, "Grad").to(p.dtype)
    sq = single(inputs, "SquaredAccumulator")
    lin = single(inputs, "LinearAccumulator")
    lr = single(inputs, "LearningRate").to(p.dtype)
    l1 = attrs.get("l1", 0.0)
    l2 = attrs.get("l2", 0.0)
    power = attrs.get("lr_power", -0.5)
    new_sq = sq + g * g
    sigma = (new_sq ** -power - sq ** -power) / lr
    lin_out = lin + g - sigma * p
    x = torch.sign(lin_out) * l1 - lin_out
    y = new_sq ** -power / lr + 2.0 * l2
    p_out = torch.where(torch.abs(lin_out) > l1, x / y, torch.zeros_like(p))
    return out(ParamOut=p_out, SquaredAccumOut=new_sq, LinearAccumOut=lin_out)


@register_op("dpsgd", inputs=("Param", "Grad", "LearningRate"),
             outputs=("ParamOut",), needs_rng=True)
def dpsgd(ctx, inputs, attrs):
    """Differentially-private SGD (parity: optimizers/dpsgd_op.cc): clip
    the gradient to clip-norm and add Gaussian noise, drawn from the
    op's seed in the executor's stream (torch's normal, not
    jax.random's)."""
    p = single(inputs, "Param")
    g = single(inputs, "Grad").to(p.dtype)
    lr = single(inputs, "LearningRate").to(p.dtype)
    clip = attrs.get("clip", 10.0)
    sigma = attrs.get("sigma", 1.0)
    batch_size = attrs.get("batch_size", 8.0)
    g_norm = torch.sqrt(torch.sum(g * g))
    g = g * torch.clamp(clip / torch.clamp_min(g_norm, 1e-12), max=1.0)
    gen = torch.Generator(device=g.device).manual_seed(ctx.rng)
    noise = sigma * clip * torch.randn(g.shape, generator=gen,
                                       dtype=g.dtype, device=g.device)
    return {"ParamOut": [p - lr * (g + noise / batch_size)]}
