"""Neural-net ops of the ported training path: the convolutions, pooling,
batch and layer norm, dropout, the losses (softmax and plain cross
entropy, sigmoid cross entropy, smooth L1, Huber, the squared error) and
the batch metrics (accuracy, AUC).

Counterpart of paddle_tpu/ops/nn.py (parity: operators/conv_op.cc,
conv_transpose_op.cc, pool_op.cc, batch_norm_op.cc, layer_norm_op.cc,
dropout_op.cc, softmax_with_cross_entropy_op.cc, cross_entropy_op.cc,
sigmoid_cross_entropy_with_logits_op.cc, smooth_l1_loss_op.cc,
huber_loss_op.cc, metrics/accuracy_op.cc, metrics/auc_op.cc), with its
numerics:
NCHW convolutions with symmetric paddings (``F.conv2d``, cuDNN on the
card: the JAX package has no Pallas kernel for them, and
``_device.set_strict_fp32`` keeps cuDNN off TF32); max pooling over
``-inf`` padding, average pooling dividing by the real cells when
``exclusive``; batch norm with f32 batch statistics (the population
variance) and f32 running statistics; layer norm over the trailing axes with the population variance and eps
1e-5; cross entropy with ``ignore_index``.  Dropout draws its mask from a
``torch.Generator`` seeded with the op's seed, so it cannot repeat the
JAX package's mask: parity runs at dropout 0.  The ``fused_attention``
op over the flash kernels (ops/flash_attention.py) registers here, so
the kernel wrappers load without the program IR.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.registry import out, register_op, single
from . import flash_attention as _fa


def _pair(v):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return (int(v), int(v))


@register_op("conv2d", inputs=("Input", "Filter", "Bias"),
             outputs=("Output",))
def conv2d(ctx, inputs, attrs):
    """NCHW input, OIHW filter, optional per-channel Bias."""
    x = single(inputs, "Input")
    w = single(inputs, "Filter")
    b = single(inputs, "Bias")
    y = F.conv2d(x, w, None if b is None else b.reshape(-1),
                 _pair(attrs.get("strides", [1, 1])),
                 _pair(attrs.get("paddings", [0, 0])),
                 _pair(attrs.get("dilations", [1, 1])),
                 int(attrs.get("groups", 1)))
    return {"Output": [y]}


@register_op("depthwise_conv2d", inputs=("Input", "Filter", "Bias"),
             outputs=("Output",))
def depthwise_conv2d(ctx, inputs, attrs):
    # conv2d's body with groups defaulted to the channel count, as the
    # JAX package shares it
    x = single(inputs, "Input")
    attrs = dict(attrs)
    attrs["groups"] = int(attrs.get("groups", x.shape[1]))
    return conv2d(ctx, inputs, attrs)


@register_op("conv2d_transpose", inputs=("Input", "Filter"),
             outputs=("Output",))
def conv2d_transpose(ctx, inputs, attrs):
    """The JAX package's op: ``lax.conv_transpose(x, swapaxes(w, 0, 1),
    transpose_kernel=True)``, which is torch's ``conv_transpose2d`` over
    the filter with its first two axes swapped — so the filter's axis 1
    is the input's channels, as in that op (its layer creates [in_c,
    out_c, H, W], which runs only when the two are equal).  Its explicit
    padding ``p`` pads the stride-dilated input: torch's ``padding = k -
    1 - p``; a ``p`` past ``k - 1`` only adds zero borders."""
    x = single(inputs, "Input")
    w = single(inputs, "Filter").transpose(0, 1)
    strides = _pair(attrs.get("strides", [1, 1]))
    pads = _pair(attrs.get("paddings", [0, 0]))
    tpad = [int(k) - 1 - p for k, p in zip(w.shape[2:], pads)]
    y = F.conv_transpose2d(x, w, None, strides,
                           tuple(max(q, 0) for q in tpad))
    extra = [max(-q, 0) for q in tpad]
    if any(extra):
        y = F.pad(y, (extra[1], extra[1], extra[0], extra[0]))
    return {"Output": [y]}


@register_op("pool2d", inputs=("X",), outputs=("Out",))
def pool2d(ctx, inputs, attrs):
    """max / avg over NCHW windows; ``global_pooling`` takes the whole
    map, ``adaptive`` (divisible sizes) an output of ``ksize``."""
    x = single(inputs, "X")
    ptype = attrs.get("pooling_type", "max")
    if attrs.get("global_pooling", False):
        ksize, pads, strides = (x.shape[2], x.shape[3]), (0, 0), (1, 1)
    else:
        ksize = _pair(attrs.get("ksize", [2, 2]))
        strides = _pair(attrs.get("strides", ksize))
        pads = _pair(attrs.get("paddings", [0, 0]))
    if attrs.get("adaptive", False):
        oh, ow = ksize
        ksize = (x.shape[2] // oh, x.shape[3] // ow)
        strides, pads = ksize, (0, 0)
    ksize = tuple(int(k) for k in ksize)
    # torch pads at most half a window itself; wider pads go in first
    own = all(p <= k // 2 for p, k in zip(pads, ksize))
    pad4 = (pads[1], pads[1], pads[0], pads[0])
    if ptype == "max":
        if own:
            return out(Out=F.max_pool2d(x, ksize, strides, pads))
        return out(Out=F.max_pool2d(F.pad(x, pad4, value=float("-inf")),
                                    ksize, strides))
    exclusive = attrs.get("exclusive", True) and pads != (0, 0)
    if own:
        return out(Out=F.avg_pool2d(x, ksize, strides, pads,
                                    count_include_pad=not exclusive))
    window = float(ksize[0] * ksize[1])
    summed = F.avg_pool2d(F.pad(x, pad4), ksize, strides) * window
    if not exclusive:
        return out(Out=summed / window)
    ones = F.pad(torch.ones_like(x[:1, :1]), pad4)
    counts = F.avg_pool2d(ones, ksize, strides) * window
    return out(Out=summed / counts)


@register_op("batch_norm",
             inputs=("X", "Scale", "Bias", "Mean", "Variance"),
             outputs=("Y", "MeanOut", "VarianceOut", "SavedMean",
                      "SavedVariance"))
def batch_norm(ctx, inputs, attrs):
    """Parity: operators/batch_norm_op.cc.  Training normalizes by the
    batch mean and population variance (taken in f32) and emits the
    running statistics ``momentum * old + (1 - momentum) * batch`` in
    f32 (MeanOut/VarianceOut alias the Mean/Variance persistables);
    ``is_test`` or ``use_global_stats`` normalizes by the running
    statistics.  The statistics outputs carry no graph: nothing
    differentiates them."""
    x = single(inputs, "X")
    scale = single(inputs, "Scale")
    bias = single(inputs, "Bias")
    mean = single(inputs, "Mean").detach()
    var = single(inputs, "Variance").detach()
    eps = float(attrs.get("epsilon", 1e-5))
    momentum = float(attrs.get("momentum", 0.9))
    nhwc = attrs.get("data_layout", "NCHW") != "NCHW" and x.dim() > 2
    xc = x.movedim(-1, 1) if nhwc else x
    if ctx.is_test or attrs.get("use_global_stats", False):
        y = F.batch_norm(xc, mean.to(x.dtype), var.to(x.dtype), scale, bias,
                         False, 0.0, eps)
        saved_mean, saved_var = mean, var
        mean_out, var_out = mean.float(), var.float()
    else:
        axes = (0,) + tuple(range(2, xc.dim()))
        batch_var, batch_mean = torch.var_mean(xc.detach().float(),
                                               dim=axes, correction=0)
        y = F.batch_norm(xc, None, None, scale, bias, True, 0.0, eps)
        saved_mean, saved_var = batch_mean, batch_var
        mean_out = momentum * mean.float() + (1.0 - momentum) * batch_mean
        var_out = momentum * var.float() + (1.0 - momentum) * batch_var
    if nhwc:
        y = y.movedim(1, -1)
    return out(Y=y, MeanOut=mean_out, VarianceOut=var_out,
               SavedMean=saved_mean, SavedVariance=saved_var)


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


def keep_mask(seed, rate, shape, device):
    """The dropout op's boolean keep mask for ``seed``: the one draw that
    the op and the row-parallel epilogue (core/fusion.py) both make."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return torch.rand(tuple(shape), generator=gen, device=device) \
        < 1.0 - rate


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
    m = keep_mask(ctx.rng, p, x.shape, x.device).to(x.dtype)
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


@register_op("cross_entropy", inputs=("X", "Label"), outputs=("Y",),
             no_grad_slots=("Label",))
def cross_entropy(ctx, inputs, attrs):
    """Parity: operators/cross_entropy_op.cc — X is a probability
    distribution (post-softmax); hard or soft labels."""
    x = single(inputs, "X")
    label = single(inputs, "Label")
    eps = 1e-12
    if attrs.get("soft_label", False):
        loss = -(label * torch.log(x.clamp_min(eps))).sum(-1, keepdim=True)
    else:
        if label.dim() == x.dim():
            label = label.squeeze(-1)
        label = label.long()
        valid = (label != attrs.get("ignore_index", -100))[..., None]
        safe = label.clamp(0, x.shape[-1] - 1)
        picked = torch.take_along_dim(x, safe[..., None], dim=-1)
        loss = torch.where(valid, -torch.log(picked.clamp_min(eps)),
                           torch.zeros_like(picked))
    return {"Y": [loss]}


@register_op("sigmoid_cross_entropy_with_logits", inputs=("X", "Label"),
             outputs=("Out",), no_grad_slots=("Label",))
def sigmoid_cross_entropy_with_logits(ctx, inputs, attrs):
    x = single(inputs, "X")
    label = single(inputs, "Label")
    loss = x.clamp_min(0.0) - x * label + torch.log1p(torch.exp(-x.abs()))
    ignore = attrs.get("ignore_index", -100)
    if ignore >= 0:
        loss = torch.where(label != ignore, loss, torch.zeros_like(loss))
    if attrs.get("normalize", False):
        n = (label != ignore).to(x.dtype).sum().clamp_min(1.0)
        loss = loss / n
    return out(Out=loss)


@register_op("smooth_l1_loss", inputs=("X", "Y"), outputs=("Out", "Diff"))
def smooth_l1_loss(ctx, inputs, attrs):
    x = single(inputs, "X")
    y = single(inputs, "Y")
    s2 = attrs.get("sigma", 1.0) ** 2
    diff = x - y
    ad = diff.abs()
    loss = torch.where(ad < 1.0 / s2, 0.5 * s2 * diff * diff, ad - 0.5 / s2)
    if x.dim() > 1:
        loss = loss.sum(dim=tuple(range(1, x.dim())))[..., None]
    return out(Out=loss, Diff=diff)


@register_op("huber_loss", inputs=("X", "Y"), outputs=("Out", "Residual"))
def huber_loss(ctx, inputs, attrs):
    x = single(inputs, "X")
    y = single(inputs, "Y")
    delta = attrs.get("delta", 1.0)
    r = y - x
    ar = r.abs()
    loss = torch.where(ar <= delta, 0.5 * r * r, delta * (ar - 0.5 * delta))
    return out(Out=loss, Residual=r)


@register_op("accuracy", inputs=("Out", "Label"), outputs=("Accuracy",),
             no_grad_slots=("Out", "Label"))
def accuracy(ctx, inputs, attrs):
    """Top-1 accuracy over the batch (argmax's first maximum, as
    jnp.argmax)."""
    pred = single(inputs, "Out")
    label = single(inputs, "Label")
    if label.dim() == pred.dim():
        label = label.squeeze(-1)
    top1 = pred.argmax(-1)
    return {"Accuracy": [(top1 == label.to(top1.dtype)).float().mean()]}


@register_op("auc", inputs=("Predict", "Label"), outputs=("AUC",),
             no_grad_slots=("Predict", "Label"))
def auc(ctx, inputs, attrs):
    """Batch AUC by the rank statistic (parity: metrics/auc_op.cc,
    simplified to a stateless batch computation, as in the JAX
    package): tied scores take ranks in a stable sort's order."""
    pred = single(inputs, "Predict")
    label = single(inputs, "Label").reshape(-1).float()
    score = pred[..., -1].reshape(-1) if pred.dim() > 1 else pred.reshape(-1)
    order = torch.argsort(score, stable=True)
    ranks = torch.empty_like(score).index_put(
        (order,), torch.arange(1, score.shape[0] + 1, dtype=score.dtype,
                               device=score.device))
    n_pos = label.sum()
    n_neg = label.shape[0] - n_pos
    auc_val = ((ranks * label).sum() - n_pos * (n_pos + 1) / 2.0) \
        / (n_pos * n_neg).clamp_min(1.0)
    return {"AUC": [auc_val]}


@register_op("mse_loss", inputs=("X", "Y"), outputs=("Out",))
def mse_loss(ctx, inputs, attrs):
    x = single(inputs, "X")
    y = single(inputs, "Y")
    return out(Out=(x - y) ** 2)


# -- the fused_attention operator (ops/flash_attention.py's kernels) --------

@register_op(_fa.OP, inputs=("Q", "K", "V", "Bias"),
             outputs=("Out",), needs_rng=True, no_grad_slots=("Bias",))
def fused_attention_op(ctx, inputs, attrs):
    """Fused scaled-dot-product attention op (parity:
    operators/fused/multihead_matmul_op.cu, but trainable).

    Packed Q/K/V [B, T, H] with attr num_heads, or Q/K/V [B, H, T, D]:
    the flash kernels of that layout on the card, their plain versions on
    the CPU, shapes alone on ``meta``.  Bias (optional): additive,
    broadcastable to [B, 1, 1, Tk] (packed) or [B, H, 1, Tk] (4-D); any
    other shape raises on the card and takes the plain composite on the
    CPU.  Attrs: causal, sm_scale, dropout_rate (0 at inference)."""
    q = single(inputs, "Q")
    k = single(inputs, "K")
    v = single(inputs, "V")
    bias = single(inputs, "Bias")
    causal = bool(attrs.get("causal", False))
    sm_scale = attrs.get("sm_scale")
    rate = 0.0 if ctx.is_test else float(attrs.get("dropout_rate", 0.0))
    if q.device.type == "meta":
        return out(Out=torch.empty(tuple(q.shape[:-1]) + (v.shape[-1],),
                                   dtype=q.dtype, device="meta"))
    if q.dim() == 3:
        return out(Out=_fa.flash_attention_packed(
            q, k, v, int(attrs["num_heads"]), bias=bias, causal=causal,
            sm_scale=sm_scale, dropout_rate=rate, seed=ctx.rng or 0))
    return out(Out=_fa.flash_attention(q, k, v, bias=bias, causal=causal,
                                       sm_scale=sm_scale, dropout_rate=rate,
                                       seed=ctx.rng or 0))
