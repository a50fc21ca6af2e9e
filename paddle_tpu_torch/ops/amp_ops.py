"""Loss-scaling ops of float16 AMP (counterpart of paddle_tpu/ops/
amp_ops.py; parity: the check_finite_and_unscale and update_loss_scaling
operators of fluid/contrib/mixed_precision).  Both run in float32 (the
AMP black list) on the step's device; neither reads a value on the host.
"""
from __future__ import annotations

import torch

from ..core.registry import register_op, single


@register_op("check_finite_and_unscale", inputs=("X", "Scale"),
             outputs=("Out", "FoundInfinite"))
def check_finite_and_unscale(ctx, inputs, attrs):
    """Every gradient divided by Scale; FoundInfinite when any result is
    not finite, and then every output is zero.  As in the JAX package
    (a documented difference from the reference, which skips the whole
    update on overflow): zero gradients leave SGD and momentum parameters
    unchanged and decay only the adaptive moments."""
    scale = single(inputs, "Scale").float()
    xs = [x.float() / scale for x in inputs["X"]]
    finite = torch.ones((), dtype=torch.bool, device=scale.device)
    for x in xs:
        finite = finite & torch.isfinite(x).all()
    found_inf = ~finite
    outs = [torch.where(found_inf, torch.zeros_like(x), x) for x in xs]
    return {"Out": outs, "FoundInfinite": [found_inf]}


@register_op("update_loss_scaling",
             inputs=("FoundInfinite", "PrevLossScaling", "InGoodSteps",
                     "InBadSteps"),
             outputs=("LossScaling", "OutGoodSteps", "OutBadSteps"))
def update_loss_scaling(ctx, inputs, attrs):
    """Dynamic loss scaling: after ``incr_every_n_steps`` finite steps in
    a row the scale grows by ``incr_ratio``; after
    ``decr_every_n_nan_or_inf`` overflowing steps in a row it shrinks by
    ``decr_ratio`` (never below 1); either change restarts both
    counters."""
    found_inf = single(inputs, "FoundInfinite")
    scale = single(inputs, "PrevLossScaling")
    good = single(inputs, "InGoodSteps")
    bad = single(inputs, "InBadSteps")
    incr_every = attrs.get("incr_every_n_steps", 1000)
    decr_every = attrs.get("decr_every_n_nan_or_inf", 2)
    incr_ratio = attrs.get("incr_ratio", 2.0)
    decr_ratio = attrs.get("decr_ratio", 0.5)

    zero = torch.zeros_like(good)
    new_good = torch.where(found_inf, zero, good + 1)
    new_bad = torch.where(found_inf, bad + 1, zero)
    should_incr = new_good >= incr_every
    should_decr = new_bad >= decr_every
    new_scale = torch.where(
        should_decr, torch.clamp(scale * decr_ratio, min=1.0),
        torch.where(should_incr, scale * incr_ratio, scale))
    changed = should_incr | should_decr
    new_good = torch.where(changed, zero, new_good)
    new_bad = torch.where(changed, zero, new_bad)
    return {"LossScaling": [new_scale], "OutGoodSteps": [new_good],
            "OutBadSteps": [new_bad]}
