"""Miscellaneous ops of the port: ``label_smooth``.

Counterpart of paddle_tpu/ops/misc.py (parity:
operators/label_smooth_op.cc); its other 15 ops wait (ROADMAP.md
Queue 1 item 6.5).
"""
from __future__ import annotations

from ..core.registry import out, register_op, single


@register_op("label_smooth", inputs=("X", "PriorDist"), outputs=("Out",),
             no_grad_slots=("PriorDist",))
def label_smooth(ctx, inputs, attrs):
    """``(1 - eps) * X + eps / K`` over the last axis's K classes, or
    ``+ eps * PriorDist`` when a prior is given."""
    x = single(inputs, "X")
    prior = single(inputs, "PriorDist")
    eps = float(attrs.get("epsilon", 0.1))
    if prior is None:
        return out(Out=(1 - eps) * x + eps / x.shape[-1])
    return out(Out=(1 - eps) * x + eps * prior)
