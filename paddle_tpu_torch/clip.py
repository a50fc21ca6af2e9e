"""Gradient clipping: the dense paths of paddle_tpu/clip.py (parity:
python/paddle/fluid/clip.py: GradientClipByValue, GradientClipByNorm,
GradientClipByGlobalNorm).

Each clip appends ops to the program after the backward pass, so the
norms and scales run inside the step.  A SelectedRows (sparse embedding)
gradient raises: sparse gradients are not ported yet (ROADMAP.md, Queue
1 item 3)."""
from __future__ import annotations

from .layers import nn as N
from .layers import tensor as T
from .layers.helper import LayerHelper


class GradientClipBase:
    def apply(self, params_grads):
        raise NotImplementedError


def _dense(params_grads, what):
    for p, g in params_grads:
        if getattr(g, "sparse_rows", None) is not None:
            raise NotImplementedError(
                f"{what} of the SelectedRows gradient of {p.name}: sparse "
                f"gradients are not ported to paddle_tpu_torch yet "
                f"(ROADMAP.md, Queue 1 item 3)")
    return params_grads


class GradientClipByValue(GradientClipBase):
    def __init__(self, max, min=None):
        self.max = max
        self.min = -max if min is None else min

    def apply(self, params_grads):
        return [(p, T.clip(g, self.min, self.max))
                for p, g in _dense(params_grads, "GradientClipByValue")]


class GradientClipByNorm(GradientClipBase):
    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def apply(self, params_grads):
        return [(p, T.clip_by_norm(g, self.clip_norm))
                for p, g in _dense(params_grads, "GradientClipByNorm")]


class GradientClipByGlobalNorm(GradientClipBase):
    """Scale all grads by clip_norm / max(global_norm, clip_norm)."""

    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def apply(self, params_grads):
        if not params_grads:
            return params_grads
        _dense(params_grads, "GradientClipByGlobalNorm")
        helper = LayerHelper("global_norm_clip")
        sq_norms = []
        for _, g in params_grads:
            sq = helper.create_variable_for_type_inference(g.dtype, True)
            helper.append_op(
                type="squared_l2_norm",
                inputs={"X": [g.name]},
                outputs={"Out": [sq.name]},
                attrs={},
            )
            sq_norms.append(sq)
        total = helper.create_variable_for_type_inference("float32", True)
        helper.append_op(
            type="sum",
            inputs={"X": [v.name for v in sq_norms]},
            outputs={"Out": [total.name]},
            attrs={},
        )
        global_norm = N.sqrt(total)
        max_norm = T.fill_constant([], "float32", self.clip_norm)
        # scale = clip_norm / max(global_norm, clip_norm)
        bigger = N.elementwise_max(global_norm, max_norm)
        scale_var = N.elementwise_div(max_norm, bigger)
        return [(p, N.elementwise_mul(g, scale_var))
                for p, g in params_grads]


# parity aliases
ErrorClipByValue = GradientClipByValue
