"""Gradient clipping: a copy of paddle_tpu/clip.py (parity:
python/paddle/fluid/clip.py: GradientClipByValue, GradientClipByNorm,
GradientClipByGlobalNorm).

Each clip appends ops to the program after the backward pass, so the
norms and scales run inside the step.  A SelectedRows (sparse embedding)
gradient keeps its (Values, Rows) pair: its norm merges duplicate rows
(``squared_l2_norm_sparse``), a by-value clip merges then clips
(``clip_sparse``), and a scale multiplies the values."""
from __future__ import annotations

from .layers import tensor as T
from .layers.helper import LayerHelper


class GradientClipBase:
    def apply(self, params_grads):
        raise NotImplementedError


def _sparse_rows(g):
    return getattr(g, "sparse_rows", None)


def _scale_sparse(g, scale_var):
    """values *= scale (a scalar var), keeping the (values, rows)
    SelectedRows association — scaling is linear, so unmerged duplicate
    rows stay correct."""
    from .layers import nn as N

    scaled = N.elementwise_mul(g, scale_var)
    scaled.sparse_rows = g.sparse_rows
    return scaled


def _sparse_sq_norm(helper, g):
    """squared_l2_norm of a SelectedRows grad with duplicate rows merged
    (reference clip.py:398 merge + get_tensor path)."""
    sq = helper.create_variable_for_type_inference("float32", True)
    helper.append_op(
        type="squared_l2_norm_sparse",
        inputs={"Values": [g.name], "Rows": [g.sparse_rows]},
        outputs={"Out": [sq.name]},
        attrs={},
        infer_shape=False,
    )
    sq.shape = []
    return sq


class GradientClipByValue(GradientClipBase):
    def __init__(self, max, min=None):
        self.max = max
        self.min = -max if min is None else min

    def apply(self, params_grads):
        result = []
        for p, g in params_grads:
            if _sparse_rows(g) is None:
                result.append((p, T.clip(g, self.min, self.max)))
                continue
            # SelectedRows: merge duplicates, clip the merged values
            # (clip_op.h SelectedRows branch — clip(sum), not sum(clip))
            helper = LayerHelper("clip_sparse")
            nv = helper.create_variable_for_type_inference(g.dtype, True)
            nr = helper.create_variable_for_type_inference("int64", True)
            helper.append_op(
                type="clip_sparse",
                inputs={"Values": [g.name], "Rows": [g.sparse_rows]},
                outputs={"OutValues": [nv.name], "OutRows": [nr.name]},
                attrs={"min": float(self.min), "max": float(self.max),
                       # out-of-bounds padding row id for the merge —
                       # dropped by downstream scatters
                       "pad_row": int(p.shape[0])},
                infer_shape=False,
            )
            nv.shape = list(g.shape)
            nr.shape = [None]
            nv.sparse_rows = nr.name
            result.append((p, nv))
        return result


class GradientClipByNorm(GradientClipBase):
    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def apply(self, params_grads):
        result = []
        for p, g in params_grads:
            if _sparse_rows(g) is None:
                result.append((p, T.clip_by_norm(g, self.clip_norm)))
                continue
            # norm over merged rows; scale the unmerged values (linear)
            from .layers import nn as N

            helper = LayerHelper("clip_by_norm_sparse")
            norm = N.sqrt(_sparse_sq_norm(helper, g))
            max_norm = T.fill_constant([], "float32", self.clip_norm)
            scale = N.elementwise_div(
                max_norm, N.elementwise_max(norm, max_norm))
            result.append((p, _scale_sparse(g, scale)))
        return result


class GradientClipByGlobalNorm(GradientClipBase):
    """Scale all grads by clip_norm / max(global_norm, clip_norm)."""

    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def apply(self, params_grads):
        if not params_grads:
            return params_grads
        helper = LayerHelper("global_norm_clip")
        sq_norms = []
        for _, g in params_grads:
            if _sparse_rows(g) is not None:
                sq_norms.append(_sparse_sq_norm(helper, g))
                continue
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
        from .layers import nn as N

        global_norm = N.sqrt(total)
        max_norm = T.fill_constant([], "float32", self.clip_norm)
        # scale = clip_norm / max(global_norm, clip_norm)
        bigger = N.elementwise_max(global_norm, max_norm)
        scale_var = N.elementwise_div(max_norm, bigger)
        return [(p, _scale_sparse(g, scale_var)
                 if _sparse_rows(g) is not None
                 else N.elementwise_mul(g, scale_var))
                for p, g in params_grads]


# parity aliases
ErrorClipByValue = GradientClipByValue
