"""Second-wave layer wrappers of the port: ``label_smooth``.

Counterpart of paddle_tpu/layers/extras.py (parity: fluid.layers
label_smooth); its other 16 layers wait (ROADMAP.md Queue 1 item
6.4).
"""
from __future__ import annotations

from .helper import LayerHelper

__all__ = ["label_smooth"]


def _one(helper, op_type, inputs, attrs, dtype, out_slot="Out",
         stop_gradient=False):
    o = helper.create_variable_for_type_inference(dtype, stop_gradient)
    helper.append_op(type=op_type, inputs=inputs,
                     outputs={out_slot: [o.name]}, attrs=attrs)
    return o


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    helper = LayerHelper("label_smooth", name=name)
    x = helper.input(label)
    ins = {"X": [x.name]}
    if prior_dist is not None:
        ins["PriorDist"] = [helper.input(prior_dist).name]
    return _one(helper, "label_smooth", ins, {"epsilon": epsilon},
                x.dtype)
