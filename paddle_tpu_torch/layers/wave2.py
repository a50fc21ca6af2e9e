"""Third-wave layer wrappers of the port: ``gather_nd``, ``beam_search``
and ``beam_search_decode``, the layers of the NMT beam decoder.

Counterpart of paddle_tpu/layers/wave2.py (parity: the corresponding
fluid.layers functions); its other layers wait (ROADMAP.md Queue 1 item
6).  ``_simple`` manufactures the one-input/one-output wrappers, as the
reference's ``layer_function_generator`` does.
"""
from __future__ import annotations

from .helper import LayerHelper

__all__ = ["gather_nd", "beam_search", "beam_search_decode"]


def _simple(op_type, in_slots, attrs, helper_name=None, out_slot="Out",
            dtype=None, stop_gradient=False):
    """One-output op call: in_slots is {slot: var-or-list}; attrs plain."""
    helper = LayerHelper(helper_name or op_type)
    ins = {}
    first = None
    for slot, v in in_slots.items():
        if v is None:
            continue
        vs = v if isinstance(v, (list, tuple)) else [v]
        vs = [helper.input(x) for x in vs]
        if first is None and vs:
            first = vs[0]
        ins[slot] = [x.name for x in vs]
    o = helper.create_variable_for_type_inference(
        dtype or (first.dtype if first is not None else "float32"),
        stop_gradient)
    helper.append_op(type=op_type, inputs=ins,
                     outputs={out_slot: [o.name]}, attrs=attrs)
    return o


def gather_nd(input, index, name=None):
    return _simple("gather_nd", {"X": input, "Index": index}, {})


def beam_search(pre_ids, pre_scores, ids, scores, beam_size, end_id,
                is_accumulated=True, name=None):
    helper = LayerHelper("beam_search")
    pi, ps = helper.input(pre_ids), helper.input(pre_scores)
    sc = helper.input(scores)
    ins = {"pre_ids": [pi.name], "pre_scores": [ps.name],
           "scores": [sc.name]}
    if ids is not None:
        ins["ids"] = [helper.input(ids).name]
    sel_ids = helper.create_variable_for_type_inference("int64", True)
    sel_sc = helper.create_variable_for_type_inference("float32", True)
    parent = helper.create_variable_for_type_inference("int32", True)
    helper.append_op(type="beam_search", inputs=ins,
                     outputs={"selected_ids": [sel_ids.name],
                              "selected_scores": [sel_sc.name],
                              "parent_idx": [parent.name]},
                     attrs={"beam_size": beam_size, "end_id": end_id,
                            "is_accumulated": is_accumulated})
    return sel_ids, sel_sc, parent


def beam_search_decode(ids, scores, parent_idx, beam_size, end_id,
                       name=None):
    helper = LayerHelper("beam_search_decode")
    iv, sv = helper.input(ids), helper.input(scores)
    pv = helper.input(parent_idx)
    sent = helper.create_variable_for_type_inference("int64", True)
    ssc = helper.create_variable_for_type_inference("float32", True)
    helper.append_op(type="beam_search_decode",
                     inputs={"Ids": [iv.name], "Scores": [sv.name],
                             "ParentIdx": [pv.name]},
                     outputs={"SentenceIds": [sent.name],
                              "SentenceScores": [ssc.name]},
                     attrs={"beam_size": beam_size, "end_id": end_id})
    return sent, ssc
