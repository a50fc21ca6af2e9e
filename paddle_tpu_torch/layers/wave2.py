"""Third-wave layer wrappers of the port: ``gather_nd``, ``beam_search``
and ``beam_search_decode`` (the NMT beam decoder's layers), ``cos_sim``
and the sequence layers ``sequence_pad``, ``_unpad``, ``_reshape``,
``_slice``, ``_scatter``, ``_enumerate``, ``_erase`` and ``_expand``.

Counterpart of paddle_tpu/layers/wave2.py (parity: the corresponding
fluid.layers functions); its other layers wait (ROADMAP.md Queue 1 item
6.4).  ``_simple`` manufactures the one-input/one-output wrappers, as the
reference's ``layer_function_generator`` does.
"""
from __future__ import annotations

from .helper import LayerHelper

__all__ = ["gather_nd", "beam_search", "beam_search_decode", "cos_sim",
           "sequence_pad", "sequence_unpad", "sequence_reshape",
           "sequence_slice", "sequence_scatter", "sequence_enumerate",
           "sequence_erase", "sequence_expand"]


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


def cos_sim(x, y, name=None):
    helper = LayerHelper("cos_sim")
    xv, yv = helper.input(x), helper.input(y)
    o = helper.create_variable_for_type_inference(xv.dtype)
    xn = helper.create_variable_for_type_inference(xv.dtype)
    yn = helper.create_variable_for_type_inference(xv.dtype)
    helper.append_op(type="cos_sim",
                     inputs={"X": [xv.name], "Y": [yv.name]},
                     outputs={"Out": [o.name], "XNorm": [xn.name],
                              "YNorm": [yn.name]}, attrs={})
    return o


def sequence_pad(x, pad_value, maxlen=None, length=None, name=None):
    helper = LayerHelper("sequence_pad")
    xv, pv = helper.input(x), helper.input(pad_value)
    ins = {"X": [xv.name], "PadValue": [pv.name]}
    if length is not None:
        ins["SeqLen"] = [helper.input(length).name]
    o = helper.create_variable_for_type_inference(xv.dtype)
    ol = helper.create_variable_for_type_inference("int64", True)
    helper.append_op(type="sequence_pad", inputs=ins,
                     outputs={"Out": [o.name], "Length": [ol.name]},
                     attrs={"padded_length": maxlen or -1})
    return o, ol


def sequence_unpad(x, length, name=None):
    return _simple("sequence_unpad", {"X": x, "Length": length}, {})


def sequence_reshape(input, new_dim, name=None):
    return _simple("sequence_reshape", {"X": input}, {"new_dim": new_dim})


def sequence_slice(input, offset, length, name=None):
    return _simple("sequence_slice",
                   {"X": input, "Offset": offset, "Length": length}, {})


def sequence_scatter(input, index, updates, name=None):
    return _simple("sequence_scatter",
                   {"X": input, "Ids": index, "Updates": updates}, {})


def sequence_enumerate(input, win_size, pad_value=0, name=None):
    return _simple("sequence_enumerate", {"X": input},
                   {"win_size": win_size, "pad_value": pad_value},
                   stop_gradient=True)


def sequence_erase(input, tokens, name=None):
    return _simple("sequence_erase", {"X": input},
                   {"tokens": list(tokens)}, stop_gradient=True)


def sequence_expand(x, y, ref_level=-1, name=None):
    return _simple("sequence_expand", {"X": x, "Y": y},
                   {"ref_level": ref_level})
