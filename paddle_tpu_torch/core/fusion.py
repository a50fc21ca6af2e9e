"""GEMM-epilogue fusion pass over Program op lists.

Counterpart of paddle_tpu/core/fusion.py (parity: the reference's fused
operators operators/fused/fused_fc_elementwise_layernorm_op.cu,
fused_bias_dropout_residual_layer_norm_op.cu and the IR passes that
rewrite graphs onto them).  The Program IR is never rewritten.  At
lowering time the planner (a near-copy of the JAX package's, so that
both packages plan the same groups) matches the op chains ``layers``
emits —

    mul/matmul -> elementwise_add(bias) -> [gelu|relu] -> [dropout]
               -> [elementwise_add(residual)] -> [layer_norm]

and, with block patterns, the attention entry (qkv mul -> bias -> three
slices -> fused_attention) and the FFN (mul -> bias -> act -> mul ->
[bias] -> tail) — and the lowerer runs each matched chain as ONE
differentiable group at its last member's position:

* ``gemm`` groups on the fused matmul-epilogue kernel
  (ops/fused_matmul.py);
* ``ffn_chain`` groups on the two-GEMM chain kernel (ops/ffn_chain.py),
  else on two fused matmul-epilogue calls;
* ``attn`` groups on the qkv-folded flash forward
  (ops/attention_epilogue.py), any tail replayed;
* a group whose shapes or dtypes its kernel does not take: a replay of
  its member ops, with the unfused lowering's semantics and random
  streams.  The predicates are static functions of shapes and dtypes;
  a kernel that fails raises.

Autograd takes the place of ``jax.vjp``: the group runs under autograd
on one detached leaf per (member uid, slot, index) of its external
inputs — never one per tensor, because a tensor that feeds two members
(the FFN input read by the up-projection and by the residual add) gets
one gradient per member from backward.py, which sums them with its own
``sum`` op.  The first member grad op (the last member's) calls
``torch.autograd.grad`` once and caches the per-leaf gradients; every
member grad op binds its own ``IG@slot`` outputs from that cache, and
internal edges stay unbound (``UNBOUND``).  The gradient ``sum`` ops of
internal edges (the qkv gradient summed over its three slices) are
skipped: their inputs are never bound.

Safety model: a chain is only fused when every intermediate is consumed
by exactly the next chain op (across ALL blocks), is not fetched, not
persistable, and not rewritten between the first and last member.

Each plan publishes its groups on the metrics registry, as in the JAX
package: ``fused_epilogue_hits_total{pattern}`` per group and
``fused_block_hits_total{pattern}`` per block family.

Not carried over from the JAX package: its environment switches, the
degradation registry and fault injection (whose only job is to fall
back), the tuning-plan override and AMP.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

from .._rng import fold_seed
from ..observability.monitor import FUSED_BLOCK_HITS, FUSED_EPILOGUE_HITS
from ..observability.registry import get_registry
from .program import EMPTY_VAR_NAME
from .registry import REGISTRY, OpContext

#: sentinel for "this grad slot is internal to a fused group: bind nothing"
UNBOUND = object()

_ACT_OPS = ("gelu", "relu")


@dataclasses.dataclass
class FusedGroup:
    gid: int
    members: list          # Operator objects, program order
    internal: frozenset    # var names produced and consumed inside the chain
    pattern: str           # e.g. "mul+bias+gelu"
    final_slot: str        # output slot of the last member ("Out" / "Y")
    roles: dict            # role -> (uid, slot, idx) into the group inputs
    act: object = None     # None | "gelu" | "relu"
    act_attrs: dict = dataclasses.field(default_factory=dict)
    dropout: object = None  # None | {"uid", "prob", "attrs"}
    norm: object = None     # None | {"type", "eps", "begin"}
    kind: str = "gemm"      # "gemm" | "attn" | "ffn_chain"
    extra: dict = dataclasses.field(default_factory=dict)

    @property
    def last_uid(self):
        return self.members[-1].uid


@dataclasses.dataclass
class FusionPlan:
    groups: list
    skip_uids: frozenset   # member uids whose ops are skipped in place
    by_last: dict          # last-member uid -> FusedGroup
    member_group: dict     # every member uid -> FusedGroup


class FusionExec:
    """Per-step execution state: one fresh instance per run of the block
    (group graphs and cached gradients must not leak across steps)."""

    def __init__(self, plan: FusionPlan):
        self.plan = plan
        self.state = {}  # gid -> [leaves, primal_outs|None, grads|None]


# --------------------------------------------------------------------------
# Pattern matching
# --------------------------------------------------------------------------


def plan_fusion(program, ops, feed_names, fetch_names,
                block_patterns=False):
    """Match fusible GEMM-epilogue chains in a top-level op list.

    With ``block_patterns`` the pass additionally matches block-level
    epilogue programs before falling back to the single-GEMM chains:
    qkv-projection -> slice x3 -> fused_attention spans, and
    mul -> bias -> act -> mul FFN up/down chains (both with the same
    optional dropout/residual/norm tail as the single-GEMM matcher).

    Returns a FusionPlan, or None when nothing fuses (or the program
    uses recompute/pipeline grads, whose forward re-traces would not see
    the plan — those paths stay unfused wholesale)."""
    for blk in program.blocks:
        for o in blk.ops:
            if o.type in ("recompute_grad", "pipeline_grad"):
                return None

    # reader occurrence counts across ALL blocks: sub-block ops may read
    # top-level vars through the environment closure
    readers = {}
    for blk in program.blocks:
        for o in blk.ops:
            for n in o.input_names():
                readers[n] = readers.get(n, 0) + 1
    fetch_set = set(fetch_names)
    feed_set = set(feed_names)

    consumers_top = {}   # name -> top-level op positions reading it
    writers_top = {}     # name -> top-level op positions writing it
    for pos, o in enumerate(ops):
        for n in set(o.input_names()):
            consumers_top.setdefault(n, []).append(pos)
        for n in o.output_names():
            writers_top.setdefault(n, []).append(pos)
    pos_of_uid = {o.uid: pos for pos, o in enumerate(ops)}

    block = program.global_block()

    def var_of(n):
        return block._find_var_recursive(n)

    def var_ndim(n):
        v = var_of(n)
        if v is None or v.shape is None:
            return None
        return len(v.shape)

    used = set()
    groups = []
    for i, op in enumerate(ops):
        if op.uid in used or op.type not in ("mul", "matmul"):
            continue
        if op.type == "mul":
            if op.attrs.get("y_num_col_dims", 1) != 1:
                continue
        else:
            if (op.attrs.get("transpose_X", False)
                    or op.attrs.get("transpose_Y", False)
                    or op.attrs.get("alpha", 1.0) != 1.0):
                continue
            wnd = var_ndim(op.inputs["Y"][0])
            if wnd is not None and wnd != 2:
                continue
        g = None
        if block_patterns:
            g = _match_attention_chain(ops, i, readers, fetch_set,
                                       feed_set, consumers_top, var_of,
                                       var_ndim, used)
            if g is None:
                g = _match_ffn_chain(ops, i, readers, fetch_set,
                                     feed_set, consumers_top, var_of,
                                     var_ndim, used)
            if g is not None and not _chain_safe(g, ops, pos_of_uid,
                                                 writers_top):
                g = None   # fall back to the single-GEMM matcher
        if g is None:
            g = _match_chain(ops, i, readers, fetch_set, feed_set,
                             consumers_top, var_of, var_ndim, used)
        if g is None:
            continue
        if not _chain_safe(g, ops, pos_of_uid, writers_top):
            continue
        groups.append(g)
        used.update(m.uid for m in g.members)

    # a group's grad ops (if any) must start at the LAST member — the
    # group cotangents are seeded from that op's output gradients
    groups = [g for g in groups if _grad_order_ok(g, ops)]
    if not groups:
        return None
    for gid, g in enumerate(groups):
        g.gid = gid
    _record_hits(groups, block_patterns)
    skip = set(m.uid for g in groups for m in g.members[:-1])
    for g in groups:
        skip.update(_internal_grad_sums(g, ops, readers, consumers_top,
                                        writers_top, fetch_set))
    return FusionPlan(
        groups=groups,
        skip_uids=frozenset(skip),
        by_last={g.last_uid: g for g in groups},
        member_group={m.uid: g for g in groups for m in g.members},
    )


def _match_chain(ops, i, readers, fetch_set, feed_set, consumers_top,
                 var_of, var_ndim, used):
    start = ops[i]
    members = [start]
    cur = start.outputs["Out"][0]
    out_nd = var_ndim(cur)
    roles = {"x": (start.uid, "X", 0), "w": (start.uid, "Y", 0)}
    pattern = [start.type]
    act = None
    act_attrs = {}
    dropout = None
    norm = None
    final_slot = "Out"

    # stage: 0=matmul 1=bias 2=act 3=dropout 4=residual 5=norm (terminal)
    stage = 0
    while stage < 5:
        if cur in fetch_set or cur in feed_set:
            break
        v = var_of(cur)
        if v is not None and v.persistable:
            break
        if readers.get(cur, 0) != 1:
            break
        cons = consumers_top.get(cur, [])
        if len(cons) != 1:
            break  # the single read is not a top-level op
        t = ops[cons[0]]
        if t.uid in used or any(t.uid == m.uid for m in members):
            break

        if t.type == "elementwise_add":
            xn, yn = t.inputs["X"][0], t.inputs["Y"][0]
            if xn == yn:
                break
            other = yn if xn == cur else xn
            ond = var_ndim(other)
            if ond is None:
                break
            axis = t.attrs.get("axis", -1)
            if (stage == 0 and xn == cur and ond == 1
                    and (axis == -1
                         or (out_nd is not None and axis == out_nd - 1))):
                roles["bias"] = (t.uid, "Y", 0)
                pattern.append("bias")
                stage = 1
            elif stage <= 3 and "residual" not in roles and ond == out_nd:
                roles["residual"] = (t.uid, "Y" if xn == cur else "X", 0)
                pattern.append("residual")
                stage = 4
            else:
                break
            cur = t.outputs["Out"][0]
        elif t.type in _ACT_OPS and stage <= 1:
            if t.inputs.get("X", [None])[0] != cur:
                break
            act = t.type
            act_attrs = dict(t.attrs)
            pattern.append(t.type)
            stage = 2
            cur = t.outputs["Out"][0]
        elif t.type == "dropout" and stage <= 2:
            if t.inputs.get("X", [None])[0] != cur:
                break
            impl = t.attrs.get("dropout_implementation",
                               "downgrade_in_infer")
            if impl != "upscale_in_train":
                break
            mask = t.outputs.get("Mask", [EMPTY_VAR_NAME])[0]
            if readers.get(mask, 0) != 0 or mask in fetch_set:
                break
            dropout = {"uid": t.uid,
                       "prob": float(t.attrs.get("dropout_prob", 0.5)),
                       "attrs": dict(t.attrs)}
            pattern.append("dropout")
            stage = 3
            cur = t.outputs["Out"][0]
        elif t.type == "layer_norm" and stage <= 4:
            if t.inputs.get("X", [None])[0] != cur:
                break
            begin = t.attrs.get("begin_norm_axis", 1)
            if out_nd is None or begin != out_nd - 1:
                break
            aux_ok = all(
                readers.get(t.outputs.get(s, [EMPTY_VAR_NAME])[0], 0) == 0
                and t.outputs.get(s, [EMPTY_VAR_NAME])[0] not in fetch_set
                for s in ("Mean", "Variance"))
            if not aux_ok:
                break
            if t.inputs.get("Scale"):
                roles["gamma"] = (t.uid, "Scale", 0)
            if t.inputs.get("Bias"):
                roles["beta"] = (t.uid, "Bias", 0)
            norm = {"type": "layer_norm",
                    "eps": float(t.attrs.get("epsilon", 1e-5)),
                    "begin": begin}
            pattern.append("layer_norm")
            stage = 5
            cur = t.outputs["Y"][0]
            final_slot = "Y"
        else:
            break
        members.append(t)

    if len(members) < 2:
        return None
    if "bias" not in roles and act is None and dropout is None \
            and norm is None:
        return None  # matmul+residual alone: no epilogue worth fusing

    internal = set()
    for m in members[:-1]:
        internal.update(n for n in m.output_names()
                        if n != EMPTY_VAR_NAME)
    # unused aux outputs of the LAST member (Mean/Variance) stay unbound
    # too when the kernel path runs; they are verified unread above.
    return FusedGroup(
        gid=-1, members=members, internal=frozenset(internal),
        pattern="+".join(pattern), final_slot=final_slot, roles=roles,
        act=act, act_attrs=act_attrs, dropout=dropout, norm=norm)


def _chain_next(ops, cur, readers, fetch_set, feed_set, consumers_top,
                var_of, used, members, n_readers=1):
    """The op(s) allowed to extend a chain through ``cur``: its
    ``n_readers`` top-level consumers, or None when ``cur`` escapes the
    chain (fetched, fed, persistable, read elsewhere, or read by an op
    already claimed)."""
    if cur in fetch_set or cur in feed_set:
        return None
    v = var_of(cur)
    if v is not None and v.persistable:
        return None
    if readers.get(cur, 0) != n_readers:
        return None
    cons = consumers_top.get(cur, [])
    if len(cons) != n_readers:
        return None
    ts = [ops[p] for p in sorted(cons)]
    for t in ts:
        if t.uid in used or any(t.uid == m.uid for m in members):
            return None
    return ts


def _match_tail(ops, cur, out_nd, readers, fetch_set, feed_set,
                consumers_top, var_of, var_ndim, used, members, roles,
                pattern):
    """Extend a block-level chain with the same optional
    [dropout] -> [residual add] -> [layer_norm] tail the single-GEMM
    matcher accepts (identical per-stage constraints).  Appends to
    ``members``/``roles``/``pattern`` in place; returns
    (dropout, norm, final_slot)."""
    dropout = None
    norm = None
    final_slot = None
    # mirror _match_chain stages: 3=dropout 4=residual 5=norm(terminal)
    stage = 2
    while stage < 5:
        ts = _chain_next(ops, cur, readers, fetch_set, feed_set,
                         consumers_top, var_of, used, members)
        if ts is None:
            break
        t = ts[0]
        if t.type == "dropout" and stage <= 2:
            if t.inputs.get("X", [None])[0] != cur:
                break
            impl = t.attrs.get("dropout_implementation",
                               "downgrade_in_infer")
            if impl != "upscale_in_train":
                break
            mask = t.outputs.get("Mask", [EMPTY_VAR_NAME])[0]
            if readers.get(mask, 0) != 0 or mask in fetch_set:
                break
            dropout = {"uid": t.uid,
                       "prob": float(t.attrs.get("dropout_prob", 0.5)),
                       "attrs": dict(t.attrs)}
            pattern.append("dropout")
            stage = 3
            cur = t.outputs["Out"][0]
        elif t.type == "elementwise_add" and stage <= 3 \
                and "residual" not in roles:
            xn, yn = t.inputs["X"][0], t.inputs["Y"][0]
            if xn == yn:
                break
            other = yn if xn == cur else xn
            ond = var_ndim(other)
            if ond is None or ond != out_nd:
                break
            roles["residual"] = (t.uid, "Y" if xn == cur else "X", 0)
            pattern.append("residual")
            stage = 4
            cur = t.outputs["Out"][0]
        elif t.type == "layer_norm":
            if t.inputs.get("X", [None])[0] != cur:
                break
            begin = t.attrs.get("begin_norm_axis", 1)
            if out_nd is None or begin != out_nd - 1:
                break
            aux_ok = all(
                readers.get(t.outputs.get(s, [EMPTY_VAR_NAME])[0], 0) == 0
                and t.outputs.get(s, [EMPTY_VAR_NAME])[0] not in fetch_set
                for s in ("Mean", "Variance"))
            if not aux_ok:
                break
            if t.inputs.get("Scale"):
                roles["gamma"] = (t.uid, "Scale", 0)
            if t.inputs.get("Bias"):
                roles["beta"] = (t.uid, "Bias", 0)
            norm = {"type": "layer_norm",
                    "eps": float(t.attrs.get("epsilon", 1e-5)),
                    "begin": begin}
            pattern.append("layer_norm")
            stage = 5
            final_slot = "Y"
        else:
            break
        members.append(t)
    return dropout, norm, final_slot


def _finish_block_group(members, roles, pattern, final_slot, kind,
                        act=None, act_attrs=None, dropout=None, norm=None,
                        extra=None):
    internal = set()
    for m in members[:-1]:
        internal.update(n for n in m.output_names()
                        if n != EMPTY_VAR_NAME)
    return FusedGroup(
        gid=-1, members=members, internal=frozenset(internal),
        pattern="+".join(pattern), final_slot=final_slot, roles=roles,
        act=act, act_attrs=act_attrs or {}, dropout=dropout, norm=norm,
        kind=kind, extra=extra or {})


def _bias_add_ok(t, cur, out_nd, var_ndim):
    """Stage-0 bias-add conditions from _match_chain: X is the chain
    value, Y a 1-D vector broadcast on the last axis."""
    xn, yn = t.inputs["X"][0], t.inputs["Y"][0]
    if xn != cur or xn == yn:
        return False
    if var_ndim(yn) != 1:
        return False
    axis = t.attrs.get("axis", -1)
    return axis == -1 or (out_nd is not None and axis == out_nd - 1)


def _match_attention_chain(ops, i, readers, fetch_set, feed_set,
                           consumers_top, var_of, var_ndim, used):
    """Match the packed-attention entry chain pt.layers emits:

        mul/matmul(x, w_qkv) -> elementwise_add(bias_qkv)
          -> slice[0:H] / slice[H:2H] / slice[2H:3H] -> fused_attention

    with the optional dropout/residual/norm tail.  The qkv bias add and
    the 1/sqrt(d) softmax scale then fold into the flash kernel entry
    (ops/attention_epilogue.py)."""
    start = ops[i]
    members = [start]
    cur = start.outputs["Out"][0]
    out_nd = var_ndim(cur)
    roles = {"x": (start.uid, "X", 0), "w": (start.uid, "Y", 0)}
    pattern = [start.type]

    ts = _chain_next(ops, cur, readers, fetch_set, feed_set,
                     consumers_top, var_of, used, members)
    if ts is None or ts[0].type != "elementwise_add" \
            or not _bias_add_ok(ts[0], cur, out_nd, var_ndim):
        return None
    t = ts[0]
    roles["qkv_bias"] = (t.uid, "Y", 0)
    pattern.append("bias")
    members.append(t)
    cur = t.outputs["Out"][0]

    # the packed qkv value: exactly three top-level slice readers that
    # partition the last axis into equal thirds
    v3 = var_of(cur)
    if v3 is None or v3.shape is None or int(v3.shape[-1]) % 3:
        return None
    h = int(v3.shape[-1]) // 3
    slices = _chain_next(ops, cur, readers, fetch_set, feed_set,
                         consumers_top, var_of, used, members,
                         n_readers=3)
    if slices is None or any(s.type != "slice" for s in slices):
        return None
    by_start = {}
    for s in slices:
        if s.inputs.get("Input", [None])[0] != cur:
            return None
        axes = s.attrs.get("axes") or []
        starts = s.attrs.get("starts") or []
        ends = s.attrs.get("ends") or []
        if len(axes) != 1 or len(starts) != 1 or len(ends) != 1:
            return None
        if out_nd is None or axes[0] != out_nd - 1:
            return None
        by_start[int(starts[0])] = (s, int(ends[0]))
    if sorted(by_start) != [0, h, 2 * h] \
            or any(by_start[st][1] != st + h for st in by_start):
        return None

    # all three slice outputs feed the SAME packed fused_attention op,
    # in Q/K/V slot order
    attn = None
    for st, slot in ((0, "Q"), (h, "K"), (2 * h, "V")):
        s = by_start[st][0]
        so = s.outputs["Out"][0]
        if so in fetch_set or so in feed_set:
            return None
        v = var_of(so)
        if v is not None and v.persistable:
            return None
        cons = consumers_top.get(so, [])
        if readers.get(so, 0) != 1 or len(cons) != 1:
            return None
        t2 = ops[cons[0]]
        if t2.uid in used or any(t2.uid == m.uid for m in members):
            return None
        if t2.type != "fused_attention" or "num_heads" not in t2.attrs:
            return None
        if t2.inputs.get(slot, [None])[0] != so:
            return None
        if attn is None:
            attn = t2
        elif attn.uid != t2.uid:
            return None
    members.extend(s for s, _ in (by_start[0], by_start[h],
                                  by_start[2 * h]))
    members.append(attn)
    if attn.inputs.get("Bias"):
        roles["attn_bias"] = (attn.uid, "Bias", 0)
    pattern.append("slice3")
    pattern.append("attention")
    extra = {"attn_pos": len(members) - 1}

    cur = attn.outputs["Out"][0]
    a_nd = var_ndim(cur)
    dropout, norm, fslot = _match_tail(
        ops, cur, a_nd, readers, fetch_set, feed_set, consumers_top,
        var_of, var_ndim, used, members, roles, pattern)
    return _finish_block_group(members, roles, pattern, fslot or "Out",
                               "attn", dropout=dropout, norm=norm,
                               extra=extra)


def _match_ffn_chain(ops, i, readers, fetch_set, feed_set, consumers_top,
                     var_of, var_ndim, used):
    """Match the FFN up/down projection chain:

        mul/matmul(x, w_up) -> bias -> gelu|relu -> mul/matmul(w_down)
          [-> bias] [-> dropout] [-> residual] [-> layer_norm]

    Where ``ffn_chain_shapes_ok`` holds the chain runs as ONE two-GEMM
    kernel (ops/ffn_chain.py); otherwise it lowers onto two single-GEMM
    fused kernels or the replay path."""
    start = ops[i]
    members = [start]
    cur = start.outputs["Out"][0]
    out_nd = var_ndim(cur)
    roles = {"x": (start.uid, "X", 0), "w1": (start.uid, "Y", 0)}
    pattern = [start.type]

    ts = _chain_next(ops, cur, readers, fetch_set, feed_set,
                     consumers_top, var_of, used, members)
    if ts is None or ts[0].type != "elementwise_add" \
            or not _bias_add_ok(ts[0], cur, out_nd, var_ndim):
        return None
    t = ts[0]
    roles["b1"] = (t.uid, "Y", 0)
    pattern.append("bias")
    members.append(t)
    cur = t.outputs["Out"][0]

    ts = _chain_next(ops, cur, readers, fetch_set, feed_set,
                     consumers_top, var_of, used, members)
    if ts is None or ts[0].type not in _ACT_OPS \
            or ts[0].inputs.get("X", [None])[0] != cur:
        return None
    t = ts[0]
    act, act_attrs = t.type, dict(t.attrs)
    pattern.append(t.type)
    members.append(t)
    cur = t.outputs["Out"][0]

    ts = _chain_next(ops, cur, readers, fetch_set, feed_set,
                     consumers_top, var_of, used, members)
    if ts is None or ts[0].type not in ("mul", "matmul") \
            or ts[0].inputs.get("X", [None])[0] != cur:
        return None
    t = ts[0]
    if t.type == "mul":
        if t.attrs.get("y_num_col_dims", 1) != 1:
            return None
    else:
        if (t.attrs.get("transpose_X", False)
                or t.attrs.get("transpose_Y", False)
                or t.attrs.get("alpha", 1.0) != 1.0):
            return None
    if var_ndim(t.inputs["Y"][0]) not in (2, None):
        return None
    roles["w2"] = (t.uid, "Y", 0)
    pattern.append(t.type)
    members.append(t)
    cur = t.outputs["Out"][0]
    out_nd2 = var_ndim(cur)

    ts = _chain_next(ops, cur, readers, fetch_set, feed_set,
                     consumers_top, var_of, used, members)
    if ts is not None and ts[0].type == "elementwise_add" \
            and _bias_add_ok(ts[0], cur, out_nd2, var_ndim):
        t = ts[0]
        roles["b2"] = (t.uid, "Y", 0)
        pattern.append("bias")
        members.append(t)
        cur = t.outputs["Out"][0]

    dropout, norm, fslot = _match_tail(
        ops, cur, out_nd2, readers, fetch_set, feed_set, consumers_top,
        var_of, var_ndim, used, members, roles, pattern)
    return _finish_block_group(members, roles, pattern, fslot or "Out",
                               "ffn_chain", act=act, act_attrs=act_attrs,
                               dropout=dropout, norm=norm)


def _chain_safe(g, ops, pos_of_uid, writers_top):
    """The group executes at the LAST member's position: every external
    input must still hold the value it had at its member's original
    position, and every internal var must have exactly one writer."""
    member_uids = {m.uid for m in g.members}
    p_last = pos_of_uid[g.members[-1].uid]
    for n in g.internal:
        if len(writers_top.get(n, [])) != 1:
            return False
    for m in g.members:
        p_m = pos_of_uid[m.uid]
        for n in m.input_names():
            if n in g.internal or n == EMPTY_VAR_NAME:
                continue
            for wp in writers_top.get(n, []):
                if p_m < wp <= p_last and ops[wp].uid not in member_uids:
                    return False
    return True


def _internal_grad_sums(g, ops, readers, consumers_top, writers_top,
                        fetch_set):
    """Gradient-accumulation ``sum`` ops subsumed by the group VJP.

    When an internal edge has several member readers (the qkv value
    feeding three slice ops), append_backward emits per-reader partial
    grads (@GRAD / @GRAD@RENAME_k) plus a ``sum`` combining them.  The
    partials are internal-edge gradients — unbound in the fused plan —
    so the sum must be skipped; that is safe exactly when every partial
    is written only by member vjp_grad ops and the summed gradient is
    read only by member vjp_grad ops (which bind from the shared group
    cotangents instead)."""
    member_uids = {m.uid for m in g.members}
    suffix = "@GRAD"

    def only_member_grads(name, skip_op):
        cons = consumers_top.get(name, [])
        if readers.get(name, 0) != len(cons):
            return False  # read from a sub-block: not subsumable
        for cp in cons:
            c = ops[cp]
            if c is skip_op:
                continue
            if c.type != "vjp_grad" \
                    or c.attrs.get("fwd_uid") not in member_uids:
                return False
        return True

    uids = []
    for o in ops:
        if o.type != "sum":
            continue
        on = o.outputs.get("Out", [EMPTY_VAR_NAME])[0]
        if on in fetch_set or not on.endswith(suffix):
            continue
        if on[:-len(suffix)] not in g.internal:
            continue
        ok = only_member_grads(on, o)
        for n in o.inputs.get("X", []):
            if not ok:
                break
            ok = only_member_grads(n, o)
            for wp in writers_top.get(n, []):
                w = ops[wp]
                if w is o:
                    continue
                if w.type != "vjp_grad" \
                        or w.attrs.get("fwd_uid") not in member_uids:
                    ok = False
                    break
        if ok:
            uids.append(o.uid)
    return uids


def _grad_order_ok(g, ops):
    member_uids = {m.uid for m in g.members}
    for o in ops:
        if o.type == "vjp_grad" and o.attrs.get("fwd_uid") in member_uids:
            # first group grad op in program order must be the last
            # forward member's (reverse emission order guarantees this
            # for append_backward; partial gradients() chains do not)
            return o.attrs["fwd_uid"] == g.last_uid
    return True


def _record_hits(groups, block_patterns=False):
    try:
        reg = get_registry()
        c = reg.counter(
            FUSED_EPILOGUE_HITS,
            "fused GEMM-epilogue chains lowered, by pattern")
        b = reg.counter(
            FUSED_BLOCK_HITS,
            "block-level epilogue programs lowered, by pattern family") \
            if block_patterns else None
        for g in groups:
            c.inc(1, pattern=g.pattern)
            if b is None:
                continue
            if g.kind == "attn":
                b.inc(1, pattern="attention_epilogue")
            elif g.kind == "ffn_chain":
                b.inc(1, pattern="ffn_chain")
            if "residual" in g.roles and g.norm is not None:
                b.inc(1, pattern="residual_norm_boundary")
    except Exception:  # noqa: BLE001 — metrics are non-load-bearing
        pass


# --------------------------------------------------------------------------
# Execution (called from core/lowering._interp_ops)
# --------------------------------------------------------------------------


def _group_inputs(grp, env, need_grad):
    """Every member's external inputs keyed ``(uid, slot, idx)``: one
    detached leaf per occurrence when the group is differentiated, so a
    tensor read by two members gets one gradient per member."""
    from .lowering import _leaf

    gins = {}
    for m in grp.members:
        for slot, names in m.inputs.items():
            for j, n in enumerate(names):
                if n != EMPTY_VAR_NAME and n not in grp.internal:
                    gins[(m.uid, slot, j)] = (_leaf(env[n]) if need_grad
                                              else env[n])
    return gins


def run_fused_group(fx, grp, env, seed, device, vjp_uids):
    """Execute one fused group at the last member's program position;
    returns the last member's outputs (detached).  When a member has a
    grad op the group runs under autograd and its leaves and outputs
    stay in ``fx.state`` for ``run_fused_grad``."""
    need_grad = any(m.uid in vjp_uids for m in grp.members)
    gins = _group_inputs(grp, env, need_grad)
    with torch.enable_grad() if need_grad else contextlib.nullcontext():
        outs = _run_group(grp, gins, seed, device)
    if need_grad:
        fx.state[grp.gid] = [gins, outs, None]
    return {slot: [v.detach() if torch.is_tensor(v) else v for v in vals]
            for slot, vals in outs.items()}


def _run_group(grp, gins, seed, device):

    cov = _try_kernel(grp, gins, seed)
    tmp = {}
    last_outs = None
    start_at = 0
    if cov is not None:
        n_cov, outs = cov
        if n_cov == len(grp.members):
            return outs
        # partial coverage (the attention kernel + a replayed tail): seed
        # the chain value from the covered member's outputs and replay
        # the remaining members through the registry
        covered = grp.members[n_cov - 1]
        for slot, names in covered.outputs.items():
            for n, v in zip(names, outs.get(slot, [])):
                if n != EMPTY_VAR_NAME:
                    tmp[n] = v
        start_at = n_cov
        last_outs = outs
    # replay path: the original member ops, in order, through the
    # registry — the unfused lowering's semantics and random streams
    for m in grp.members[start_at:]:
        ins = {slot: [tmp[n] if n in grp.internal
                      else gins.get((m.uid, slot, j))
                      for j, n in enumerate(names)]
               for slot, names in m.inputs.items()}
        opdef = REGISTRY.get(m.type)
        ctx = OpContext(
            rng=fold_seed(seed, m.uid) if opdef.needs_rng else None,
            is_test=bool(m.attrs.get("is_test", False)), attrs=m.attrs,
            device=device)
        outs = opdef.compute(ctx, ins, m.attrs)
        for slot, names in m.outputs.items():
            for n, v in zip(names, outs.get(slot, [])):
                if n != EMPTY_VAR_NAME:
                    tmp[n] = v
        last_outs = outs
    return last_outs


def _try_kernel(grp, gins, seed):
    """Lower the group onto its kernel when the shapes and dtypes allow.

    Returns ``(n_covered, outs)`` — the number of leading members the
    kernel covered and the covered member's outputs — or None for the
    replay path.  GEMM and FFN-chain kernels cover the whole group; the
    attention kernel covers through the fused_attention member and
    leaves any dropout/residual/norm tail to the replay loop."""
    if grp.kind == "attn":
        return _try_kernel_attn(grp, gins, seed)
    if grp.kind == "ffn_chain":
        return _try_kernel_ffn(grp, gins, seed)
    outs = _try_kernel_gemm(grp, gins, seed)
    return None if outs is None else (len(grp.members), outs)


def _group_getv(grp, gins):
    def getv(role):
        r = grp.roles.get(role)
        return None if r is None else gins.get(r)

    return getv


def _floating(*tensors):
    return all(t is None or (torch.is_tensor(t) and t.is_floating_point())
               for t in tensors)


def _rows(mm, x):
    """(x_num_col_dims, M, K) of a mul/matmul member's X, or None."""
    xnc = mm.attrs.get("x_num_col_dims", 1) if mm.type == "mul" \
        else x.dim() - 1
    if x.dim() < 2 or xnc < 1 or xnc >= x.dim():
        return None
    m_rows = k_dim = 1
    for d in x.shape[:xnc]:
        m_rows *= int(d)
    for d in x.shape[xnc:]:
        k_dim *= int(d)
    return xnc, m_rows, k_dim


def _dropout(grp, seed):
    """(rate, kernel seed) of the group's dropout member: the seed the
    unfused lowering would give that op."""

    if grp.dropout is None:
        return 0.0, 0
    if grp.dropout["attrs"].get("is_test", False):
        return 0.0, 0
    rate = grp.dropout["prob"]
    return rate, (fold_seed(seed, grp.dropout["uid"]) if rate > 0.0 else 0)


def _try_kernel_attn(grp, gins, seed):
    """qkv projection + bias + slice3 + packed flash attention as one
    kernel entry (ops/attention_epilogue.py): the qkv bias add and the
    softmax scale apply in the flash forward kernel."""
    from ..ops import attention_epilogue as ae

    getv = _group_getv(grp, gins)
    x, w, b_qkv = getv("x"), getv("w"), getv("qkv_bias")
    attn_bias = getv("attn_bias")
    if x is None or w is None or b_qkv is None:
        return None
    if not _floating(x, w, b_qkv, attn_bias):
        return None
    mm = grp.members[0]
    if x.dim() != 3 or w.dim() != 2:
        return None
    xnc = mm.attrs.get("x_num_col_dims", 1) if mm.type == "mul" \
        else x.dim() - 1
    if xnc != 2:
        return None
    b, t_len, k_dim = (int(d) for d in x.shape)
    if int(w.shape[0]) != k_dim or int(w.shape[1]) % 3:
        return None
    h = int(w.shape[1]) // 3
    if tuple(b_qkv.shape) != (3 * h,):
        return None
    attn_m = grp.members[grp.extra["attn_pos"]]
    nh = int(attn_m.attrs["num_heads"])
    if not ae.attn_epilogue_shapes_ok(t_len, h, nh, x.dtype):
        return None
    if attn_bias is not None and not ae.key_padding_ok(attn_bias, b, t_len):
        return None
    rate = 0.0 if attn_m.attrs.get("is_test", False) \
        else float(attn_m.attrs.get("dropout_rate", 0.0))
    if rate >= 1.0:
        return None
    o = ae.fused_qkv_attention(
        x, w, b_qkv, nh, attn_bias=attn_bias,
        causal=bool(attn_m.attrs.get("causal", False)),
        sm_scale=attn_m.attrs.get("sm_scale"), dropout_rate=rate,
        seed=fold_seed(seed, attn_m.uid))
    return grp.extra["attn_pos"] + 1, {"Out": [o]}


def _try_kernel_ffn(grp, gins, seed):
    """FFN up/down chain: the two-GEMM chain kernel where
    ``ffn_chain_shapes_ok`` holds (ops/ffn_chain.py), else two fused
    matmul-epilogue calls, else None (replay)."""
    from ..ops import ffn_chain as fc
    from ..ops import fused_matmul as fm

    getv = _group_getv(grp, gins)
    x, w1, w2 = getv("x"), getv("w1"), getv("w2")
    b1, b2 = getv("b1"), getv("b2")
    res = getv("residual")
    gamma, beta = getv("gamma"), getv("beta")
    if x is None or w1 is None or w2 is None:
        return None
    if not _floating(x, w1, b1, w2, b2, res, gamma, beta):
        return None
    if w1.dim() != 2 or w2.dim() != 2:
        return None
    rows = _rows(grp.members[0], x)
    if rows is None:
        return None
    xnc, m_rows, k_dim = rows
    if k_dim != int(w1.shape[0]):
        return None
    f_dim = int(w1.shape[1])
    if f_dim != int(w2.shape[0]):
        return None
    n_dim = int(w2.shape[1])
    # the down-projection must see the [.., ffn_dim] intermediate as the
    # same [M, F] matrix the chain kernel computes
    m2 = next(m for m in grp.members if m.uid == grp.roles["w2"][0])
    h1_shape = tuple(x.shape[:xnc]) + (f_dim,)
    xnc2 = m2.attrs.get("x_num_col_dims", 1) if m2.type == "mul" \
        else len(h1_shape) - 1
    if xnc2 < 1 or xnc2 >= len(h1_shape):
        return None
    lead = trail = 1
    for d in h1_shape[:xnc2]:
        lead *= int(d)
    for d in h1_shape[xnc2:]:
        trail *= int(d)
    if lead != m_rows or trail != f_dim:
        return None
    out_shape = tuple(x.shape[:xnc]) + (n_dim,)
    if b1 is not None and tuple(b1.shape) != (f_dim,):
        return None
    for v in (b2, gamma, beta):
        if v is not None and tuple(v.shape) != (n_dim,):
            return None
    if res is not None and tuple(res.shape) != out_shape:
        return None

    rate, dseed = _dropout(grp, seed)
    if rate >= 1.0:
        return None
    spec = fm.EpilogueSpec(
        act=grp.act,
        act_approximate=bool(grp.act_attrs.get("approximate", False)),
        dropout_rate=float(rate),
        norm=grp.norm["type"] if grp.norm else None,
        norm_eps=grp.norm["eps"] if grp.norm else 1e-5)
    x2 = x.reshape(m_rows, k_dim)
    res2 = None if res is None else res.reshape(m_rows, n_dim)

    if fc.ffn_chain_shapes_ok(m_rows, k_dim, f_dim, n_dim, x.dtype):
        y2 = fc.fused_ffn_chain(x2, w1, b1, w2, b2, residual=res2,
                                gamma=gamma, beta=beta, seed=dseed,
                                spec=spec)
        return len(grp.members), {grp.final_slot: [y2.reshape(out_shape)]}
    if not (fm.fused_shapes_ok(m_rows, k_dim, f_dim, x.dtype)
            and fm.fused_shapes_ok(m_rows, f_dim, n_dim, x.dtype)):
        return None
    spec1 = fm.EpilogueSpec(act=grp.act,
                            act_approximate=spec.act_approximate)
    h1 = fm.fused_matmul(x2, w1, b1, spec=spec1)
    y2 = fm.fused_matmul(h1, w2, b2, res2, gamma, beta, dseed,
                         spec._replace(act=None))
    return len(grp.members), {grp.final_slot: [y2.reshape(out_shape)]}


def _try_kernel_gemm(grp, gins, seed):
    """The fused matmul-epilogue kernel when the shapes allow: the final
    member's outputs dict, or None for the replay path."""
    from ..ops import fused_matmul as fm

    getv = _group_getv(grp, gins)
    x, w = getv("x"), getv("w")
    bias, res = getv("bias"), getv("residual")
    gamma, beta = getv("gamma"), getv("beta")
    if x is None or w is None:
        return None
    if not _floating(x, w, bias, res, gamma, beta):
        return None
    if w.dim() != 2:
        return None
    rows = _rows(grp.members[0], x)
    if rows is None:
        return None
    xnc, M, K = rows
    N = int(w.shape[1])
    if K != int(w.shape[0]):
        return None
    out_shape = tuple(x.shape[:xnc]) + (N,)
    for v in (bias, gamma, beta):
        if v is not None and tuple(v.shape) != (N,):
            return None
    if res is not None and tuple(res.shape) != out_shape:
        return None
    if not fm.fused_shapes_ok(M, K, N, x.dtype):
        return None
    rate, dseed = _dropout(grp, seed)
    if rate >= 1.0:
        return None
    spec = fm.EpilogueSpec(
        act=grp.act,
        act_approximate=bool(grp.act_attrs.get("approximate", False)),
        dropout_rate=float(rate),
        norm=grp.norm["type"] if grp.norm else None,
        norm_eps=grp.norm["eps"] if grp.norm else 1e-5)
    y2 = fm.fused_matmul(x.reshape(M, K), w, bias,
                         None if res is None else res.reshape(M, N),
                         gamma, beta, dseed, spec)
    return {grp.final_slot: [y2.reshape(out_shape)]}


def run_fused_grad(op, fx, grp, env):
    """Execute one member's vjp_grad op from the shared group graph.

    The first group grad op (the LAST forward member's, by reverse
    emission order) takes the final output's cotangent from env and runs
    ``torch.autograd.grad`` once over every leaf; each member grad op
    then binds its own ``IG@slot`` outputs from the cached per-(uid,
    slot, idx) gradients.  Internal-edge gradients stay unbound
    (UNBOUND) — nothing outside the group reads them, by construction of
    the plan.  A leaf autograd did not reach gets zeros."""
    st = fx.state.get(grp.gid)
    if st is None:
        raise RuntimeError(
            f"fused group {grp.pattern}: grad op before forward execution")
    gins, prim_outs, grads = st
    if grads is None:
        if op.attrs["fwd_uid"] != grp.last_uid:
            raise RuntimeError(
                f"fused group {grp.pattern}: grad ops out of order "
                f"(got fwd_uid={op.attrs['fwd_uid']}, expected "
                f"{grp.last_uid} first)")
        prims, cts = [], []
        for slot, vals in prim_outs.items():
            names = op.inputs.get("OG@" + slot, [])
            for j, p in enumerate(vals):
                n = names[j] if j < len(names) else EMPTY_VAR_NAME
                if n == EMPTY_VAR_NAME or n not in env \
                        or not torch.is_tensor(p) or not p.requires_grad:
                    continue
                prims.append(p)
                cts.append(env[n].to(p.dtype))
        keys = [k for k, v in gins.items()
                if torch.is_tensor(v) and v.requires_grad]
        got = [None] * len(keys)
        if prims and keys:
            got = torch.autograd.grad(prims, [gins[k] for k in keys], cts,
                                      allow_unused=True)
        grads = {k: (g if g is not None
                     else torch.zeros_like(gins[k])).detach()
                 for k, g in zip(keys, got)}
        st[1] = None          # the forward graph is consumed
        st[2] = grads
    uid = op.attrs["fwd_uid"]
    member = next(m for m in grp.members if m.uid == uid)
    return {"IG@" + slot: [grads.pop((uid, slot, j), UNBOUND)
                           for j in range(len(names))]
            for slot, names in member.inputs.items()}
