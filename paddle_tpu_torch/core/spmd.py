"""What the lowering does under a mesh: the port's stand-in for GSPMD.

The JAX package hands a mesh, sharded feeds and sharded parameters to
XLA, whose partitioner derives every collective; the step computes the
global batch's loss.  Here each rank runs the op list on its slice of
the batch, and this module plans (``plan_mesh``, once per lowering) and
runs (``MeshExec``, once per step) the collectives that keep the
semantics global:

* **Batch-sharded values.**  Every feed of rank >= 1 is split along dim
  0 over the batch axes; a value derived from one along dim 0 stays
  split.  The ops that may read such a value:

  - row-local ops (``ROW_LOCAL``: elementwise, activations, casts and
    comparisons, ``mul``/``matmul`` over the last dims, ``layer_norm``,
    dropout, ``lookup_table``, the attention op, the convolutions and
    pooling, the per-row losses) and
    the ops of ``AXIS_OPS`` (softmax, concat, reshape, transpose, ...)
    when they leave dim 0 alone: they run unchanged;
  - the reductions ``reduce_sum``, ``reduce_mean`` and ``mean`` over dim
    0 (or over everything): the rank's partial result goes through
    ``forward_sum`` (its backward passes the cotangent through
    unscaled), so a count-normalized loss divides the global sum by the
    global count;
  - ``moe_ffn`` (ops/moe.py), which routes the global token set itself;
  - ``batch_norm`` in training (sync-BN, as the JAX package's statistics
    are the global batch's): the channel sums and the count go through
    one all-reduce, the global mean's squared deviations through a
    second, both with an all-reduce backward (``sum_both_ways``: each
    rank's rows feed the statistics every rank reads); the running
    statistics follow the global ones on every rank.

  Any other op that reads a batch-sharded value raises, naming the op
  and Queue 1 item 5.
* **Gradients.**  The backward is linear in the cotangents, so each
  rank's parameter gradients are its part of the global ones; after the
  last op that writes a parameter gradient they are summed over the data
  axis (``sum_gradients``, bucketed), before clipping, regularization
  and the update read them.
* **The Megatron split** (a ``model`` axis of P > 1 ranks; the JAX
  package hands the same rules to XLA's partitioner): ``plan_split``
  propagates a second property beside the batch split, values split
  over ``model`` along one dim (the last, or the head dim after the
  split reshape), from the rule-sharded parameters through the ops
  that know how to run on their rank's part:

  - column-parallel ``mul``/``matmul`` (the weight split on its output
    dim): the input through ``backward_sum`` (forward identity,
    backward all-reduce), the local GEMM;
  - row-parallel ``mul``/``matmul`` (split on the contraction dim): the
    local GEMM over the rank's K slice, then ``forward_sum``;
  - the vocab-parallel ``lookup_table`` (the table split on dim 0): the
    rank's rows, ids outside them reading zero, then ``forward_sum``;
  - head ops: the split and merge ``reshape``/``transpose``/``slice``/
    ``squeeze`` (their literal head counts and offsets become the
    rank's in the lowering: ``OpSplit.attrs``), ``softmax`` over keys,
    the per-head ``matmul``s, ``dropout`` and ``fused_attention`` (their
    random bits fold in the model rank), the activations, and
    elementwise ops (a replicated operand that spans the split dim is
    cut to the rank's part, its gradient summed back: ``narrow``);
  - ``softmax_with_cross_entropy`` gathers vocab-split logits first;
  - the update ops, on the rank's shards of parameter, gradient and
    accumulators.

  Any other op that reads a model-split value raises, naming the op and
  Queue 1 item 5.  A fused qkv projection's weight and bias are stored
  head-grouped (``Sharding.groups``: rank r holds [q_r | k_r | v_r]), so
  the rank's GEMM yields whole local heads; ``local``/``gather`` keep
  every saved, fetched or checkpointed value in the whole order.  A
  rule-sharded parameter that some op outside these classes reads is
  gathered whole for the step, as before the split (counted:
  ``MeshPlan.stats["whole_gathers"]``).  Replicated parameters get the
  same gradient on every model rank from this placement alone, so the
  gradient sum stays over ``data``.
* **Sharded storage.**  A parameter a rule shards is stored as the
  rank's shard and, outside the split, gathered whole at the start of
  the step; its accumulators are stored as shards of the same spec.
  Under ZeRO-1 every accumulator is also split over ``data`` on its
  first free divisible dim.  An update op (one with a ``Param`` slot)
  whose parameter or accumulators are sharded runs on the rank's slices
  of parameter and gradient (and the accumulator shards); the parameter
  is then gathered again (over ``data`` alone for a parameter the split
  consumes).  The step writes shards back.
* **Fetches** come back global: a batch-sharded value is gathered along
  dim 0, a sharded accumulator whole.
"""
from __future__ import annotations

import collections
import dataclasses
import math

import torch
import torch.nn.functional as F

from .._rng import fold_seed
from ..parallel import _collectives as col
from ..parallel import mesh as mesh_lib
from .program import EMPTY_VAR_NAME, GRAD_SUFFIX

ITEM5 = "ROADMAP.md, Queue 1 item 5"

#: ops that work row by row: every output row depends on the same rows of
#: the batch-sharded inputs
ROW_LOCAL = frozenset("""
abs acos asin atan ceil cos cosh erf exp floor log log10 log1p log2
reciprocal round rsqrt sign sin sinh sqrt square tan tanh
relu relu6 elu gelu leaky_relu sigmoid logsigmoid softplus softsign swish
hard_shrink hard_sigmoid hard_swish soft_shrink stanh thresholded_relu
elementwise_add elementwise_sub elementwise_mul elementwise_div
elementwise_max elementwise_min elementwise_pow elementwise_mod
elementwise_floordiv pow scale clip maximum_eps where
equal not_equal less_than less_equal greater_than greater_equal
logical_and logical_or logical_xor logical_not cast assign sum
dropout layer_norm lookup_table mul matmul fused_attention one_hot
conv2d depthwise_conv2d conv2d_transpose pool2d label_smooth
softmax_with_cross_entropy cross_entropy sigmoid_cross_entropy_with_logits
huber_loss smooth_l1_loss mse_loss tril_triu
fill_constant_batch_size_like uniform_random_batch_size_like
gaussian_random_batch_size_like
""".split())

#: ops that are row-local unless their axis attr names dim 0
AXIS_OPS = {"softmax": ("axis", -1), "log_softmax": ("axis", -1),
            "cumsum": ("axis", -1), "concat": ("axis", 0),
            "split": ("axis", 0), "stack": ("axis", 0),
            "unstack": ("axis", 0), "arg_max": ("axis", -1),
            "arg_min": ("axis", -1), "top_k": (None, -1)}

#: reductions that become a forward sum when they reduce dim 0 (top-1
#: accuracy is a mean over the rows)
REDUCTIONS = {"reduce_sum": "sum", "reduce_mean": "mean", "mean": "mean",
              "accuracy": "mean"}

def _leaves_dim0(op, ndim):
    """Whether a shape op keeps dim 0 where it is (a batch-sharded input
    stays split along dim 0 of its output)."""
    a = op.attrs
    if op.type == "reshape":
        shape = list(a.get("shape", ()))
        return bool(shape) and shape[0] in (0, -1)
    if op.type == "transpose":
        perm = list(a.get("axis", ()))
        return bool(perm) and perm[0] == 0
    if op.type == "unsqueeze":
        axes = a.get("axes") or ()
        return 0 not in [x % (ndim + len(axes)) for x in axes]
    if op.type == "squeeze":
        axes = a.get("axes") or ()
        return bool(axes) and 0 not in [x % max(ndim, 1) for x in axes]
    if op.type == "slice":
        return 0 not in [x % max(ndim, 1) for x in a.get("axes", ())]
    if op.type == "expand":
        times = list(a.get("expand_times", ()))
        return not times or times[0] == 1
    if op.type == "pad":
        p = list(a.get("paddings", ()))
        return len(p) < 2 or (p[0] == 0 and p[1] == 0)
    return False


SHAPE_OPS = ("reshape", "transpose", "squeeze", "unsqueeze", "slice",
             "expand", "pad")


def _reduces_dim0(op, ndim):
    if op.type in ("mean", "accuracy"):
        return True
    dim = op.attrs.get("dim", None)
    if op.attrs.get("reduce_all", False) or dim is None:
        return True
    dims = dim if isinstance(dim, (list, tuple)) else [dim]
    if not dims:
        return False
    return 0 in [d % max(ndim, 1) for d in dims]


@dataclasses.dataclass
class MeshPlan:
    """What ``plan_mesh`` derives from the program, once per lowering."""

    compiled: object
    batch_sharded: frozenset      # names split along dim 0
    forward_sums: dict            # op uid -> "sum" | "mean"
    sync_index: int               # block-0 op index of the gradient sum
    grad_names: tuple             # parameter gradients summed over data
    specs: dict                   # persistable -> storage Sharding
    full_shapes: dict             # persistable -> its whole shape
    update_ops: dict              # op uid -> (slice Sharding, full shape)
    moe: dict                     # moe_ffn uid -> how it splits
    skip_uids: frozenset          # update ops of another stage's params
    remote: frozenset             # names another pipeline rank holds
    split: object = None          # SplitPlan under a model axis, or None
    sync_bn: frozenset = frozenset()   # batch_norm uids on batch statistics
    #: the steps' collectives and whole gathers so far (MeshExec adds
    #: each step's), and the last step's alone
    stats: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    last_stats: dict = dataclasses.field(default_factory=dict)


def _var_shape(block, name):
    var = block._find_var_recursive(name)
    return None if var is None or var.shape is None else tuple(var.shape)


def plan_mesh(program, ops, compiled, feed_names, persist_names,
              remote=frozenset()):
    """The mesh plan of block 0's op list (see the module docstring);
    raises for a program that reads a batch-sharded value in an op this
    module does not know how to run under a batch split.  ``remote``:
    the parameters (and their gradients and accumulators) another
    pipeline stage's rank holds — their update ops are skipped here."""
    block = program.global_block()
    batch_axes = compiled.batch_axes
    sharded = set()
    if batch_axes:
        for n in feed_names:
            shp = _var_shape(block, n)
            if shp is None or len(shp) >= 1:
                sharded.add(n)
    forward_sums, moe, sync_bn = {}, {}, set()
    fwd_inputs = {}

    def visit(op_list):
        for op in op_list:
            ins = [n for n in op.input_names() if n != EMPTY_VAR_NAME]
            hit = [n for n in ins if n in sharded]
            outs = [n for n in op.output_names() if n != EMPTY_VAR_NAME]
            fwd_inputs[op.uid] = op.inputs
            if op.type == "moe_ffn":
                moe[op.uid] = (op.inputs["X"][0] in sharded,
                               op.inputs["W1"][0])
            if op.type == "vjp_grad":
                src = fwd_inputs.get(op.attrs.get("fwd_uid"), {})
                for slot, names in op.outputs.items():
                    fwd = src.get(slot[3:], []) if slot.startswith("IG@") \
                        else []
                    for n, f in zip(names, fwd):
                        if n != EMPTY_VAR_NAME and f in sharded:
                            sharded.add(n)
                continue
            if op.type == "pipeline_grad":
                visit(program.blocks[op.attrs["sub_block"]].ops)
                continue
            if op.type == "recompute_grad" or not hit:
                continue
            ndim = len(_var_shape(block, hit[0]) or (1,))
            if op.type in REDUCTIONS:
                if _reduces_dim0(op, ndim):
                    forward_sums[op.uid] = REDUCTIONS[op.type]
                    continue
            elif op.type == "moe_ffn":
                sharded.add(op.outputs["Out"][0])
                continue
            elif op.type in AXIS_OPS:
                key, default = AXIS_OPS[op.type]
                axis = op.attrs.get(key, default) if key else default
                if axis % max(ndim, 1) == 0:
                    _refuse(op, hit[0], f"along axis {axis}")
            elif op.type in SHAPE_OPS:
                if not _leaves_dim0(op, ndim):
                    _refuse(op, hit[0], "moving or cutting dim 0")
            elif op.type == "layer_norm":
                if op.attrs.get("begin_norm_axis", 1) == 0:
                    _refuse(op, hit[0], "normalizing over dim 0")
            elif op.type == "batch_norm":
                if op.inputs["X"][0] not in sharded:
                    _refuse(op, hit[0], "as a statistic")
                if not (program.is_test or op.attrs.get("is_test", False)
                        or op.attrs.get("use_global_stats", False)):
                    sync_bn.add(op.uid)
                # the statistics outputs are the global batch's
                sharded.add(op.outputs["Y"][0])
                continue
            elif op.type not in ROW_LOCAL:
                _refuse(op, hit[0], "")
            sharded.update(outs)

    visit(ops)
    params = {p.name for p in program.all_parameters()}
    pgrads = {p + GRAD_SUFFIX for p in params}
    last = -1
    for i, op in enumerate(ops):
        outs = op.output_names()
        if pgrads & set(outs):
            last = i
        if batch_axes and any(n.endswith(GRAD_SUFFIX + "@ROWS")
                              for n in outs):
            raise NotImplementedError(
                f"sparse (SelectedRows) gradients under a mesh are not "
                f"ported ({ITEM5}): use is_sparse=False")
    sync_index = last + 1
    grad_names = []
    for op in ops[:sync_index]:
        for n in op.output_names():
            if n in pgrads and n not in grad_names and n not in remote:
                grad_names.append(n)

    # storage: rule specs, accumulators follow their parameter, ZeRO-1
    specs, full_shapes, acc_param = {}, {}, {}
    for op in ops[sync_index:]:
        if "Param" not in op.inputs:
            continue
        p = op.inputs["Param"][0]
        pshape = _var_shape(block, p)
        for slot, names in op.inputs.items():
            for n in names:
                var = block._find_var_recursive(n)
                if var is not None and getattr(var, "is_optimizer_state",
                                               False) \
                        and _var_shape(block, n) == pshape:
                    acc_param[n] = p
    for n in persist_names:
        shp = _var_shape(block, n)
        if shp is None or n in remote:
            continue
        full_shapes[n] = shp
        sh = compiled.param_sharding(n, ndim=len(shp), shape=shp,
                                     rule_name=acc_param.get(n, n))
        if not sh.is_replicated:
            sh.shard_shape(shp)          # raises on an uneven split
            specs[n] = sh
    wanted = set()
    for op in ops:
        if op.type == "vjp_grad":
            for slot, names in op.outputs.items():
                if slot.startswith("IG@"):
                    wanted.update((op.attrs.get("fwd_uid"), slot[3:], j)
                                  for j, n in enumerate(names)
                                  if n != EMPTY_VAR_NAME)
    split = plan_split(program, ops, compiled, specs, wanted)
    update_ops, skip = {}, set()
    for op in ops[sync_index:]:
        if "Param" not in op.inputs:
            continue
        p = op.inputs["Param"][0]
        if p in remote:
            skip.add(op.uid)
            continue
        accs = [n for names in op.inputs.values() for n in names
                if acc_param.get(n) == p]
        sliced = [specs[n] for n in accs if n in specs] or \
            ([specs[p]] if p in specs else [])
        if split is not None and p in split.params:
            # the parameter is the rank's model shard already: slice it
            # (and its gradient) over the other axes alone
            rest = [sh.without(mesh_lib.MODEL_AXIS) for sh in sliced]
            if rest and not rest[0].is_replicated:
                update_ops[op.uid] = (rest[0],
                                      specs[p].shard_shape(full_shapes[p]))
        elif sliced:
            update_ops[op.uid] = (sliced[0], full_shapes.get(p))
        elif any(n in specs for names in op.inputs.values() for n in names):
            raise NotImplementedError(
                f"op '{op.type}' reads a sharded accumulator without its "
                f"parameter's slice ({ITEM5})")
    moe_modes = {}
    for uid, (batch, w1_name) in moe.items():
        w1 = specs.get(w1_name)
        first = w1.spec[0] if w1 is not None and w1.spec else None
        moe_modes[uid] = {
            "batch": batch,
            "expert_axis": mesh_lib.EXPERT_AXIS
            if first == mesh_lib.EXPERT_AXIS else None}
    return MeshPlan(compiled=compiled, batch_sharded=frozenset(sharded),
                    forward_sums=forward_sums, sync_index=sync_index,
                    grad_names=tuple(grad_names), specs=specs,
                    full_shapes=full_shapes, update_ops=update_ops,
                    moe=moe_modes, skip_uids=frozenset(skip),
                    remote=frozenset(remote), split=split,
                    sync_bn=frozenset(sync_bn))


def pipeline_microbatches(program):
    """M of the program's pipeline_grad op (1 without one)."""
    for op in program.global_block().ops:
        if op.type == "pipeline_grad":
            return int(op.attrs["num_microbatches"])
    return 1


def local_feed(compiled, program, t):
    """The rank's rows of a global feed: dim 0 split over the batch axes
    (row-major, the first axis major).  In a pipelined program each rank
    takes its part of every microbatch, so that its microbatch m is a
    slice of the global microbatch m (GSPMD's split of the global
    [M, B/M] reshape)."""
    sh = compiled.feed_sharding(None, t.dim())
    if sh.is_replicated:
        return t
    parts = sh.parts(0)
    idx = sh.index(0)
    B = t.shape[0]
    M = pipeline_microbatches(program)
    if B % (parts * M):
        raise ValueError(
            f"a batch of {B} rows does not split into {parts} ranks"
            f"{f' x {M} microbatches' if M > 1 else ''} over the batch "
            f"axes {compiled.batch_axes}")
    rows = t.reshape((M, parts, B // (M * parts)) + tuple(t.shape[1:]))
    return rows[:, idx].reshape((B // parts,) + tuple(t.shape[1:]))


def place(scope, plan, name, val):
    """The stored form of persistable ``name``: its shard where the mesh
    shards it (a whole value is cut to the rank's shard and put back in
    the scope).  Records the placement in ``scope._shardings`` for
    ``whole_value``."""
    sh = plan.specs.get(name)
    if sh is None or not torch.is_tensor(val):
        return val
    if not hasattr(scope, "_shardings"):
        scope._shardings = {}
    scope._shardings[name] = (sh, plan.full_shapes[name])
    if tuple(val.shape) == plan.full_shapes[name] and \
            sh.shard_shape(val.shape) != tuple(val.shape):
        val = sh.local(val).clone()
        scope.set_var(name, val)
    return val


def whole_value(scope, name, val):
    """``val`` whole: a stored shard is gathered over its mesh (a
    collective: every rank of the mesh must ask for the same names in
    the same order, as a checkpoint save does)."""
    rec = getattr(scope, "_shardings", {}).get(name)
    if rec is None or not torch.is_tensor(val):
        return val
    sh, full = rec
    if tuple(val.shape) == full:
        return val
    return sh.gather(val)


def _refuse(op, name, how):
    raise NotImplementedError(
        f"op '{op.type}' reads the batch-sharded value '{name}'"
        f"{' ' + how if how else ''}: under a data mesh only row-local "
        f"ops, full reductions and moe_ffn are ported ({ITEM5})")


# -- the Megatron split over the model axis ----------------------------------

#: single-input ops that work element by element: a model-split input
#: gives an output split the same way
MODEL_UNARY = frozenset("""
abs acos asin atan ceil cos cosh erf exp floor log log10 log1p log2
reciprocal round rsqrt sign sin sinh sqrt square tan tanh
relu relu6 elu gelu leaky_relu sigmoid logsigmoid softplus softsign swish
hard_shrink hard_sigmoid hard_swish soft_shrink stanh thresholded_relu
scale clip cast assign dropout
""".split())


@dataclasses.dataclass
class OpSplit:
    """How one op runs on its model rank.  ``pre``: (slot, j) ->
    ("bsum",) | ("narrow", dim, groups, grad) | ("gather", dim) on that
    input; ``post``: output slots summed over ``model``; ``attrs``: the
    op's attrs on the rank (None: the program's)."""

    kind: str
    pre: dict = dataclasses.field(default_factory=dict)
    post: tuple = ()
    attrs: object = None
    model_rng: bool = False


@dataclasses.dataclass
class SplitPlan:
    """What ``plan_split`` derives: the model-split values (name -> (dim,
    groups)), the ops that run on their rank's part, the parameters the
    split consumes (never gathered whole) and the collectives a training
    step runs over ``model``."""

    parts: int
    values: dict
    ops: dict
    params: frozenset
    planned: dict


def _prod(dims):
    p = 1
    for d in dims:
        p *= int(d)
    return p


def _refuse_split(op, name, how=""):
    raise NotImplementedError(
        f"op '{op.type}' reads the model-split value '{name}'"
        f"{' ' + how if how else ''}: under a model axis only the Megatron "
        f"split's ops (column/row-parallel mul and matmul, the vocab-"
        f"parallel lookup_table, the head ops, elementwise ops and the "
        f"updates) are ported ({ITEM5})")


def _model_spec_dim(sh):
    """The one dim ``sh`` splits over ``model`` alone, or None."""
    dims = [d for d, e in enumerate(sh.spec)
            if mesh_lib.MODEL_AXIS in mesh_lib._axes_of(e)]
    if len(dims) != 1 or mesh_lib._axes_of(sh.spec[dims[0]]) != \
            (mesh_lib.MODEL_AXIS,):
        return None
    return dims[0]


def _consumers(ops):
    cons = {}
    for op in ops:
        for n in set(op.input_names()):
            cons.setdefault(n, []).append(op)
    return cons


def _qkv_groups(block, cons, out):
    """How many equal blocks a column projection's output ``out`` (after
    its bias add) packs: the k slices that cut its last dim into k equal
    parts, or the reshape that splits it into (g, heads, d_head); 1
    otherwise."""
    readers = cons.get(out, [])
    shp = _var_shape(block, out)
    if not readers or not shp or int(shp[-1]) <= 0:
        return 1
    n, nd = int(shp[-1]), len(shp)
    if len(readers) >= 2 and all(o.type == "slice" for o in readers):
        cuts = set()
        for o in readers:
            axes = list(o.attrs.get("axes") or ())
            if len(axes) != 1 or axes[0] % nd != nd - 1:
                return 1
            cuts.add((int(o.attrs["starts"][0]), int(o.attrs["ends"][0])))
        k = len(readers)
        if n % k == 0 and cuts == {(i * n // k, (i + 1) * n // k)
                                   for i in range(k)}:
            return k
        return 1
    if len(readers) == 1 and readers[0].type == "reshape":
        oshp = _var_shape(block, readers[0].outputs["Out"][0])
        if not oshp:
            return 1
        for k in range(len(oshp) - 1, -1, -1):
            tail = oshp[k:]
            if any(int(d) <= 0 for d in tail):
                return 1
            if _prod(tail) == n:
                return int(tail[0]) if len(tail) >= 3 else 1
    return 1


def _reshape_split(in_shape, d, g, out_shape, P):
    """(dim, groups) of a reshape's output when its input is split along
    ``d`` in ``g`` groups over P ranks, or None when the split does not
    map onto one output dim."""
    for k_in in range(d, -1, -1):
        tail = in_shape[k_in:]
        if any(int(x) <= 0 for x in tail):
            break
        t = _prod(tail)
        for k_out in range(len(out_shape) - 1, -1, -1):
            otail = out_shape[k_out:]
            if any(int(x) <= 0 for x in otail):
                break
            if _prod(otail) != t:
                continue
            G = _prod(in_shape[k_in:d]) * g
            for j in range(k_out, len(out_shape)):
                if _prod(out_shape[k_out:j + 1]) % (G * P) == 0:
                    c = _prod(out_shape[k_out:j])
                    if G % c:
                        return None
                    return j, G // c
            return None
    return None


def plan_split(program, ops, compiled, specs, wanted):
    """The Megatron split of block 0's op list (see the module
    docstring), or None without a model axis of more than one rank.
    ``specs``: the persistables' storage shardings (groups are added
    here); ``wanted``: the (forward uid, slot, j) whose input gradient
    some vjp_grad op asks for."""
    mesh = compiled.mesh
    P = mesh_lib.axis_size(mesh, mesh_lib.MODEL_AXIS)
    if P <= 1:
        return None
    block = program.global_block()
    params = {p.name for p in program.all_parameters()}
    cand = {n: _model_spec_dim(sh) for n, sh in specs.items()
            if n in params}
    cand = {n: d for n, d in cand.items() if d is not None and d <= 1}
    if not cand:
        return None
    if any(o.type in ("pipeline_grad", "recompute_grad") for o in ops):
        raise NotImplementedError(
            f"the Megatron split under a pipeline or Recompute is not "
            f"ported ({ITEM5})")
    if getattr(program, "_amp_dtype", None) is not None:
        raise NotImplementedError(
            f"AMP under a model axis is not ported ({ITEM5})")
    cons = _consumers(ops)
    # a parameter read where the split does not know how: gathered whole
    sub_reads = set()
    for blk in program.blocks[1:]:
        for o in blk.ops:
            sub_reads.update(o.input_names())
    for n in list(cand):
        ok = n not in sub_reads
        for o in cons.get(n, []):
            if o.type in ("mul", "matmul"):
                ok = ok and o.inputs["Y"][0] == n \
                    and len(_var_shape(block, n) or ()) == 2
            elif o.type == "lookup_table":
                ok = ok and cand[n] == 0 and not o.attrs.get("is_sparse")
            elif not (o.type.startswith("elementwise_") or o.type == "sum"
                      or "Param" in o.inputs):
                ok = False
        if not ok:
            del cand[n]
    # the head grouping of fused projections, from their readers
    groups = {}
    for o in ops:
        if o.type not in ("mul", "matmul") or o.inputs["Y"][0] not in cand:
            continue
        w = o.inputs["Y"][0]
        t_y = o.type == "matmul" and o.attrs.get("transpose_Y", False)
        if (cand[w] == 1) == bool(t_y):
            continue                       # row-parallel: one group
        out, bias = o.outputs["Out"][0], None
        nxt = cons.get(out, [])
        if len(nxt) == 1 and nxt[0].type == "elementwise_add" \
                and nxt[0].inputs["X"][0] == out \
                and nxt[0].inputs["Y"][0] in cand \
                and len(_var_shape(block, nxt[0].inputs["Y"][0]) or ()) == 1:
            bias = nxt[0].inputs["Y"][0]
            out = nxt[0].outputs["Out"][0]
        g = _qkv_groups(block, cons, out)
        if g > 1:
            if groups.get(w, g) != g:
                del cand[w]
                continue
            groups[w] = g
            if bias is not None:
                groups[bias] = g
    split = {n: (d, groups.get(n, 1)) for n, d in cand.items()}
    plan_ops, fwd_inputs = {}, {}
    planned = collections.Counter()

    def shape(n):
        return _var_shape(block, n) or ()

    def nd(n):
        return len(shape(n))

    for op in ops:
        fwd_inputs[op.uid] = op.inputs
        if op.type == "vjp_grad":
            src = fwd_inputs.get(op.attrs.get("fwd_uid"), {})
            for slot, names in op.outputs.items():
                if not slot.startswith("IG@"):
                    continue
                for n, f in zip(names, src.get(slot[3:], [])):
                    if n != EMPTY_VAR_NAME and f in split:
                        split[n] = split[f]
            continue
        hit = [(slot, j, n) for slot, names in op.inputs.items()
               for j, n in enumerate(names) if n in split]
        if not hit:
            continue
        outs = [n for n in op.output_names() if n != EMPTY_VAR_NAME]
        rec, out_split = _split_op(op, hit, split, cand, shape, nd, P,
                                   wanted)
        plan_ops[op.uid] = rec
        for slot, j in rec.pre:
            kind = rec.pre[(slot, j)][0]
            if kind == "bsum" or (kind == "narrow" and rec.pre[(slot, j)][3]):
                planned["backward_sum"] += 1
            elif kind == "gather":
                planned["all_gather"] += 1
        planned["forward_sum"] += len(rec.post)
        if out_split is not None:
            for n in outs:
                split[n] = out_split
        elif rec.kind == "update":
            p = op.inputs["Param"][0]
            for n in outs:
                if shape(n) == shape(p):
                    split[n] = split[p]
    for n, (d, g) in split.items():
        if n in specs and g > 1:
            specs[n] = dataclasses.replace(
                specs[n], groups=tuple(g if i == d else 1
                                       for i in range(d + 1)))
    return SplitPlan(parts=P, values=split, ops=plan_ops,
                     params=frozenset(cand), planned=dict(planned))


def _split_op(op, hit, split, cand, shape, nd, P, wanted):
    """(OpSplit, the outputs' split or None) of one op reading the
    model-split inputs ``hit``; raises for an op the split cannot run."""
    t = op.type
    first = hit[0][2]

    def grad(slot, j=0):
        return (op.uid, slot, j) in wanted

    if t in ("mul", "matmul"):
        X, Y = op.inputs["X"][0], op.inputs["Y"][0]
        xs, ys = split.get(X), split.get(Y)
        t_x = t == "matmul" and op.attrs.get("transpose_X", False)
        t_y = t == "matmul" and op.attrs.get("transpose_Y", False)
        if ys is not None and Y in cand and nd(Y) == 2 and not t_x:
            if t == "mul" and op.attrs.get("y_num_col_dims", 1) != 1:
                _refuse_split(op, Y, "flattening its weight")
            out_nd = nd(op.outputs["Out"][0])
            if (ys[0] == 1) != bool(t_y):            # column-parallel
                if xs is not None:
                    _refuse_split(op, X, "as the input of a column-"
                                  "parallel product")
                pre = {("X", 0): ("bsum",)} if grad("X") else {}
                return OpSplit("column", pre=pre), (out_nd - 1, ys[1])
            if ys[1] != 1:
                _refuse_split(op, Y, "split in groups on its rows")
            k = nd(X) - 1
            if t == "mul" and op.attrs.get("x_num_col_dims", 1) != k:
                _refuse_split(op, X, "flattening a split input")
            if xs is None:                           # row-parallel
                pre = {("X", 0): ("narrow", k, 1, grad("X"))}
            elif xs != (k, 1):
                _refuse_split(op, X, "split off its contraction dim")
            else:
                pre = {}
            return OpSplit("row", pre=pre, post=("Out",)), None
        if t == "matmul" and xs is not None and ys is not None \
                and nd(X) == nd(Y) >= 3 and xs == ys \
                and xs[0] < nd(X) - 2:
            return OpSplit("heads"), xs
        _refuse_split(op, first)
    if t == "lookup_table":
        W = op.inputs["W"][0]
        if W in cand and split.get(W) == (0, 1) \
                and op.inputs["Ids"][0] not in split:
            return OpSplit("vocab", post=("Out",)), None
        _refuse_split(op, first)
    if t.startswith("elementwise_"):
        out = op.outputs["Out"][0]
        o_nd = nd(out)
        axis = op.attrs.get("axis", -1)
        found, offs = None, {}
        for slot in ("X", "Y"):
            names = op.inputs.get(slot) or []
            if not names:
                continue
            n = names[0]
            if slot == "X" or axis is None or axis == -1 or nd(n) == nd(
                    op.inputs["X"][0]):
                offs[slot] = o_nd - nd(n)
            else:
                offs[slot] = axis
            if n in split:
                d, g = split[n]
                here = (d + offs[slot], g)
                if found is not None and found != here:
                    _refuse_split(op, n, "split unlike its other operand")
                found = here
        pre = {}
        for slot, off in offs.items():
            n = op.inputs[slot][0]
            if n in split:
                continue
            k = found[0] - off
            shp = shape(n)
            if 0 <= k < len(shp) and int(shp[k]) != 1:
                pre[(slot, 0)] = ("narrow", k, found[1], grad(slot))
        return OpSplit("local", pre=pre), found
    if t in MODEL_UNARY:
        # dropout on a split value draws for the rank's own heads
        return OpSplit("local", model_rng=t == "dropout"), split[first]
    if t == "sum":
        states = {split.get(n) for n in op.inputs["X"]}
        if len(states) != 1:
            _refuse_split(op, first, "beside a value split otherwise")
        return OpSplit("local"), split[first]
    d, g = split[first]
    if t == "reshape":
        out = op.outputs["Out"][0]
        lit = list(op.attrs.get("shape", ()))
        got = _reshape_split(shape(first), d, g, shape(out), P)
        if got is None:
            _refuse_split(op, first, "moving its split dim")
        j = got[0]
        if j < len(lit) and lit[j] not in (-1, 0):
            lit[j] = int(lit[j]) // P
        elif j < len(lit) and lit[j] == 0 and j != d:
            _refuse_split(op, first, "copying a dim it splits")
        return OpSplit("heads", attrs=dict(op.attrs, shape=lit)), got
    if t == "transpose":
        perm = [p % nd(first) for p in op.attrs.get("axis", ())]
        return OpSplit("heads"), (perm.index(d), g)
    if t == "slice":
        axes = [a % nd(first) for a in op.attrs.get("axes", ())]
        if d not in axes:
            return OpSplit("heads"), (d, g)
        i = axes.index(d)
        n = int(shape(first)[d])
        blk = n // g
        st, en = int(op.attrs["starts"][i]), int(op.attrs["ends"][i])
        st, en = max(st + n if st < 0 else st, 0), min(en + n if en < 0
                                                       else en, n)
        if st % blk or en % blk or en <= st:
            _refuse_split(op, first, "cutting across its head groups")
        starts, ends = list(op.attrs["starts"]), list(op.attrs["ends"])
        starts[i], ends[i] = st // P, en // P
        return (OpSplit("heads", attrs=dict(op.attrs, starts=starts,
                                            ends=ends)),
                (d, (en - st) // blk))
    if t in ("squeeze", "unsqueeze"):
        axes = sorted(a % (nd(first) if t == "squeeze" else
                           nd(op.outputs["Out"][0]))
                      for a in op.attrs.get("axes") or ())
        if t == "squeeze":
            if d in axes or not axes:
                _refuse_split(op, first, "squeezing its split dim")
            return OpSplit("heads"), (d - sum(a < d for a in axes), g)
        nd_ = d
        for a in axes:
            if a <= nd_:
                nd_ += 1
        return OpSplit("heads"), (nd_, g)
    if t in ("softmax", "log_softmax"):
        if op.attrs.get("axis", -1) % nd(first) == d:
            _refuse_split(op, first, "along its split dim")
        return OpSplit("heads"), (d, g)
    if t == "fused_attention":
        q = op.inputs["Q"][0]
        states = {split.get(op.inputs[s][0]) for s in ("Q", "K", "V")}
        if len(states) != 1:
            _refuse_split(op, first, "beside a q/k/v split otherwise")
        bias = (op.inputs.get("Bias") or [EMPTY_VAR_NAME])[0]
        if bias in split:
            _refuse_split(op, bias, "as the attention bias")
        attrs = dict(op.attrs)
        pre = {}
        if nd(q) == 3:
            if (d, g) != (2, 1):
                _refuse_split(op, q, "split off its packed heads")
            nh = int(attrs["num_heads"])
            if nh % P:
                _refuse_split(op, q, f"with {nh} heads over {P} ranks")
            if attrs.get("sm_scale") is None:
                attrs["sm_scale"] = 1.0 / math.sqrt(
                    int(shape(q)[-1]) // nh)
            attrs["num_heads"] = nh // P
        elif (d, g) != (1, 1):
            _refuse_split(op, q, "split off its head dim")
        elif bias != EMPTY_VAR_NAME and len(shape(bias)) == 4 \
                and int(shape(bias)[1]) != 1:
            pre[("Bias", 0)] = ("narrow", 1, 1, False)
        return OpSplit("heads", pre=pre, attrs=attrs, model_rng=True), \
            (d, g)
    if t == "softmax_with_cross_entropy":
        lg = op.inputs["Logits"][0]
        if split.get(lg) != (nd(lg) - 1, 1) \
                or op.inputs["Label"][0] in split:
            _refuse_split(op, first)
        return OpSplit("gather",
                       pre={("Logits", 0): ("gather", nd(lg) - 1)}), None
    if "Param" in op.inputs:
        if op.inputs["Param"][0] not in split:
            _refuse_split(op, first, "updating a parameter stored whole")
        return OpSplit("update"), None
    _refuse_split(op, first)


class MeshExec:
    """One step's collectives over a ``MeshPlan``; installed (``active``)
    while the lowered block runs so that sub-block interpreters and
    ``moe_ffn`` see it."""

    def __init__(self, plan):
        self.plan = plan
        self.mesh = plan.compiled.mesh
        self.batch_groups = [
            (a, mesh_lib.axis_group(self.mesh, a))
            for a in plan.compiled.batch_axes]
        self.batch_parts = 1
        for a, _ in self.batch_groups:
            self.batch_parts *= mesh_lib.axis_size(self.mesh, a)
        self.data_group = mesh_lib.axis_group(self.mesh, mesh_lib.DATA_AXIS)
        #: how the moe_ffn op running now splits (set around its compute)
        self.moe_mode = None
        self.split = plan.split
        self.model_group = mesh_lib.axis_group(self.mesh,
                                               mesh_lib.MODEL_AXIS)
        self.model_rank = mesh_lib.axis_rank(self.mesh, mesh_lib.MODEL_AXIS)
        #: this step's collectives over model and its whole gathers
        self.stats = collections.Counter()

    def moe_row_offset(self, rows):
        """Where this rank's ``rows`` tokens sit in the gathered order."""
        return self.plan.compiled.feed_sharding(None, 1).index(0) * rows

    def group(self, axis):
        return mesh_lib.axis_group(self.mesh, axis)

    def size(self, axis):
        return mesh_lib.axis_size(self.mesh, axis)

    def rank(self, axis):
        return mesh_lib.axis_rank(self.mesh, axis)

    # -- entry and exit -------------------------------------------------
    def enter(self, env):
        """Stored shards of parameters -> whole values (accumulators stay
        shards: only their update op reads them; a parameter the model
        split consumes stays the rank's shard)."""
        mine = self.split.params if self.split is not None else ()
        for n, sh in self.plan.specs.items():
            if n in env and not self._is_accumulator(n) and n not in mine:
                env[n] = sh.gather(env[n])
                self.stats["whole_gathers"] += 1
        return env

    def finish(self):
        """Add this step's counts to the plan's."""
        self.plan.stats.update(self.stats)
        self.plan.last_stats = dict(self.stats)

    def _is_accumulator(self, n):
        return self.plan.compiled._is_optimizer_state(n)

    def store(self, name, value):
        sh = self.plan.specs.get(name)
        if sh is None or tuple(value.shape) != self.plan.full_shapes[name]:
            return value
        return sh.local(value)

    def fetch(self, name, value):
        if not torch.is_tensor(value):
            return value
        sh = self.plan.specs.get(name)
        if self.split is not None and name in self.split.values \
                and sh is None:
            d, g = self.split.values[name]
            value = mesh_lib.ungroup(
                col.gather_along(value, self.model_group, d), d,
                self.split.parts, g)
        if name in self.plan.batch_sharded and value.dim() >= 1:
            for a, g in reversed(self.batch_groups):
                value = col.gather_along(value, g, 0)
            return value
        sh = self.plan.specs.get(name)
        if sh is not None and tuple(value.shape) != \
                self.plan.full_shapes[name]:
            return sh.gather(value)
        return value

    # -- per op -----------------------------------------------------------
    def reduce_outs(self, op, outs):
        kind = self.plan.forward_sums[op.uid]
        res = {}
        for slot, vals in outs.items():
            new = []
            for v in vals:
                for _, g in self.batch_groups:
                    v = col.forward_sum(v, g)
                if kind == "mean":
                    v = v / self.batch_parts
                new.append(v)
            res[slot] = new
        return res

    def slice_update(self, op, ins):
        sh, full = self.plan.update_ops[op.uid]
        return {slot: [sh.local(v) if torch.is_tensor(v)
                       and tuple(v.shape) == full else v for v in vals]
                for slot, vals in ins.items()}

    def gather_update(self, op, outs):
        sh, full = self.plan.update_ops[op.uid]
        p = op.outputs.get("ParamOut", [None])[0]
        res = dict(outs)
        if p is not None and "ParamOut" in outs:
            res["ParamOut"] = [sh.gather(outs["ParamOut"][0])]
            if self.split is None or p not in self.split.params:
                self.stats["whole_gathers"] += 1
        return res

    def sum_grads(self, env):
        names = [n for n in self.plan.grad_names if n in env]
        if self.data_group is None or not names:
            return
        for n, v in zip(names, col.sum_gradients(
                [env[n] for n in names], self.data_group)):
            env[n] = v

    def step_seed(self, seed):
        """Ranks on different data coordinates draw different random
        bits (dropout on different rows); model ranks draw the same, so
        a replicated value's mask is one mask (``run_op`` folds the model
        rank into the ops that draw for local heads)."""
        if self.size(mesh_lib.DATA_AXIS) > 1:
            return fold_seed(seed, 1 + self.rank(mesh_lib.DATA_AXIS))
        return seed

    # -- the model split --------------------------------------------------
    def split_of(self, op):
        """The op's ``OpSplit``, or None."""
        return None if self.split is None else self.split.ops.get(op.uid)

    def model_seed(self, seed):
        return fold_seed(seed, 0x5EED + self.model_rank)

    def model_sum(self, v):
        self.stats["forward_sum"] += 1
        return col.forward_sum(v, self.model_group)

    def transform(self, how, v):
        """One input transform of ``OpSplit.pre`` (see ``OpSplit``)."""
        kind = how[0]
        if kind == "bsum":
            return col.backward_sum(v, self.model_group, self.stats)
        if kind == "narrow":
            _, dim, groups, grad = how
            if grad:
                v = col.backward_sum(v, self.model_group, self.stats)
            return mesh_lib.take_block(v, dim, self.split.parts,
                                       self.model_rank, groups)
        self.stats["all_gather"] += 1
        return col.all_gather(v, self.model_group, how[1])

    def split_inputs(self, rec, ins):
        """``ins`` with the op's input transforms applied."""
        if not rec.pre:
            return ins
        res = {slot: list(vals) for slot, vals in ins.items()}
        for (slot, j), how in rec.pre.items():
            if slot in res and torch.is_tensor(res[slot][j]):
                res[slot][j] = self.transform(how, res[slot][j])
        return res

    def run_op(self, opdef, ctx, ins, op):
        """One op's compute on this rank: its input transforms, its
        attrs and random bits on the rank, the vocab-parallel lookup,
        and the sums of its outputs over ``model``."""
        rec = self.split_of(op)
        if rec is None:
            return opdef.compute(ctx, ins, op.attrs)
        ins = self.split_inputs(rec, ins)
        attrs = op.attrs if rec.attrs is None else rec.attrs
        rng = ctx.rng
        if rec.model_rng and rng is not None:
            rng = self.model_seed(rng)
        ctx = dataclasses.replace(ctx, attrs=attrs, rng=rng)
        if rec.kind == "vocab":
            outs = {"Out": [self._vocab_lookup(ins, attrs)]}
        else:
            outs = opdef.compute(ctx, ins, attrs)
        for slot in rec.post:
            outs = dict(outs)
            outs[slot] = [self.model_sum(v) for v in outs[slot]]
        return outs

    def _vocab_lookup(self, ins, attrs):
        """The rank's part of a lookup in a table split over its rows:
        the rows it holds, zero for ids outside them (the sum over
        ``model`` follows).  jnp.take's index rule as ``lookup_table``'s:
        a negative id wraps, one outside [-vocab, vocab) reads NaN on
        every rank."""
        from ..ops.tensor import _fill_invalid, _take_index

        w, ids = ins["W"][0], ins["Ids"][0]
        if ids.dim() >= 2 and ids.shape[-1] == 1:
            ids = ids.squeeze(-1)
        rows = w.shape[0]
        safe, invalid = _take_index(ids, rows * self.split.parts)
        local = safe - self.model_rank * rows
        mine = (local >= 0) & (local < rows)
        res = F.embedding(torch.where(mine, local, 0), w)
        res = res.masked_fill(~mine[..., None], 0.0)
        res = _fill_invalid(res, invalid[..., None])
        padding_idx = attrs.get("padding_idx", -1)
        if padding_idx is not None and padding_idx >= 0:
            res = res.masked_fill((ids == padding_idx)[..., None], 0.0)
        return res

    # -- sync-BN ----------------------------------------------------------
    def sync_batch_norm(self, ins, attrs):
        """``batch_norm`` in training over the global batch (the JAX
        formula, paddle_tpu/ops/nn.py): float32 statistics, the mean
        from one all-reduce of the channel sums and the count, the
        population variance from a second of the squared deviations;
        both sums' backward is an all-reduce.  The normalization runs in
        x's dtype; the running statistics update from the global ones,
        the same on every rank."""
        from ..core.registry import out, single

        x = single(ins, "X")
        scale, bias = single(ins, "Scale"), single(ins, "Bias")
        mean, var = single(ins, "Mean").detach(), \
            single(ins, "Variance").detach()
        eps = float(attrs.get("epsilon", 1e-5))
        momentum = float(attrs.get("momentum", 0.9))
        nhwc = attrs.get("data_layout", "NCHW") != "NCHW" and x.dim() > 2
        xc = x.movedim(-1, 1) if nhwc else x
        axes = (0,) + tuple(range(2, xc.dim()))
        ch = (1, -1) + (1,) * (xc.dim() - 2)
        xf = xc.float()
        sums = torch.cat([xf.sum(dim=axes),
                          xf.new_full((1,), float(xf.numel() // xf.shape[1]))])
        for _, g in self.batch_groups:
            sums = col.sum_both_ways(sums, g)
            self.stats["batch_stat_sums"] += 1
        count = sums[-1].detach()
        use_mean = sums[:-1] / count
        dev = xf - use_mean.reshape(ch)
        sq = (dev * dev).sum(dim=axes)
        for _, g in self.batch_groups:
            sq = col.sum_both_ways(sq, g)
            self.stats["batch_stat_sums"] += 1
        use_var = sq / count
        inv = torch.rsqrt(use_var.to(x.dtype).reshape(ch)
                          + torch.tensor(eps, dtype=x.dtype,
                                         device=x.device))
        y = (xc - use_mean.to(x.dtype).reshape(ch)) * inv
        if scale is not None:
            y = y * scale.reshape(ch)
        if bias is not None:
            y = y + bias.reshape(ch)
        if nhwc:
            y = y.movedim(1, -1)
        bm, bv = use_mean.detach(), use_var.detach()
        return out(Y=y,
                   MeanOut=momentum * mean.float() + (1.0 - momentum) * bm,
                   VarianceOut=momentum * var.float() + (1.0 - momentum) * bv,
                   SavedMean=bm, SavedVariance=bv)


# -- the active step (read by the interpreter and moe_ffn) -----------------
_active = None


def active():
    return _active


def set_active(mexec):
    global _active
    prev, _active = _active, mexec
    return prev
