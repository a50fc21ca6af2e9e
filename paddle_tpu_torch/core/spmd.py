"""What the lowering does under a mesh: the port's stand-in for GSPMD.

The JAX package hands a mesh, sharded feeds and sharded parameters to
XLA, whose partitioner derives every collective; the step computes the
global batch's loss.  Here each rank runs the op list on its slice of
the batch, and this module plans (``plan_mesh``, once per lowering) and
runs (``MeshExec``, once per step) the collectives that keep the
semantics global:

* **Batch-sharded values.**  Every feed of rank >= 1 is split along dim
  0 over the batch axes; a value derived from one stays split, along
  the dim its op moves the batch to (``MeshPlan.batch_dims``: a
  time-major transpose leaves it split along dim 1, a StaticRNN's step
  input along dim 0 again).  Every registered op has a class
  (``OP_CLASSES``; ``op_class``), which decides how it reads such a
  value:

  - ``elementwise`` and ``row`` ops act within one row of the batch dim
    (``row``: the padded sequence layout keeps a sequence in a row, so
    ``lstm``, ``gru``, the ``sequence_*`` ops and the fused RNN and fc
    ops are row ops at dim 0, ``cudnn_lstm`` at its time-major dim 1;
    products, lookups, norms and per-row losses at any leading dim);
    ``axis`` and ``shape`` ops too while they leave the batch dim whole
    (``_Planner.local_dims``): they run unchanged;
  - ``sum`` reductions over the batch dim (``reduce_sum``,
    ``reduce_mean``, ``mean``, ``accuracy``, ``squared_l2_norm``) sum
    the ranks' partial results (``sum_both_ways``), so a
    count-normalized loss divides the global sum by the global count;
  - ``extreme`` reductions over it (``reduce_max``/``min``/``prod``/
    ``all``/``any``) reduce the partials by their own kind
    (``reduce_extreme``: the backward goes to the tied elements of
    every rank, evenly, as jnp.max's does; ``reduce_prod``;
    ``reduce_logical``);
  - ``batch_stats``: ``batch_norm`` and ``fused_batch_norm_act`` in
    training take the global batch's statistics (sync-BN,
    ``MeshExec.sync_batch_norm``: the channel sums and the count through
    one all-reduce, the squared deviations through a second, both with
    an all-reduce backward; ``fused_batch_norm_act`` then applies its
    ``act_type`` as its own compute does); the running statistics follow
    the global ones on every rank;
  - ``size``: ``shape`` reports the global batch dim;
  - ``moe``: ``moe_ffn`` (ops/moe.py) routes the global token set;
  - ``sparse_grad``: ``lookup_table_sparse_grad`` runs on the rank's
    ids; its (Values, Rows) pair is gathered whole at the gradient sum;
  - ``whole`` — the row movers (``gather``, ``scatter``, ``gather_nd``,
    ``gather_mm``, ``fusion_transpose_flatten_concat``, an ``axis`` or
    ``shape`` op along the batch dim), the metrics (``auc``, a stateless
    rank statistic of the batch) and beam search, and any ``after_sum``
    or ``source`` op that reads a batch-sharded value: its batch-sharded
    inputs are gathered whole (``gather_whole``), every rank runs the op
    on the global batch, and an output that keeps the batch dim
    (``RESHARD``: cumsum, softmax and concat along it) is cut to
    the rank's rows again (``take_rows``); the others stay whole;
  - ``after_sum`` ops (the optimizers and update ops, the clips,
    ``check_finite_and_unscale``, ``update_loss_scaling``, ``isfinite``,
    the SelectedRows ops) read summed gradients: every rank holds the
    same values, so every rank takes the same step, skips the same
    AMP step and keeps the same loss scale.

* **Control flow.**  ``while``, ``conditional_block``, ``switch`` and
  ``static_rnn`` are planned through their sub-blocks with the same
  classes: a StaticRNN's step input split along dim d > 0 is split along
  d - 1 in the step (one split along its time dim 0 is gathered whole
  first), its step outputs stacked along a new dim 0 are split one dim
  further out; a loop-carried value or memory whose body splits it
  starts as the rank's rows of its initial value (or whole, the other
  way round).  A condition the host reads (``while``,
  ``conditional_block``, ``switch``) is the same on every rank, so every
  rank runs the same trips and branches: one that is itself
  batch-sharded (a per-row predicate where a scalar is read) is refused,
  as the JAX package's ``lax`` loops and branches refuse one, and any
  other that derives from batch data does so through a ``sum``,
  ``extreme``, ``size`` or ``whole`` op, whose result is already reduced
  over ``data`` (each element of an all-reduce comes out of one
  reduction, sent to every rank) or computed from the gathered batch on
  every rank alike.

* **Gradients: the rule for whole values.**  A rank's cotangent of a
  batch-sharded value is that of its own rows, exact.  A rank's
  cotangent of a whole value (a parameter, a reduction's result, a row
  mover's whole output, the loss) is its *share*: the shares of the
  ranks add up to the cotangent.  So the loss's seed is 1/P on each of
  the P ranks over ``data`` (``MeshPlan.seeds``; Recompute's and the
  pipeline's seeds too); a sum over the batch sums the shares again in
  its backward (``sum_both_ways``); ``gather_whole``'s backward is a
  reduce-scatter, ``take_rows``'s puts the rank's rows back among
  zeros.  A parameter that every rank reads whole after a gather gets a
  share of its gradient on each rank, and the parameter gradients are
  summed over the data axis (``sum_gradients``, bucketed) after the last
  op that writes one, before clipping, regularization and the update
  read them; SelectedRows gradients are gathered there instead
  (``gather_rows``, the ranks' row counts first), so the sparse updates
  see the global gradient and no dense table gradient is formed.

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
  its batch dim, a sharded accumulator whole.
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

#: the ops that run sub-blocks (core/lowering.py's BLOCK_OPS)
BLOCK_OPS = ("while", "conditional_block", "switch", "static_rnn")


def _words(s):
    return frozenset(s.split())


#: every registered op's class under a batch split (module docstring)
OP_CLASSES = {
    "elementwise": _words("""
abs acos asin atan ceil cos cosh erf exp floor log log10 log1p log2
reciprocal round rsqrt sign sin sinh sqrt square tan tanh
relu relu6 elu gelu leaky_relu sigmoid logsigmoid softplus softsign swish
hard_shrink hard_sigmoid hard_swish soft_shrink stanh thresholded_relu
elementwise_add elementwise_sub elementwise_mul elementwise_div
elementwise_max elementwise_min elementwise_pow elementwise_mod
elementwise_floordiv pow scale clip maximum_eps where
equal not_equal less_than less_equal greater_than greater_equal
logical_and logical_or logical_xor logical_not cast assign sum dropout
sigmoid_cross_entropy_with_logits huber_loss smooth_l1_loss mse_loss
fused_elemwise_activation"""),
    "row": _words("""
mul matmul fc lookup_table layer_norm one_hot label_smooth tril_triu
softmax_with_cross_entropy cross_entropy cos_sim fused_attention
conv2d depthwise_conv2d conv2d_transpose pool2d conv2d_fusion
fill_constant_batch_size_like uniform_random_batch_size_like
gaussian_random_batch_size_like
lstm gru lstmp cudnn_lstm lstm_unit gru_unit fusion_lstm fusion_gru
sequence_concat sequence_conv sequence_enumerate sequence_erase
sequence_expand sequence_expand_as sequence_mask sequence_pad
sequence_pool sequence_reshape sequence_reverse sequence_scatter
sequence_slice sequence_softmax sequence_unpad
fused_embedding_seq_pool fused_fc_elementwise_layernorm
fusion_repeated_fc_relu fusion_seqconv_eltadd_relu
fusion_seqexpand_concat_fc fusion_seqpool_concat fusion_seqpool_cvm_concat
fusion_squared_mat_sub multihead_matmul"""),
    "axis": _words("""
softmax log_softmax cumsum concat split stack unstack arg_max arg_min
top_k"""),
    "shape": _words("reshape transpose squeeze unsqueeze slice expand pad"),
    "sum": _words("reduce_sum reduce_mean mean accuracy squared_l2_norm"),
    "extreme": _words("reduce_max reduce_min reduce_prod reduce_all "
                      "reduce_any"),
    "batch_stats": _words("batch_norm fused_batch_norm_act"),
    "size": _words("shape"),
    "moe": _words("moe_ffn"),
    "sparse_grad": _words("lookup_table_sparse_grad"),
    "whole": _words("""
gather gather_nd scatter gather_mm fusion_transpose_flatten_concat auc
beam_search beam_search_decode frobenius_norm"""),
    "after_sum": _words("""
sgd momentum adam adamw adamax adagrad adadelta decayed_adagrad rmsprop
ftrl lamb lars_momentum dpsgd sgd_sparse adam_sparse
check_finite_and_unscale update_loss_scaling isfinite clip_by_norm
dgc_clip_by_norm average_accumulates increment merge_selected_rows
get_tensor_from_selected_rows sparse_to_dense_grad clip_sparse
squared_l2_norm_sparse"""),
    "source": _words("""
fill_constant assign_value range uniform_random gaussian_random
truncated_gaussian_random"""),
}
_CLASS_OF = {t: c for c, ts in OP_CLASSES.items() for t in ts}

#: ``axis`` ops whose output along the batch dim is a batch again: after
#: they run on the whole value, the rank takes its rows back
RESHARD = frozenset("softmax log_softmax cumsum concat".split())
#: the batch dim of a ``row`` op other than dim 0: the products, lookups,
#: norms and per-row losses take any leading dim (``_Planner.local_dims``),
#: the sequence, recurrent, convolution and fused ops dim 0, or this
_AT_DIM = {"cudnn_lstm": 1}
#: outputs of a row op that hold no batch rows
_NOT_ROWS = {"fusion_squared_mat_sub": ("SquaredY",)}
#: the reductions of the ``extreme`` class, by op
_EXTREME = {"reduce_max": "max", "reduce_min": "min", "reduce_prod": "prod",
            "reduce_all": "all", "reduce_any": "any"}
#: ``sum`` reductions: a forward sum, or a sum then a division by P
_SUM_KIND = {"reduce_sum": "sum", "reduce_mean": "mean", "mean": "mean",
             "accuracy": "mean", "squared_l2_norm": "sum"}


def op_class(op_type):
    """The class of ``op_type`` under a batch split (``OP_CLASSES``), or
    None for an op this module does not know."""
    return _CLASS_OF.get(op_type)


@dataclasses.dataclass
class OpMode:
    """How one op that reads a batch-sharded value runs on its rank.
    ``kind``: "local" (unchanged), "sum" (a sum over the batch: ``how``
    "sum" or "mean"), "extreme" (``how`` the reduction, ``dims`` the
    input dims it reduces, ``keep`` its keep_dim), "sync_bn", "size"
    (``dims`` (the batch dim,)), "moe" or "whole" (``gather``: (slot,
    j) -> the dim to gather; ``reshard``: (slot, j) -> the dim to cut
    the rank's rows along)."""

    kind: str
    how: str = ""
    dims: tuple = ()
    keep: bool = False
    gather: dict = dataclasses.field(default_factory=dict)
    reshard: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class BlockMode:
    """How a block op's sub-blocks run on the rank.  ``pre``: outer name
    -> (its batch dim or None, the dim the loop wants or None): a step
    input split along time, or a carried value or memory that the body
    splits otherwise, is gathered whole and/or cut to the rank's rows
    before the loop; ``outs``: (branch block, Out j) -> the dim a
    branch's output is gathered along (the branches split it unlike each
    other)."""

    pre: dict = dataclasses.field(default_factory=dict)
    outs: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class MeshPlan:
    """What ``plan_mesh`` derives from the program, once per lowering."""

    compiled: object
    batch_dims: dict              # batch-sharded name -> its batch dim
    modes: dict                   # op uid -> OpMode (batch-reading ops)
    sync_index: int               # block-0 op index of the gradient sum
    grad_names: tuple             # parameter gradients summed over data
    specs: dict                   # persistable -> storage Sharding
    full_shapes: dict             # persistable -> its whole shape
    update_ops: dict              # op uid -> (slice Sharding, full shape)
    moe: dict                     # moe_ffn uid -> how it splits
    skip_uids: frozenset          # update ops of another stage's params
    remote: frozenset             # names another pipeline rank holds
    split: object = None          # SplitPlan under a model axis, or None
    blocks: dict = dataclasses.field(default_factory=dict)  # uid->BlockMode
    seeds: frozenset = frozenset()   # fill_constant uids of loss seeds
    #: (Values, Rows) of each SelectedRows gradient gathered at the sum
    sparse_grads: tuple = ()
    #: the steps' collectives and whole gathers so far (MeshExec adds
    #: each step's), and the last step's alone
    stats: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    last_stats: dict = dataclasses.field(default_factory=dict)


def _var_shape(block, name):
    var = block._find_var_recursive(name)
    return None if var is None or var.shape is None else tuple(var.shape)


def _axes(a, ndim):
    a = a if isinstance(a, (list, tuple)) else [a]
    return [int(x) % max(ndim, 1) for x in a]


def _reduced(op, ndim):
    """The dims a reduction op reduces (every dim for a full one)."""
    if op.type in ("mean", "accuracy", "squared_l2_norm"):
        return list(range(ndim))
    dim = op.attrs.get("dim", None)
    if op.attrs.get("reduce_all", False) or dim is None:
        return list(range(ndim))
    return _axes(dim, ndim)


def _after_reduce(d, dims, keep):
    """Where dim ``d`` lands after reducing ``dims`` (not one of them)."""
    return d if keep else d - sum(x < d for x in dims)


def _shape_dim(op, d, ndim, out_ndim):
    """Where a shape op moves batch dim ``d``, or None when it cuts,
    merges or expands that dim."""
    a = op.attrs
    t = op.type
    if t == "transpose":
        perm = _axes(a.get("axis", ()), ndim)
        return perm.index(d) if d in perm else None
    if t == "reshape":
        shape = list(a.get("shape", ()))
        # the dims up to d are copied ("0") or the batch dim alone is
        # inferred ("-1") with every later dim kept as a literal
        if d < len(shape) and all(s == 0 for s in shape[:d]) \
                and shape[d] in (0, -1):
            return d
        return None
    if t == "unsqueeze":
        axes = sorted(_axes(a.get("axes") or (), out_ndim))
        nd = d
        for x in axes:
            if x <= nd:
                nd += 1
        return nd
    if t == "squeeze":
        axes = _axes(a.get("axes") or (), ndim)
        if not axes or d in axes:
            return None
        return d - sum(x < d for x in axes)
    if t == "slice":
        return None if d in _axes(a.get("axes", ()), ndim) else d
    if t == "expand":
        times = list(a.get("expand_times", ()))
        return d if not times or times[d] == 1 else None
    if t == "pad":
        p = list(a.get("paddings", ()))
        return d if len(p) < 2 * d + 2 or (p[2 * d] == 0
                                           and p[2 * d + 1] == 0) else None
    return None


def _refuse(op, name, how):
    raise NotImplementedError(
        f"op '{op.type}' reads the batch-sharded value '{name}'"
        f"{' ' + how if how else ''} ({ITEM5})")


def plan_mesh(program, ops, compiled, feed_names, persist_names,
              remote=frozenset()):
    """The mesh plan of block 0's op list and its sub-blocks (see the
    module docstring); raises for a program whose ops this module has no
    class for.  ``remote``: the parameters (and their gradients and
    accumulators) another pipeline stage's rank holds — their update ops
    are skipped here."""
    block = program.global_block()
    batch_axes = compiled.batch_axes
    dims = {}
    if batch_axes:
        for n in feed_names:
            shp = _var_shape(block, n)
            if shp is None or len(shp) >= 1:
                dims[n] = 0
    params = {p.name for p in program.all_parameters()}
    pgrads = {p + GRAD_SUFFIX for p in params}
    last = -1
    sparse = []
    for i, op in enumerate(ops):
        outs = list(op.output_names())
        if pgrads & set(outs):
            last = i
        for n in outs:
            if n.endswith(GRAD_SUFFIX + "@ROWS") and batch_axes:
                sparse.append((n[:-len("@ROWS")], n))
    sync_index = last + 1
    planner = _Planner(program, dims)
    planner.visit(ops, sync_index, [n for pair in sparse for n in pair])
    sparse_values = {v for v, _ in sparse}
    grad_names = []
    for op in ops[:sync_index]:
        for n in op.output_names():
            if n in pgrads and n not in grad_names and n not in remote \
                    and n not in sparse_values:
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
    for uid, (batch, w1_name) in planner.moe.items():
        w1 = specs.get(w1_name)
        first = w1.spec[0] if w1 is not None and w1.spec else None
        moe_modes[uid] = {
            "batch": batch,
            "expert_axis": mesh_lib.EXPERT_AXIS
            if first == mesh_lib.EXPERT_AXIS else None}
    return MeshPlan(compiled=compiled, batch_dims=dict(planner.dims),
                    modes=planner.modes, sync_index=sync_index,
                    grad_names=tuple(grad_names), specs=specs,
                    full_shapes=full_shapes, update_ops=update_ops,
                    moe=moe_modes, skip_uids=frozenset(skip),
                    remote=frozenset(remote), split=split,
                    blocks=planner.blocks, seeds=frozenset(planner.seeds),
                    sparse_grads=tuple(sparse))


class _Planner:
    """The walk of ``plan_mesh`` over block 0 and its sub-blocks: the
    batch dim of every batch-sharded value (``dims``) and each op's
    ``OpMode`` or ``BlockMode``."""

    def __init__(self, program, dims):
        self.program = program
        self.dims = dims
        self.modes, self.blocks, self.moe = {}, {}, {}
        self.seeds = set()
        self.fwd_inputs = {}
        #: every block's variables' shapes (a sub-block's own included)
        self.shapes = {}
        for blk in reversed(program.blocks):
            for name, var in blk.vars.items():
                if var.shape is not None:
                    self.shapes[name] = tuple(var.shape)

    def nd(self, n):
        return len(self.shapes.get(n, ()))

    def unsplit_rows(self, op, aligned):
        """Whether an input the batch split leaves whole has a batch of
        rows at its dim ``aligned(slot, name)`` (declared -1 there): an
        op that reads it beside a split input must see the whole batch.
        Parameters and other static shapes never do."""
        for slot, names in op.inputs.items():
            for n in names:
                if n == EMPTY_VAR_NAME or n in self.dims:
                    continue
                k = aligned(slot, n)
                shp = self.shapes.get(n, ())
                if k is not None and 0 <= k < len(shp) \
                        and shp[k] in (-1, None):
                    return True
        return False

    def visit(self, op_list, sync_index=None, after_sum=()):
        for i, op in enumerate(op_list):
            if i == sync_index:
                # the SelectedRows gradients are whole after the sum
                for n in after_sum:
                    self.dims.pop(n, None)
            self.fwd_inputs[op.uid] = op.inputs
            ins = [n for n in op.input_names() if n != EMPTY_VAR_NAME]
            outs = [n for n in op.output_names() if n != EMPTY_VAR_NAME]
            if op.type == "vjp_grad":
                src = self.fwd_inputs.get(op.attrs.get("fwd_uid"), {})
                for slot, names in op.outputs.items():
                    fwd = src.get(slot[3:], []) if slot.startswith("IG@") \
                        else []
                    for n, f in zip(names, fwd):
                        if n != EMPTY_VAR_NAME and f in self.dims:
                            self.dims[n] = self.dims[f]
                continue
            if op.type == "pipeline_grad":
                self.visit(self.program.blocks[op.attrs["sub_block"]].ops)
                continue
            if op.type == "recompute_grad":
                continue
            if op.type in BLOCK_OPS:
                self.visit_block_op(op)
                continue
            hit = {n: self.dims[n] for n in ins if n in self.dims}
            if not hit:
                if op.type == "fill_constant" and len(outs) == 1 \
                        and outs[0].endswith(GRAD_SUFFIX) \
                        and outs[0][:-len(GRAD_SUFFIX)] not in self.dims:
                    self.seeds.add(op.uid)      # the seed of a whole loss
                for n in outs:
                    self.dims.pop(n, None)
                continue
            if op_class(op.type) is None:
                _refuse(op, next(iter(hit)), "in an op with no class "
                        "under a batch split")
            mode, out_dims = self.classify(op, hit)
            self.modes[op.uid] = mode
            for n in outs:
                self.dims.pop(n, None)
            self.dims.update(out_dims)

    # -- one op ---------------------------------------------------------
    def slot_dims(self, op):
        """(slot, j) -> batch dim of every batch-sharded input."""
        return {(slot, j): self.dims[n]
                for slot, names in op.inputs.items()
                for j, n in enumerate(names) if n in self.dims}

    def classify(self, op, hit):
        """(OpMode, {output name: batch dim}) of an op that reads the
        batch-sharded inputs ``hit``."""
        cls = op_class(op.type)
        name0 = next(iter(hit))
        d = hit[name0]
        nd0 = self.nd(name0)
        outs = {slot: [n for n in names if n != EMPTY_VAR_NAME]
                for slot, names in op.outputs.items()}
        if cls == "moe":
            self.moe[op.uid] = (op.inputs["X"][0] in self.dims,
                                op.inputs["W1"][0])
            return OpMode("moe"), {op.outputs["Out"][0]: d}
        if cls == "batch_stats":
            x = op.inputs["X"][0]
            if x not in self.dims or self.dims[x] != 0:
                return self.whole(op)
            training = not (self.program.is_test
                            or op.attrs.get("is_test", False)
                            or op.attrs.get("use_global_stats", False))
            # the statistics outputs are the global batch's
            return OpMode("sync_bn" if training else "local"), \
                {op.outputs["Y"][0]: 0}
        if cls == "sparse_grad":
            return OpMode("local"), {n: 0 for n in op.output_names()
                                     if n != EMPTY_VAR_NAME}
        if cls in ("sum", "extreme"):
            red = _reduced(op, nd0)
            keep = bool(op.attrs.get("keep_dim", False))
            if d not in red:
                return OpMode("local"), {
                    op.outputs["Out"][0]: _after_reduce(d, red, keep)}
            if cls == "sum":
                return OpMode("sum", how=_SUM_KIND[op.type]), {}
            return OpMode("extreme", how=_EXTREME[op.type],
                          dims=tuple(red), keep=keep), {}
        if cls == "size":
            return OpMode("size", dims=(d,)), {}
        if cls in ("elementwise", "row", "axis", "shape"):
            got = self.local_dims(op, cls, hit, outs)
            if got is not None:
                return OpMode("local"), got
        return self.whole(op)

    def whole(self, op):
        """The ``whole`` mode: gather the batch-sharded inputs, run on
        the global batch, cut the rows of a ``RESHARD`` output back."""
        gather = self.slot_dims(op)
        reshard, out_dims = {}, {}
        if op.type in RESHARD:
            d = min(gather.values())
            for slot, names in op.outputs.items():
                for j, n in enumerate(names):
                    if n != EMPTY_VAR_NAME and self.nd(n) > d:
                        reshard[(slot, j)] = d
                        out_dims[n] = d
        return OpMode("whole", gather=gather, reshard=reshard), out_dims

    def local_dims(self, op, cls, hit, outs):
        """The outputs' batch dims when ``op`` runs unchanged on its rows,
        or None when it must see the whole batch."""
        t, a = op.type, op.attrs
        name0 = next(iter(hit))
        d = hit[name0]
        nd0 = self.nd(name0)
        all_outs = [n for ns in outs.values() for n in ns]

        def every(dim):
            return {n: dim for n in all_outs}

        if cls == "elementwise":
            if t.startswith("elementwise_") or t == "fused_elemwise_activation":
                x, y = op.inputs["X"][0], op.inputs["Y"][0]
                nx, ny = self.nd(x), self.nd(y)
                axis = a.get("axis", -1)
                off = nx - ny if axis is None or axis == -1 or nx == ny \
                    else axis
                want = {self.dims[x]} if x in self.dims else set()
                if y in self.dims:
                    want.add(self.dims[y] + off)
                if len(want) != 1:
                    return None
                d = want.pop()
                if self.unsplit_rows(
                        op, lambda slot, n: d - (off if slot == "Y" else 0)):
                    return None
                return every(d)
            if len(set(hit.values())) != 1 \
                    or self.unsplit_rows(op, lambda slot, n: d):
                return None
            return every(d)
        if cls == "axis":
            if len(set(hit.values())) != 1 \
                    or self.unsplit_rows(op, lambda slot, n: d):
                return None
            key = "axis" if t != "top_k" else None
            axis = a.get(key, -1 if t not in ("concat", "split", "stack",
                                              "unstack") else 0) \
                if key else -1
            if t == "stack":
                out_nd = nd0 + 1
                axis %= out_nd
                if axis <= d:
                    return every(d + 1)
                return every(d)
            axis %= max(nd0, 1)
            if axis == d:
                return None
            if t == "concat" and len(hit) != len(
                    [n for n in op.inputs["X"] if n != EMPTY_VAR_NAME]):
                return None
            if t in ("unstack", "arg_max", "arg_min"):
                return every(d - (axis < d))
            return every(d)
        if cls == "shape":
            out = op.outputs["Out"][0]
            nd_ = _shape_dim(op, d, nd0, self.nd(out))
            if nd_ is None:
                return None
            return {n: nd_ for n in all_outs
                    if n == out or self.nd(n) > nd_}
        # row ops
        slots = self.slot_dims(op)
        dset = set(slots.values())
        if len(dset) != 1 or self.unsplit_rows(op, lambda slot, n: d):
            return None
        at = _AT_DIM.get(t, 0)
        if t in ("mul", "fc"):
            xs = "X" if t == "mul" else "Input"
            if set(k[0] for k in slots) != {xs}:
                return None
            k = int(a.get("x_num_col_dims" if t == "mul"
                          else "in_num_col_dims", 1))
            return every(d) if d < k else None
        if t == "matmul":
            xn, yn = op.inputs["X"][0], op.inputs["Y"][0]
            nx, ny = self.nd(xn), self.nd(yn)
            if yn in self.dims:
                # a batched product: both split along one batch dim
                if xn not in self.dims or nx != ny or d >= nx - 2:
                    return None
                return every(d)
            if d < nx - 2 or (d == nx - 2 and not a.get("transpose_X")):
                return every(d)
            return None
        if t == "lookup_table":
            if set(k[0] for k in slots) != {"Ids"}:
                return None
            return every(d)
        if t == "layer_norm":
            if d >= int(a.get("begin_norm_axis", 1)):
                return None
            return {n: d for n in all_outs
                    if n == op.outputs["Y"][0] or self.nd(n) > d}
        if t in ("softmax_with_cross_entropy", "cross_entropy",
                 "one_hot", "label_smooth", "cos_sim"):
            ax = int(a.get("axis", -1)) % max(nd0, 1)
            if d >= nd0 - 1 or (t == "softmax_with_cross_entropy"
                                and ax == d):
                return None
            return every(d)
        if t == "tril_triu":
            return every(d) if d < nd0 - 2 else None
        if t.endswith("_batch_size_like"):
            if int(a.get("input_dim_idx", 0)) != d:
                return {}
            return every(int(a.get("output_dim_idx", 0)))
        if d != at:
            return None
        skip = _NOT_ROWS.get(t, ())
        return {n: at for slot, ns in outs.items() if slot not in skip
                for n in ns}

    # -- block ops ------------------------------------------------------
    def visit_block_op(self, op):
        """A block op's sub-blocks, to a fixed point of the carried
        values' batch dims (a few passes at most)."""
        rec = BlockMode()
        self.blocks[op.uid] = rec
        init = dict(self.dims)
        for _ in range(4):
            before = dict(self.dims)
            if op.type == "static_rnn":
                self.plan_static_rnn(op, rec, init)
            elif op.type == "while":
                self.plan_while(op, rec, init)
            else:
                self.plan_branches(op, rec)
            if self.dims == before:
                break

    def start(self, rec, init, n):
        """Where carried value ``n`` is split as the loop starts."""
        how = rec.pre.get(n)
        return init.get(n) if how is None else how[1]

    def settle(self, rec, init, n, d):
        """The body splits carried value ``n`` along ``d`` (None: whole):
        its initial value is converted to match before the loop."""
        if d == init.get(n):
            rec.pre.pop(n, None)
        else:
            rec.pre[n] = (init.get(n), d)

    def plan_static_rnn(self, op, rec, init):
        a = op.attrs
        for ln, n in zip(a["x_local_names"], op.inputs.get("X", [])):
            d = init.get(n)
            if d == 0:
                rec.pre[n] = (0, None)          # split along time: whole
                d = None
            self.set(ln, None if d is None else d - 1)
        inits = op.inputs.get("Init", [])
        for ln, n in zip(a["mem_local_names"], inits):
            self.set(ln, self.start(rec, init, n))
        self.visit(self.program.blocks[a["sub_block"]].ops)
        for ln, un, n in zip(a["mem_local_names"], a["mem_update_names"],
                             inits):
            if self.dims.get(un) != self.start(rec, init, n):
                self.settle(rec, init, n, self.dims.get(un))
        for n, sn in zip(op.outputs.get("Out", []), a["step_out_names"]):
            d = self.dims.get(sn)
            self.set(n, None if d is None else d + 1)
        for n, un in zip(op.outputs.get("LastMem", []),
                         a["mem_update_names"]):
            self.set(n, self.dims.get(un))

    def plan_while(self, op, rec, init):
        cond = op.inputs["Condition"][0]
        names = list(op.outputs["Out"])
        for n in names:
            self.set(n, self.start(rec, init, n))
        self.visit(self.program.blocks[op.attrs["sub_block"]].ops)
        for n in names:
            if self.dims.get(n) != self.start(rec, init, n):
                self.settle(rec, init, n, self.dims.get(n))
        if cond in self.dims:
            _refuse(op, cond, "as its loop condition: a per-row predicate "
                    "where a scalar is read")

    def plan_branches(self, op, rec):
        a = op.attrs
        if op.type == "conditional_block":
            conds = op.inputs["Cond"]
            pairs = [(a["true_block"], a["true_out_names"]),
                     (a["false_block"], a["false_out_names"])]
        else:
            conds = op.inputs.get("Conds", [])
            pairs = [(b, op.outputs["Out"]) for b in a["case_blocks"]]
            if a.get("default_block") is not None:
                pairs.append((a["default_block"], op.outputs["Out"]))
        for c in conds:
            if c in self.dims:
                _refuse(op, c, "as its branch condition: a per-row "
                        "predicate where a scalar is read")
        found = {}
        for blk, names in pairs:
            self.visit(self.program.blocks[blk].ops)
            for j, n in enumerate(names):
                found.setdefault(j, {})[blk] = self.dims.get(n)
        rec.outs = {}
        for j, n in enumerate(op.outputs["Out"]):
            ds = set(found.get(j, {None: self.dims.get(n)}).values())
            if len(ds) == 1:
                self.set(n, ds.pop())
                continue
            # the branches split it unlike each other: whole after either
            for blk, d in found[j].items():
                if d is not None:
                    rec.outs[(blk, j)] = d
            self.set(n, None)

    def set(self, n, d):
        if d is None:
            self.dims.pop(n, None)
        else:
            self.dims[n] = d


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
        d = self.plan.batch_dims.get(name)
        if d is not None and value.dim() > d:
            for a, g in reversed(self.batch_groups):
                value = col.gather_along(value, g, d)
            return value
        sh = self.plan.specs.get(name)
        if sh is not None and tuple(value.shape) != \
                self.plan.full_shapes[name]:
            return sh.gather(value)
        return value

    # -- per op: the batch split ----------------------------------------
    def run(self, opdef, ctx, ins, op):
        """One op's compute on this rank under its ``OpMode`` (the module
        docstring): unchanged, a sum or an extreme reduction over the
        batch, sync-BN, the global batch's size, or the op on the whole
        batch; a loss's seed divided among the ranks."""
        mode = self.plan.modes.get(op.uid)
        if mode is not None and mode.kind == "sync_bn":
            res = self.sync_batch_norm(ins, op.attrs)
            if op.type == "fused_batch_norm_act":
                from ..ops.fused import bn_act_outputs

                res = bn_act_outputs(res, op.attrs)
            return res
        if mode is not None and mode.gather:
            ins = {slot: list(vals) for slot, vals in ins.items()}
            for (slot, j), d in mode.gather.items():
                ins[slot][j] = self.gather_whole(ins[slot][j], d)
        outs = self.run_op(opdef, ctx, ins, op)
        if op.uid in self.plan.seeds and self.batch_parts > 1:
            return {slot: [v / self.batch_parts for v in vals]
                    for slot, vals in outs.items()}
        if mode is None or mode.kind == "local":
            return outs
        outs = {slot: list(vals) for slot, vals in outs.items()}
        if mode.kind == "whole":
            for (slot, j), d in mode.reshard.items():
                outs[slot][j] = col.take_rows(outs[slot][j],
                                              self.data_group, d)
        elif mode.kind == "sum":
            for slot, vals in outs.items():
                outs[slot] = [self.batch_sum(v, mode.how) for v in vals]
        elif mode.kind == "extreme":
            x = ins["X"][0]
            outs["Out"] = [self.batch_extreme(x, outs["Out"][0], mode)]
        elif mode.kind == "size":
            v = outs["Out"][0].clone()
            v[mode.dims[0]] *= self.batch_parts
            outs["Out"] = [v]
        return outs

    def batch_sum(self, v, how):
        """The ranks' partial sums added up; each rank's cotangent of
        the sum is a share, so the backward sums the shares again."""
        for _, g in self.batch_groups:
            v = col.sum_both_ways(v, g)
            self.stats["batch_sums"] += 1
        return v / self.batch_parts if how == "mean" else v

    def batch_extreme(self, x, y, mode):
        """The ranks' partial ``mode.how`` reductions ``y`` of ``x``
        reduced over the data axis."""
        self.stats["batch_reductions"] += 1
        g = self.data_group
        if mode.how in ("all", "any"):
            return col.reduce_logical(y, g, mode.how)
        if mode.how == "prod":
            return col.reduce_prod(y, g)
        with torch.no_grad():
            kept = [1 if i in mode.dims else s
                    for i, s in enumerate(x.shape)]
            hits = (x == y.reshape(kept)).sum(dim=mode.dims,
                                              keepdim=mode.keep)
        return col.reduce_extreme(y, hits.reshape(y.shape), g, mode.how)

    def gather_whole(self, v, d):
        self.stats["batch_gathers"] += 1
        return col.gather_whole(v, self.data_group, d)

    def seed_scale(self):
        """The factor of a loss's seed on this rank (Recompute's and the
        pipeline's backward seed their loss themselves)."""
        return 1.0 / self.batch_parts

    # -- block ops --------------------------------------------------------
    def block_pre(self, op, env):
        """A block op's carried values, memories and step inputs split as
        its loop wants them (``BlockMode.pre``), in ``env``."""
        rec = self.plan.blocks.get(op.uid)
        if rec is None:
            return
        for n, (src, dst) in rec.pre.items():
            v = env[n]
            if src is not None:
                v = self.gather_whole(v, src)
            if dst is not None:
                v = col.take_rows(v, self.data_group, dst)
            env[n] = v

    def branch_out(self, op, blk, j, v):
        """A branch's output ``j`` whole where the other branches split it
        otherwise."""
        rec = self.plan.blocks.get(op.uid)
        d = None if rec is None else rec.outs.get((blk, j))
        return v if d is None else self.gather_whole(v, d)

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
        """The parameter gradients summed over the data axis; each
        SelectedRows gradient's values and rows gathered instead (the
        global gradient, its rows in the global batch's order)."""
        if self.data_group is None:
            return
        names = [n for n in self.plan.grad_names if n in env]
        for n, v in zip(names, col.sum_gradients(
                [env[n] for n in names], self.data_group)):
            env[n] = v
        for vals, rows in self.plan.sparse_grads:
            if vals in env and rows in env:
                env[vals] = col.gather_rows(env[vals], self.data_group)
                env[rows] = col.gather_rows(env[rows], self.data_group)
                self.stats["sparse_row_gathers"] += 1

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
