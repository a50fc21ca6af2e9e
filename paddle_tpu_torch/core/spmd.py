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
    pooling, the per-row losses; ``batch_norm`` only on its running
    statistics: its batch statistics are the global batch's in the JAX
    package, sync-BN, which waits) and
    the ops of ``AXIS_OPS`` (softmax, concat, reshape, transpose, ...)
    when they leave dim 0 alone: they run unchanged;
  - the reductions ``reduce_sum``, ``reduce_mean`` and ``mean`` over dim
    0 (or over everything): the rank's partial result goes through
    ``forward_sum`` (its backward passes the cotangent through
    unscaled), so a count-normalized loss divides the global sum by the
    global count;
  - ``moe_ffn`` (ops/moe.py), which routes the global token set itself.

  Any other op that reads a batch-sharded value raises, naming the op
  and Queue 1 item 5.
* **Gradients.**  The backward is linear in the cotangents, so each
  rank's parameter gradients are its part of the global ones; after the
  last op that writes a parameter gradient they are summed over the data
  axis (``sum_gradients``, bucketed), before clipping, regularization
  and the update read them.
* **Sharded storage.**  A parameter a rule shards is stored as the
  rank's shard and gathered whole at the start of the step; its
  accumulators are stored as shards of the same spec.  Under ZeRO-1
  every accumulator is also split over ``data`` on its first free
  divisible dim.  An update op (one with a ``Param`` slot) whose
  parameter or accumulators are sharded runs on the rank's slices of
  parameter and gradient (and the accumulator shards); the parameter is
  then gathered whole again.  The step writes shards back.
* **Fetches** come back global: a batch-sharded value is gathered along
  dim 0, a sharded accumulator whole.
"""
from __future__ import annotations

import dataclasses

import torch

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

#: reductions that become a forward sum when they reduce dim 0
REDUCTIONS = {"reduce_sum": "sum", "reduce_mean": "mean", "mean": "mean"}

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
    if op.type == "mean":
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
    forward_sums, moe = {}, {}
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
                if not (program.is_test or op.attrs.get("is_test", False)
                        or op.attrs.get("use_global_stats", False)):
                    _refuse(op, hit[0], "for batch statistics, which are "
                            "the global batch's in the JAX package "
                            "(sync-BN is not ported)")
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
        if sliced:
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
                    remote=frozenset(remote))


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
        shards: only their update op reads them)."""
        for n, sh in self.plan.specs.items():
            if n in env and not self._is_accumulator(n):
                env[n] = sh.gather(env[n])
        return env

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
        bits (dropout on different rows)."""
        if self.size(mesh_lib.DATA_AXIS) > 1:
            from .._rng import fold_seed

            return fold_seed(seed, 1 + self.rank(mesh_lib.DATA_AXIS))
        return seed


# -- the active step (read by the interpreter and moe_ffn) -----------------
_active = None


def active():
    return _active


def set_active(mexec):
    global _active
    prev, _active = _active, mexec
    return prev
