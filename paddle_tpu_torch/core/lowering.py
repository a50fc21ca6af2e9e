"""Block lowering: turn a Program block into one Python function over
torch tensors.

Counterpart of paddle_tpu/core/lowering.py: ``analyze_block``,
``lower_block``, ``_interp_ops``, ``_run_vjp_grad`` and the block ops.
The JAX package traces the op list into one jitted XLA function; here the
function interprets the op list eagerly over a name -> tensor env, each
op dispatching its own PyTorch calls and kernels.

Gradient ops (type ``vjp_grad``, appended by core/backward.py) take the
place of ``jax.vjp``: a forward op whose uid some ``vjp_grad`` op names
runs under autograd on detached leaf copies of its inputs (views, not
copies), so its graph is its own; the ``vjp_grad`` op then calls
``torch.autograd.grad`` on that op's outputs with the cotangents from the
env and drops the saved graph.  Backward reuses the forward's saved
tensors exactly like the JAX tape — no recomputation, no per-op grad
kernels.

The GEMM-epilogue fusion pass (core/fusion.py) plans once per lowered
block 0 when ``fuse_epilogues`` is on: ``_interp_ops`` skips the planned
members but the last and the internal gradient sums, runs each group at
its last member, and routes the members' ``vjp_grad`` ops to
``run_fused_grad``.

Per-op trace attribution, as the JAX lowering's ``jax.named_scope``:
while the profiler's torch.profiler session runs, each op executes
inside a ``torch.profiler.record_function`` named ``"type:first_output"``
(a fused group under its last member's name), so a Kineto trace maps
each CUDA kernel back to its program op.  The scope opens only then:
the untraced step pays one flag check per op.

Control flow: the block ops (``BLOCK_OPS``: while, conditional_block,
switch, static_rnn) run their sub-blocks through the same interpreter,
eagerly — the JAX package's ``lax.while_loop`` / ``lax.scan`` /
``lax.cond`` become Python loops and branches over tensors.  ``while``
and ``conditional_block`` read their condition on the host (one
device-to-host sync per trip or branch); ``static_rnn`` and ``switch``
read none.  A block op in ``vjp_uids`` runs its whole sub-block under
autograd on leaf copies of its declared inputs, so its ``vjp_grad`` op
differentiates through the loop as one ``autograd.grad``; reads the op
does not declare stay constants, as in the JAX package.

``FLAGS_check_nan_inf`` (flags.py): every floating output an op writes
is scanned for NaN and Inf, and the first raises ``RuntimeError`` naming
the op's index, type and output, as in the JAX lowering.  The flag is
read once per op list; off, the step pays that one read.

Recompute (``recompute_grad``, appended by RecomputeOptimizer): the ops
before it run under autograd in segments cut after each checkpoint
variable's producer, each segment under non-reentrant
``torch.utils.checkpoint``, so only the segments' inputs and live
outputs stay alive; the op then takes ``autograd.grad`` of the loss,
which runs each segment's forward once more — two forwards a step, as
XLA's CSE leaves the JAX package's ``jax.checkpoint`` re-trace.  Every
random op draws from ``fold_seed(seed, op.uid)``, so a recomputed
dropout draws the same bits.  The fusion pass plans no group in such a
program (core/fusion.py).

Pipelines (``pipeline_grad``, appended by PipelineOptimizer): the
forward lives in a sub-block, split at the cut variables into preamble,
S stages and head by dataflow (``plan_pipeline``, the JAX lowering's
rules and error texts); the stages run under ``parallel.pipeline``'s
GPipe schedule (over the mesh's ``pipe`` axis, or in sequence without
one), each under ``torch.utils.checkpoint``, and the op takes
``autograd.grad`` of the unweighted mean of the per-microbatch losses.
The fusion pass plans nothing in such a program (core/fusion.py).

Meshes (a CompiledProgram with one): core/spmd.py plans the batch split
(each op's class, the sub-blocks of the block ops included), the
gradient sum, the sharded storage and the Megatron split over a
``model`` axis once per lowering, and its ``MeshExec`` runs them each
step: an op runs through ``MeshExec.run`` (its inputs gathered whole or
its outputs summed over the batch, its inputs' collectives, its attrs
and random bits on the model rank, its outputs' sums), inside the op's
own autograd graph so that its ``vjp_grad`` differentiates through
them.  The block ops convert their carried values before a loop
(``MeshExec.block_pre``); the fusion pass plans no group around an op
that does not run row by row under the mesh.

AMP (``program._amp_dtype``, set by contrib/mixed_precision's
``decorate``): the dtype policy applies to every op's inputs just before
its compute (``policy.amp_cast``, the JAX lowering's ``_amp_cast``), in
block 0, in sub-blocks, in recompute segments and in a fused group's
replayed members; it rewrites no op of the program.  A forward op's leaf
copies are taken after the cast, so its ``vjp_grad`` returns gradients in
the dtypes the op computed in, as the JAX ``jax.vjp`` of the cast inputs
does; the persistables stay float32 master weights.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch
from torch.utils.checkpoint import checkpoint as _checkpoint

from .. import profiler as _prof
from .._rng import fold_seed
from ..contrib.mixed_precision.policy import amp_cast
from ..flags import flag as _flag
from . import spmd
from .fusion import UNBOUND, FusionExec, plan_fusion, run_fused_grad, \
    run_fused_group
from .program import EMPTY_VAR_NAME, Program
from .registry import REGISTRY, OpContext

VJP_GRAD_OP = "vjp_grad"
RECOMPUTE_GRAD_OP = "recompute_grad"
PIPELINE_GRAD_OP = "pipeline_grad"

#: ops that run a sub-block of the program (parity: the JAX lowering's
#: BLOCK_OPS and the reference's while_op.cc, conditional_block_op.cc,
#: recurrent_op.cc); the interpreter runs them itself, like vjp_grad
BLOCK_OPS = ("while", "conditional_block", "switch", "static_rnn")


@dataclasses.dataclass
class LoweredBlock:
    fn: object  # (feeds, mut_params, const_params, seed) -> (fetches, new_persist)
    feed_names: tuple
    mut_param_names: tuple  # persistables read AND written
    const_param_names: tuple  # persistables/scope vars read only
    persist_out_names: tuple  # persistables written back to scope
    fetch_names: tuple
    runs: int = 0   # steps run through fn (the Executor counts them)
    fusion_plan: object = None  # core/fusion.FusionPlan, or None
    mesh_plan: object = None    # core/spmd.MeshPlan, or None


def analyze_block(program: Program, block_idx: int, feed_names, fetch_names):
    """Classify variables: external inputs (from scope), written persistables."""
    block = program.blocks[block_idx]
    produced = set(feed_names)
    external = []
    ext_set = set()
    written_persist = []
    for op in block.ops:
        for n in op.input_names():
            if n == EMPTY_VAR_NAME:
                continue
            if n not in produced and n not in ext_set:
                ext_set.add(n)
                external.append(n)
        for n in op.output_names():
            produced.add(n)
            var = block._find_var_recursive(n)
            if var is not None and var.persistable and n not in written_persist:
                written_persist.append(n)
    # fetches of vars never produced in this block must come from scope
    for n in fetch_names:
        if n not in produced and n not in ext_set:
            ext_set.add(n)
            external.append(n)
    mut = tuple(n for n in external if n in written_persist)
    const = tuple(n for n in external if n not in written_persist)
    return mut, const, tuple(written_persist)


def lower_block(program: Program, block_idx: int, feed_names, fetch_names,
                device, fuse_epilogues=False, fuse_block_epilogues=False,
                mesh=None) -> LoweredBlock:
    """The block as ``fn(feeds, mut_params, const_params, seed)``: every
    op's outputs land on ``device`` (ops with tensor inputs follow their
    inputs; ops that create tensors use ``OpContext.device``).  With
    ``fuse_epilogues`` block 0 runs its matched chains as fused groups
    (``fuse_block_epilogues`` adds the block patterns).  ``mesh``: a
    CompiledProgram with a mesh — the feeds are the rank's slices, the
    sharded persistables the rank's shards, and the fetches come back
    global (core/spmd.py)."""
    block = program.blocks[block_idx]
    ops = list(block.ops)
    feed_names = tuple(feed_names)
    fetch_names = tuple(fetch_names)
    _refuse_hidden_fetches(program, ops, fetch_names)
    mut, const, persist_out = analyze_block(
        program, block_idx, feed_names, fetch_names)
    vjp_uids = frozenset(
        op.attrs["fwd_uid"] for op in ops if op.type == VJP_GRAD_OP)
    _mark_shared_vjps(ops)
    # a program cloned for test runs every op with is_test semantics
    is_test = program.is_test
    recompute = _plan_recompute(program, ops, fetch_names, persist_out)
    mplan = None
    if mesh is not None and mesh.has_mesh:
        if block_idx != 0:
            raise ValueError("a mesh runs block 0")
        remote = _remote_pipeline_names(program, ops, mesh)
        persist = [n for n in dict.fromkeys(mut + const + persist_out)
                   if _persistable(block, n)]
        mplan = spmd.plan_mesh(program, ops, mesh, feed_names, persist,
                               remote)
        mut = tuple(n for n in mut if n not in remote)
        const = tuple(n for n in const if n not in remote)
        persist_out = tuple(n for n in persist_out if n not in remote)
    fusion_plan = None
    if fuse_epilogues and block_idx == 0:
        # under a mesh a group is cut where one of its ops does not run
        # row by row (a sum over the batch inside a product's chain)
        fusion_plan = plan_fusion(
            program, ops, feed_names, fetch_names,
            block_patterns=fuse_block_epilogues,
            exclude=frozenset() if mplan is None else frozenset(
                uid for uid, m in mplan.modes.items()
                if m.kind != "local"))
    start = recompute.op_index if recompute is not None else 0
    # the gradient sum runs between rest[:sync] and rest[sync:]
    sync = len(ops) if mplan is None else max(mplan.sync_index - start, 0)

    def run_block(feeds, mut_params, const_params, seed):
        env = {}
        env.update(const_params)
        env.update(mut_params)
        env.update(feeds)
        mx = None if mplan is None else spmd.MeshExec(mplan)
        prev = spmd.set_active(mx)
        try:
            if mx is not None:
                env = mx.enter(env)
                seed = mx.step_seed(seed)
            fusion = None if fusion_plan is None else FusionExec(fusion_plan)
            vjps = {}
            rest = ops[start:]
            if recompute is not None:
                _run_recompute_forward(program, recompute, env, seed, vjps,
                                       device, is_test)
            with torch.no_grad():
                _interp_ops(program, rest[:sync], env, seed, vjps, vjp_uids,
                            device, fusion, is_test)
                if mx is not None:
                    mx.sum_grads(env)
                    _interp_ops(program, rest[sync:], env, seed, vjps,
                                vjp_uids, device, fusion, is_test)
            if recompute is not None:
                # the forward's values carry its (freed) graph
                env = {n: v.detach() if torch.is_tensor(v) else v
                       for n, v in env.items()}
            if mx is None:
                fetches = [env[n] for n in fetch_names]
                new_persist = {n: env[n] for n in persist_out}
            else:
                fetches = [mx.fetch(n, env[n]) for n in fetch_names]
                new_persist = {n: mx.store(n, env[n]) for n in persist_out}
                mx.finish()
        finally:
            spmd.set_active(prev)
        return fetches, new_persist

    return LoweredBlock(fn=run_block, feed_names=feed_names,
                        mut_param_names=mut, const_param_names=const,
                        persist_out_names=persist_out,
                        fetch_names=fetch_names, fusion_plan=fusion_plan,
                        mesh_plan=mplan)


def _persistable(block, name):
    var = block._find_var_recursive(name)
    return var is not None and var.persistable


def _refuse_hidden_fetches(program, ops, fetch_names):
    """Under PipelineOptimizer the forward lives in a sub-block: only the
    loss (and top-level vars) can be fetched (the JAX lowering's check,
    its message)."""
    for top_op in ops:
        if top_op.type != PIPELINE_GRAD_OP:
            continue
        sub_produced = set()
        for o in program.blocks[top_op.attrs["sub_block"]].ops:
            sub_produced.update(o.output_names())
        hidden = [n for n in fetch_names
                  if n in sub_produced
                  and n not in top_op.outputs.get("Loss", [])]
        if hidden:
            raise ValueError(
                f"Cannot fetch {hidden}: under PipelineOptimizer the "
                f"forward runs microbatched inside the pipeline "
                f"schedule, so only the loss "
                f"({top_op.outputs['Loss']}) and top-level variables "
                f"are fetchable")


def _leaf(v):
    """A detached view of ``v`` that autograd differentiates (floating
    tensors) — the op's own graph starts here."""
    if torch.is_tensor(v) and (v.is_floating_point() or v.is_complex()):
        return v.detach().requires_grad_()
    return v


#: the scope of an op when no device trace runs (reusable: no state)
_NO_SCOPE = contextlib.nullcontext()


def _op_scope_name(op):
    """Trace scope for one program op: "type:first_output".  '/' would
    open a nested profiler scope, so it is flattened."""
    for names in op.outputs.values():
        for n in names:
            if n != EMPTY_VAR_NAME:
                return f"{op.type}:{n}".replace("/", "_")
    return op.type


def _interp_ops(program, ops, env, seed, vjps, vjp_uids, device,
                fusion=None, is_test=False):
    """Execute an op list of ``program`` over ``env`` (name -> tensor), in
    place.  Shared by block 0 and the sub-blocks of block ops.

    Runs under ``torch.no_grad``; a forward op in ``vjp_uids`` runs under
    autograd on leaf copies of its inputs and leaves (inputs, outputs) in
    ``vjps`` for its ``vjp_grad`` op.  ``fusion`` (a FusionExec): planned
    groups run at their last member (earlier members and internal
    gradient sums are skipped) and member ``vjp_grad`` ops bind from the
    group's gradients, never binding ``UNBOUND``.  ``is_test`` (the
    program's) is ORed into every op's own ``is_test`` attr."""
    plan = fusion.plan if fusion is not None else None
    scoped = _prof.device_tracing()
    mx = spmd.active()
    nan_check = _flag("FLAGS_check_nan_inf")
    amp = getattr(program, "_amp_dtype", None)
    for i, op in enumerate(ops):
        if plan is not None and op.uid in plan.skip_uids:
            continue
        if mx is not None and op.uid in mx.plan.skip_uids:
            continue    # the update of another pipeline stage's parameter
        # per-op trace attribution (the JAX lowering's named_scope)
        with (torch.profiler.record_function(_op_scope_name(op))
              if scoped else _NO_SCOPE):
            try:
                if op.type == VJP_GRAD_OP:
                    grp = None if plan is None else plan.member_group.get(
                        op.attrs.get("fwd_uid"))
                    outs = (_run_vjp_grad(op, env, vjps) if grp is None
                            else run_fused_grad(op, fusion, grp, env))
                elif op.type == RECOMPUTE_GRAD_OP:
                    outs = _run_recompute_grad(op, env, vjps)
                elif op.type == PIPELINE_GRAD_OP:
                    outs = _run_pipeline_grad(program, op, env, seed,
                                              device, is_test)
                elif plan is not None and op.uid in plan.by_last:
                    outs = run_fused_group(fusion, plan.by_last[op.uid],
                                           env, seed, device, vjp_uids,
                                           is_test, amp)
                elif op.type in BLOCK_OPS:
                    outs = _run_block_op(program, op, env, seed, vjps,
                                         vjp_uids, device, is_test)
                else:
                    opdef = REGISTRY.get(op.type)
                    ins = {slot: [env[n] for n in names]
                           for slot, names in op.inputs.items()}
                    if amp is not None:
                        ins = amp_cast(ins, op.type, amp)
                    ctx = OpContext(
                        # fold by uid: unique program-wide, so no two ops
                        # share a stream
                        rng=(fold_seed(seed, op.uid) if opdef.needs_rng
                             else None),
                        is_test=is_test or bool(op.attrs.get("is_test",
                                                             False)),
                        attrs=op.attrs, device=device)
                    if mx is not None and op.uid in mx.plan.update_ops:
                        ins = mx.slice_update(op, ins)
                    if op.uid in vjp_uids:
                        ins = {slot: [_leaf(v) for v in vals]
                               for slot, vals in ins.items()}
                        with torch.enable_grad():
                            outs = _compute(opdef, ctx, ins, op, mx)
                        vjps[op.uid] = (ins, outs)
                    else:
                        outs = _compute(opdef, ctx, ins, op, mx)
            except KeyError as e:
                raise RuntimeError(
                    f"Lowering failed at op #{i} {op!r}: missing variable "
                    f"{e}. Did you run the startup program / feed all data?"
                ) from e
        for slot, names in op.outputs.items():
            vals = outs.get(slot, [])
            for n, v in zip(names, vals):
                if n != EMPTY_VAR_NAME and v is not UNBOUND:
                    env[n] = v
                    if nan_check:
                        _check_nan_inf(op, i, n, v)
    return env


def _compute(opdef, ctx, ins, op, mx):
    """One op's compute; under a mesh, an op that reads batch-sharded
    values runs as its class says (core/spmd.py: a sum over the batch,
    sync-BN, the op on the whole batch, ...), an op of the model split
    runs on the rank's part and an update op's parameter comes back
    whole."""
    if mx is None:
        return opdef.compute(ctx, ins, op.attrs)
    if op.uid in mx.plan.moe:
        mx.moe_mode = mx.plan.moe[op.uid]
        try:
            return opdef.compute(ctx, ins, op.attrs)
        finally:
            mx.moe_mode = None
    outs = mx.run(opdef, ctx, ins, op)
    if op.uid in mx.plan.update_ops:
        outs = mx.gather_update(op, outs)
    return outs


def _check_nan_inf(op, op_idx, name, value):
    """Per-op output scan (parity: FLAGS_check_nan_inf,
    framework/operator.cc:1029; the JAX lowering's ``_check_nan_inf``,
    the same message).  One host sync per floating output on the card:
    it runs only under the flag, which also turns the fusion pass off so
    every op's output is seen."""
    if not torch.is_tensor(value) or not value.is_floating_point():
        return
    if not bool(torch.isfinite(value).all()):
        kind = "nan" if bool(torch.isnan(value).any()) else "inf"
        dtype = str(value.dtype).replace("torch.", "")
        raise RuntimeError(
            f"Operator #{op_idx} '{op.type}' output '{name}' contains "
            f"{kind} (FLAGS_check_nan_inf); shape={tuple(value.shape)} "
            f"dtype={dtype}")


def _run_block_op(program, op, env, seed, vjps, vjp_uids, device, is_test):
    """Execute a control-flow op that owns sub-blocks.  In ``vjp_uids``
    the whole op runs under autograd on leaf copies of its declared
    inputs and leaves (inputs, outputs) for its ``vjp_grad`` op; the
    sub-blocks' own ops capture nothing (no per-op vjp, no fusion)."""
    runner = _BLOCK_RUNNERS[op.type]
    ins = {slot: [env[n] for n in names] for slot, names in op.inputs.items()}
    if op.uid not in vjp_uids:
        return runner(program, op, ins, env, seed, device, is_test)
    ins = {slot: [_leaf(v) for v in vals] for slot, vals in ins.items()}
    with torch.enable_grad():
        outs = runner(program, op, ins, env, seed, device, is_test)
    vjps[op.uid] = (ins, outs)
    return outs


def _subblock_env(op, ins, outer_env):
    """Base environment of a sub-block: the outer env (constants) with
    the op's declared inputs (the differentiable operands) over it."""
    env = dict(outer_env)
    for slot, names in op.inputs.items():
        for n, v in zip(names, ins.get(slot, [])):
            env[n] = v
    return env


def _run_subblock(program, block_idx, env, seed, device, is_test):
    """Interpret one sub-block over ``env``, capturing nothing: a block
    op is differentiated as a unit."""
    return _interp_ops(program, program.blocks[block_idx].ops, env, seed,
                       {}, frozenset(), device, None, is_test)


def _truth(t):
    """A scalar condition tensor as a Python bool (a host sync on the
    card).  Under a mesh it is the same on every rank (core/spmd.py,
    "Control flow")."""
    return bool(t.reshape(()))


def _mesh_pre(op, env):
    """Under a mesh, a block op's loop values split as its sub-block
    wants them (core/spmd.py ``BlockMode.pre``)."""
    mx = spmd.active()
    if mx is not None:
        mx.block_pre(op, env)


def _branch_out(op, blk, j, v):
    mx = spmd.active()
    return v if mx is None else mx.branch_out(op, blk, j, v)


def _run_while(program, op, ins, outer_env, seed, device, is_test):
    """``while`` over a sub-block (parity: while_op.cc; the JAX lowering's
    ``_run_while``).  The carried state is the op's Out vars and the
    condition; every carried value is coerced back to its carry's dtype
    and shape after a trip, and trip ``it`` draws from
    ``fold_seed(seed, it)``, so dropout in the body draws a fresh mask
    per trip.

    With ``max_iters`` the loop is bounded: the JAX package runs exactly
    ``max_iters`` trips of ``lax.cond(active, body, identity)``.  A trip
    whose condition is false is the identity and leaves the condition
    false, so the trips after the first false one are skipped here — the
    same values, and the untaken body never runs (no 0 * inf in the
    gradient).  A condition still true after ``max_iters`` trips
    truncates the loop.  Unbounded, it loops while the condition holds
    (forward only: core/backward.py refuses to differentiate it)."""
    cond_name = op.inputs["Condition"][0]
    out_names = list(op.outputs["Out"])
    base_env = _subblock_env(op, ins, outer_env)
    _mesh_pre(op, base_env)
    sub_idx = op.attrs["sub_block"]
    max_iters = op.attrs.get("max_iters")
    carry = {n: base_env[n] for n in sorted(set(out_names) | {cond_name})}
    it = 0
    while (max_iters is None or it < int(max_iters)) \
            and _truth(carry[cond_name]):
        env = dict(base_env)
        env.update(carry)
        _run_subblock(program, sub_idx, env, fold_seed(seed, it), device,
                      is_test)
        carry = {n: env[n].to(c.dtype).reshape(c.shape)
                 for n, c in carry.items()}
        it += 1
    return {"Out": [carry[n] for n in out_names]}


def _run_cond(program, op, ins, outer_env, seed, device, is_test):
    """``conditional_block`` (parity: conditional_block_op.cc,
    layers.cond): only the branch the predicate picks runs; its
    ``*_out_names`` (the returned vars, then the outer writes) are the
    op's Out."""
    base_env = _subblock_env(op, ins, outer_env)
    if _truth(base_env[op.inputs["Cond"][0]]):
        block_idx, names = op.attrs["true_block"], op.attrs["true_out_names"]
    else:
        block_idx, names = (op.attrs["false_block"],
                            op.attrs["false_out_names"])
    env = dict(base_env)
    _run_subblock(program, block_idx, env, seed, device, is_test)
    return {"Out": [_branch_out(op, block_idx, j, env[n])
                    for j, n in enumerate(names)]}


def _run_switch(program, op, ins, outer_env, seed, device, is_test):
    """Switch/case (parity: layers.Switch, the JAX lowering's
    ``_run_switch``): every case block and the default block run, and
    nested ``torch.where`` selects each output — the first true case
    wins.  No host sync."""
    base_env = _subblock_env(op, ins, outer_env)
    cond_names = op.inputs["Conds"]
    case_envs = []
    for bi in op.attrs["case_blocks"]:
        env = dict(base_env)
        _run_subblock(program, bi, env, seed, device, is_test)
        case_envs.append(env)
    default_block = op.attrs.get("default_block")
    denv = base_env
    if default_block is not None:
        denv = dict(base_env)
        _run_subblock(program, default_block, denv, seed, device, is_test)
    outs = []
    for j, n in enumerate(op.outputs["Out"]):
        acc = denv.get(n, base_env.get(n))
        if default_block is not None and acc is not None:
            acc = _branch_out(op, default_block, j, acc)
        for cname, cenv, bi in zip(reversed(cond_names), reversed(case_envs),
                                   reversed(op.attrs["case_blocks"])):
            v = cenv.get(n)
            if v is None:
                continue
            v = _branch_out(op, bi, j, v)
            pred = base_env[cname].reshape(()).to(torch.bool)
            acc = torch.where(pred, v, acc)
        outs.append(acc)
    return {"Out": outs}


def _run_static_rnn(program, op, ins, outer_env, seed, device, is_test):
    """StaticRNN (parity: recurrent_op.cc; the JAX lowering's
    ``lax.scan``): a Python loop over the leading T axis of the step
    inputs; memories are the carry, step outputs are stacked along a new
    axis 0, and step ``t`` draws from ``fold_seed(seed, t)``.  No host
    sync."""
    base_env = _subblock_env(op, ins, outer_env)
    _mesh_pre(op, base_env)
    sub_idx = op.attrs["sub_block"]
    xs = list(zip(op.attrs["x_local_names"], op.inputs.get("X", [])))
    mem_locals = op.attrs["mem_local_names"]
    mem_updates = op.attrs["mem_update_names"]
    step_out_names = op.attrs["step_out_names"]
    carry = {ln: base_env[n]
             for ln, n in zip(mem_locals, op.inputs.get("Init", []))}
    steps = base_env[xs[0][1]].shape[0]
    ys = [[] for _ in step_out_names]
    for t in range(steps):
        env = dict(base_env)
        env.update(carry)
        for ln, n in xs:
            env[ln] = base_env[n][t]
        _run_subblock(program, sub_idx, env, fold_seed(seed, t), device,
                      is_test)
        carry = {ln: env[un] for ln, un in zip(mem_locals, mem_updates)}
        for y, n in zip(ys, step_out_names):
            y.append(env[n])
    return {"Out": [torch.stack(y) for y in ys],
            "LastMem": [carry[ln] for ln in mem_locals]}


_BLOCK_RUNNERS = {
    "while": _run_while,
    "conditional_block": _run_cond,
    "switch": _run_switch,
    "static_rnn": _run_static_rnn,
}


@dataclasses.dataclass
class _RecomputePlan:
    op_index: int   # the recompute_grad op's index in block 0
    op: object
    # (ops, names each segment outputs) in program order
    segments: list


def _plan_recompute(program, ops, fetch_names, persist_out):
    """Cut the forward before a ``recompute_grad`` op into segments:
    each ends with the op that writes a checkpoint variable.  A segment
    outputs only the names something after it reads (a later op, any
    sub-block, a fetch, a persistable written back, the loss); the rest
    of its values live only inside it.  None without such an op."""
    at = [i for i, op in enumerate(ops) if op.type == RECOMPUTE_GRAD_OP]
    if not at:
        return None
    r = at[0]
    rop = ops[r]
    ckpts = set(rop.attrs.get("checkpoints") or ())
    cuts, start = [], 0
    for i, op in enumerate(ops[:r]):
        if ckpts & set(op.output_names()):
            cuts.append((start, i + 1))
            start = i + 1
    if start < r:
        cuts.append((start, r))
    always = set(fetch_names) | set(persist_out) | set(rop.input_names())
    for blk in program.blocks[1:]:
        for o in blk.ops:
            always.update(o.input_names())
    segments = []
    for a, b in cuts:
        later = set(always)
        for o in ops[b:]:
            later.update(o.input_names())
        produced = []
        for o in ops[a:b]:
            produced += [n for n in o.output_names()
                         if n != EMPTY_VAR_NAME and n not in produced]
        segments.append((ops[a:b], tuple(n for n in produced
                                         if n in later)))
    return _RecomputePlan(op_index=r, op=rop, segments=segments)


def _run_recompute_forward(program, plan, env, seed, vjps, device, is_test):
    """The forward before a ``recompute_grad`` op, under autograd, one
    checkpointed segment at a time (see the module docstring).  The
    parameters the op differentiates become leaves; they wait in
    ``vjps`` under the op's uid."""
    leaves = {n: _leaf(env[n]) for n in plan.op.inputs["Params"]}
    env.update(leaves)
    with torch.enable_grad():
        for seg_ops, out_names in plan.segments:
            snap = dict(env)

            def seg(seg_ops=seg_ops, out_names=out_names, snap=snap):
                e = dict(snap)
                _interp_ops(program, seg_ops, e, seed, {}, frozenset(),
                            device, None, is_test)
                return tuple(e[n] for n in out_names)

            # every random op seeds from fold_seed(seed, op.uid): torch's
            # global RNG state plays no part in a recomputed segment
            env.update(zip(out_names, _checkpoint(
                seg, use_reentrant=False, preserve_rng_state=False)))
    vjps[plan.op.uid] = leaves


def _run_recompute_grad(op, env, vjps):
    """The whole loss's parameter gradients (parity: the JAX lowering's
    ``_run_recompute_grad``): ``autograd.grad`` through the checkpointed
    forward, which recomputes each segment; a parameter the loss does
    not reach gets zeros."""
    leaves = vjps.pop(op.uid)
    loss = env[op.inputs["Loss"][0]]
    names = list(op.inputs["Params"])
    mx = spmd.active()
    seed = torch.ones_like(loss) * (1.0 if mx is None else mx.seed_scale())
    grads = torch.autograd.grad([loss], [leaves[n] for n in names],
                                [seed], allow_unused=True)
    return {"Grad": [torch.zeros_like(leaves[n]) if g is None else g
                     for n, g in zip(names, grads)]}


def _mark_shared_vjps(ops):
    """A forward op that more than one backward pass differentiates (a
    ``gradients()`` call, then ``minimize()`` of the same loss) keeps its
    graph for the later ones: every ``vjp_grad`` op but the last of its
    forward op gets ``_vjp_retain``."""
    last = {}
    for op in ops:
        if op.type == VJP_GRAD_OP:
            last[op.attrs["fwd_uid"]] = op.uid
    for op in ops:
        if op.type == VJP_GRAD_OP:
            op._vjp_retain = last[op.attrs["fwd_uid"]] != op.uid


def _run_vjp_grad(op, env, vjps):
    """Execute a generic gradient op: ``torch.autograd.grad`` through the
    forward op's own graph, then drop it (keep it, when a later backward
    pass differentiates the same op: ``_mark_shared_vjps``).  Outputs
    without a cotangent (no grad var, integer outputs, outputs autograd
    did not track) take a zero cotangent by being left out, as
    ``_zero_cotangent`` does in the JAX package; an input autograd did
    not reach gets zeros."""
    fwd_uid = op.attrs["fwd_uid"]
    if fwd_uid not in vjps:
        raise RuntimeError(
            f"vjp_grad op references forward op uid={fwd_uid} which was not "
            f"executed in this block (grad ops must follow their forward op)")
    retain = getattr(op, "_vjp_retain", False)
    ins, outs = vjps[fwd_uid] if retain else vjps.pop(fwd_uid)
    prims, cts = [], []
    for slot, vals in outs.items():
        names = op.inputs.get("OG@" + slot, [])
        for j, p in enumerate(vals):
            n = names[j] if j < len(names) else EMPTY_VAR_NAME
            if n == EMPTY_VAR_NAME or n not in env or not p.requires_grad:
                continue
            prims.append(p)
            cts.append(env[n].to(p.dtype))
    wanted, targets = [], []
    for slot, vals in ins.items():
        names = op.outputs.get("IG@" + slot, [])
        for j, v in enumerate(vals):
            if (j < len(names) and names[j] != EMPTY_VAR_NAME
                    and torch.is_tensor(v) and v.requires_grad):
                wanted.append((slot, j))
                targets.append(v)
    grads = [None] * len(targets)
    if prims and targets:
        grads = torch.autograd.grad(prims, targets, cts, allow_unused=True,
                                    retain_graph=retain)
    result = {"IG@" + slot: [None] * len(vals) for slot, vals in ins.items()}
    for (slot, j), g, t in zip(wanted, grads, targets):
        result["IG@" + slot][j] = (g if g is not None
                                   else torch.zeros_like(t)).detach()
    return result


# -- pipelines (PipelineOptimizer's pipeline_grad) ---------------------------

@dataclasses.dataclass
class _PipelinePlan:
    cut_vars: list
    num_microbatches: int
    axis_name: str
    pre_ops: list
    stage_ops: list
    post_ops: list
    plists: list          # each stage's parameter names, in first-read order
    homogeneous: bool
    t_ext: list           # side inputs the stages read
    post_ext: set         # what the head reads besides the last cut var
    produced_in_sub: set
    param_names: list
    loss_name: str


def _canon_attr(v):
    import numpy as _np

    return v.tolist() if isinstance(v, _np.ndarray) else v


def plan_pipeline(program, op):
    """Split a ``pipeline_grad`` op's sub-block at its cut variables into
    preamble, S stages and head, by dataflow (the JAX lowering's
    ``_run_pipeline_grad`` rules and error texts): ops inside the stage
    region that do not (transitively) consume the first cut variable
    are hoisted into the preamble.  Cached on the op."""
    cached = getattr(op, "_pipeline_plan", None)
    if cached is not None:
        return cached
    attrs = op.attrs
    cut_vars = list(attrs["cut_vars"])
    fwd_ops = program.blocks[attrs["sub_block"]].ops
    param_names = list(op.inputs["Params"])
    param_set = set(param_names)
    prod_idx = {}
    for i, fop in enumerate(fwd_ops):
        for n in fop.output_names():
            if n in cut_vars and n not in prod_idx:
                prod_idx[n] = i
    missing = [c for c in cut_vars if c not in prod_idx]
    if missing:
        raise ValueError(f"pipeline cut vars not produced in block: {missing}")
    idxs = [prod_idx[c] for c in cut_vars]
    if idxs != sorted(idxs):
        raise ValueError("pipeline cut vars must be produced in order")
    region = fwd_ops[idxs[0] + 1: idxs[-1] + 1]
    tainted = {cut_vars[0]}
    stage_region, hoisted = [], []
    for o in region:
        if any(n in tainted for n in o.input_names()):
            stage_region.append(o)
            tainted.update(o.output_names())
        else:
            hoisted.append(o)
    pre_ops = fwd_ops[: idxs[0] + 1] + hoisted
    bnd_pos = {}
    for i, o in enumerate(stage_region):
        for n in o.output_names():
            if n in cut_vars[1:] and n not in bnd_pos:
                bnd_pos[n] = i
    off_stream = [c for c in cut_vars[1:] if c not in bnd_pos]
    if off_stream:
        raise ValueError(
            f"pipeline cut vars {off_stream} are not on the pipeline "
            f"dataflow stream (their producers do not transitively consume "
            f"the first cut var '{cut_vars[0]}'); cut at activations that "
            f"flow stage-to-stage, not at feed-derived side values")
    ridx = [-1] + [bnd_pos[c] for c in cut_vars[1:]]
    stage_ops = [stage_region[ridx[s] + 1: ridx[s + 1] + 1]
                 for s in range(len(cut_vars) - 1)]
    post_ops = fwd_ops[idxs[-1] + 1:]

    def _stage_signature(ops_s, s, plist):
        produced = {}
        sig = []
        for i, o in enumerate(ops_s):
            canon_in = []
            for slot, names in sorted(o.inputs.items()):
                for pos, n in enumerate(names):
                    if n in param_set:
                        canon_in.append((slot, pos, "param", plist.index(n)))
                    elif n == cut_vars[s]:
                        canon_in.append((slot, pos, "stream"))
                    elif n in produced:
                        canon_in.append((slot, pos, "local", produced[n]))
                    else:
                        canon_in.append((slot, pos, "ext", n))
            for slot, names in sorted(o.outputs.items()):
                for pos, n in enumerate(names):
                    produced[n] = (i, slot, pos)
            attrs_c = sorted((k, repr(_canon_attr(v)))
                             for k, v in o.attrs.items())
            sig.append((o.type, tuple(canon_in), tuple(attrs_c)))
        return sig

    t_types = [o.type for o in stage_ops[0]]
    plists, extsets = [], []
    for s, ops_s in enumerate(stage_ops):
        produced = set()
        plist, ext = [], set()
        for o in ops_s:
            for n in o.input_names():
                if n in param_set:
                    if n not in plist:
                        plist.append(n)
                elif n not in produced and n != cut_vars[s]:
                    ext.add(n)
            produced.update(o.output_names())
        plists.append(plist)
        extsets.append(ext)
    homogeneous = (
        all([o.type for o in ops_s] == t_types for ops_s in stage_ops)
        and all(len(pl) == len(plists[0]) for pl in plists)
        and all(e == extsets[0] for e in extsets))
    if homogeneous:
        t_sig = _stage_signature(stage_ops[0], 0, plists[0])
        for s in range(1, len(stage_ops)):
            sig_s = _stage_signature(stage_ops[s], s, plists[s])
            if sig_s != t_sig:
                import warnings

                diff = next(i for i, (a, b) in enumerate(zip(t_sig, sig_s))
                            if a != b)
                warnings.warn(
                    f"pipeline stage {s} op {diff} "
                    f"({stage_ops[s][diff].type}) differs from stage 0 in "
                    f"attrs/wiring; falling back to the HETEROGENEOUS "
                    f"path (per-stage bodies). Make the stages exactly "
                    f"isomorphic to regain the stacked fast path.\n"
                    f"stage0: {t_sig[diff]}\nstage{s}: {sig_s[diff]}",
                    stacklevel=2)
                homogeneous = False
                break
    stage_produced = []
    for ops_s in stage_ops:
        prod = set()
        for o in ops_s:
            prod.update(o.output_names())
        stage_produced.append(prod)
    for s, ext in enumerate(extsets):
        for n in ext:
            owners = [j for j, prod in enumerate(stage_produced)
                      if j != s and n in prod]
            if owners:
                raise ValueError(
                    f"pipeline stage {s} reads '{n}', an internal of "
                    f"stage {owners[0]}; stages may only exchange data "
                    f"through the cut variables — cut at activations "
                    f"that flow stage-to-stage, or move the shared "
                    f"computation into the preamble")
    t_ext = sorted(set().union(*extsets)) if not homogeneous \
        else sorted(extsets[0])
    produced_in_sub = set()
    for fop in fwd_ops:
        produced_in_sub.update(fop.output_names())
    post_produced, post_ext = set(), set()
    for o in post_ops:
        for n in o.input_names():
            if (n not in post_produced and n not in param_set
                    and n != cut_vars[-1]):
                post_ext.add(n)
        post_produced.update(o.output_names())
    bad = post_ext & (produced_in_sub - set(cut_vars))
    bad -= {n for o in pre_ops for n in o.output_names()}
    if bad:
        raise ValueError(
            f"pipeline head reads stage-internal vars {sorted(bad)}; it may "
            f"only read the last cut var, preamble outputs, and feeds")
    plan = _PipelinePlan(
        cut_vars=cut_vars, num_microbatches=int(attrs["num_microbatches"]),
        axis_name=attrs.get("axis_name", "pipe"), pre_ops=pre_ops,
        stage_ops=stage_ops, post_ops=post_ops, plists=plists,
        homogeneous=homogeneous, t_ext=t_ext, post_ext=post_ext,
        produced_in_sub=produced_in_sub, param_names=param_names,
        loss_name=op.outputs["Loss"][0])
    op._pipeline_plan = plan
    return plan


def _remote_pipeline_names(program, ops, compiled):
    """Under a mesh whose pipe axis has more than one rank: the names
    this rank does not hold — every other stage's parameters, their
    gradients and their optimizer accumulators."""
    from ..parallel import mesh as mesh_lib

    remote = set()
    for op in ops:
        if op.type != PIPELINE_GRAD_OP:
            continue
        pp = plan_pipeline(program, op)
        P = mesh_lib.axis_size(compiled.mesh, pp.axis_name)
        if pp.axis_name not in mesh_lib.axis_names(compiled.mesh):
            continue
        S = len(pp.stage_ops)
        if P != S:
            raise ValueError(
                f"pipeline has {S} stages but mesh axis '{pp.axis_name}' "
                f"has size {P}; they must match (one stage per pipeline "
                f"rank)")
        d = mesh_lib.axis_rank(compiled.mesh, pp.axis_name)
        for s, plist in enumerate(pp.plists):
            if s != d:
                remote.update(plist)
    if not remote:
        return frozenset()
    block = program.global_block()
    for op in ops:
        if op.inputs.get("Param", [None])[0] in remote:
            for n in [*op.input_names(), *op.output_names()]:
                var = block._find_var_recursive(n)
                if var is not None and getattr(var, "is_optimizer_state",
                                               False):
                    remote.add(n)
    remote.update(n + "@GRAD" for n in list(remote))
    return frozenset(remote)


def _run_pipeline_grad(program, op, env, seed, device, is_test):
    """Pipelined forward + backward (parity: the JAX lowering's
    ``_run_pipeline_grad``, PipelineOptimizer fluid/optimizer.py:3374).
    The preamble runs once on the whole batch, the stages under
    ``parallel.pipeline.gpipe`` (homogeneous stages share stage 0's ops
    as their template; heterogeneous ones run their own), the head once
    per microbatch; the loss is the unweighted mean of the microbatch
    losses and the op returns its gradients.  A parameter another
    pipeline rank holds gets no gradient here (``UNBOUND``)."""
    import warnings

    from ..parallel import mesh as mesh_lib
    from ..parallel.pipeline import gpipe, gpipe_het, split_microbatches

    pp = plan_pipeline(program, op)
    attrs = op.attrs
    cut_vars, M = pp.cut_vars, pp.num_microbatches
    param_set = set(pp.param_names)
    mx = spmd.active()
    mesh = mx.mesh if mx is not None else None
    piped = mesh is not None and pp.axis_name in mesh_lib.axis_names(mesh)
    d = mesh_lib.axis_rank(mesh, pp.axis_name) if piped else 0
    leaves = {n: _leaf(env[n]) for n in pp.param_names if n in env}
    base_env = {k: v for k, v in env.items()
                if k not in pp.produced_in_sub and k not in param_set}
    S = len(pp.stage_ops)
    block = program.global_block()
    with torch.enable_grad():
        env2 = dict(base_env)
        env2.update(leaves)
        _interp_ops(program, pp.pre_ops, env2, seed, {}, frozenset(),
                    device, None, is_test)
        b0 = env2[cut_vars[0]]
        B = b0.shape[0]
        bcast_names = set(attrs.get("broadcast_inputs") or ())
        try:
            cut0_shape = block.var(cut_vars[0]).shape
        except (KeyError, ValueError, AttributeError):
            cut0_shape = None
        symbolic_batch = bool(cut0_shape) and cut0_shape[0] in (-1, None)
        if not symbolic_batch:
            warnings.warn(
                "pipeline program has a static (literal) batch dim, so "
                "the split/broadcast decision for side inputs falls "
                "back to the leading-dim==batch heuristic; declare "
                "feeds with batch None (pt.data default) for derived "
                "provenance, or list shared tensors in "
                "PipelineOptimizer(broadcast_inputs=[...])",
                stacklevel=2)

        def leading_is_batch(name):
            if not symbolic_batch:
                return True
            try:
                var = block.var(name)
            except (KeyError, ValueError, AttributeError):
                return True
            if getattr(var, "is_data", False):
                return True
            shp = var.shape
            return bool(shp) and len(shp) >= 1 and shp[0] in (-1, None)

        def per_batch(n, v):
            return (n not in bcast_names and torch.is_tensor(v)
                    and v.dim() >= 1 and v.shape[0] == B
                    and leading_is_batch(n))

        x_mb = split_microbatches(b0, M)
        s_consts_mb = {n: split_microbatches(env2[n], M)
                       for n in pp.t_ext if per_batch(n, env2[n])}
        s_consts = {n: env2[n] for n in pp.t_ext
                    if not per_batch(n, env2[n])}
        if pp.homogeneous:
            t_params = pp.plists[0]
            template = pp.stage_ops[0]
            if piped:
                stacked = [leaves[pp.plists[d][k]][None]
                           for k in range(len(t_params))]
            else:
                stacked = [torch.stack([leaves[pp.plists[s][k]]
                                        for s in range(S)])
                           for k in range(len(t_params))]

            def stage_fn(params, act, consts_one, stage_idx, mb_idx):
                senv = dict(consts_one)
                senv[cut_vars[0]] = act
                senv.update(zip(t_params, params))
                srng = fold_seed(fold_seed(seed, 7919 + stage_idx), mb_idx)
                _interp_ops(program, template, senv, srng, {}, frozenset(),
                            device, None, is_test)
                return senv[cut_vars[1]]

            out_mb = gpipe(stage_fn, stacked, x_mb, consts_mb=s_consts_mb,
                           consts=s_consts, mesh=mesh if piped else None,
                           axis_name=pp.axis_name)
        else:
            def make_stage(s):
                def fn(act, consts_one, mb_idx):
                    senv = dict(consts_one)
                    senv[cut_vars[s]] = act
                    srng = fold_seed(fold_seed(seed, 7919 + s), mb_idx)
                    _interp_ops(program, pp.stage_ops[s], senv, srng, {},
                                frozenset(), device, None, is_test)
                    return senv[cut_vars[s + 1]]
                return fn

            stage_params = [{n: leaves[n] for n in plist if n in leaves}
                            for plist in pp.plists]
            try:
                out_mb = gpipe_het(
                    [make_stage(s) for s in range(S)], x_mb,
                    consts_mb=s_consts_mb, consts=s_consts,
                    mesh=mesh if piped else None, axis_name=pp.axis_name,
                    stage_params=stage_params)
            except RuntimeError as e:
                if "size" not in str(e) and "shape" not in str(e):
                    raise
                raise ValueError(
                    f"heterogeneous pipeline stages must produce cut "
                    f"activations of ONE shared shape/dtype (they ride "
                    f"the same stage-to-stage transfers) — cut at points "
                    f"after any regime change (e.g. after the "
                    f"conv→sequence reshape): {e}") from e
        p_consts_mb = {n: split_microbatches(env2[n], M)
                       for n in pp.post_ext if per_batch(n, env2[n])}
        p_consts = {n: env2[n] for n in pp.post_ext
                    if not per_batch(n, env2[n])}
        losses = []
        for m in range(M):
            penv = dict(p_consts)
            penv.update(leaves)
            penv.update({n: v[m] for n, v in p_consts_mb.items()})
            penv[cut_vars[-1]] = out_mb[m]
            _interp_ops(program, pp.post_ops, penv,
                        fold_seed(seed, 104729 + m), {}, frozenset(),
                        device, None, is_test)
            losses.append(penv[pp.loss_name].reshape(()))
        loss = torch.stack(losses).mean()
    names = [n for n in pp.param_names if n in leaves]
    scale = 1.0 if mx is None else mx.seed_scale()
    grads = dict(zip(names, torch.autograd.grad(
        [loss], [leaves[n] for n in names], [torch.full_like(loss, scale)],
        allow_unused=True)))
    return {"Loss": [loss.detach()],
            "Grad": [UNBOUND if n not in leaves else
                     (torch.zeros_like(leaves[n]) if grads[n] is None
                      else grads[n]) for n in pp.param_names]}
