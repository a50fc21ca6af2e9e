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

Not ported: recompute, pipeline and AMP.  Their ops are not registered,
so a program that holds one raises at run time, naming the op.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

from .. import profiler as _prof
from .._rng import fold_seed
from ..flags import flag as _flag
from .fusion import UNBOUND, FusionExec, plan_fusion, run_fused_grad, \
    run_fused_group
from .program import EMPTY_VAR_NAME, Program
from .registry import REGISTRY, OpContext

VJP_GRAD_OP = "vjp_grad"

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
                device, fuse_epilogues=False,
                fuse_block_epilogues=False) -> LoweredBlock:
    """The block as ``fn(feeds, mut_params, const_params, seed)``: every
    op's outputs land on ``device`` (ops with tensor inputs follow their
    inputs; ops that create tensors use ``OpContext.device``).  With
    ``fuse_epilogues`` block 0 runs its matched chains as fused groups
    (``fuse_block_epilogues`` adds the block patterns)."""
    block = program.blocks[block_idx]
    ops = list(block.ops)
    feed_names = tuple(feed_names)
    fetch_names = tuple(fetch_names)
    mut, const, persist_out = analyze_block(
        program, block_idx, feed_names, fetch_names)
    vjp_uids = frozenset(
        op.attrs["fwd_uid"] for op in ops if op.type == VJP_GRAD_OP)
    # a program cloned for test runs every op with is_test semantics
    is_test = program.is_test
    fusion_plan = None
    if fuse_epilogues and block_idx == 0:
        fusion_plan = plan_fusion(program, ops, feed_names, fetch_names,
                                  block_patterns=fuse_block_epilogues)

    def run_block(feeds, mut_params, const_params, seed):
        env = {}
        env.update(const_params)
        env.update(mut_params)
        env.update(feeds)
        fusion = None if fusion_plan is None else FusionExec(fusion_plan)
        with torch.no_grad():
            _interp_ops(program, ops, env, seed, {}, vjp_uids, device,
                        fusion, is_test)
        fetches = [env[n] for n in fetch_names]
        new_persist = {n: env[n] for n in persist_out}
        return fetches, new_persist

    return LoweredBlock(fn=run_block, feed_names=feed_names,
                        mut_param_names=mut, const_param_names=const,
                        persist_out_names=persist_out,
                        fetch_names=fetch_names, fusion_plan=fusion_plan)


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
    nan_check = _flag("FLAGS_check_nan_inf")
    for i, op in enumerate(ops):
        if plan is not None and op.uid in plan.skip_uids:
            continue
        # per-op trace attribution (the JAX lowering's named_scope)
        with (torch.profiler.record_function(_op_scope_name(op))
              if scoped else _NO_SCOPE):
            try:
                if op.type == VJP_GRAD_OP:
                    grp = None if plan is None else plan.member_group.get(
                        op.attrs.get("fwd_uid"))
                    outs = (_run_vjp_grad(op, env, vjps) if grp is None
                            else run_fused_grad(op, fusion, grp, env))
                elif plan is not None and op.uid in plan.by_last:
                    outs = run_fused_group(fusion, plan.by_last[op.uid],
                                           env, seed, device, vjp_uids,
                                           is_test)
                elif op.type in BLOCK_OPS:
                    outs = _run_block_op(program, op, env, seed, vjps,
                                         vjp_uids, device, is_test)
                else:
                    opdef = REGISTRY.get(op.type)
                    ins = {slot: [env[n] for n in names]
                           for slot, names in op.inputs.items()}
                    ctx = OpContext(
                        # fold by uid: unique program-wide, so no two ops
                        # share a stream
                        rng=(fold_seed(seed, op.uid) if opdef.needs_rng
                             else None),
                        is_test=is_test or bool(op.attrs.get("is_test",
                                                             False)),
                        attrs=op.attrs, device=device)
                    if op.uid in vjp_uids:
                        ins = {slot: [_leaf(v) for v in vals]
                               for slot, vals in ins.items()}
                        with torch.enable_grad():
                            outs = opdef.compute(ctx, ins, op.attrs)
                        vjps[op.uid] = (ins, outs)
                    else:
                        outs = opdef.compute(ctx, ins, op.attrs)
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
    card)."""
    return bool(t.reshape(()))


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
    return {"Out": [env[n] for n in names]}


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
    for n in op.outputs["Out"]:
        acc = denv.get(n, base_env.get(n))
        for cname, cenv in zip(reversed(cond_names), reversed(case_envs)):
            v = cenv.get(n)
            if v is None:
                continue
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


def _run_vjp_grad(op, env, vjps):
    """Execute a generic gradient op: ``torch.autograd.grad`` through the
    forward op's own graph, then drop it.  Outputs without a cotangent
    (no grad var, integer outputs, outputs autograd did not track) take a
    zero cotangent by being left out, as ``_zero_cotangent`` does in the
    JAX package; an input autograd did not reach gets zeros."""
    fwd_uid = op.attrs["fwd_uid"]
    if fwd_uid not in vjps:
        raise RuntimeError(
            f"vjp_grad op references forward op uid={fwd_uid} which was not "
            f"executed in this block (grad ops must follow their forward op)")
    ins, outs = vjps.pop(fwd_uid)
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
        grads = torch.autograd.grad(prims, targets, cts, allow_unused=True)
    result = {"IG@" + slot: [None] * len(vals) for slot, vals in ins.items()}
    for (slot, j), g, t in zip(wanted, grads, targets):
        result["IG@" + slot][j] = (g if g is not None
                                   else torch.zeros_like(t)).detach()
    return result
