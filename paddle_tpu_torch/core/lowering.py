"""Block lowering: turn a Program block into one Python function over
torch tensors.

Counterpart of paddle_tpu/core/lowering.py, for what training needs:
``analyze_block``, ``lower_block``, ``_interp_ops``, ``_run_vjp_grad``.
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

Not ported: control-flow sub-blocks, recompute, pipeline and AMP.  Their
ops are not registered, so a program that holds one raises at run time,
naming the op.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

from .. import profiler as _prof
from .._rng import fold_seed
from .fusion import UNBOUND, FusionExec, plan_fusion, run_fused_grad, \
    run_fused_group
from .program import EMPTY_VAR_NAME, Program
from .registry import REGISTRY, OpContext

VJP_GRAD_OP = "vjp_grad"


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
            _interp_ops(ops, env, seed, {}, vjp_uids, device, fusion)
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


def _interp_ops(ops, env, seed, vjps, vjp_uids, device, fusion=None):
    """Execute an op list over ``env`` (name -> tensor), in place.

    Runs under ``torch.no_grad``; a forward op in ``vjp_uids`` runs under
    autograd on leaf copies of its inputs and leaves (inputs, outputs) in
    ``vjps`` for its ``vjp_grad`` op.  ``fusion`` (a FusionExec): planned
    groups run at their last member (earlier members and internal
    gradient sums are skipped) and member ``vjp_grad`` ops bind from the
    group's gradients, never binding ``UNBOUND``."""
    plan = fusion.plan if fusion is not None else None
    scoped = _prof.device_tracing()
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
                                           env, seed, device, vjp_uids)
                else:
                    opdef = REGISTRY.get(op.type)
                    ins = {slot: [env[n] for n in names]
                           for slot, names in op.inputs.items()}
                    ctx = OpContext(
                        # fold by uid: unique program-wide, so no two ops
                        # share a stream
                        rng=(fold_seed(seed, op.uid) if opdef.needs_rng
                             else None),
                        is_test=bool(op.attrs.get("is_test", False)),
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
    return env


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
