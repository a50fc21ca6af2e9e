"""Pipeline parallelism: the GPipe and 1F1B schedules over a ``pipe``
mesh axis (counterpart of paddle_tpu/parallel/pipeline.py).

Capability parity: the reference's PipelineOptimizer
(python/paddle/fluid/optimizer.py:3374) executed by PipelineTrainer /
SectionWorker (framework/pipeline_trainer.cc:24,38,169).

The JAX package runs the schedule as one ``lax.scan`` under
``shard_map`` and derives the backward by ``jax.vjp``.  Here the ticks
are a Python loop, one rank per stage:

* **GPipe** (``gpipe``): ``T = M + S - 1`` forward ticks; at tick ``t``
  stage ``s`` runs microbatch ``t - s`` and sends its output to stage
  ``s + 1`` (``exchange`` over the pipe group's point-to-point links).
  The last stage's outputs are broadcast to every rank (the JAX
  package's psum of the masked buffer), so the head runs on every rank
  and each rank's loss is the same.  The schedule is one
  ``torch.autograd.Function``: its backward runs the same ticks in
  reverse, each stage recomputing its forward from the saved input (the
  JAX package's ``jax.checkpoint`` of each stage) and sending the input's
  cotangent to stage ``s - 1``; the input's gradient is broadcast from
  stage 0 and the shared side inputs' gradients are summed over the
  group (the transposes of the JAX package's replicated in-specs).
* **Without a pipe axis** the stages run in sequence, each under
  ``torch.utils.checkpoint``, with the same numerics and no transfer.
* **1F1B** (``one_f_one_b``): ``T = M + 2(S - 1)`` ticks, each a
  forward micro-step (the stage input saved in a ring of ``2S`` slots)
  and a backward micro-step that recomputes from the ring; the last
  stage seeds its cotangent from its in-stage head the same tick.

Each rank holds only its stage's parameters: under a pipe axis
``stacked_params`` may hold every stage (leading dim S; the rank takes
its own) or only the rank's (leading dim 1).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint as _checkpoint

from . import _collectives as col
from . import mesh as mesh_lib

__all__ = ["gpipe", "gpipe_het", "split_microbatches", "merge_microbatches",
           "one_f_one_b"]


def _require_pipe_axis(mesh, axis_name, S):
    P = mesh_lib.axis_size(mesh, axis_name)
    if P != S:
        raise ValueError(
            f"pipeline has {S} stages but mesh axis '{axis_name}' has "
            f"size {P}; they must match (one stage per pipeline rank)")


def _has_axis(mesh, axis_name):
    return mesh is not None and axis_name in mesh_lib.axis_names(mesh)


def _local_stage(stacked_params, S, d):
    """The rank's stage parameters from [S, ...] or [1, ...] tensors."""
    out = []
    for p in stacked_params:
        if p.shape[0] == S:
            out.append(p[d])
        elif p.shape[0] == 1:
            out.append(p[0])
        else:
            raise ValueError(
                f"stacked pipeline parameters need a leading dim of {S} "
                f"(every stage) or 1 (this rank's), got {tuple(p.shape)}")
    return out


def split_microbatches(x, num_microbatches, batch_dim=0):
    """[B, ...] -> [M, B//M, ...] (B must divide evenly); a dict of
    tensors maps every value."""
    if isinstance(x, dict):
        return {k: split_microbatches(v, num_microbatches, batch_dim)
                for k, v in x.items()}
    B = x.shape[batch_dim]
    if B % num_microbatches:
        raise ValueError(
            f"batch {B} not divisible by {num_microbatches} microbatches")
    return x.reshape(x.shape[:batch_dim] + (num_microbatches,
                                            B // num_microbatches)
                     + x.shape[batch_dim + 1:])


def merge_microbatches(x, batch_dim=0):
    """[M, b, ...] -> [M*b, ...]."""
    if isinstance(x, dict):
        return {k: merge_microbatches(v, batch_dim) for k, v in x.items()}
    return x.reshape(x.shape[:batch_dim] + (-1,) + x.shape[batch_dim + 2:])


def _pick(consts_mb, m):
    return {k: v[m] for k, v in consts_mb.items()}


def gpipe(stage_fn, stacked_params, x_mb, consts_mb=None, consts=None,
          mesh=None, axis_name="pipe", remat=True):
    """Run microbatches through S homogeneous stages with a GPipe
    schedule.

    stage_fn(params, act, consts_one, stage_idx, mb_idx) -> act_out
        params: one stage's parameters (a list, leading S axis removed);
        act: the activation, of one shape in and out; consts_one: the
        microbatch's side inputs merged with the shared ``consts``.
    stacked_params: list of [S, ...] tensors (stage-major), or under a
        pipe axis [1, ...] tensors of this rank's stage.
    x_mb: [M, ...] microbatched input; consts_mb: {name: [M, ...]};
    consts: {name: tensor} shared by every microbatch.
    mesh: a mesh with an ``axis_name`` axis of size S, or None to run the
        stages in sequence (same numerics, no transfer).
    Returns the [M, ...] outputs of the last stage, on every rank."""
    consts_mb = dict(consts_mb or {})
    consts = dict(consts or {})
    stacked_params = list(stacked_params)
    M = x_mb.shape[0]
    if not _has_axis(mesh, axis_name):
        S = stacked_params[0].shape[0]

        def call(s, m, act):
            params = [p[s] for p in stacked_params]
            c = _pick(consts_mb, m)
            c.update(consts)
            return stage_fn(params, act, c, s, m)

        return _gpipe_sequential(call, x_mb, S, M, remat)
    S = mesh_lib.axis_size(mesh, axis_name)
    if stacked_params[0].shape[0] not in (S, 1):
        _require_pipe_axis(mesh, axis_name, stacked_params[0].shape[0])
    d = mesh_lib.axis_rank(mesh, axis_name)
    local = _local_stage(stacked_params, S, d)

    def call(params, act, c, m):
        return stage_fn(params, act, c, d, m)

    return _pipe_run(call, local, x_mb, consts_mb, consts,
                     mesh_lib.axis_group(mesh, axis_name), S, M, d)


def gpipe_het(stage_fns, x_mb, consts_mb=None, consts=None, mesh=None,
              axis_name="pipe", remat=True, stage_params=None):
    """HETEROGENEOUS GPipe: per-stage bodies (parity:
    pipeline_trainer.cc:24,38 arbitrary per-section programs) under the
    schedule of :func:`gpipe`.

    stage_fns: S callables ``fn(act, consts_one, mb_idx) -> act_out``;
    ``stage_params[s]`` ({name: tensor}, optional) are merged into stage
    s's ``consts_one`` — under a pipe axis only the rank's own entry is
    read, and its gradients stay on the rank.  Boundary activations share
    one shape and dtype across stages (they ride the same transfers)."""
    consts_mb = dict(consts_mb or {})
    consts = dict(consts or {})
    S = len(stage_fns)
    stage_params = list(stage_params or [{}] * S)
    M = x_mb.shape[0]
    if not _has_axis(mesh, axis_name):
        def call(s, m, act):
            c = _pick(consts_mb, m)
            c.update(consts)
            c.update(stage_params[s])
            return stage_fns[s](act, c, m)

        return _gpipe_sequential(call, x_mb, S, M, remat)
    _require_pipe_axis(mesh, axis_name, S)
    d = mesh_lib.axis_rank(mesh, axis_name)
    names = sorted(stage_params[d])

    def call(params, act, c, m):
        c = dict(c)
        c.update(zip(names, params))
        return stage_fns[d](act, c, m)

    return _pipe_run(call, [stage_params[d][n] for n in names], x_mb,
                     consts_mb, consts, mesh_lib.axis_group(mesh, axis_name),
                     S, M, d)


def _gpipe_sequential(call, x_mb, S, M, remat):
    """No pipe axis: every stage in turn, per microbatch."""
    outs = []
    for m in range(M):
        act = x_mb[m]
        for s in range(S):
            if remat and torch.is_grad_enabled():
                act = _checkpoint(call, s, m, act, use_reentrant=False,
                                  preserve_rng_state=False)
            else:
                act = call(s, m, act)
        outs.append(act)
    return torch.stack(outs)


def _pipe_run(call, params, x_mb, consts_mb, consts, group, S, M, d):
    # non-tensor side inputs (Python scalars) ride in the closure
    other = {k: v for k, v in consts.items() if not torch.is_tensor(v)}
    consts = {k: v for k, v in consts.items() if torch.is_tensor(v)}
    if other:
        inner = call

        def call(params, act, c, m):
            c = dict(c)
            c.update(other)
            return inner(params, act, c, m)

    mb_keys = sorted(consts_mb)
    c_keys = sorted(consts)
    flat = [x_mb, *params, *(consts_mb[k] for k in mb_keys),
            *(consts[k] for k in c_keys)]
    spec = (call, group, S, M, d, len(params), mb_keys, c_keys)
    return _GPipe.apply(spec, *flat)


def _unflatten(spec, flat):
    _, _, _, _, _, n_p, mb_keys, c_keys = spec
    x_mb = flat[0]
    params = list(flat[1:1 + n_p])
    rest = flat[1 + n_p:]
    consts_mb = dict(zip(mb_keys, rest[:len(mb_keys)]))
    consts = dict(zip(c_keys, rest[len(mb_keys):]))
    return x_mb, params, consts_mb, consts


def _stage_consts(consts_mb, consts, m):
    c = _pick(consts_mb, m)
    c.update(consts)
    return c


class _GPipe(torch.autograd.Function):
    """The GPipe ticks over a pipe group; backward = the ticks reversed,
    each stage recomputed from its saved input."""

    @staticmethod
    def forward(ctx, spec, *flat):
        call, group, S, M, d = spec[:5]
        x_mb, params, consts_mb, consts = _unflatten(spec, flat)
        like = x_mb[0]
        saved = [None] * M
        out_buf = torch.zeros_like(x_mb)
        act = None
        for t in range(M + S - 1):
            m = t - d
            out = None
            if 0 <= m < M:
                a = x_mb[m] if d == 0 else act
                saved[m] = a
                out = call(params, a, _stage_consts(consts_mb, consts, m), m)
                if d == S - 1:
                    out_buf[m] = out
            sends = [(out, d + 1)] if out is not None and d < S - 1 else []
            nxt = t + 1 - d
            recvs = [(like, d - 1)] if d > 0 and 0 <= nxt < M else []
            got = col.exchange(sends, recvs, group)
            act = got[0] if got else None
        ctx.spec = spec
        ctx.saved_acts = saved
        ctx.save_for_backward(*flat)
        return col.broadcast_from(out_buf, group, S - 1)

    @staticmethod
    def backward(ctx, g_out):
        spec = ctx.spec
        call, group, S, M, d = spec[:5]
        flat = ctx.saved_tensors
        x_mb, params, consts_mb, consts = _unflatten(spec, flat)
        p_grads = [None] * len(params)
        cmb_grads = {k: None for k in consts_mb}
        c_grads = {k: None for k in consts}
        dx = torch.zeros_like(x_mb)
        like = x_mb[0]
        ct = None
        for t in reversed(range(M + S - 1)):
            m = t - d
            da = None
            if 0 <= m < M:
                if d == S - 1:
                    ct = g_out[m]
                with torch.enable_grad():
                    a = ctx.saved_acts[m].detach().requires_grad_(
                        ctx.saved_acts[m].is_floating_point())
                    ps = [_grad_leaf(p) for p in params]
                    cm = {k: _grad_leaf(v[m]) for k, v in consts_mb.items()}
                    cs = {k: _grad_leaf(v) for k, v in consts.items()}
                    c = dict(cm)
                    c.update(cs)
                    out = call(ps, a, c, m)
                    targets = [a, *ps, *cm.values(), *cs.values()]
                    want = [v for v in targets
                            if torch.is_tensor(v) and v.requires_grad]
                    gs = dict(zip(map(id, want), torch.autograd.grad(
                        out, want, ct, allow_unused=True)))
                da = gs.get(id(a))
                for i, p in enumerate(ps):
                    p_grads[i] = _acc(p_grads[i], gs.get(id(p)))
                for k, v in cm.items():
                    g = gs.get(id(v))
                    if g is not None:
                        if cmb_grads[k] is None:
                            cmb_grads[k] = torch.zeros_like(consts_mb[k])
                        cmb_grads[k][m] += g
                for k, v in cs.items():
                    c_grads[k] = _acc(c_grads[k], gs.get(id(v)))
                if d == 0 and da is not None:
                    dx[m] = da
            sends = []
            if d > 0 and 0 <= m < M:
                sends = [(da if da is not None else torch.zeros_like(like),
                          d - 1)]
            prv = t - 1 - d
            recvs = [(like, d + 1)] if d < S - 1 and 0 <= prv < M else []
            got = col.exchange(sends, recvs, group)
            ct = got[0] if got else None
        dx = col.broadcast_from(dx, group, 0)
        shared = [(consts_mb[k], cmb_grads, k) for k in consts_mb] + \
            [(consts[k], c_grads, k) for k in consts]
        live = [(t, store, k) for t, store, k in shared
                if torch.is_tensor(t) and t.is_floating_point()]
        summed = col.sum_gradients(
            [store[k] if store[k] is not None else torch.zeros_like(t)
             for t, store, k in live], group)
        for (t, store, k), g in zip(live, summed):
            store[k] = g
        return (None, dx, *p_grads, *(cmb_grads[k] for k in consts_mb),
                *(c_grads[k] for k in consts))


def _grad_leaf(v):
    if torch.is_tensor(v) and v.is_floating_point():
        return v.detach().requires_grad_()
    return v


def _acc(acc, g):
    if g is None:
        return acc
    return g if acc is None else acc + g


def one_f_one_b(stage_fn, stacked_params, x_mb, head_fn, head_params,
                consts_mb=None, consts=None, mesh=None, axis_name="pipe"):
    """1F1B (PipeDream-flush / Megatron) schedule: forward and backward
    micro-steps interleave after warmup, so each stage keeps at most
    O(S) microbatch inputs in flight instead of GPipe's O(M).

    ``T = M + 2(S-1)`` ticks; at tick t stage s runs the forward of
    microbatch ``t - s`` (saving its input in a ring of ``2S`` slots) and
    the backward of microbatch ``t - 2(S-1) + s`` (recomputed from the
    ring); the last stage's head (``head_fn(head_params, act,
    consts_one, mb_idx) -> scalar``) seeds its cotangent the same tick,
    and cotangents hop one stage back per tick.

    ``head_params``: a list of tensors.  Returns (total_loss,
    d_stacked_params, d_head_params, d_x_mb): the sum of the
    microbatch losses and its gradients, equal to plain autograd of that
    sum; ``d_stacked_params`` holds the rank's stage only (leading dim
    1)."""
    consts_mb = dict(consts_mb or {})
    consts = dict(consts or {})
    if not _has_axis(mesh, axis_name):
        raise ValueError(
            "one_f_one_b needs a mesh with the pipeline axis "
            f"'{axis_name}' (use gpipe()'s sequential fallback for "
            f"single-device runs)")
    S = mesh_lib.axis_size(mesh, axis_name)
    if stacked_params[0].shape[0] not in (S, 1):
        _require_pipe_axis(mesh, axis_name, stacked_params[0].shape[0])
    d = mesh_lib.axis_rank(mesh, axis_name)
    group = mesh_lib.axis_group(mesh, axis_name)
    params = [p.detach() for p in _local_stage(stacked_params, S, d)]
    head_params = [h.detach() for h in head_params]
    M = x_mb.shape[0]
    R = 2 * S
    like = x_mb[0]
    ring = [None] * R
    dp = [torch.zeros_like(p) for p in params]
    dhp = [torch.zeros_like(h) for h in head_params]
    dx = torch.zeros_like(x_mb)
    loss = torch.zeros((), dtype=x_mb.dtype, device=x_mb.device)
    act_in, ct_in = None, None
    for t in range(M + 2 * (S - 1)):
        fm = t - d
        out = seed = None
        if 0 <= fm < M:
            a = x_mb[fm] if d == 0 else act_in
            ring[fm % R] = a
            c = _stage_consts(consts_mb, consts, fm)
            with torch.no_grad():
                out = stage_fn(params, a, c, d, fm)
            if d == S - 1:
                with torch.enable_grad():
                    hp = [h.requires_grad_() for h in
                          (x.detach() for x in head_params)]
                    o = out.detach().requires_grad_()
                    lm = head_fn(hp, o, c, fm)
                    gs = torch.autograd.grad(lm, [*hp, o],
                                             allow_unused=True)
                loss = loss + lm.detach()
                for i, g in enumerate(gs[:-1]):
                    if g is not None:
                        dhp[i] += g
                seed = gs[-1] if gs[-1] is not None else torch.zeros_like(o)
        bm = t - 2 * (S - 1) + d
        da = None
        if 0 <= bm < M:
            ct = seed if d == S - 1 else ct_in
            c = _stage_consts(consts_mb, consts, bm)
            with torch.enable_grad():
                a = ring[bm % R].detach().requires_grad_()
                ps = [p.detach().requires_grad_() for p in params]
                o = stage_fn(ps, a, c, d, bm)
                gs = torch.autograd.grad(o, [a, *ps], ct, allow_unused=True)
            da = gs[0] if gs[0] is not None else torch.zeros_like(a)
            for i, g in enumerate(gs[1:]):
                if g is not None:
                    dp[i] += g
            if d == 0:
                dx[bm] = da
        sends, recvs = [], []
        if out is not None and d < S - 1:
            sends.append((out, d + 1))
        if da is not None and d > 0:
            sends.append((da, d - 1))
        if d > 0 and 0 <= t + 1 - d < M:
            recvs.append((like, d - 1))
        nb = t + 1 - 2 * (S - 1) + d
        if d < S - 1 and 0 <= nb < M:
            recvs.append((like, d + 1))
        got = iter(col.exchange(sends, recvs, group))
        act_in = next(got) if d > 0 and 0 <= t + 1 - d < M else None
        ct_in = next(got) if d < S - 1 and 0 <= nb < M else None
    loss, *dhp = col.sum_gradients([loss, *dhp], group) if group is not None \
        else [loss, *dhp]
    dx = col.broadcast_from(dx, group, 0)
    return loss, [g[None] for g in dp], dhp, dx
