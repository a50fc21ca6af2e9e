"""Sequence/context parallelism: ring attention and Ulysses head-sharding
over ``torch.distributed`` (counterpart of
paddle_tpu/parallel/ring_attention.py).

* ``ring_attention`` — blockwise attention over a ``seq`` process group.
  Each rank owns a query chunk; key/value chunks (and the key bias)
  rotate one rank per step with point-to-point sends while an online
  softmax folds in one chunk per step.  The flash body runs the flat
  flash kernels (ops/flash_attention.py) on every chunk and merges the
  normalised partials through their logsumexp, so no rank ever holds a
  [Tq_local, Tk_local] score tile outside a kernel; its backward walks
  the ring again with the flat dq and dk/dv kernels.  The einsum body is
  the plain recurrence, differentiated by autograd through the shifts,
  each step checkpointed so that backward recomputes its score tile
  instead of saving P of them.

* ``ulysses_attention`` — the all-to-all alternative: [B, H, T/P, D] ->
  [B, H/P, T, D] turns sequence sharding into head sharding, plain full
  attention runs per rank, and a second all-to-all restores it.

Unlike the JAX functions, which take GLOBAL [B, H, T, D] arrays and
shard them with ``shard_map`` when given a mesh, these are per-rank:
every rank of the group calls them with its own [B, H, T/P, D] chunk
(rank r holds positions [r T/P, (r + 1) T/P)), as the JAX functions'
``mesh=None`` form inside an existing ``shard_map``.  ``mesh`` only
names the process group of ``axis``: a ``DeviceMesh``, else the current
mesh (``set_current_mesh``), else the default group; without any
process group the call is the one-rank case.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from .._rng import fold_seed
from ..ops import flash_attention as fa
from ..ops.attention import _NEG_INF, attention
from ._collectives import all_to_all, group_rank_size, ring_shift, shift
from .mesh import current_mesh

__all__ = ["ring_attention", "ulysses_attention"]


def _group(mesh, axis):
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is not None:
        return mesh.get_group(axis)
    return dist.group.WORLD if dist.is_initialized() else None


def _bias_view(bc, H):
    """A rotating [B, Tk] key bias as the kernels' [B, H, 1, Tk] view."""
    if bc is None:
        return None
    B, Tk = bc.shape
    return bc[:, None, None, :].expand(B, H, 1, Tk)


def _visits(idx, P, causal):
    """(step, causal flag of the chunk held at that step, whether it runs
    at all): step r holds the chunk of rank (idx - r) mod P; under the
    causal mask the diagonal chunk (step 0) runs causal, earlier ranks'
    chunks unmasked and later ranks' chunks not at all."""
    for r in range(P):
        src = (idx - r) % P
        yield r, causal and src == idx, not (causal and src > idx)


class _RingFlash(torch.autograd.Function):
    """Per-rank ring attention through the flat flash kernels.

    Forward: each step runs the flat forward on (q, the chunk held) and
    merges its normalised output by lse reweighting, then k, v and the
    key bias move one rank on.  Chunks from later ranks run no kernel
    under the causal mask (they would merge with weight exp(-1e30 - m) =
    0), so causal ring attention does about half the flops.  Saves q, the
    local k, v and bias, o and the merged lse — no chunk of another rank.

    Backward: the gradient of attention over all the keys is each chunk's
    flash backward under the merged lse and the global delta =
    rowsum(do * o), so the ring is walked again: dq sums over chunks, and
    each chunk's dk, dv and dbias (summed over heads) travel with it and
    come home after P shifts."""

    @staticmethod
    def forward(ctx, q, k, v, kbias, group, causal, sm_scale):
        idx, P = group_rank_size(group)
        B, H, Tq, D = q.shape
        acc = torch.zeros((B, H, Tq, D), dtype=torch.float32,
                          device=q.device)
        m = torch.full((B, H, Tq), _NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        kc, vc, bc = k, v, kbias
        for r, diag, runs in _visits(idx, P, causal):
            if runs:
                o_i, lse_i = fa.flash_forward_flat(q, kc, vc, _bias_view(bc, H),
                                                   diag, sm_scale)
                # step 0 is the diagonal chunk, so m is finite from then on
                m_new = torch.maximum(m, lse_i)
                alpha, w = torch.exp(m - m_new), torch.exp(lse_i - m_new)
                acc = acc * alpha[..., None] + w[..., None] * o_i
                l = l * alpha + w
                m = m_new
            if r < P - 1:
                kc, vc, bc = shift((kc, vc, bc), group)
        o = acc / l[..., None]
        ctx.save_for_backward(q, k, v, kbias, o, m + torch.log(l))
        ctx.cfg = (group, causal, sm_scale)
        return o.to(q.dtype)

    @staticmethod
    def backward(ctx, do):
        q, k, v, kbias, o, lse = ctx.saved_tensors
        group, causal, sm_scale = ctx.cfg
        idx, P = group_rank_size(group)
        H = q.shape[1]
        do = do.float().contiguous()
        delta = fa.flash_delta_flat(o, do)
        dq = torch.zeros_like(o)
        kc, vc, bc = k, v, kbias
        dk = torch.zeros_like(k, dtype=torch.float32)
        dv = torch.zeros_like(v, dtype=torch.float32)
        db = None if kbias is None else torch.zeros_like(kbias)
        for r, diag, runs in _visits(idx, P, causal):
            if runs:
                dq_i, dk_i, dv_i, db_i = fa.flash_backward_flat(
                    q, kc, vc, _bias_view(bc, H), do, lse, delta, diag,
                    sm_scale)
                dq += dq_i
                dk += dk_i
                dv += dv_i
                if db is not None:
                    db += db_i.sum(dim=1)
            if r < P - 1:
                kc, vc, bc, dk, dv, db = shift((kc, vc, bc, dk, dv, db),
                                               group)
            else:
                dk, dv, db = shift((dk, dv, db), group)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None if db is None or not ctx.needs_input_grad[3] else db,
                None, None, None)


def _ring_attention_shard_flash(q, k, v, kbias, group, causal, sm_scale):
    if causal and q.shape[-2] != k.shape[-2]:
        raise ValueError(
            f"causal ring attention through the flash kernels needs equal "
            f"local chunks (the chunk-level causal dispatch); got q "
            f"{q.shape[-2]} and k {k.shape[-2]} positions")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    if kbias is not None:
        kbias = kbias.float().contiguous()
    return _RingFlash.apply(q, k, v, kbias, group, bool(causal),
                            float(sm_scale))


def _einsum_step(qf, kc, vc, bc, acc, m, l, mask, sm_scale):
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kc.float()) * sm_scale
    if bc is not None:
        s = s + bc[:, None, None, :]
    if mask is not None:
        s = s.masked_fill(~mask, _NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    p = torch.exp(s - m_new)
    alpha = torch.exp(m - m_new)
    l = l * alpha + p.sum(dim=-1, keepdim=True)
    acc = acc * alpha + torch.einsum("bhqk,bhkd->bhqd", p, vc.float())
    return acc, m_new, l


def _ring_attention_shard(q, k, v, kbias, group, causal, sm_scale,
                          use_flash=None):
    """Per-rank ring attention: q [B, H, Tq_local, D], k/v [B, H,
    Tk_local, D] (the local chunks), kbias [B, Tk_local] additive or
    None.  The flash body, or the plain online-softmax recurrence over
    einsums (global positions masked start-aligned, rows >= cols, under
    causal) when ``use_flash`` is False or, on the CPU, None with unequal
    chunks."""
    if use_flash is None:
        use_flash = q.device.type == "cuda" or q.shape[-2] == k.shape[-2]
    if use_flash:
        return _ring_attention_shard_flash(q, k, v, kbias, group, causal,
                                           sm_scale)
    idx, P = group_rank_size(group)
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    qf = q.float()
    rows = idx * Tq + torch.arange(Tq, device=q.device)
    acc = torch.zeros((B, H, Tq, D), dtype=torch.float32, device=q.device)
    m = torch.full((B, H, Tq, 1), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    kc, vc = k, v
    bc = None if kbias is None else kbias.float()
    for r in range(P):
        src = (idx - r) % P
        mask = None
        if causal:
            cols = src * Tk + torch.arange(Tk, device=q.device)
            mask = rows[:, None] >= cols[None, :]
        # backward recomputes this step's score tile (jax.checkpoint)
        acc, m, l = checkpoint(_einsum_step, qf, kc, vc, bc, acc, m, l,
                               mask, sm_scale, use_reentrant=False)
        if r < P - 1:
            kc, vc, bc = ring_shift((kc, vc, bc), group)
    return (acc / l).to(q.dtype)


def ring_attention(q, k, v, kbias=None, mesh=None, axis="seq",
                   causal=False, sm_scale=None, use_flash=None):
    """Ring attention, per rank: q/k/v are this rank's [B, H, T/P, D]
    chunks of the sequence sharded over ``axis``, kbias its [B, T/P]
    chunk of an additive key bias (padding mask) or None -> this rank's
    [B, H, T/P, D] output chunk, differentiable in q, k, v and kbias.

    ``mesh`` names the process group of ``axis`` (see the module
    docstring).  ``use_flash``: the flash-kernel body (True) or the
    plain einsum ring (False).  None takes the flash body on CUDA tensors,
    whose kernels raise on a dtype, d_head or chunk shape they cannot
    take, and on CPU tensors with equal chunks (the kernels' plain
    versions there); only an explicit False runs plain attention on the
    card."""
    return _ring_attention_shard(q, k, v, kbias, _group(mesh, axis), causal,
                                 sm_scale, use_flash=use_flash)


def ulysses_attention(q, k, v, mesh=None, axis="seq", causal=False,
                      sm_scale=None, dropout_rate=0.0, rng=None):
    """Ulysses sequence parallelism (parity pattern: DeepSpeed-Ulysses),
    per rank: q/k/v [B, H, T/P, D] -> [B, H, T/P, D], differentiable.
    Needs H % P == 0.  ``rng``: an integer dropout seed; each rank folds
    its index into it, so the sequence shards draw independent masks."""
    group = _group(mesh, axis)
    idx, P = group_rank_size(group)
    H = q.shape[1]
    if H % P:
        raise ValueError(f"ulysses_attention needs num_heads ({H}) "
                         f"divisible by the '{axis}' group ({P})")
    gen = None
    if dropout_rate > 0.0:
        gen = torch.Generator(device=q.device).manual_seed(
            fold_seed(int(rng or 0), idx))

    # [B, H, T/P, D] -> [B, H/P, T, D]: split heads, gather the sequence
    qh, kh, vh = (all_to_all(x, group, 1, 2) for x in (q, k, v))
    o = attention(qh, kh, vh, causal=causal, sm_scale=sm_scale,
                  dropout_rate=dropout_rate, generator=gen)
    return all_to_all(o, group, 2, 1)
