"""Eager op dispatch over torch autograd (parity: imperative/tracer.h:57
Tracer::TraceOp + imperative/engine.h:75 BasicEngine +
imperative/gradient_accumulator.cc).

Counterpart of paddle_tpu/dygraph/engine.py.  Every eager op runs the
SAME registered op function the Executor lowers (core/registry.py)
directly on the VarBases' tensors — no per-op shape inference.  When an
input that is floating and not ``stop_gradient`` reaches an op with
recording on, the op runs with torch's grad mode on and autograd keeps
its graph: torch autograd is the tape.  ``backward(root)`` then gives a
``.grad`` to every live VarBase the root reaches whose ``stop_gradient``
is False — intermediates too, as the JAX tape does — adding to a
``.grad`` already there.

The JAX tape holds its entries in a list that ``backward`` clears (unless
``retain_graph``) and prunes as outputs die.  Here refcounts free a
graph whose outputs died, and the list is a generation number: a
``backward`` without ``retain_graph`` (and ``reset_tape``) starts a new
one, a VarBase remembers the generation of the op that made it, and
``backward`` reaches only the current one.  So a second ``backward``
from a root whose tape was cleared reaches nothing but gives the root
its seed, without raising, as in the JAX package; a VarBase of an older
generation read by a new op enters the new graph as a leaf.

Random ops draw an int seed per op from ``seed(s)`` through
``_rng.fold_seed`` (the JAX package folds a ``jax.random`` key): the
kernels' Philox keys and the init ops' generators take it, so an eager
run is reproducible from its seed, with masks other than the JAX
package's.
"""
from __future__ import annotations

import weakref

import torch

from .._rng import fold_seed
from ..core import unique_name
from ..core.registry import REGISTRY, OpContext
from .varbase import VarBase, _floating

__all__ = ["run_eager_op", "run_inline_op", "backward", "reset_tape",
           "seed", "EagerBlock", "register_var", "lookup_var"]

_grad_enabled: bool = True
_TRACER = None  # set by jit.TracedLayer.trace to mirror ops into a Program
# name -> VarBase; lets name-based static-style code (LayerHelper,
# initializers, optimizer _append_optimize_op) resolve eager tensors
_NS = weakref.WeakValueDictionary()
# name -> [weakref] of live VarBases a later one of the same name
# displaced from _NS (two models built under one unique_name.guard()):
# a lookup falls back to the latest of them once the newer one dies
_SHADOWED = {}
#: the tape's generation (see the module docstring)
_GEN = 0

_rng_seed = 0
_rng_counter = 0


def seed(s: int):
    """Set the eager-mode random seed (parity: fluid seed for dygraph)."""
    global _rng_seed, _rng_counter
    _rng_seed, _rng_counter = int(s), 0


def _next_rng() -> int:
    global _rng_counter
    _rng_counter += 1
    return fold_seed(_rng_seed, _rng_counter)


def register_var(v):
    """Resolve ``v.name`` to ``v`` from now on (LayerHelper.input calls
    this for every VarBase a layer function reads)."""
    name = v.name
    old = _NS.get(name)
    if old is not None and old is not v:
        refs = [r for r in _SHADOWED.get(name, ())
                if r() is not None and r() is not v and r() is not old]
        _SHADOWED[name] = refs + [weakref.ref(old)]
    _NS[name] = v


def _live_vars():
    """Every live VarBase once, shadowed ones included."""
    live = {id(v): v for v in list(_NS.values())}
    for refs in list(_SHADOWED.values()):
        for r in refs:
            v = r()
            if v is not None:
                live[id(v)] = v
    return live.values()


def lookup_var(name: str):
    v = _NS.get(name)
    refs = _SHADOWED.get(name)
    while v is None and refs:
        v = refs.pop()()
        if v is not None:
            _NS[name] = v
    if v is None:
        raise KeyError(
            f"eager variable '{name}' not alive (dygraph namespace is "
            f"weak — keep a reference to tensors you use by name)")
    return v


def reset_tape():
    """Forget every recorded op: later backward passes reach nothing
    recorded before this call."""
    global _GEN
    _GEN += 1


def _read(v):
    """An input's tensor; a value recorded on a cleared tape is cut to a
    leaf first (its graph belongs to a finished backward)."""
    if v._gen is not None and v._gen != _GEN:
        v._make_leaf(v._value)
    return v._value


def _differentiable(vs) -> bool:
    return any(not v._stop_gradient and v._value is not None
               and _floating(v._value) for v in vs)


def _output(val, record):
    """A new VarBase for an op's output: ``VarBase.__init__`` would cut
    the graph (it detaches), so the fields are set here."""
    v = VarBase.__new__(VarBase)
    v._stop_gradient = not record
    v._value = val
    v._gen = _GEN if record and val.grad_fn is not None else None
    v.name = unique_name.generate("eager_tmp")
    v.persistable = False
    v.grad = None
    _NS[v.name] = v
    return v


def run_eager_op(op_type, inputs, attrs=None, is_test=None,
                 out_targets=None):
    """Execute one registered op eagerly.

    inputs: {slot: [VarBase]}; returns {slot: [VarBase]}.  If
    ``out_targets`` maps a slot/pos to an existing VarBase, the result is
    written into it: a declared placeholder takes the output as it is,
    an existing tensor (ParamOut, the batch-norm running statistics) is
    replaced by a new detached leaf — the VarBase keeps its identity and
    name, so optimizer state keyed by name still finds it."""
    from .base import current_device, train_mode

    opdef = REGISTRY.get(op_type)
    attrs = dict(attrs or {})
    ins = {slot: [_read(v) for v in vs] for slot, vs in inputs.items()}
    ctx = OpContext(
        rng=_next_rng() if opdef.needs_rng else None,
        is_test=(not train_mode()) if is_test is None else is_test,
        attrs=attrs, device=current_device())
    if bool(attrs.get("is_test", False)):
        ctx.is_test = True
    record = _grad_enabled and any(
        _differentiable(vs) for vs in inputs.values())
    with torch.set_grad_enabled(record):
        outs = opdef.compute(ctx, ins, attrs)

    targets = out_targets or {}
    out_vars = {}
    for slot, vals in outs.items():
        lst = []
        for pos, val in enumerate(vals):
            tgt = targets.get((slot, pos))
            if tgt is None:
                lst.append(_output(val, record))
            elif tgt._value is None:
                # a declared placeholder adopts op-output semantics
                tgt._stop_gradient = tgt._stop_gradient or not record
                if tgt._stop_gradient:
                    tgt._make_leaf(val)
                else:
                    tgt._value = val
                    tgt._gen = _GEN if val.grad_fn is not None else None
                lst.append(tgt)
            else:
                # written in place: a new leaf, stop_gradient as it was
                tgt._make_leaf(val)
                lst.append(tgt)
        out_vars[slot] = lst
    if _TRACER is not None:
        _TRACER.record(op_type, inputs, attrs, out_vars)
    return out_vars


def run_inline_op(fn, in_vars):
    """Record an arbitrary torch function of [VarBase] -> tensor (used for
    indexing and other ad-hoc eager ops)."""
    if _TRACER is not None:
        raise ValueError(
            "this operation (tensor indexing / inline torch op) has no "
            "registered op type and cannot be captured by TracedLayer")
    vals = [_read(v) for v in in_vars]
    record = _grad_enabled and _differentiable(in_vars)
    with torch.set_grad_enabled(record):
        val = fn(*vals)
    return _output(val, record)


def backward(root, retain_graph=False):
    """Differentiate ``root`` (parity: BasicEngine::Execute), seeded with
    ones_like(root) (reference: loss grad filled with 1): every live
    VarBase of the current generation (and every leaf) with
    ``stop_gradient`` False that the root reaches gains its gradient in
    ``.grad``; the root gains the seed."""
    if root.value is None:
        raise ValueError("backward() on an uninitialized VarBase")
    t = root.value
    seed_ct = torch.ones_like(t)
    if t.grad_fn is not None and root._gen == _GEN:
        wanted = [v for v in _live_vars()
                  if v is not root and not v._stop_gradient
                  and v._value is not None and v._value.requires_grad
                  and (v._value.grad_fn is None or v._gen == _GEN)]
        grads = torch.autograd.grad(
            [t], [v._value for v in wanted], grad_outputs=[seed_ct],
            allow_unused=True, retain_graph=retain_graph) if wanted else ()
        for v, g in zip(wanted, grads):
            if g is not None:
                v.grad = g if v.grad is None else v.grad + g
    root.grad = seed_ct if root.grad is None else root.grad + seed_ct
    if not retain_graph:
        reset_tape()


class EagerBlock:
    """Adapter: a ``Block``-shaped object whose append_op executes eagerly,
    resolving variable names through the dygraph namespace.  This is what
    lets name-based static-graph code (initializers, regularizers,
    clips, Optimizer._append_optimize_op) run unchanged in imperative
    mode."""

    def append_op(self, type, inputs=None, outputs=None, attrs=None,
                  **kwargs):
        in_vars = {
            slot: [lookup_var(n) for n in names]
            for slot, names in (inputs or {}).items()
        }
        out_targets = {}
        for slot, names in (outputs or {}).items():
            for pos, n in enumerate(names):
                tgt = _NS.get(n)
                if tgt is not None:
                    out_targets[(slot, pos)] = tgt
        out_vars = run_eager_op(type, in_vars, attrs,
                                out_targets=out_targets)
        # register any newly created outputs under their declared names
        for slot, names in (outputs or {}).items():
            vals = out_vars.get(slot, [])
            for n, v in zip(names, vals):
                if v.name != n:
                    v.name = n
                    register_var(v)
        return out_vars

    def create_var(self, name=None, **kwargs):
        return VarBase(None, name=name, dtype=kwargs.get("dtype", "float32"),
                       shape=kwargs.get("shape"))
