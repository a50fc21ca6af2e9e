"""Autodiff: append_backward over the Program IR.

Counterpart of paddle_tpu/core/backward.py, copied close to verbatim so
that both packages append the same grad ops under the same names (parity:
python/paddle/fluid/backward.py:1133 append_backward, gradient
aggregation by sum-op insertion, backward.py:961).  It is pure IR: every
forward op on the loss's path gets the same generic ``vjp_grad`` op keyed
by the forward op's uid; core/lowering.py runs it with autograd.  A
``lookup_table`` with ``is_sparse=True`` whose table has no other use on
the loss's path gets a SelectedRows gradient instead: a
``lookup_table_sparse_grad`` op writing (Values, Rows) — the ``@GRAD``
variable and its ``@ROWS`` twin, named in ``gvar.sparse_rows``.
"""
from __future__ import annotations

from . import unique_name
from .lowering import VJP_GRAD_OP
from .program import EMPTY_VAR_NAME, GRAD_SUFFIX, Parameter, Variable
from .types import is_floating


def append_backward(loss: Variable, parameter_list=None, no_grad_set=None):
    """Append gradient ops for `loss` to its program's global block.

    Returns [(param, grad_var), ...] for every trainable parameter reached
    by the backward pass — the input to Optimizer.apply_gradients.
    """
    block = loss.block.program.global_block()
    program = block.program
    no_grad = set(no_grad_set or ())

    fwd_ops = list(block.ops)

    # -- 1. which vars require grad (forward propagation) ------------------
    if parameter_list is not None:
        seed_params = {
            p.name if isinstance(p, Variable) else p for p in parameter_list
        }
    else:
        seed_params = {
            p.name for p in block.all_parameters() if p.trainable
        }
    produced = set()
    for op in fwd_ops:
        produced.update(op.output_names())

    requires: set[str] = set()
    for name, var in block.vars.items():
        if name in produced or name in no_grad:
            continue
        if isinstance(var, Parameter):
            if var.trainable and name in seed_params:
                requires.add(name)
        elif not var.stop_gradient:
            requires.add(name)

    for op in fwd_ops:
        if any(n in requires for n in op.input_names()):
            for n in op.output_names():
                var = block._find_var_recursive(n)
                if n in no_grad or (var is not None and var.stop_gradient
                                    and not isinstance(var, Parameter)):
                    continue
                requires.add(n)

    # -- 2. which ops influence the loss (backward reachability) -----------
    influence = {loss.name}
    relevant = [False] * len(fwd_ops)
    for i in reversed(range(len(fwd_ops))):
        op = fwd_ops[i]
        if any(n in influence for n in op.output_names()):
            if any(n in requires for n in op.input_names()):
                relevant[i] = True
                influence.update(op.input_names())

    # -- 3. seed: d loss / d loss = 1 --------------------------------------
    loss_grad_name = loss.name + GRAD_SUFFIX
    block.create_var(
        name=loss_grad_name, shape=loss.shape, dtype=loss.dtype,
        stop_gradient=True,
    )
    block.append_op(
        type="fill_constant",
        inputs={},
        outputs={"Out": [loss_grad_name]},
        attrs={
            "shape": list(loss.shape or ()),
            "value": 1.0,
            "dtype": loss.dtype,
        },
        infer_shape=False,
    )

    # pending[name] -> list of grad-term var names awaiting aggregation
    pending: dict[str, list[str]] = {loss.name: [loss_grad_name]}
    finalized: dict[str, str] = {loss.name: loss_grad_name}

    def _grad_var_for(name: str) -> Variable:
        src = block._find_var_recursive(name)
        gname = name + GRAD_SUFFIX
        if not block.has_var(gname):
            block.create_var(
                name=gname,
                shape=src.shape if src is not None else None,
                dtype=src.dtype if src is not None else "float32",
                stop_gradient=True,
            )
        return block.var(gname)

    def _finalize(name: str) -> str:
        """Aggregate pending grad terms of `name` into its canonical @GRAD
        var (sum-op insertion, parity backward.py:961)."""
        if name in finalized:
            return finalized[name]
        terms = pending.get(name, [])
        if not terms:
            return EMPTY_VAR_NAME
        gvar = _grad_var_for(name)
        if len(terms) == 1 and terms[0] == gvar.name:
            finalized[name] = gvar.name
            return gvar.name
        block.append_op(
            type="sum" if len(terms) > 1 else "assign",
            inputs={"X": terms},
            outputs={"Out": [gvar.name]},
            attrs={},
            infer_shape=False,
        )
        finalized[name] = gvar.name
        return gvar.name

    # Vars whose grad accumulation was restarted for a pre-op version (an
    # op that both reads and writes the name, e.g. While carried state):
    # their new terms must be renamed so they don't collide with the
    # already-consumed post-op @GRAD var.
    reopened: set[str] = set()

    def _new_term(name: str) -> str:
        """A fresh grad-term name for one contribution to d(name)."""
        terms = pending.setdefault(name, [])
        if not terms and name not in finalized and name not in reopened:
            gname = name + GRAD_SUFFIX
            _grad_var_for(name)
            terms.append(gname)
            return gname
        t = unique_name.generate(name + GRAD_SUFFIX + "@RENAME")
        src = block._find_var_recursive(name)
        block.create_var(
            name=t,
            shape=src.shape if src is not None else None,
            dtype=src.dtype if src is not None else "float32",
            stop_gradient=True,
        )
        # First contribution was already canonically named; keep both as terms.
        if name in finalized:
            raise RuntimeError(
                f"grad of {name} contributed after finalization "
                f"(op ordering bug in append_backward)"
            )
        terms.append(t)
        return t

    # Sparse embedding grads (SelectedRows parity): a lookup_table with
    # is_sparse=True whose table is consumed by NO other grad-relevant op
    # gets a (Rows, Values) gradient instead of a dense [vocab, dim]
    # scatter — see ops/tensor.py lookup_table_sparse_grad.  Multi-use
    # tables fall back to dense (the aggregation sum needs dense terms).
    sparse_uids = set()
    for i, op in enumerate(fwd_ops):
        if (op.type == "lookup_table" and op.attrs.get("is_sparse")
                and op.inputs["W"][0] in requires):
            w = op.inputs["W"][0]
            uses = sum(
                1 for j, o in enumerate(fwd_ops)
                if relevant[j] and w in o.input_names())
            if uses == 1:
                sparse_uids.add(op.uid)

    # -- 4. emit vjp_grad ops in reverse topological order -----------------
    for i in reversed(range(len(fwd_ops))):
        if not relevant[i]:
            continue
        op = fwd_ops[i]
        if op.uid in sparse_uids:
            og = _finalize(op.outputs["Out"][0])
            if og == EMPTY_VAR_NAME:
                continue
            w_name = op.inputs["W"][0]
            g_term = _new_term(w_name)
            rows_name = g_term + "@ROWS"
            w_var = block.var(w_name)
            gvar = block.var(g_term)
            gvar.shape = [None, w_var.shape[1]]
            block.create_var(name=rows_name, shape=[None], dtype="int64",
                             stop_gradient=True)
            block.append_op(
                type="lookup_table_sparse_grad",
                inputs={"Ids": list(op.inputs["Ids"]), "OutGrad": [og]},
                outputs={"Values": [g_term], "Rows": [rows_name]},
                attrs={"padding_idx": op.attrs.get("padding_idx", -1)},
                infer_shape=False,
            )
            gvar.sparse_rows = rows_name
            continue
        if op.type == "while" and op.attrs.get("max_iters") is None:
            # the JAX package's lax.while_loop has no reverse-mode, and the
            # port keeps its contract; the reference builds while_grad
            # (operators/controlflow/while_op.cc).  A trip bound —
            # While(cond, max_iters=N) — makes the loop differentiable.
            raise NotImplementedError(
                "Cannot differentiate through an unbounded While loop: "
                "it is forward only, as in the JAX package. Pass "
                "While(cond, max_iters=N) for a bounded loop with exact "
                "reverse-mode, or use layers.StaticRNN for trainable "
                "recurrence.")
        og_inputs = {}
        any_ct = False
        for slot, names in op.outputs.items():
            og = []
            for n in names:
                g = _finalize(n) if n != EMPTY_VAR_NAME else EMPTY_VAR_NAME
                if g != EMPTY_VAR_NAME:
                    any_ct = True
                og.append(g)
            og_inputs["OG@" + slot] = og
        if not any_ct:
            continue

        # In-place ops (While/assign-style carried state) read and write
        # the same var name.  The grad flowing to the INPUT side belongs to
        # the pre-op version: restart its accumulation (renamed terms) now
        # that the post-op grad has been consumed as OG above.
        dual = set(op.output_names()) & set(op.input_names())
        for n in dual:
            if n in finalized:
                del finalized[n]
                pending.pop(n, None)
                reopened.add(n)

        ig_outputs = {}
        for slot, names in op.inputs.items():
            ig = []
            for n in names:
                var = block._find_var_recursive(n)
                if (
                    n in requires
                    and var is not None
                    and var.dtype is not None
                    and is_floating(var.dtype)
                ):
                    ig.append(_new_term(n))
                else:
                    ig.append(EMPTY_VAR_NAME)
            ig_outputs["IG@" + slot] = ig

        # Also pass the forward op's real inputs so the lowerer could rebuild
        # the vjp if residuals are unavailable (kept in desc for fidelity).
        block.append_op(
            type=VJP_GRAD_OP,
            inputs=og_inputs,
            outputs=ig_outputs,
            attrs={"fwd_uid": op.uid, "fwd_type": op.type},
            infer_shape=False,
        )

    # -- 5. finalize all remaining grads (leaf vars: params and data) ------
    for name in list(pending):
        _finalize(name)
    params_and_grads = []
    for p in block.all_parameters():
        if p.name not in seed_params or not p.trainable:
            continue
        g = _finalize(p.name)
        if g == EMPTY_VAR_NAME:
            continue
        gvar = block.var(g)
        params_and_grads.append((p, gvar))
    return params_and_grads


def gradients(targets, inputs, target_gradients=None, no_grad_set=None):
    """Compute d(targets)/d(inputs) (parity: fluid.gradients).

    Implemented via append_backward on the first target; returns grad
    vars aligned with `inputs` (None where unreachable)."""
    targets = targets if isinstance(targets, (list, tuple)) else [targets]
    inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    loss = targets[0]
    block = loss.block.program.global_block()
    for v in inputs:
        if v.stop_gradient:
            v.stop_gradient = False
    append_backward(loss, no_grad_set=no_grad_set,
                    parameter_list=[
                        p.name for p in block.all_parameters() if p.trainable
                    ] or None)
    outs = []
    for v in inputs:
        gname = v.name + GRAD_SUFFIX
        outs.append(block.var(gname) if block.has_var(gname) else None)
    return outs
