"""Control-flow layers: While, cond, Switch, StaticRNN, and the
comparisons and ``increment`` that drive them.

Counterpart of paddle_tpu/layers/control_flow.py, copied close to
verbatim so that both packages build the same sub-blocks and block ops
under the same names, slots and attrs (parity: python/paddle/fluid/
layers/control_flow.py and the reference's while_op.cc,
conditional_block_op.cc, recurrent_op.cc).  Each construct builds a
sub-block in the Program and one block op in the parent block;
core/lowering.py runs the sub-block eagerly — a Python loop for
``while`` and ``static_rnn``, a branch for ``conditional_block``, every
case then ``torch.where`` for ``switch``.  StaticRNN and a bounded
``While(cond, max_iters=N)`` are reverse-differentiable (the whole op
under autograd); an unbounded While is forward only, as in the JAX
package.
"""
from __future__ import annotations

import numpy as np

from ..core import unique_name
from ..core.program import default_main_program
from .helper import LayerHelper

__all__ = [
    "While", "Switch", "cond", "StaticRNN", "increment", "less_than",
    "less_equal", "greater_than", "greater_equal", "equal", "not_equal",
]


def _block_io(program, blk):
    """(external_reads, external_writes) of a sub-block: names resolving to
    vars of ancestor blocks that the sub-block consumes / assigns."""
    produced = set()
    reads, writes = [], []
    for op in blk.ops:
        for n in op.input_names():
            if not n or n in produced or n in reads:
                continue
            if n not in blk.vars and blk._find_var_recursive(n) is not None:
                reads.append(n)
        for n in op.output_names():
            produced.add(n)
            if n not in blk.vars and blk._find_var_recursive(n) is not None:
                if n not in writes:
                    writes.append(n)
    return reads, writes


class While:
    """``while cond:`` over a sub-block.

    Usage (reference-identical contract)::

        i = layers.fill_constant(shape=[1], dtype='int64', value=0)
        n = layers.fill_constant(shape=[1], dtype='int64', value=10)
        c = layers.less_than(i, n)
        w = layers.While(c)
        with w.block():
            ...                       # update loop vars via layers.assign
            layers.increment(i, in_place=True)
            layers.less_than(i, n, cond=c)   # refresh the condition

    ``max_iters``: optional static trip bound.  The bounded form runs at
    most ``max_iters`` trips (in forward-only and differentiated programs
    alike, so both compute identical values) and is what makes the loop
    reverse-differentiable: the unbounded form is forward only, as the
    JAX package's ``lax.while_loop``.  The bound is a hard contract: if
    the condition is still true after ``max_iters`` trips, the loop is
    TRUNCATED at ``max_iters`` — a documented semantics, not an error.
    """

    def __init__(self, cond, is_test=False, name=None, max_iters=None):
        if cond.dtype is not None and str(cond.dtype) != "bool":
            raise TypeError(
                f"While condition must be a bool tensor, got dtype "
                f"{cond.dtype} for '{cond.name}'")
        if cond.shape is not None and int(np.prod(cond.shape)) > 1:
            raise ValueError(
                f"While condition must be a scalar (shape (1,) or ()), "
                f"got shape {tuple(cond.shape)} for '{cond.name}'")
        self.cond_var = cond
        self.program = default_main_program()
        self.is_test = is_test
        # Optional trip bound: enables reverse-mode autodiff (while_grad
        # parity, while_op.cc).
        if max_iters is not None:
            if int(max_iters) != max_iters or int(max_iters) < 1:
                raise ValueError(
                    f"While max_iters must be a positive integer, got "
                    f"{max_iters!r}")
            max_iters = int(max_iters)
        self.max_iters = max_iters

    def block(self):
        return _WhileGuard(self)

    def _complete(self, sub_block):
        program = self.program
        reads, writes = _block_io(program, sub_block)
        x = list(dict.fromkeys(reads + writes))
        if self.cond_var.name not in writes:
            writes = writes + [self.cond_var.name]
        parent = program.blocks[sub_block.parent_idx]
        parent.append_op(
            type="while",
            inputs={"X": x, "Condition": [self.cond_var.name]},
            outputs={"Out": list(writes)},
            attrs={"sub_block": sub_block.idx, "is_test": self.is_test,
                   **({"max_iters": self.max_iters}
                      if self.max_iters is not None else {})},
            infer_shape=False,
        )


class _WhileGuard:
    def __init__(self, while_op):
        self.while_op = while_op

    def __enter__(self):
        self.sub_block = self.while_op.program.create_block()
        return self

    def __exit__(self, exc_type, *a):
        self.while_op.program.rollback()
        if exc_type is None:
            self.while_op._complete(self.sub_block)
        return False


def cond(pred, true_fn=None, false_fn=None, name=None):
    """Functional two-branch conditional (parity: layers.cond /
    conditional_block_op.cc).  Both branches must return the same structure
    of Variables; only the branch the predicate picks runs."""
    program = default_main_program()

    def trace(fn):
        blk = program.create_block()
        try:
            out = fn() if fn is not None else None
        finally:
            program.rollback()
        if out is None:
            outs = []
        elif isinstance(out, (list, tuple)):
            outs = list(out)
        else:
            outs = [out]
        return blk, outs

    true_blk, true_outs = trace(true_fn)
    false_blk, false_outs = trace(false_fn)
    if len(true_outs) != len(false_outs):
        raise ValueError(
            f"cond branches must return the same number of outputs "
            f"({len(true_outs)} vs {len(false_outs)})"
        )

    reads_t, writes_t = _block_io(program, true_blk)
    reads_f, writes_f = _block_io(program, false_blk)
    # Outer vars written inside a branch (layers.assign(..., output=s)
    # idiom) must propagate: the reference's conditional_block runs over
    # the shared scope (conditional_block_op.cc), so add each written
    # outer var as an extra op output selected between branch value and
    # passthrough.
    writes = list(dict.fromkeys(writes_t + writes_f))
    x = list(dict.fromkeys(reads_t + reads_f + writes))

    parent = program.current_block()
    out_vars = []
    for tv in true_outs:
        ov = parent.create_var(
            name=unique_name.generate("cond.out"),
            shape=tv.shape, dtype=tv.dtype,
        )
        out_vars.append(ov)
    parent.append_op(
        type="conditional_block",
        inputs={"Cond": [pred.name], "X": x},
        outputs={"Out": [v.name for v in out_vars] + writes},
        attrs={
            "true_block": true_blk.idx,
            "false_block": false_blk.idx,
            "true_out_names": [v.name for v in true_outs] + writes,
            "false_out_names": [v.name for v in false_outs] + writes,
        },
        infer_shape=False,
    )
    if not out_vars:
        return None
    return out_vars[0] if len(out_vars) == 1 else out_vars


class Switch:
    """Multi-case scalar switch (parity: layers.Switch — the construct the
    reference's piecewise LR schedules are built on).  Case bodies write
    outer vars with layers.assign; first true case wins.

    Lowered by running every (tiny, scalar) case branch and selecting with
    nested ``torch.where`` — branchless, as in the JAX package.
    """

    def __init__(self, name=None):
        self.program = default_main_program()
        self.case_conds = []
        self.case_blocks = []
        self.default_block = None
        self._inside = False

    def __enter__(self):
        self._inside = True
        return self

    def __exit__(self, exc_type, *a):
        self._inside = False
        if exc_type is None:
            self._complete()
        return False

    def case(self, condition):
        return _SwitchCaseGuard(self, condition)

    def default(self):
        return _SwitchCaseGuard(self, None)

    def _complete(self):
        program = self.program
        all_blocks = self.case_blocks + (
            [self.default_block] if self.default_block is not None else []
        )
        reads, writes = [], []
        for blk in all_blocks:
            r, w = _block_io(program, blk)
            reads += [n for n in r if n not in reads]
            writes += [n for n in w if n not in writes]
        parent = program.current_block()
        parent.append_op(
            type="switch",
            inputs={
                "Conds": [c.name for c in self.case_conds],
                "X": [n for n in reads if n not in writes] + writes,
            },
            outputs={"Out": list(writes)},
            attrs={
                "case_blocks": [b.idx for b in self.case_blocks],
                "default_block": (
                    self.default_block.idx
                    if self.default_block is not None else None
                ),
            },
            infer_shape=False,
        )


class _SwitchCaseGuard:
    def __init__(self, switch, condition):
        self.switch = switch
        self.condition = condition

    def __enter__(self):
        self.blk = self.switch.program.create_block()
        return self

    def __exit__(self, exc_type, *a):
        self.switch.program.rollback()
        if exc_type is None:
            if self.condition is None:
                self.switch.default_block = self.blk
            else:
                self.switch.case_conds.append(self.condition)
                self.switch.case_blocks.append(self.blk)
        return False


class StaticRNN:
    """Static (fixed-length) RNN over a sub-block, lowered to a loop over
    the leading axis (parity: layers.StaticRNN / operators/recurrent_op.cc;
    the reference executes the sub-block T times through a nested
    Executor and hand-built recurrent_grad — here autograd differentiates
    the loop).

    Step inputs are time-major ``[T, batch, ...]``::

        rnn = layers.StaticRNN()
        with rnn.step():
            x_t = rnn.step_input(x)            # [T,B,D] -> [B,D]
            h_prev = rnn.memory(init=h0)       # carried state
            h = layers.fc(layers.concat([x_t, h_prev], 1), size=H)
            rnn.update_memory(h_prev, h)
            rnn.step_output(h)
        out = rnn()                            # [T,B,H]
    """

    def __init__(self, name=None):
        self.helper = LayerHelper("static_rnn", name=name)
        self.program = default_main_program()
        self.sub_block = None
        self._x = []          # (outer_name, local_var)
        self._mems = []       # (local_var, init_name)
        self._mem_updates = {}  # local name -> update var name
        self._step_outs = []  # local vars
        self._outputs = []    # outer stacked vars
        self._last_mems = []  # outer final-memory vars
        self._seq_len_dim = None

    def step(self):
        return _RNNStepGuard(self)

    def step_input(self, x):
        if x.shape is None or len(x.shape) < 1:
            raise ValueError("StaticRNN step input needs a known rank")
        if self._seq_len_dim is None:
            self._seq_len_dim = x.shape[0]
        local = self.sub_block.create_var(
            name=unique_name.generate("rnn.step_in"),
            shape=tuple(x.shape[1:]), dtype=x.dtype,
        )
        self._x.append((x.name, local))
        return local

    def memory(self, init=None, shape=None, batch_ref=None, init_value=0.0,
               init_batch_dim_idx=0, ref_batch_dim_idx=0):
        if init is None:
            if shape is None or batch_ref is None:
                raise ValueError(
                    "StaticRNN.memory needs init= or (shape= and batch_ref=)"
                )
            # build the init in the PARENT block (fill batch-sized constant)
            parent = self.program.blocks[self.sub_block.parent_idx]
            init_var = parent.create_var(
                name=unique_name.generate("rnn.mem_init"),
                shape=tuple(shape), dtype=batch_ref.dtype,
            )
            parent.append_op(
                type="fill_constant_batch_size_like",
                inputs={"Input": [batch_ref.name]},
                outputs={"Out": [init_var.name]},
                attrs={
                    "shape": list(shape), "value": init_value,
                    "dtype": batch_ref.dtype,
                    "input_dim_idx": ref_batch_dim_idx,
                    "output_dim_idx": init_batch_dim_idx,
                },
                infer_shape=False,
            )
            init = init_var
        local = self.sub_block.create_var(
            name=unique_name.generate("rnn.mem"),
            shape=init.shape, dtype=init.dtype,
        )
        self._mems.append((local, init.name))
        return local

    def update_memory(self, mem, var):
        self._mem_updates[mem.name] = var.name

    def step_output(self, o):
        self._step_outs.append(o)

    def output(self, *outputs):
        for o in outputs:
            self.step_output(o)

    def _complete(self):
        program = self.program
        blk = self.sub_block
        for local, _ in self._mems:
            if local.name not in self._mem_updates:
                raise ValueError(
                    f"StaticRNN memory {local.name} never updated "
                    f"(call rnn.update_memory)"
                )
        reads, _ = _block_io(program, blk)
        local_names = {lv.name for _, lv in self._x}
        local_names |= {lv.name for lv, _ in self._mems}
        reads = [n for n in reads if n not in local_names]
        parent = program.blocks[blk.parent_idx]

        T = self._seq_len_dim if self._seq_len_dim is not None else -1
        for o in self._step_outs:
            ov = parent.create_var(
                name=unique_name.generate("rnn.out"),
                shape=(T,) + tuple(o.shape or ()), dtype=o.dtype,
            )
            self._outputs.append(ov)
        for local, _ in self._mems:
            lv = parent.create_var(
                name=unique_name.generate("rnn.last_mem"),
                shape=local.shape, dtype=local.dtype,
            )
            self._last_mems.append(lv)

        parent.append_op(
            type="static_rnn",
            inputs={
                "X": [n for n, _ in self._x],
                "Init": [init for _, init in self._mems],
                "P": reads,
            },
            outputs={
                "Out": [v.name for v in self._outputs],
                "LastMem": [v.name for v in self._last_mems],
            },
            attrs={
                "sub_block": blk.idx,
                "x_local_names": [lv.name for _, lv in self._x],
                "mem_local_names": [lv.name for lv, _ in self._mems],
                "mem_update_names": [
                    self._mem_updates[lv.name] for lv, _ in self._mems
                ],
                "step_out_names": [o.name for o in self._step_outs],
            },
            infer_shape=False,
        )

    def __call__(self):
        outs = self._outputs
        return outs[0] if len(outs) == 1 else outs

    def last_memories(self):
        return list(self._last_mems)


class _RNNStepGuard:
    def __init__(self, rnn):
        self.rnn = rnn

    def __enter__(self):
        self.rnn.sub_block = self.rnn.program.create_block()
        return self

    def __exit__(self, exc_type, *a):
        self.rnn.program.rollback()
        if exc_type is None:
            self.rnn._complete()
        return False


# -- small control-flow helpers --------------------------------------------

def increment(x, value=1.0, in_place=True):
    """x += value (parity: layers.increment / increment_op.cc)."""
    helper = LayerHelper("increment")
    out = x if in_place else helper.create_variable_for_type_inference(
        x.dtype)
    helper.append_op(
        type="increment",
        inputs={"X": [x.name]},
        outputs={"Out": [out.name]},
        attrs={"step": float(value)},
    )
    return out


def _compare(op_type):
    def layer(x, y, cond=None, name=None):
        helper = LayerHelper(op_type, name=name)
        x = helper.input(x)
        attrs = {}
        inputs = {"X": [x.name]}
        if isinstance(y, (int, float)):
            attrs["scalar_y"] = float(y)
        else:
            inputs["Y"] = [helper.input(y).name]
        if cond is None:
            cond = helper.create_variable_for_type_inference("bool")
            cond.stop_gradient = True
        helper.append_op(
            type=op_type,
            inputs=inputs,
            outputs={"Out": [cond.name]},
            attrs=attrs,
        )
        return cond

    layer.__name__ = op_type
    layer.__doc__ = (
        f"Elementwise {op_type} producing a bool tensor; `cond=` writes "
        f"into an existing var (the While-loop condition refresh idiom)."
    )
    return layer


less_than = _compare("less_than")
less_equal = _compare("less_equal")
greater_than = _compare("greater_than")
greater_equal = _compare("greater_equal")
equal = _compare("equal")
not_equal = _compare("not_equal")
