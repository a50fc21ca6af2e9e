"""Program IR: the user-facing graph the framework builds and executes.

Counterpart of paddle_tpu/core/program.py, copied close to verbatim so
that programs, variable names and op uids come out identical in both
packages (parity: the reference's ProgramDesc/BlockDesc/OpDesc/VarDesc,
framework/framework.proto:42,104,164,173, and their Python mirrors
python/paddle/fluid/framework.py).

What differs from the JAX package:
  * Shape inference runs each op's compute function on ``meta`` tensors
    (no data, no launch) where the JAX package uses ``jax.eval_shape``,
    with the same two fake extents (3 and 5) for dynamic (-1) dims, so
    -1 dims are rediscovered the same way.
  * The Executor interprets the op list eagerly (core/lowering.py); there
    is no jit.

``to_dict``/``from_dict`` write and read the JAX package's JSON program
desc, field for field, so a model file written by one package loads in
the other (io.save_inference_model).
"""
from __future__ import annotations

import copy
from collections import OrderedDict

import numpy as np

from . import unique_name
from .registry import REGISTRY, OpContext
from .types import canonical_dtype, runtime_dtype

GRAD_SUFFIX = "@GRAD"
EMPTY_VAR_NAME = ""  # placeholder for "no grad produced for this input"


class Variable:
    """A named tensor in a Block (parity: framework.py:802 Variable +
    framework/framework.proto:164 VarDesc)."""

    def __init__(
        self,
        block,
        name,
        shape=None,
        dtype="float32",
        persistable=False,
        stop_gradient=False,
        is_data=False,
    ):
        self.block = block
        self.name = name
        self.shape = _normalize_shape(shape)
        self.dtype = canonical_dtype(dtype) if dtype is not None else None
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.is_data = is_data
        #: an optimizer accumulator (moments, beta powers): what the
        #: Executor's optimizer_state_bytes gauge sums
        self.is_optimizer_state = False

    # -- convenience -------------------------------------------------------
    @property
    def ndim(self):
        return None if self.shape is None else len(self.shape)

    def grad_name(self):
        return self.name + GRAD_SUFFIX

    def astype(self, dtype):
        from .. import layers

        return layers.cast(self, dtype)

    def numpy(self):
        """This variable's current value in the global scope, on the
        host."""
        import torch

        from .scope import global_scope

        val = global_scope().find_var(self.name)
        if val is None:
            raise RuntimeError(f"Variable {self.name} has no value in scope")
        if torch.is_tensor(val):
            return val.detach().cpu().numpy()
        return np.asarray(val)

    def to_dict(self):
        return {
            "name": self.name,
            "shape": list(self.shape) if self.shape is not None else None,
            "dtype": self.dtype,
            "persistable": self.persistable,
            "stop_gradient": self.stop_gradient,
            "is_data": self.is_data,
            "is_parameter": isinstance(self, Parameter),
            "trainable": getattr(self, "trainable", False),
            "is_optimizer_state": self.is_optimizer_state,
        }

    def __repr__(self):
        return (
            f"Variable(name={self.name}, shape={self.shape}, "
            f"dtype={self.dtype}, persistable={self.persistable})"
        )


class Parameter(Variable):
    """A trainable persistable variable (parity: framework.py:4591)."""

    def __init__(self, block, name, shape, dtype="float32", trainable=True,
                 regularizer=None, **kw):
        super().__init__(
            block, name, shape=shape, dtype=dtype, persistable=True,
            stop_gradient=not trainable,
        )
        self.trainable = trainable
        self.regularizer = regularizer
        self.optimize_attr = kw.get("optimize_attr", {"learning_rate": 1.0})


class Operator:
    """One op in a block (parity: framework.py:1701 Operator +
    framework/framework.proto:42 OpDesc)."""

    def __init__(self, block, uid, type, inputs, outputs, attrs):
        self.block = block
        self.uid = uid  # program-unique id; grad ops reference fwd uid
        self.type = type
        # slot -> [var names]; normalized copies
        self.inputs = {k: list(v) for k, v in (inputs or {}).items() if v}
        self.outputs = {k: list(v) for k, v in (outputs or {}).items()}
        self.attrs = dict(attrs or {})

    def input_names(self):
        for names in self.inputs.values():
            yield from names

    def output_names(self):
        for names in self.outputs.values():
            for n in names:
                if n != EMPTY_VAR_NAME:
                    yield n

    def to_dict(self):
        return {
            "uid": self.uid,
            "type": self.type,
            "inputs": {k: list(v) for k, v in self.inputs.items()},
            "outputs": {k: list(v) for k, v in self.outputs.items()},
            "attrs": _jsonable_attrs(self.attrs),
        }

    def __repr__(self):
        ins = ", ".join(f"{k}={v}" for k, v in self.inputs.items())
        outs = ", ".join(f"{k}={v}" for k, v in self.outputs.items())
        return f"{{{self.type}: ({ins}) -> ({outs})}}"


class Block:
    """A basic block of the program (parity: framework.py:2153 Block)."""

    def __init__(self, program, idx, parent_idx=-1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars: OrderedDict[str, Variable] = OrderedDict()
        self.ops: list[Operator] = []

    # -- vars --------------------------------------------------------------
    def create_var(self, name=None, **kwargs):
        if name is None:
            name = unique_name.generate("tmp")
        if name in self.vars:
            return self.vars[name]
        var = Variable(self, name, **kwargs)
        self.vars[name] = var
        self.program._bump()
        return var

    def create_parameter(self, name, shape, dtype="float32", **kwargs):
        param = Parameter(self, name, shape, dtype, **kwargs)
        self.vars[name] = param
        self.program._bump()
        return param

    def var(self, name) -> Variable:
        v = self._find_var_recursive(name)
        if v is None:
            raise KeyError(f"Variable '{name}' not found in block {self.idx}")
        return v

    def has_var(self, name) -> bool:
        return self._find_var_recursive(name) is not None

    def _find_var_recursive(self, name):
        block = self
        while block is not None:
            if name in block.vars:
                return block.vars[name]
            block = (
                self.program.blocks[block.parent_idx]
                if block.parent_idx >= 0
                else None
            )
        return None

    def all_parameters(self):
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    # -- ops ---------------------------------------------------------------
    def append_op(self, type, inputs=None, outputs=None, attrs=None,
                  infer_shape=True):
        op = Operator(
            self, self.program._next_op_uid(), type, inputs, outputs, attrs
        )
        self.ops.append(op)
        self.program._bump()
        if infer_shape and REGISTRY.has(type):
            try:
                self._infer_op_shapes(op)
            except Exception:
                # Shape inference is best-effort at build time; lowering
                # reports real errors with full context.
                pass
        return op

    def prepend_op(self, type, inputs=None, outputs=None, attrs=None):
        op = Operator(
            self, self.program._next_op_uid(), type, inputs, outputs, attrs
        )
        self.ops.insert(0, op)
        self.program._bump()
        return op

    def _infer_op_shapes(self, op):
        """Generic shape/dtype inference by double evaluation on meta
        tensors.

        Dynamic (-1) dims are substituted with two distinct fake extents;
        output dims that differ between the evaluations are marked -1.
        """
        import torch

        opdef = REGISTRY.get(op.type)
        results = []
        for fake in (3, 5):
            ins = {}
            for slot, names in op.inputs.items():
                vals = []
                for n in names:
                    v = self._find_var_recursive(n)
                    if v is None or v.shape is None or v.dtype is None:
                        return
                    shape = tuple(fake if d < 0 else d for d in v.shape)
                    vals.append(torch.empty(shape, device="meta",
                                            dtype=runtime_dtype(v.dtype)))
                ins[slot] = vals
            ctx = OpContext(rng=0 if opdef.needs_rng else None,
                            is_test=True, attrs=op.attrs,
                            device=torch.device("meta"))
            with torch.no_grad():
                results.append(opdef.compute(ctx, ins, op.attrs))

        r3, r5 = results
        for slot, names in op.outputs.items():
            outs3 = r3.get(slot, [])
            outs5 = r5.get(slot, [])
            for name, a3, a5 in zip(names, outs3, outs5):
                if name == EMPTY_VAR_NAME:
                    continue
                var = self._find_var_recursive(name)
                if var is None:
                    var = self.create_var(name=name)
                shape = tuple(
                    d3 if d3 == d5 else -1
                    for d3, d5 in zip(a3.shape, a5.shape)
                )
                var.shape = shape
                var.dtype = canonical_dtype(a3.dtype)

    def to_dict(self):
        return {
            "idx": self.idx,
            "parent_idx": self.parent_idx,
            "vars": [v.to_dict() for v in self.vars.values()],
            "ops": [op.to_dict() for op in self.ops],
        }

    def __repr__(self):
        lines = [f"Block {self.idx} ({len(self.vars)} vars, {len(self.ops)} ops)"]
        lines += [f"  {op!r}" for op in self.ops]
        return "\n".join(lines)


class Program:
    """A whole computation (parity: framework.py:3579 Program)."""

    def __init__(self):
        self.blocks = [Block(self, 0)]
        self.random_seed = 0
        self._op_uid = 0
        self._current_block_idx = 0
        self._exec_cache = {}

    # -- structure ---------------------------------------------------------
    def global_block(self) -> Block:
        return self.blocks[0]

    def current_block(self) -> Block:
        return self.blocks[self._current_block_idx]

    def create_block(self, parent_idx=None) -> Block:
        parent = self._current_block_idx if parent_idx is None else parent_idx
        blk = Block(self, len(self.blocks), parent)
        self.blocks.append(blk)
        self._current_block_idx = blk.idx
        self._bump()
        return blk

    def rollback(self):
        self._current_block_idx = self.current_block().parent_idx
        if self._current_block_idx < 0:
            self._current_block_idx = 0

    def all_parameters(self):
        params = []
        for blk in self.blocks:
            params.extend(blk.all_parameters())
        return params

    def list_vars(self):
        for blk in self.blocks:
            yield from blk.vars.values()

    def _bump(self):
        """Any mutation drops the Executor's lowered blocks."""
        self._exec_cache.clear()

    def _next_op_uid(self):
        self._op_uid += 1
        return self._op_uid

    # -- cloning / pruning -------------------------------------------------
    def clone(self, for_test=False):
        """Deep-copy the program with its own lowering cache.  With
        ``for_test=True`` every op runs with is_test semantics (dropout
        off, in the unfused ops and inside every fused group) — parity
        with Program.clone(for_test=True) (framework.py:3706)."""
        p = Program.__new__(Program)
        p.blocks = []
        p.random_seed = self.random_seed
        p._op_uid = self._op_uid
        p._current_block_idx = 0
        p._exec_cache = {}
        p._is_test = for_test or self.is_test
        for blk in self.blocks:
            nb = Block(p, blk.idx, blk.parent_idx)
            for v in blk.vars.values():
                nv = copy.copy(v)
                nv.block = nb
                nb.vars[nv.name] = nv
            for op in blk.ops:
                nb.ops.append(
                    Operator(nb, op.uid, op.type, op.inputs, op.outputs,
                             copy.deepcopy(op.attrs))
                )
            p.blocks.append(nb)
        return p

    @property
    def is_test(self):
        return getattr(self, "_is_test", False)

    def prune(self, targets):
        """Keep only the ops needed to compute ``targets`` (parity:
        framework.py Program._prune / pybind.cc:1127)."""
        target_names = {
            t.name if isinstance(t, Variable) else t for t in targets
        }
        blk = self.global_block()
        needed = set(target_names)
        kept_uids = set()
        for op in reversed(blk.ops):
            if any(n in needed for n in op.output_names()):
                kept_uids.add(op.uid)
                needed.update(op.input_names())
        p = self.clone()
        nb = p.global_block()
        nb.ops = [op for op in nb.ops if op.uid in kept_uids]
        keep_vars = set()
        for op in nb.ops:
            keep_vars.update(op.input_names())
            keep_vars.update(op.output_names())
        keep_vars |= target_names
        nb.vars = OrderedDict(
            (k, v) for k, v in nb.vars.items() if k in keep_vars
        )
        p._bump()
        return p

    # -- serialization -----------------------------------------------------
    def to_dict(self):
        return {
            "version": 1,
            "random_seed": self.random_seed,
            "blocks": [b.to_dict() for b in self.blocks],
        }

    @staticmethod
    def from_dict(d) -> "Program":
        p = Program()
        p.random_seed = d.get("random_seed", 0)
        p.blocks = []
        for bd in d["blocks"]:
            blk = Block(p, bd["idx"], bd["parent_idx"])
            for vd in bd["vars"]:
                if vd.get("is_parameter"):
                    v = Parameter(
                        blk, vd["name"], vd["shape"], vd["dtype"],
                        trainable=vd.get("trainable", True),
                    )
                else:
                    v = Variable(
                        blk, vd["name"], vd["shape"], vd["dtype"],
                        persistable=vd["persistable"],
                        stop_gradient=vd["stop_gradient"],
                        is_data=vd.get("is_data", False),
                    )
                v.is_optimizer_state = vd.get("is_optimizer_state", False)
                blk.vars[v.name] = v
            for od in bd["ops"]:
                op = Operator(blk, od["uid"], od["type"], od["inputs"],
                              od["outputs"], od["attrs"])
                blk.ops.append(op)
                p._op_uid = max(p._op_uid, op.uid)
            p.blocks.append(blk)
        if not p.blocks:
            p.blocks = [Block(p, 0)]
        return p

    def __repr__(self):
        return "\n".join(repr(b) for b in self.blocks)


# -- default program machinery (parity: framework.py:4839,4925) ------------

_main_program = Program()
_startup_program = Program()


def default_main_program() -> Program:
    return _main_program


def default_startup_program() -> Program:
    return _startup_program


def switch_main_program(program: Program) -> Program:
    global _main_program
    old, _main_program = _main_program, program
    return old


def switch_startup_program(program: Program) -> Program:
    global _startup_program
    old, _startup_program = _startup_program, program
    return old


class program_guard:
    """``with program_guard(main, startup):`` — scope the default programs."""

    def __init__(self, main_program, startup_program=None):
        self.main = main_program
        self.startup = startup_program

    def __enter__(self):
        self.old_main = switch_main_program(self.main)
        if self.startup is not None:
            self.old_startup = switch_startup_program(self.startup)
        return self

    def __exit__(self, *exc):
        switch_main_program(self.old_main)
        if self.startup is not None:
            switch_startup_program(self.old_startup)
        return False


def data(name, shape, dtype="float32", stop_gradient=True):
    """Declare a feed variable (parity: fluid/input.py fluid.data /
    layers.data).  `None` dims become -1 (dynamic)."""
    blk = default_main_program().global_block()
    return blk.create_var(
        name=name,
        shape=shape,
        dtype=dtype,
        stop_gradient=stop_gradient,
        is_data=True,
    )


# -- helpers ---------------------------------------------------------------

def _normalize_shape(shape):
    if shape is None:
        return None
    return tuple(-1 if d is None else int(d) for d in shape)


def _jsonable_attrs(attrs):
    clean = {}
    for k, v in attrs.items():
        if isinstance(v, np.ndarray):
            clean[k] = v.tolist()
        elif isinstance(v, (np.integer,)):
            clean[k] = int(v)
        elif isinstance(v, (np.floating,)):
            clean[k] = float(v)
        elif isinstance(v, tuple):
            clean[k] = list(v)
        else:
            clean[k] = v
    return clean

