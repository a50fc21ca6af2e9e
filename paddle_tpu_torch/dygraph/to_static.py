"""dygraph_to_static: AST transpiler for data-dependent control flow.

Parity: python/paddle/fluid/dygraph/dygraph_to_static/ (ProgramTranslator,
IfElseTransformer, LoopTransformer) — the reference rewrites a
``@declarative`` function's AST so Python ``if``/``while``/``for range``
over *tensors* become conditional_block / while ops in the built
program, while plain-Python control flow keeps its eager semantics.

Counterpart of paddle_tpu/dygraph/to_static.py: the transformer is pure
Python and comes across as a copy over the port's ``layers`` and
``layers/control_flow.py``.  The rewritten AST routes control flow
through ``convert_ifelse`` / ``convert_while``, which check at RUNTIME
whether the predicate is a graph ``Variable``:

* plain Python value → ordinary Python branch/loop (zero overhead),
* ``Variable`` → build ``layers.cond`` or a ``layers.While`` sub-block,
  which core/lowering.py runs as a branch or a Python loop reading its
  condition on the host (``max_iters`` bounds the loop and makes it
  reverse-differentiable: the whole op runs under autograd).

So one function body serves both eager dygraph calls (concrete values —
Python control flow just runs) and static program building (abstract
Variables — ops are emitted), the reference's ProgramTranslator
contract.

Supported rewrites: ``if`` / ``if-else`` on tensor predicates (branches
may assign; early ``return``/``break``/``continue`` inside a tensor-``if``
are NOT supported and those statements fall back untransformed),
``while`` on tensor predicates, and ``for i in range(...)`` with tensor
bounds (desugared to ``while``; the loop test goes through
``convert_range_continues`` so negative steps iterate correctly; tensor
steps are rejected because the comparison direction depends on the sign).

Known semantic deviation: a name assigned only inside one branch of an
``if`` is pre-bound to ``None`` before the statement (the lowered cond
needs both branches to produce every output).  On the plain-Python path
this means such a name is bound to ``None`` after the statement where
the undecorated function would leave it unbound — a later
``if x is None`` or NameError-based probe observes different behaviour.
"""
from __future__ import annotations

import ast
import functools
import inspect
import textwrap

from ..core.program import Variable

__all__ = ["to_static", "declarative", "convert_ifelse", "convert_while",
           "unwrap"]

_CONVERT_IF = "__dy2st_convert_ifelse"
_CONVERT_WHILE = "__dy2st_convert_while"
_CONVERT_RANGE = "__dy2st_convert_range"
_MAX_ITERS = "__dy2st_max_iters"


# --------------------------------------------------------------------------
# runtime converters
# --------------------------------------------------------------------------


def _as_bool_pred(pred):
    from .. import layers

    if pred.dtype is not None and str(pred.dtype) != "bool":
        pred = layers.cast(pred, "bool")
    return pred


def convert_ifelse(pred, true_fn, false_fn, vals):
    """Branch on `pred`: Python branch for plain values, layers.cond for
    Variables.  Both fns take the branch-assigned locals as parameters
    (they'd otherwise be unbound locals of the generated closures) and
    return the same tuple of them."""
    if isinstance(pred, Variable):
        from .. import layers

        if any(v is None for v in vals):
            raise ValueError(
                "a variable assigned inside a tensor `if` must be "
                "initialized before the `if` (both branches of the "
                "lowered cond must produce it)")
        out = layers.cond(_as_bool_pred(pred), lambda: true_fn(*vals),
                          lambda: false_fn(*vals))
        if out is None:
            return ()
        return tuple(out) if isinstance(out, (list, tuple)) else (out,)
    return true_fn(*vals) if pred else false_fn(*vals)


def convert_range_continues(i, limit, step):
    """Loop-continue test for the range()→while desugaring, honouring the
    step sign.  A tensor step's sign isn't knowable at build time."""
    if isinstance(step, Variable):
        raise NotImplementedError(
            "to_static: `range` with a tensor step is not supported "
            "(the comparison direction depends on the step's sign)")
    if step == 0:
        raise ValueError("range() arg 3 must not be zero")
    return i < limit if step > 0 else i > limit


def convert_while(cond_fn, body_fn, loop_vars, max_iters=None):
    """Loop: Python while for plain predicates, a While sub-block when
    the predicate is a Variable.  loop_vars is the tuple of carried
    locals; body_fn returns the updated tuple."""
    pred = cond_fn(*loop_vars)
    if not isinstance(pred, Variable):
        while pred:
            loop_vars = body_fn(*loop_vars)
            pred = cond_fn(*loop_vars)
        return loop_vars

    import numpy as np

    from .. import layers

    # promote plain-Python loop carries (e.g. the desugared range index
    # starting at literal 0) to graph tensors, and COPY Variable carries
    # into fresh vars — the sub-block assigns back into its carries, and
    # writing into a feed/parameter var in place would corrupt it (and
    # its gradient path)
    def promote(v):
        if isinstance(v, Variable):
            return layers.assign(v)
        if v is None:
            raise ValueError(
                "a loop variable of a tensor `while`/`for` must be "
                "initialized before the loop (body-local temporaries "
                "cannot be carried through the lowered While)")
        arr = np.asarray(v)
        if arr.dtype == np.float64:
            arr = arr.astype(np.float32)
        elif arr.dtype not in (np.float32, np.int32, np.int64, np.bool_):
            arr = arr.astype(np.int64)
        return layers.assign(arr.reshape([1]) if arr.ndim == 0 else arr)

    loop_vars = tuple(promote(v) for v in loop_vars)
    cond_var = layers.assign(_as_bool_pred(cond_fn(*loop_vars)))
    w = layers.While(cond_var, max_iters=max_iters)
    with w.block():
        new_vars = body_fn(*loop_vars)
        if len(new_vars) != len(loop_vars):
            raise ValueError("while body must return the same number of "
                             "loop vars")
        for old, new in zip(loop_vars, new_vars):
            if new is not old:
                layers.assign(new, output=old)
        layers.assign(_as_bool_pred(cond_fn(*loop_vars)),
                      output=cond_var)
    return loop_vars


# --------------------------------------------------------------------------
# AST analysis helpers
# --------------------------------------------------------------------------


class _NameCollector(ast.NodeVisitor):
    def __init__(self):
        self.stores = []
        self.loads = []

    def visit_Name(self, node):
        if isinstance(node.ctx, ast.Store):
            if node.id not in self.stores:
                self.stores.append(node.id)
        elif isinstance(node.ctx, ast.Load):
            if node.id not in self.loads:
                self.loads.append(node.id)

    def visit_FunctionDef(self, node):
        pass  # nested defs have their own scope

    visit_AsyncFunctionDef = visit_FunctionDef
    visit_Lambda = visit_FunctionDef


def _names(nodes):
    c = _NameCollector()
    for n in nodes if isinstance(nodes, (list, tuple)) else [nodes]:
        c.visit(n)
    return c.stores, c.loads


def _contains_escape(nodes):
    """True if the statements contain return/break/continue at THIS loop/
    branch level.  Must NOT descend into nested function definitions —
    previously-transformed inner control flow leaves __dy2st_* closures
    (with their own returns) in the body, and walking into them would
    make every outer loop bail out to the Python path."""

    def check(node):
        if isinstance(node, (ast.Return, ast.Break, ast.Continue)):
            return True
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            return False
        return any(check(c) for c in ast.iter_child_nodes(node))

    return any(check(n) for n in nodes)


def _load(name):
    return ast.Name(id=name, ctx=ast.Load())


def _store(name):
    return ast.Name(id=name, ctx=ast.Store())


# --------------------------------------------------------------------------
# the transformer
# --------------------------------------------------------------------------


class _ControlFlowTransformer(ast.NodeTransformer):
    def __init__(self):
        self.counter = 0

    def _fresh(self, base):
        self.counter += 1
        return f"__dy2st_{base}{self.counter}"

    # -- if ---------------------------------------------------------------
    def visit_If(self, node):
        self.generic_visit(node)
        if _contains_escape(node.body) or _contains_escape(node.orelse):
            return node  # unsupported in a tensor branch; leave as-is
        stores_t, _ = _names(node.body)
        stores_f, _ = _names(node.orelse)
        assigned = list(dict.fromkeys(stores_t + stores_f))

        true_name = self._fresh("true_fn")
        false_name = self._fresh("false_fn")
        ret = ast.Return(value=ast.Tuple(
            elts=[_load(n) for n in assigned], ctx=ast.Load()))
        true_def = ast.FunctionDef(
            name=true_name, args=_arg_list(assigned),
            body=(list(node.body) or [ast.Pass()]) + [ret],
            decorator_list=[])
        false_def = ast.FunctionDef(
            name=false_name, args=_arg_list(assigned),
            body=(list(node.orelse) or [ast.Pass()]) + [ret],
            decorator_list=[])
        call = ast.Call(func=_load(_CONVERT_IF),
                        args=[node.test, _load(true_name),
                              _load(false_name),
                              ast.Tuple(elts=[_load(n) for n in assigned],
                                        ctx=ast.Load())], keywords=[])
        if assigned:
            out = ast.Assign(
                targets=[ast.Tuple(elts=[_store(n) for n in assigned],
                                   ctx=ast.Store())],
                value=call)
        else:
            out = ast.Expr(value=call)
        return _bind_unbound(assigned) + [true_def, false_def, out]

    # -- while ------------------------------------------------------------
    def visit_While(self, node):
        self.generic_visit(node)
        if node.orelse or _contains_escape(node.body):
            return node
        stores, _ = _names(node.body)
        _, test_loads = _names(node.test)
        loop_vars = list(dict.fromkeys(
            [n for n in test_loads if n in stores] + stores))
        if not loop_vars:
            return node  # nothing carried; leave the Python loop alone

        cond_name = self._fresh("cond_fn")
        body_name = self._fresh("body_fn")
        args = _arg_list(loop_vars)
        cond_def = ast.FunctionDef(
            name=cond_name, args=args,
            body=[ast.Return(value=node.test)], decorator_list=[])
        body_def = ast.FunctionDef(
            name=body_name, args=_arg_list(loop_vars),
            body=list(node.body) + [ast.Return(value=ast.Tuple(
                elts=[_load(n) for n in loop_vars], ctx=ast.Load()))],
            decorator_list=[])
        call = ast.Call(
            func=_load(_CONVERT_WHILE),
            args=[_load(cond_name), _load(body_name),
                  ast.Tuple(elts=[_load(n) for n in loop_vars],
                            ctx=ast.Load())],
            keywords=[ast.keyword(arg="max_iters",
                                  value=_load(_MAX_ITERS))])
        out = ast.Assign(
            targets=[ast.Tuple(elts=[_store(n) for n in loop_vars],
                               ctx=ast.Store())],
            value=call)
        return _bind_unbound(loop_vars) + [cond_def, body_def, out]

    # -- for i in range(...) ----------------------------------------------
    def visit_For(self, node):
        if (not node.orelse
                and isinstance(node.target, ast.Name)
                and isinstance(node.iter, ast.Call)
                and isinstance(node.iter.func, ast.Name)
                and node.iter.func.id == "range"
                and 1 <= len(node.iter.args) <= 3
                and not node.iter.keywords
                and not _contains_escape(node.body)):
            a = node.iter.args
            start = a[0] if len(a) > 1 else ast.Constant(value=0)
            stop = a[1] if len(a) > 1 else a[0]
            step = a[2] if len(a) > 2 else ast.Constant(value=1)
            i = node.target.id
            limit = self._fresh("limit")
            stepv = self._fresh("step")
            new = [
                ast.Assign(targets=[_store(i)], value=start),
                ast.Assign(targets=[_store(limit)], value=stop),
                ast.Assign(targets=[_store(stepv)], value=step),
                ast.While(
                    test=ast.Call(func=_load(_CONVERT_RANGE),
                                  args=[_load(i), _load(limit),
                                        _load(stepv)],
                                  keywords=[]),
                    body=list(node.body) + [ast.AugAssign(
                        target=_store(i), op=ast.Add(),
                        value=_load(stepv))],
                    orelse=[]),
            ]
            out = []
            for stmt in new:
                r = self.visit(stmt) if isinstance(stmt, ast.While) \
                    else stmt
                out.extend(r if isinstance(r, list) else [r])
            return out
        self.generic_visit(node)
        return node


def _no_args():
    return ast.arguments(posonlyargs=[], args=[], vararg=None,
                         kwonlyargs=[], kw_defaults=[], kwarg=None,
                         defaults=[])


def _arg_list(names):
    return ast.arguments(
        posonlyargs=[], args=[ast.arg(arg=n) for n in names], vararg=None,
        kwonlyargs=[], kw_defaults=[], kwarg=None, defaults=[])


def _bind_unbound(names):
    """`try: x \n except (NameError, UnboundLocalError): x = None` per
    name — branch/loop locals first bound inside the block still work."""
    body = []
    for n in names:
        h = ast.ExceptHandler(
            type=ast.Tuple(elts=[_load("NameError"),
                                 _load("UnboundLocalError")],
                           ctx=ast.Load()),
            name=None,
            body=[ast.Assign(targets=[_store(n)],
                             value=ast.Constant(value=None))])
        body.append(ast.Try(body=[ast.Expr(value=_load(n))],
                            handlers=[h], orelse=[], finalbody=[]))
    return body


# --------------------------------------------------------------------------
# public API
# --------------------------------------------------------------------------


def _transpile(fn, max_iters):
    src = textwrap.dedent(inspect.getsource(fn))
    tree = ast.parse(src)
    fdef = tree.body[0]
    fdef.decorator_list = []        # drop @to_static itself
    new_body = []
    t = _ControlFlowTransformer()
    for stmt in fdef.body:
        r = t.visit(stmt)
        new_body.extend(r if isinstance(r, list) else [r])
    fdef.body = new_body
    ast.fix_missing_locations(tree)
    code = compile(tree, filename=f"<dy2st {fn.__qualname__}>",
                   mode="exec")
    glb = dict(fn.__globals__)
    glb[_CONVERT_IF] = convert_ifelse
    glb[_CONVERT_WHILE] = convert_while
    glb[_CONVERT_RANGE] = convert_range_continues
    glb[_MAX_ITERS] = max_iters
    loc = {}
    exec(code, glb, loc)
    new_fn = loc[fdef.name]
    if fn.__closure__:
        # rebuild with the original closure when shapes match; otherwise
        # closures over transformed names are unsupported
        try:
            new_fn = type(fn)(new_fn.__code__, glb, fn.__name__,
                              fn.__defaults__, fn.__closure__)
        except (TypeError, ValueError):
            raise TypeError(
                f"to_static: cannot transpile closure function "
                f"{fn.__qualname__} (free variables "
                f"{fn.__code__.co_freevars} vs transformed "
                f"{new_fn.__code__.co_freevars})")
    return new_fn


def to_static(fn=None, *, max_loop_iters=None):
    """Decorator: transpile tensor control flow (see module docstring).

    max_loop_iters: optional static trip bound forwarded to every
    converted loop — required if you want to differentiate through it
    (the bounded While runs under autograd as one op)."""
    if fn is None:
        return functools.partial(to_static, max_loop_iters=max_loop_iters)
    transpiled = _transpile(fn, max_loop_iters)

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        return transpiled(*args, **kwargs)

    wrapper.__wrapped_original__ = fn
    wrapper.__dy2st_transpiled__ = transpiled
    return wrapper


declarative = to_static


def unwrap(fn):
    """The original (untranspiled) function."""
    return getattr(fn, "__wrapped_original__", fn)
