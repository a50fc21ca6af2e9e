"""Operator overloading on Variable: a copy of
paddle_tpu/layers/math_op_patch.py (parity: fluid/layers/math_op_patch.py):
``a + b``, ``a * 2``, ``a - b``, ``a ** 0.5``, ``a < b`` ... build
elementwise/scale/compare ops.  ``bool(var)`` raises."""
from __future__ import annotations

from ..core.program import Variable
from .helper import LayerHelper


def _scalar_op(var, scale, bias):
    helper = LayerHelper("scale")
    out = helper.create_variable_for_type_inference(var.dtype)
    helper.append_op(
        type="scale",
        inputs={"X": [var.name]},
        outputs={"Out": [out.name]},
        attrs={"scale": float(scale), "bias": float(bias)},
    )
    return out


def _binary(op_type, x, y, reverse=False):
    if isinstance(y, (int, float)):
        if op_type == "elementwise_add":
            return _scalar_op(x, 1.0, y)
        if op_type == "elementwise_sub":
            if reverse:
                return _scalar_op(x, -1.0, y)
            return _scalar_op(x, 1.0, -y)
        if op_type == "elementwise_mul":
            return _scalar_op(x, y, 0.0)
        if op_type == "elementwise_div" and not reverse:
            return _scalar_op(x, 1.0 / y, 0.0)
        if not reverse:
            # delegate to the layer, which bakes the scalar into attrs
            from . import nn as _nn

            return getattr(_nn, op_type)(x, y)
        from . import tensor as T

        y = T.fill_constant(shape=[], dtype=x.dtype, value=y)
    helper = LayerHelper(op_type)
    a, b = (y, x) if reverse else (x, y)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type=op_type,
        inputs={"X": [a.name], "Y": [b.name]},
        outputs={"Out": [out.name]},
        attrs={"axis": -1},
    )
    return out


def monkey_patch_variable():
    def make(op_type, reverse=False):
        def impl(self, other):
            return _binary(op_type, self, other, reverse)

        return impl

    Variable.__add__ = make("elementwise_add")
    Variable.__radd__ = make("elementwise_add")
    Variable.__sub__ = make("elementwise_sub")
    Variable.__rsub__ = make("elementwise_sub", reverse=True)
    Variable.__mul__ = make("elementwise_mul")
    Variable.__rmul__ = make("elementwise_mul")
    Variable.__truediv__ = make("elementwise_div")
    Variable.__rtruediv__ = make("elementwise_div", reverse=True)
    Variable.__pow__ = make("elementwise_pow")
    Variable.__rpow__ = make("elementwise_pow", reverse=True)
    Variable.__mod__ = make("elementwise_mod")
    Variable.__floordiv__ = make("elementwise_floordiv")
    Variable.__lt__ = make("less_than")
    Variable.__le__ = make("less_equal")
    Variable.__gt__ = make("greater_than")
    Variable.__ge__ = make("greater_equal")
    Variable.__neg__ = lambda self: _scalar_op(self, -1.0, 0.0)
    Variable.__matmul__ = lambda self, other: _binary("matmul", self, other)

    def _no_bool(self):
        raise TypeError(
            f"bool(Variable '{self.name}') is undefined in a static "
            f"graph: Python would silently treat the tensor as truthy "
            f"(e.g. an infinite `while`). Use layers.cond / layers.While "
            f"for tensor control flow; for None-checks use `is not "
            f"None`.")

    Variable.__bool__ = _no_bool
