"""Math ops of the ported training path: matmul, the broadcasted
elementwise family, reductions (sum, mean), activations, softmax,
comparison.

Counterpart of paddle_tpu/ops/math.py (parity: operators/matmul_op.cc,
mul_op.cc, elementwise/, reduce_ops/, activation_op.cc, scale_op.cc).
Float32 matmuls go to cuBLAS in full float32 (no TF32, see _device.py),
as the JAX package left them to XLA.  Every function also runs on
``meta`` tensors (shape inference).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.registry import out, register_op, single


# -- matmul family ---------------------------------------------------------

@register_op("matmul", inputs=("X", "Y"), outputs=("Out",))
def matmul(ctx, inputs, attrs):
    x = single(inputs, "X")
    y = single(inputs, "Y")
    if attrs.get("transpose_X", False):
        x = x.transpose(-1, -2)
    if attrs.get("transpose_Y", False):
        y = y.transpose(-1, -2)
    res = torch.matmul(x, y)
    alpha = attrs.get("alpha", 1.0)
    if alpha != 1.0:
        res = res * alpha
    return out(Out=res)


@register_op("mul", inputs=("X", "Y"), outputs=("Out",))
def mul(ctx, inputs, attrs):
    """Flattening matmul (parity: operators/mul_op.cc): X is flattened to
    2D at x_num_col_dims, Y at y_num_col_dims."""
    x = single(inputs, "X")
    y = single(inputs, "Y")
    xnc = attrs.get("x_num_col_dims", 1)
    ync = attrs.get("y_num_col_dims", 1)
    xs, ys = tuple(x.shape), tuple(y.shape)
    x2 = x.reshape(-1, _prod(xs[xnc:]))
    y2 = y.reshape(_prod(ys[:ync]), -1)
    return out(Out=torch.matmul(x2, y2).reshape(xs[:xnc] + ys[ync:]))


def _prod(dims):
    p = 1
    for d in dims:
        p *= int(d)
    return p


# -- broadcasted elementwise binary family ---------------------------------

def _bcast_y(x, y, axis):
    """Reference broadcast rule (elementwise_op_function.h): align Y's dims
    with X starting at `axis` (default: trailing alignment)."""
    if axis is None or axis == -1 or y.dim() == x.dim():
        return y
    trailing = x.dim() - axis - y.dim()
    return y.reshape((1,) * axis + tuple(y.shape) + (1,) * trailing)


def _register_elementwise(name, fn):
    @register_op(f"elementwise_{name}", inputs=("X", "Y"), outputs=("Out",))
    def ew(ctx, inputs, attrs, fn=fn):
        x = single(inputs, "X")
        y = single(inputs, "Y")
        if y is None:  # scalar operand baked into attrs
            y = torch.full((), attrs["scalar_y"], dtype=x.dtype,
                           device=x.device)
        else:
            y = _bcast_y(x, y, attrs.get("axis", -1))
        return out(Out=fn(x, y))


_register_elementwise("add", torch.add)
_register_elementwise("sub", torch.sub)
_register_elementwise("mul", torch.mul)
_register_elementwise("div", torch.div)
_register_elementwise("max", torch.maximum)


@register_op("scale", inputs=("X",), outputs=("Out",))
def scale(ctx, inputs, attrs):
    x = single(inputs, "X")
    s = torch.full((), attrs.get("scale", 1.0), dtype=x.dtype,
                   device=x.device)
    b = torch.full((), attrs.get("bias", 0.0), dtype=x.dtype,
                   device=x.device)
    if attrs.get("bias_after_scale", True):
        return out(Out=x * s + b)
    return out(Out=(x + b) * s)


# -- reductions ------------------------------------------------------------

def _register_reduce(name, fn):
    @register_op(f"reduce_{name}", inputs=("X",), outputs=("Out",))
    def red(ctx, inputs, attrs, fn=fn):
        x = single(inputs, "X")
        keep = attrs.get("keep_dim", False)
        dim = attrs.get("dim", None)
        if attrs.get("reduce_all", False) or dim is None:
            res = fn(x)
            if keep:
                res = res.reshape((1,) * x.dim())
            return out(Out=res)
        dim = tuple(d % x.dim() for d in
                    (dim if isinstance(dim, (list, tuple)) else [dim]))
        if not dim:
            # an empty dim reduces nothing, as jnp.sum(axis=()) does
            # (torch.sum(dim=()) would reduce every axis)
            return out(Out=x)
        return out(Out=fn(x, dim=dim, keepdim=keep))


_register_reduce("sum", torch.sum)
_register_reduce("mean", torch.mean)


@register_op("mean", inputs=("X",), outputs=("Out",))
def mean(ctx, inputs, attrs):
    return out(Out=single(inputs, "X").mean())


# -- unary activations (parity: activation_op.cc) ---------------------------

def _register_unary(name, fn):
    @register_op(name, inputs=("X",), outputs=("Out",))
    def un(ctx, inputs, attrs, fn=fn):
        return out(Out=fn(single(inputs, "X"), attrs))


_register_unary("relu", lambda x, a: torch.relu(x))
# exact-erf gelu unless asked otherwise, as the JAX op's default
_register_unary("gelu", lambda x, a: F.gelu(
    x, approximate="tanh" if a.get("approximate", False) else "none"))


# -- comparison (parity: operators/controlflow/compare_op.cc) ---------------

@register_op("not_equal", inputs=("X", "Y"), outputs=("Out",),
             no_grad_slots=("X", "Y"))
def not_equal(ctx, inputs, attrs):
    x = single(inputs, "X")
    y = single(inputs, "Y")
    if y is None:
        y = torch.full((), attrs["scalar_y"], dtype=x.dtype, device=x.device)
    return out(Out=torch.ne(x, y))


# -- softmax ---------------------------------------------------------------

@register_op("softmax", inputs=("X",), outputs=("Out",))
def softmax(ctx, inputs, attrs):
    x = single(inputs, "X")
    return out(Out=torch.softmax(x, dim=attrs.get("axis", -1)))
