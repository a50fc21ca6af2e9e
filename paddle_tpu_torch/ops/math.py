"""Math ops: matmul, the broadcasted elementwise family, clipping and
norms, reductions, activations and pointwise math, comparisons and
logical ops, softmax and the index ops (arg_max/min, top_k, cumsum).

Counterpart of paddle_tpu/ops/math.py, op for op, with its attrs, its
broadcasting ``axis`` and its result dtypes (bool for comparisons and
``isfinite``, int32 for arg_max/arg_min/top_k indices) (parity:
operators/matmul_op.cc, mul_op.cc, elementwise/, reduce_ops/,
activation_op.cc, scale_op.cc, clip_op.cc, top_k_op.cc, arg_max/min,
cumsum).  XLA compiled these for the JAX package with no Pallas kernel;
here they are plain PyTorch.  Float32 matmuls go to cuBLAS in full
float32 (no TF32, see _device.py); bfloat16 and float16 ones (AMP) sum in
float32 and round the product to their type, as the JAX dots do: cuBLAS
with its reduced-precision reductions off on the card, widened operands
elsewhere (``fused_matmul.matmul_f32``).  Every function also runs on
``meta`` tensors (shape inference).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.registry import out, register_op, single
from .fused_matmul import matmul_f32


# -- matmul family ---------------------------------------------------------

@register_op("matmul", inputs=("X", "Y"), outputs=("Out",))
def matmul(ctx, inputs, attrs):
    x = single(inputs, "X")
    y = single(inputs, "Y")
    if attrs.get("transpose_X", False):
        x = x.transpose(-1, -2)
    if attrs.get("transpose_Y", False):
        y = y.transpose(-1, -2)
    res = matmul_f32(x, y)
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
    return out(Out=matmul_f32(x2, y2).reshape(xs[:xnc] + ys[ync:]))


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
_register_elementwise("min", torch.minimum)
_register_elementwise("pow", torch.pow)
# jnp.mod and jnp.floor_divide round toward -inf, as torch's do
_register_elementwise("mod", torch.remainder)
# jnp.floor_divide's gradient is zero; torch's has none (autograd raises),
# so the operands leave the graph and the vjp hands back zeros
_register_elementwise("floordiv", lambda x, y: torch.floor_divide(
    x.detach(), y.detach()))


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


def _clip(x, lo, hi):
    """jnp.clip's expression, minimum(maximum(x, lo), hi): at x == lo or
    hi the gradient is split between the two operands (0.5), where
    torch.clamp passes it whole."""
    if lo is not None:
        x = torch.maximum(x, torch.full((), lo, dtype=x.dtype,
                                        device=x.device))
    if hi is not None:
        x = torch.minimum(x, torch.full((), hi, dtype=x.dtype,
                                        device=x.device))
    return x


@register_op("clip", inputs=("X",), outputs=("Out",))
def clip(ctx, inputs, attrs):
    return out(Out=_clip(single(inputs, "X"), attrs.get("min"),
                         attrs.get("max")))


@register_op("clip_by_norm", inputs=("X",), outputs=("Out",))
def clip_by_norm(ctx, inputs, attrs):
    x = single(inputs, "X")
    max_norm = attrs["max_norm"]
    norm = torch.sqrt(torch.sum(x * x))
    return out(Out=torch.where(norm > max_norm, x * (max_norm / norm), x))


# -- reductions ------------------------------------------------------------

def _reduce_prod(x, dim=None, keepdim=False):
    """torch.prod over a tuple of dims (torch's takes one)."""
    if dim is None:
        return torch.prod(x)
    for d in sorted(dim, reverse=True):
        x = torch.prod(x, dim=d, keepdim=keepdim)
    return x


def _float_mean_input(x):
    """jnp.mean of integer or bool input is float32; torch.mean raises."""
    return x if x.is_floating_point() or x.is_complex() else \
        x.to(torch.float32)


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
_register_reduce("mean", lambda x, **kw: torch.mean(_float_mean_input(x),
                                                  **kw))
_register_reduce("max", torch.amax)
_register_reduce("min", torch.amin)
_register_reduce("prod", _reduce_prod)
_register_reduce("all", torch.all)
_register_reduce("any", torch.any)


@register_op("mean", inputs=("X",), outputs=("Out",))
def mean(ctx, inputs, attrs):
    return out(Out=_float_mean_input(single(inputs, "X")).mean())


@register_op("squared_l2_norm", inputs=("X",), outputs=("Out",))
def squared_l2_norm(ctx, inputs, attrs):
    x = single(inputs, "X")
    return out(Out=torch.sum(x * x))


@register_op("frobenius_norm", inputs=("X",), outputs=("Out",))
def frobenius_norm(ctx, inputs, attrs):
    x = single(inputs, "X")
    return out(Out=torch.sqrt(torch.sum(x * x)))


# -- unary activations (parity: activation_op.cc) ---------------------------

class _AbsFn(torch.autograd.Function):
    """|x| with jnp.abs's gradient: sign where x >= 0 picks +1, so the
    gradient at 0 is 1 (torch.abs gives 0 there)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.abs(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0, g, -g)


def _abs(x):
    if x.requires_grad and x.is_floating_point():
        return _AbsFn.apply(x)
    return torch.abs(x)


def _sign(x):
    """jnp.sign: NaN stays NaN and -0.0 stays -0.0 (torch.sign gives 0.0
    for both); the gradient is zero, as torch.sign's."""
    if not x.is_floating_point():
        return torch.sign(x)
    keep = (x == 0) | torch.isnan(x)
    return torch.where(keep, x.detach(), torch.sign(x))


# (device type, dtype, form) -> whether F.gelu gives NaN at +inf there
_GELU_INF_IS_NAN = {}


def _gelu(x, approximate):
    """F.gelu, with jax.nn.gelu's +inf at +inf.  F.gelu's vectorized CPU
    kernel for the erf form gives NaN there; a 64-element probe, run once
    per device type, dtype and form, decides whether this device needs
    the guard, so a device whose kernel is right pays nothing for it."""
    form = "tanh" if approximate else "none"
    y = F.gelu(x, approximate=form)
    if x.is_meta:   # shape inference: nothing to probe
        return y
    key = (x.device.type, x.dtype, form)
    guard = _GELU_INF_IS_NAN.get(key)
    if guard is None:
        probe = F.gelu(torch.full((64,), float("inf"), dtype=x.dtype,
                                  device=x.device), approximate=form)
        guard = _GELU_INF_IS_NAN[key] = bool(torch.isnan(probe).any())
    return torch.where(x == float("inf"), x, y) if guard else y


def _register_unary(name, fn):
    @register_op(name, inputs=("X",), outputs=("Out",))
    def un(ctx, inputs, attrs, fn=fn):
        return out(Out=fn(single(inputs, "X"), attrs))


_register_unary("relu", lambda x, a: torch.relu(x))
_register_unary("sigmoid", lambda x, a: torch.sigmoid(x))
_register_unary("tanh", lambda x, a: torch.tanh(x))
_register_unary("exp", lambda x, a: torch.exp(x))
_register_unary("log", lambda x, a: torch.log(x))
_register_unary("log2", lambda x, a: torch.log2(x))
_register_unary("log10", lambda x, a: torch.log10(x))
_register_unary("log1p", lambda x, a: torch.log1p(x))
_register_unary("sqrt", lambda x, a: torch.sqrt(x))
_register_unary("rsqrt", lambda x, a: torch.rsqrt(x))
_register_unary("square", lambda x, a: x * x)
_register_unary("abs", lambda x, a: _abs(x))
_register_unary("ceil", lambda x, a: torch.ceil(x))
_register_unary("floor", lambda x, a: torch.floor(x))
# half to even, as jnp.round
_register_unary("round", lambda x, a: torch.round(x))
_register_unary("reciprocal", lambda x, a: 1.0 / x)
_register_unary("sign", lambda x, a: _sign(x))
_register_unary("sin", lambda x, a: torch.sin(x))
_register_unary("cos", lambda x, a: torch.cos(x))
_register_unary("tan", lambda x, a: torch.tan(x))
_register_unary("asin", lambda x, a: torch.asin(x))
_register_unary("acos", lambda x, a: torch.acos(x))
_register_unary("atan", lambda x, a: torch.atan(x))
_register_unary("sinh", lambda x, a: torch.sinh(x))
_register_unary("cosh", lambda x, a: torch.cosh(x))
_register_unary("erf", lambda x, a: torch.erf(x))
# exact-erf gelu unless asked otherwise, as the JAX op's default
_register_unary("gelu", lambda x, a: _gelu(x, a.get("approximate", False)))
# jax.nn.leaky_relu's where(x >= 0, ...): the gradient at 0 is 1
_register_unary("leaky_relu", lambda x, a: torch.where(
    x >= 0, x, a.get("alpha", 0.02) * x))
_register_unary("elu", lambda x, a: F.elu(x, alpha=a.get("alpha", 1.0)))
# log(1 + e^x) without F.softplus's linear cut past 20, as jax.nn.softplus
_register_unary("softplus", lambda x, a: torch.logaddexp(
    x, torch.zeros_like(x)))
_register_unary("softsign", lambda x, a: x / (1.0 + torch.abs(x)))
_register_unary("relu6", lambda x, a: _clip(
    x, 0.0, a.get("threshold", 6.0)))
_register_unary("swish", lambda x, a: x * torch.sigmoid(
    a.get("beta", 1.0) * x))
_register_unary("hard_sigmoid", lambda x, a: _clip(
    a.get("slope", 0.2) * x + a.get("offset", 0.5), 0.0, 1.0))
_register_unary("hard_swish", lambda x, a: x * _clip(
    x + a.get("offset", 3.0), 0.0, a.get("threshold", 6.0))
    / a.get("scale", 6.0))
_register_unary("logsigmoid", lambda x, a: F.logsigmoid(x))
_register_unary("thresholded_relu", lambda x, a: torch.where(
    x > a.get("threshold", 1.0), x, torch.zeros_like(x)))
_register_unary("hard_shrink", lambda x, a: torch.where(
    torch.abs(x) > a.get("threshold", 0.5), x, torch.zeros_like(x)))
_register_unary("soft_shrink", lambda x, a: torch.sign(x) * torch.relu(
    torch.abs(x) - a.get("lambda", 0.5)))
_register_unary("stanh", lambda x, a: a.get("scale_b", 1.7159) * torch.tanh(
    a.get("scale_a", 0.67) * x))


@register_op("pow", inputs=("X",), outputs=("Out",))
def pow_op(ctx, inputs, attrs):
    x = single(inputs, "X")
    return out(Out=torch.pow(x, attrs.get("factor", 1.0)))


# -- comparisons / logical (parity: operators/controlflow/compare_op.cc) ---

def _register_compare(name, fn):
    @register_op(name, inputs=("X", "Y"), outputs=("Out",),
                 no_grad_slots=("X", "Y"))
    def cmp(ctx, inputs, attrs, fn=fn):
        x = single(inputs, "X")
        y = single(inputs, "Y")
        if y is None:
            y = torch.full((), attrs["scalar_y"], dtype=x.dtype,
                           device=x.device)
        return out(Out=fn(x, y))


_register_compare("equal", torch.eq)
_register_compare("not_equal", torch.ne)
_register_compare("less_than", torch.lt)
_register_compare("less_equal", torch.le)
_register_compare("greater_than", torch.gt)
_register_compare("greater_equal", torch.ge)
_register_compare("logical_and", torch.logical_and)
_register_compare("logical_or", torch.logical_or)
_register_compare("logical_xor", torch.logical_xor)


@register_op("logical_not", inputs=("X",), outputs=("Out",),
             no_grad_slots=("X",))
def logical_not(ctx, inputs, attrs):
    return out(Out=torch.logical_not(single(inputs, "X")))


@register_op("isfinite", inputs=("X",), outputs=("Out",),
             no_grad_slots=("X",))
def isfinite(ctx, inputs, attrs):
    return out(Out=torch.all(torch.isfinite(single(inputs, "X"))))


# -- softmax / indices -----------------------------------------------------

@register_op("softmax", inputs=("X",), outputs=("Out",))
def softmax(ctx, inputs, attrs):
    x = single(inputs, "X")
    return out(Out=torch.softmax(x, dim=attrs.get("axis", -1)))


@register_op("log_softmax", inputs=("X",), outputs=("Out",))
def log_softmax(ctx, inputs, attrs):
    x = single(inputs, "X")
    return out(Out=F.log_softmax(x, dim=attrs.get("axis", -1)))


@register_op("arg_max", inputs=("X",), outputs=("Out",), no_grad_slots=("X",))
def arg_max(ctx, inputs, attrs):
    x = single(inputs, "X")
    return out(Out=torch.argmax(x, dim=attrs.get("axis", -1)).to(
        torch.int32))


@register_op("arg_min", inputs=("X",), outputs=("Out",), no_grad_slots=("X",))
def arg_min(ctx, inputs, attrs):
    x = single(inputs, "X")
    return out(Out=torch.argmin(x, dim=attrs.get("axis", -1)).to(
        torch.int32))


@register_op("top_k", inputs=("X",), outputs=("Out", "Indices"),
             no_grad_slots=("X",))
def top_k(ctx, inputs, attrs):
    x = single(inputs, "X")
    k = attrs.get("k", 1)
    # jax.lax.top_k puts the lower index first among equal values;
    # torch.topk leaves their order open, a stable descending sort keeps it
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return out(Out=vals[..., :k], Indices=idx[..., :k].to(torch.int32))


@register_op("cumsum", inputs=("X",), outputs=("Out",))
def cumsum(ctx, inputs, attrs):
    x = single(inputs, "X")
    axis = attrs.get("axis", -1) % x.dim()
    res = torch.cumsum(x, dim=axis)
    if attrs.get("reverse", False):
        res = torch.flip(torch.cumsum(torch.flip(x, (axis,)), dim=axis),
                         (axis,))
    if attrs.get("exclusive", False):
        # the JAX op pads one zero in front along the axis and drops the
        # last entry, whichever way it summed
        zero = torch.zeros_like(res.narrow(axis, 0, 1))
        res = torch.cat([zero, res.narrow(axis, 0, res.shape[axis] - 1)],
                        dim=axis)
    return out(Out=res)


@register_op("maximum_eps", inputs=("X",), outputs=("Out",))
def maximum_eps(ctx, inputs, attrs):
    x = single(inputs, "X")
    return out(Out=torch.clamp_min(x, attrs.get("eps", 1e-12)))
