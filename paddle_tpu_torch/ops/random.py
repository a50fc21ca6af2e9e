"""Random init ops (parity: operators/gaussian_random_op.cc,
uniform_random_op.cc, truncated_gaussian_random_op.cc).

Counterpart of paddle_tpu/ops/random.py.  Each op draws from a
``torch.Generator`` on the executor's device seeded with the op's seed
(the step seed folded with the op's uid), so a startup program is
reproducible per ``random_seed`` — but its numbers are torch's, not the
JAX package's: tests carry weights across with ``io.load_params``.
"""
from __future__ import annotations

import math

import torch

from ..core.registry import out, register_op, single
from ..core.types import runtime_dtype


def _draw(ctx, attrs, fn, shape=None, seed=None):
    shape = tuple(int(d) for d in (attrs["shape"] if shape is None
                                   else shape))
    dtype = runtime_dtype(attrs.get("dtype", "float32"))
    if ctx.device.type == "meta":       # shape inference: no generator
        return torch.empty(shape, dtype=dtype, device="meta")
    gen = torch.Generator(device=ctx.device).manual_seed(
        ctx.rng if seed is None else seed)
    return fn(shape, generator=gen, device=ctx.device, dtype=dtype)


@register_op("gaussian_random", inputs=(), outputs=("Out",), needs_rng=True)
def gaussian_random(ctx, inputs, attrs):
    z = _draw(ctx, attrs, torch.randn)
    return out(Out=attrs.get("mean", 0.0) + attrs.get("std", 1.0) * z)


@register_op("uniform_random", inputs=(), outputs=("Out",), needs_rng=True)
def uniform_random(ctx, inputs, attrs):
    lo = attrs.get("min", -1.0)
    hi = attrs.get("max", 1.0)
    return out(Out=lo + (hi - lo) * _draw(ctx, attrs, torch.rand))


#: standard normal CDF at -2 and 2 (the truncation points)
_CDF_LO = 0.5 * math.erfc(2.0 / math.sqrt(2.0))
_CDF_HI = 1.0 - _CDF_LO


@register_op("truncated_gaussian_random", inputs=(), outputs=("Out",),
             needs_rng=True)
def truncated_gaussian_random(ctx, inputs, attrs):
    """Normal truncated at 2 sigma (the reference kernel's bound), by
    inverting the CDF of a uniform draw over [Phi(-2), Phi(2)]."""
    u = _draw(ctx, attrs, torch.rand)
    p = _CDF_LO + (_CDF_HI - _CDF_LO) * u
    z = (math.sqrt(2.0) * torch.erfinv(2.0 * p - 1.0)).clamp(-2.0, 2.0)
    return out(Out=attrs.get("mean", 0.0) + attrs.get("std", 1.0) * z)


def _batch_size_like(ctx, inputs, attrs, fn):
    """Draw ``attrs["shape"]`` with its output_dim_idx copied from the
    input's input_dim_idx.  The reference's seed contract (the JAX
    package's misc2._maybe_seeded): ``seed != 0`` draws the same numbers
    every run, ``seed == 0`` a fresh stream from the program's."""
    x = single(inputs, "Input")
    shape = [int(d) for d in attrs["shape"]]
    shape[int(attrs.get("output_dim_idx", 0))] = \
        x.shape[int(attrs.get("input_dim_idx", 0))]
    seed = int(attrs.get("seed", 0))
    return _draw(ctx, attrs, fn, shape=shape, seed=seed or None)


@register_op("uniform_random_batch_size_like", inputs=("Input",),
             outputs=("Out",), needs_rng=True, no_grad_slots=("Input",))
def uniform_random_batch_size_like(ctx, inputs, attrs):
    lo = float(attrs.get("min", -1.0))
    hi = float(attrs.get("max", 1.0))
    u = _batch_size_like(ctx, inputs, attrs, torch.rand)
    return out(Out=lo + (hi - lo) * u)


@register_op("gaussian_random_batch_size_like", inputs=("Input",),
             outputs=("Out",), needs_rng=True, no_grad_slots=("Input",))
def gaussian_random_batch_size_like(ctx, inputs, attrs):
    z = _batch_size_like(ctx, inputs, attrs, torch.randn)
    return out(Out=z * float(attrs.get("std", 1.0))
               + float(attrs.get("mean", 0.0)))
