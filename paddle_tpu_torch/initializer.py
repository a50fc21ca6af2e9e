"""Parameter initializers: a copy of paddle_tpu/initializer.py (parity:
python/paddle/fluid/initializer.py).

An initializer appends an init op (fill_constant / gaussian_random /
uniform_random / truncated_gaussian_random) for a parameter into the
*startup program*, so both packages emit the same startup ops; running
the startup program materializes all parameters in the scope.  The
numpy-array initializer is not ported (its ``assign_value`` op is, in
ops/tensor.py, for ``layers.assign``).
"""
from __future__ import annotations

import math


class Initializer:
    def append_op(self, var, block):
        raise NotImplementedError


class ConstantInitializer(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def append_op(self, var, block):
        block.append_op(
            type="fill_constant",
            outputs={"Out": [var.name]},
            attrs={"shape": list(var.shape), "value": self.value,
                   "dtype": var.dtype},
            infer_shape=False,
        )


class UniformInitializer(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self.low, self.high, self.seed = low, high, seed

    def append_op(self, var, block):
        block.append_op(
            type="uniform_random",
            outputs={"Out": [var.name]},
            attrs={"shape": list(var.shape), "min": self.low,
                   "max": self.high, "dtype": var.dtype, "seed": self.seed},
            infer_shape=False,
        )


class NormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def append_op(self, var, block):
        block.append_op(
            type="gaussian_random",
            outputs={"Out": [var.name]},
            attrs={"shape": list(var.shape), "mean": self.loc,
                   "std": self.scale, "dtype": var.dtype, "seed": self.seed},
            infer_shape=False,
        )


class TruncatedNormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def append_op(self, var, block):
        block.append_op(
            type="truncated_gaussian_random",
            outputs={"Out": [var.name]},
            attrs={"shape": list(var.shape), "mean": self.loc,
                   "std": self.scale, "dtype": var.dtype, "seed": self.seed},
            infer_shape=False,
        )


def _fans(var):
    shape = var.shape
    if len(shape) == 2:
        fan_in, fan_out = shape[0], shape[1]
    elif len(shape) > 2:
        receptive = 1
        for d in shape[2:]:
            receptive *= d
        fan_in = shape[1] * receptive
        fan_out = shape[0] * receptive
    else:
        fan_in = fan_out = shape[0] if shape else 1
    return fan_in, fan_out


class XavierInitializer(Initializer):
    """Glorot init (parity: initializer.py XavierInitializer)."""

    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        self.uniform = uniform
        self.fan_in, self.fan_out, self.seed = fan_in, fan_out, seed

    def append_op(self, var, block):
        fi, fo = _fans(var)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        if self.uniform:
            limit = math.sqrt(6.0 / (fi + fo))
            UniformInitializer(-limit, limit, self.seed).append_op(var, block)
        else:
            std = math.sqrt(2.0 / (fi + fo))
            NormalInitializer(0.0, std, self.seed).append_op(var, block)


# Short aliases matching fluid.initializer usage.
Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
TruncatedNormal = TruncatedNormalInitializer
Xavier = XavierInitializer
