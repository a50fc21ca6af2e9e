"""Threefry2x32 counter-based random bits, bit for bit as jax.random
draws them, in torch integer arithmetic on any device.

The sampler's schedule-invariant randomness is ``fold_in(root, word)``
per (request, position); token parity with the JAX engine needs the same
bits, which a ``torch.Generator`` does not give.  This module reproduces:

* ``threefry2x32`` — JAX's 20-round hash (``jax._src.prng``);
* ``fold_in`` — ``threefry_2x32(key, threefry_seed(data))``, i.e. the
  hash of the counter pair (0, data);
* ``random_bits`` — the ``jax_threefry_partitionable`` layout (the
  default of the JAX this port is held against): element i of a flat
  draw hashes the counter pair (i >> 32, i & 0xFFFFFFFF) and XORs the
  two output words;
* ``uniform`` / ``gumbel`` / ``categorical`` — ``jax.random``'s float
  construction (mantissa bits OR 1.0, minus 1.0, ``mode="low"`` Gumbel
  = -log(-log(u))) and the Gumbel-max argmax.

uint32 words live in int64 tensors and every sum is masked to 32 bits.
Gumbel noise is -log(-log(u)) with the logarithm XLA's CPU backend
emits (the Cephes polynomial, fused multiply-adds where XLA fuses them),
reproduced step by step in float32 with each fused multiply-add taken
through float64 — so the noise, and the token it picks, is the
reference's on every device.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["threefry2x32", "fold_in", "random_bits", "uniform", "gumbel",
           "categorical", "xla_log"]

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r):
    return ((x << r) & _M32) | (x >> (32 - r))


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 with 20 rounds on broadcastable int64 tensors of
    uint32 values; returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x1, x2


def fold_in(key, data):
    """key [..., 2], data [...] (uint32 values) -> keys [..., 2]."""
    data = data.to(torch.int64) & _M32
    o1, o2 = threefry2x32(key[..., 0], key[..., 1],
                          torch.zeros_like(data), data)
    return torch.stack([o1, o2], dim=-1)


def random_bits(key, n):
    """32-bit draws: key [..., 2] -> [..., n] int64 of uint32 values."""
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(key[..., 0, None], key[..., 1, None],
                          i >> 32, i & _M32)
    return b1 ^ b2


_TINY = float(np.finfo(np.float32).tiny)


def uniform(key, n, minval=0.0, maxval=1.0):
    """float32 uniforms in [minval, maxval): key [..., 2] -> [..., n]."""
    bits = random_bits(key, n)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    f = f - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    span = torch.tensor(maxval, dtype=torch.float32,
                        device=key.device) - lo
    return torch.maximum(lo, f * span + lo)


def _f32(v):
    return float(np.float32(v))


_SQRTHF = _f32(0.707106781186547524)
_P = [_f32(c) for c in (7.0376836292E-2, -1.1514610310E-1,
                        1.1676998740E-1, -1.2420140846E-1,
                        1.4249322787E-1, -1.6668057665E-1,
                        2.0000714765E-1, -2.4999993993E-1,
                        3.3333331174E-1)]
_LN2_HI = _f32(0.693359375)
_LN2_LO = _f32(-2.12194440e-4)


def _fma(a, b, c):
    """float32 a*b + c with one rounding (the product is exact in
    float64; the sum rounds in float64, then to float32)."""
    return (a.double() * b + (c.double() if torch.is_tensor(c) else c)
            ).float()


def xla_log(x):
    """Natural log of positive float32 ``x``, bit for bit as XLA's CPU
    backend computes it (frexp, the Cephes degree-8 polynomial, ln 2 in
    two parts).  0 -> -inf, < 0 -> NaN, +inf -> +inf."""
    x0 = x
    x = torch.clamp_min(x, 2.0 ** -126)
    b = x.contiguous().view(torch.int32)
    e = ((b >> 23) - 127).float() + 1.0
    m = ((b & 0x007FFFFF) | 0x3F000000).view(torch.float32)
    mask = m < _SQRTHF
    tmp = torch.where(mask, m, torch.zeros_like(m))
    x = m - 1.0
    e = e - mask.float()
    x = x + tmp
    z = x * x
    x3 = z * x
    y0 = _fma(x, _P[0], _P[1])
    y1 = _fma(x, _P[3], _P[4])
    y2 = _fma(x, _P[6], _P[7])
    y0 = _fma(y0, x, _P[2])
    y1 = _fma(y1, x, _P[5])
    y2 = _fma(y2, x, _P[8])
    t = _fma(y0, x3, y1)
    t = _fma(t, x3, y2)
    t = _fma(t, x3, e * _LN2_LO)
    r = (x - z * 0.5) + t
    r = r + e * _LN2_HI
    r = torch.where(x0 == 0, torch.full_like(r, -float("inf")), r)
    r = torch.where(x0 < 0, torch.full_like(r, float("nan")), r)
    return torch.where(x0 == float("inf"), x0, r)


def gumbel(key, n):
    """Standard Gumbel float32 noise (jax.random.gumbel, mode "low"):
    key [..., 2] -> [..., n]."""
    return -xla_log(-xla_log(uniform(key, n, minval=_TINY)))


def categorical(key, logits):
    """Gumbel-max draw per row: key [R, 2], logits [R, V] -> [R] int64."""
    return torch.argmax(gumbel(key, logits.shape[-1]) + logits, dim=-1)
