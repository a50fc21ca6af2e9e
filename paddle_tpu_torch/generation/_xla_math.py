"""XLA's CPU float32 arithmetic for the sampler's nucleus cut, bit for bit,
in torch float32 operations on any device.

The top-p cut keeps the smallest prefix of descending probabilities whose
mass reaches top_p; a token whose preceding mass lies within one rounding
of top_p lands on the side the arithmetic puts it.  Token parity with the
JAX engine therefore needs the reference's probabilities and running
sums to the last bit, which ``torch.softmax`` and ``torch.cumsum`` do not
give.  This module reproduces what XLA's CPU backend (JAX 0.9) compiles
``jax.nn.softmax`` and ``jnp.cumsum`` to, read from the optimised HLO:

* ``xla_exp`` — the Cephes exponential XLA emits (range reduction by
  ln 2 in two parts, a degree-5 polynomial, every multiply-add fused),
  with results below the smallest normal float32 flushed to zero as the
  CPU backend runs with flush-to-zero on;
* ``xla_sum`` — a row sum rewritten as a tree: windows of 32, the row
  centred in its padding (pad // 2 zeros in front), each window summed
  in order, then the window sums reduced the same way until 32 or fewer
  remain, which are summed in order;
* ``xla_softmax`` — ``exp(x - max) / sum``, flushed to zero;
* ``xla_cumsum`` — ``reduce_window`` (the lowering of ``jnp.cumsum``)
  rewritten as a scan over tiles of 16: an in-order inclusive sum within
  each tile, the cumulative sums of the tile totals (the same scan,
  recursively), and each tile's sum plus the total of the tiles before
  it.

Each fused multiply-add is taken through float64 (the product is exact
there, so one rounding to float32 remains), as ``_threefry.xla_log``
does.  ``tests/test_torch_sampler.py`` holds every function here against
``jax`` bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["xla_exp", "xla_sum", "xla_softmax", "xla_cumsum"]

_FLT_MIN = float(np.finfo(np.float32).tiny)
#: window of XLA's tree rewrite of a row reduction
_SUM_WINDOW = 32
#: tile of XLA's rewrite of a cumulative reduce_window
_SCAN_TILE = 16


def _f32(v):
    return float(np.float32(v))


def _fma(a, b, c):
    return (a.double() * b + (c.double() if torch.is_tensor(c) else c)
            ).float()


def _flush(x):
    return torch.where(x.abs() < _FLT_MIN, torch.zeros_like(x), x)


_LOG2E = _f32(1.44269504088896341)
_LN2_HI, _LN2_LO = _f32(0.693359375), _f32(-2.12194440e-4)
_EXP_P = [_f32(c) for c in (1.9875691500E-4, 1.3981999507E-3,
                            8.3334519073E-3, 4.1665795894E-2,
                            1.6666665459E-1, 5.0000001201E-1)]


def xla_exp(x):
    """exp of float32 ``x`` <= 88.3 (the softmax calls it on x - max <=
    0), bit for bit as XLA's CPU backend computes it."""
    x = x.clamp(_f32(-87.8), _f32(88.8))
    n = torch.floor(_fma(x, _LOG2E, 0.5))
    r = _fma(n, -_LN2_HI, x)
    r = _fma(n, -_LN2_LO, r)
    y = _fma(r, _EXP_P[0], _EXP_P[1])
    for p in _EXP_P[2:]:
        y = _fma(y, r, p)
    y = _fma(y, r * r, r) + 1.0
    two_n = ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    return _flush(y * two_n)


def _in_order(x):
    """Sum over the last axis, left to right."""
    acc = x[..., 0]
    for i in range(1, x.shape[-1]):
        acc = acc + x[..., i]
    return acc


def xla_sum(x):
    """Row sums over the last axis in XLA's tree order."""
    n = x.shape[-1]
    if n <= _SUM_WINDOW:
        return _in_order(x)
    windows = -(-n // _SUM_WINDOW)
    pad = windows * _SUM_WINDOW - n
    x = F.pad(x, (pad // 2, pad - pad // 2))
    return xla_sum(_in_order(x.unflatten(-1, (windows, _SUM_WINDOW))))


def xla_softmax(x):
    """Softmax over the last axis of float32 ``x`` [S, V]."""
    e = xla_exp(x - x.max(dim=-1, keepdim=True).values)
    return _flush(e / xla_sum(e)[..., None])


def xla_cumsum(x):
    """Inclusive cumulative sum over the last axis of ``x`` [S, V]."""
    S, V = x.shape
    if V <= _SCAN_TILE:
        cols = [x[:, 0]]
        for i in range(1, V):
            cols.append(cols[-1] + x[:, i])
        return torch.stack(cols, dim=1)
    tiles = -(-V // _SCAN_TILE)
    xt = F.pad(x, (0, tiles * _SCAN_TILE - V)).view(S, tiles, _SCAN_TILE)
    cols = [xt[..., 0]]
    for i in range(1, _SCAN_TILE):
        cols.append(cols[-1] + xt[..., i])
    within = torch.stack(cols, dim=-1)                  # [S, tiles, 16]
    totals = xla_cumsum(within[..., -1])                # [S, tiles]
    before = F.pad(totals[:, :-1], (1, 0))
    return (within + before[..., None]).reshape(S, -1)[:, :V]
