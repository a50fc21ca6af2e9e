"""N-d indexing ops of the port: ``gather_nd``.

Counterpart of paddle_tpu/ops/manip.py (parity:
operators/gather_nd_op.cc); the rest of that file waits (ROADMAP.md
Queue 1 item 6).
"""
from __future__ import annotations

from ..core.registry import out, register_op, single


@register_op("gather_nd", inputs=("X", "Index"), outputs=("Out",),
             no_grad_slots=("Index",))
def gather_nd(ctx, inputs, attrs):
    """Index[..., K] indexes the first K dims of X; Out.shape =
    Index.shape[:-1] + X.shape[K:]."""
    x = single(inputs, "X")
    index = single(inputs, "Index").long()
    return out(Out=x[tuple(index.movedim(-1, 0))])
