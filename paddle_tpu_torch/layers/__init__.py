"""paddle_tpu_torch.layers — the layers of the ported training path
(counterpart of paddle_tpu.layers)."""
from ..core.program import data  # noqa: F401  (layers.data parity)
from .nn import (  # noqa: F401
    dropout, elementwise_add, elementwise_div, elementwise_max,
    elementwise_mul, elementwise_sub, embedding, fc,
    fused_multihead_attention, gelu, layer_norm, not_equal, relu, softmax,
    softmax_with_cross_entropy, square_error_cost,
)
from .tensor import (  # noqa: F401
    cast, matmul, mean, range, reduce_mean, reduce_sum, reshape, scale,
    slice, squeeze, transpose, unsqueeze,
)
