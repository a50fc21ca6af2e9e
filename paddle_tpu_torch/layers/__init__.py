"""paddle_tpu_torch.layers — the layer library (counterpart of
paddle_tpu.layers): what the BERT builders, the fc and 4-D attention
programs, the learning-rate schedules and gradient clipping use, the
conv, pool and batch-norm layers of the vision models, ``label_smooth``
and the beam decoder's layers (``gather_nd``, ``beam_search``,
``beam_search_decode``), the loss and metric layers, the control-flow
layers (While, cond, Switch, StaticRNN), the recurrent layers
(``dynamic_lstm``, ``dynamic_gru``, ``lstm``), the sequence layers over
padded batches plus lengths (``sequence_lod``'s and wave2's), ``cos_sim``,
and every generated unary/binary layer of the JAX package.  Importing it patches
Variable's operators (math_op_patch)."""
from ..core.program import data  # noqa: F401  (layers.data parity)
from .nn import *  # noqa: F401,F403
from .nn import _BINARY_OPS, _UNARY_OPS  # noqa: F401
from .nn import (  # noqa: F401
    accuracy, auc, batch_norm, conv2d, conv2d_transpose, cross_entropy,
    dropout, embedding, fc, fused_multihead_attention, huber_loss,
    layer_norm, moe, pool2d,
    sigmoid_cross_entropy_with_logits, softmax_with_cross_entropy,
    square_error_cost,
)
from .tensor import (  # noqa: F401
    argmax, argmin, assign, cast, clip, clip_by_norm, concat, cumsum,
    expand, fill_constant, fill_constant_batch_size_like, gather,
    gaussian_random, gaussian_random_batch_size_like, matmul, mean, mul,
    one_hot, ones, ones_like, pad, pow, range, reduce_all, reduce_any,
    reduce_max, reduce_mean, reduce_min, reduce_prod, reduce_sum, reshape,
    scale, scatter, shape, slice, split, squeeze, stack, topk, transpose,
    uniform_random, uniform_random_batch_size_like, unsqueeze, unstack,
    where, zeros, zeros_like,
)
from .control_flow import (  # noqa: F401  (overrides nn's plain compare ops
    # with cond=-capable versions, matching fluid.layers signatures)
    StaticRNN, Switch, While, cond, equal, greater_equal, greater_than,
    increment, less_equal, less_than, not_equal,
)
from .rnn import dynamic_gru, dynamic_lstm, lstm  # noqa: F401
from .extras import label_smooth  # noqa: F401
from .sequence_lod import (  # noqa: F401
    sequence_concat, sequence_conv, sequence_expand_as,
    sequence_first_step, sequence_last_step, sequence_mask, sequence_pool,
    sequence_reverse, sequence_softmax,
)
from .wave2 import (  # noqa: F401
    beam_search, beam_search_decode, cos_sim, gather_nd, sequence_enumerate,
    sequence_erase, sequence_expand, sequence_pad, sequence_reshape,
    sequence_scatter, sequence_slice, sequence_unpad,
)
from .learning_rate_scheduler import (  # noqa: F401
    cosine_decay, exponential_decay, inverse_time_decay, linear_lr_warmup,
    natural_exp_decay, noam_decay, piecewise_decay, polynomial_decay,
)
from .math_op_patch import monkey_patch_variable

monkey_patch_variable()
