"""AMP op lists (counterpart of paddle_tpu/contrib/mixed_precision/
policy.py; parity: fluid/contrib/mixed_precision/fp16_lists.py).

White-list ops run their float inputs in the compute dtype (bfloat16 or
float16: the products, where the tensor cores' rate lives); black-list
ops force float32 (numerics-sensitive reductions, normalisations,
losses, the loss-scaling bookkeeping and every optimizer update).  Ops
in neither list run in whatever dtype arrives, so elementwise chains
stay in the compute dtype.  The lists are the JAX package's, op for op.
"""
import os

import torch

AMP_WHITE_LIST = frozenset({
    "matmul", "mul", "conv2d", "depthwise_conv2d", "conv2d_transpose",
    "fused_attention",
})

AMP_BLACK_LIST = frozenset({
    "softmax_with_cross_entropy", "cross_entropy",
    "sigmoid_cross_entropy_with_logits", "mean", "reduce_sum",
    # batch_norm is not here for bfloat16 (gray: its normalisation follows
    # the compute dtype; the Mean/Variance slots keep float32 through
    # AMP_KEEP_F32_SLOTS); layer_norm is
    "reduce_mean", "layer_norm", "group_norm",
    "instance_norm", "sum", "softmax", "log_softmax",
    "squared_l2_norm", "frobenius_norm",
    # the loss-scaling ops: the gray rule would cast the float32 Scale
    # to float16 (inf at 2^16) and zero every unscaled gradient
    "check_finite_and_unscale", "update_loss_scaling",
    # optimizer updates consume float32 master weights
    "sgd", "sgd_sparse", "momentum", "adam", "adam_sparse", "adamw",
    "adagrad", "decayed_adagrad", "rmsprop", "adadelta", "adamax",
    "lamb", "lars_momentum", "ftrl", "dpsgd",
})

# the batch_norm family (plain, sync and fused-activation share the math)
_BN_OPS = frozenset({"batch_norm", "sync_batch_norm",
                     "fused_batch_norm_act"})

# float16-only additions: batch statistics in float16 overflow (a
# variance past 65504 is inf); bfloat16 has float32's exponent range
AMP_BLACK_LIST_F16_EXTRA = _BN_OPS

# input slots the gray cast never touches: batch norm's running mean and
# variance accumulate in float32 (a bfloat16 round trip a step would hold
# them to 8 bits)
AMP_KEEP_F32_SLOTS = {op: frozenset({"Mean", "Variance"}) for op in _BN_OPS}

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}


def amp_torch_dtype(amp_dtype):
    """The torch dtype of a program's ``_amp_dtype`` (a name or a torch
    dtype)."""
    if isinstance(amp_dtype, torch.dtype):
        return amp_dtype
    try:
        return _DTYPES[str(amp_dtype)]
    except KeyError:
        raise ValueError(f"AMP dtype must be bfloat16 or float16, got "
                         f"{amp_dtype!r}") from None


def bn_bf16_enabled():
    """Whether batch_norm's normalisation may run in the AMP dtype:
    ``PADDLE_TPU_BN_BF16=0`` forces the family onto float32, as the JAX
    package reads it (read when a program is lowered)."""
    return os.environ.get("PADDLE_TPU_BN_BF16", "1") != "0"


def amp_runs_f32(op_type, amp_dtype):
    """The one decision point for "this op forces float32 under AMP";
    ``amp_dtype`` is a torch dtype or its name."""
    if op_type in AMP_BLACK_LIST:
        return True
    if amp_torch_dtype(amp_dtype) == torch.float16 \
            and op_type in AMP_BLACK_LIST_F16_EXTRA:
        return True
    if op_type in _BN_OPS and not bn_bf16_enabled():
        return True
    return False


def amp_cast(ins, op_type, amp_dtype):
    """An op's inputs ({slot: [tensors]}) under the policy (the JAX
    lowering's ``_amp_cast``): white-list ops take their floating inputs
    in ``amp_dtype``, black-list ops in float32, and gray ops in
    ``amp_dtype`` only when one floating input already is, so an
    elementwise chain after a product stays in the compute dtype.
    Slots in AMP_KEEP_F32_SLOTS keep their dtype."""
    amp_dtype = amp_torch_dtype(amp_dtype)
    keep_f32 = AMP_KEEP_F32_SLOTS.get(op_type, ())
    if op_type in AMP_WHITE_LIST:
        target = amp_dtype
    elif amp_runs_f32(op_type, amp_dtype):
        target = torch.float32
    else:
        target = amp_dtype
        if not any(torch.is_tensor(v) and v.dtype == target
                   for vals in ins.values() for v in vals):
            return ins
    return {slot: [v.to(target)
                   if torch.is_tensor(v) and v.is_floating_point()
                   and v.dtype != target and slot not in keep_f32 else v
                   for v in vals]
            for slot, vals in ins.items()}
