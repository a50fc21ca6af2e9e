"""Automatic mixed precision (counterpart of paddle_tpu/contrib/
mixed_precision; parity: fluid/contrib/mixed_precision/).

``decorate(optimizer)`` returns an OptimizerWithMixedPrecision whose
minimize() runs the model's matmul-class ops in bfloat16 (or float16,
with dynamic loss scaling) over float32 master weights: the lowering
applies the dtype policy of ``policy.py`` to every op's inputs, and the
fused groups run their kernels in the AMP dtype."""
from .decorator import OptimizerWithMixedPrecision, decorate  # noqa: F401
from .policy import AMP_BLACK_LIST, AMP_WHITE_LIST  # noqa: F401
