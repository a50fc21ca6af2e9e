"""Device resolution and float32 matmul settings for the port.

Entry points run on the card unless the caller asks for the CPU:
``resolve_device(None)`` is ``cuda`` and raises when no CUDA device is
visible.  There is no silent move to the CPU — tests pass
``device="cpu"`` explicitly.

Matmuls stay in full float32: TF32 is switched off for both cuBLAS and
cuDNN whenever a CUDA device is resolved, so the card computes the same
arithmetic the JAX reference does on the CPU (up to summation order).
bfloat16 and float16 matmuls (AMP's products outside the fused groups)
sum in float32: cuBLAS's reduced-precision reductions are switched off,
as the JAX dots reduce with ``preferred_element_type=float32``.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device", "set_strict_fp32"]


def set_strict_fp32():
    """Full-precision float32 matmuls and convolutions (no TF32), and
    bfloat16/float16 matmuls that reduce in float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(device=None):
    """``None`` -> the first CUDA device, or RuntimeError when there is
    none.  An explicit device is returned as a ``torch.device``; asking
    for CUDA without a card raises the same way."""
    if device is None:
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "paddle_tpu_torch runs on a CUDA device by default and "
                "none is available; pass device='cpu' to run the plain "
                "PyTorch path on the CPU")
        set_strict_fp32()
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    return device
