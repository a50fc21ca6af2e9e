"""Operators of the port (counterpart of paddle_tpu.ops): importing this
package registers every ported op; ``attention`` holds the plain
composite attention the LM and the CPU paths use."""
from . import flash_attention, math, nn, optim, random, tensor  # noqa: F401
from .attention import attention, attention_packed

__all__ = ["attention", "attention_packed"]
