"""Operators of the port (counterpart of paddle_tpu.ops): importing this
package registers every ported op; ``attention`` holds the plain
composite attention the LM and the CPU paths use; ``fused_matmul``,
``ffn_chain`` and ``attention_epilogue`` are the fused groups' kernels
(core/fusion.py)."""
from . import (attention_epilogue, ffn_chain, flash_attention,  # noqa: F401
               fused_matmul, math, misc2, nn, optim, random,
               tensor)
from .attention import attention, attention_packed

__all__ = ["attention", "attention_packed"]
