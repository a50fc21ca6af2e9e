"""Plain PyTorch operators of the port (counterpart of paddle_tpu.ops)."""
from .attention import attention_packed

__all__ = ["attention_packed"]
