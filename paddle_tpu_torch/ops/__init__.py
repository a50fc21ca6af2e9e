"""Operators of the port (counterpart of paddle_tpu.ops).  ``attention``
holds the plain composite attention the LM and the CPU paths use;
``fused_matmul``, ``ffn_chain``, ``attention_epilogue`` and
``flash_attention`` are the kernels' wrappers (the fused groups of
core/fusion.py and the ``fused_attention`` op), ``_library`` their
``torch.library`` ops for an export trace.

Submodules load at first access.  :func:`register_all` imports the
modules that register program operators; importing ``core`` calls it,
so the kernel wrappers load without the program IR."""
import importlib

from .attention import attention, attention_packed

#: the modules whose import registers program operators
_REGISTERING = ("amp_ops", "decode", "fused", "manip", "math", "misc",
                "misc2", "moe", "nn", "optim", "random", "rnn", "sequence",
                "tensor")


def register_all():
    for name in _REGISTERING:
        importlib.import_module(f".{name}", __name__)


def __getattr__(name):
    try:
        module = importlib.import_module(f".{name}", __name__)
    except ModuleNotFoundError as e:
        if e.name != f"{__name__}.{name}":
            raise
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}") from None
    globals()[name] = module
    return module


__all__ = ["attention", "attention_packed", "register_all"]
