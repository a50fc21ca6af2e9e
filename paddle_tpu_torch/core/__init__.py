"""Core of the port: program IR, scope, lowering, executor, autodiff
(counterpart of paddle_tpu.core)."""
from .backward import append_backward, gradients  # noqa: F401
from .executor import Executor  # noqa: F401
from .program import (  # noqa: F401
    Block,
    Operator,
    Parameter,
    Program,
    Variable,
    data,
    default_main_program,
    default_startup_program,
    program_guard,
)
from .registry import REGISTRY, OpContext, register_op  # noqa: F401
from .scope import Scope, global_scope, scope_guard  # noqa: F401
from .types import CPUPlace, CUDAPlace, Place  # noqa: F401

# every operator registers itself when its module loads; the IR and the
# lowering need all of them, and the kernel modules stand apart from the
# IR (``inference.load_exported`` imports them without ``core``)
from ..ops import register_all as _register_all  # noqa: E402

_register_all()
