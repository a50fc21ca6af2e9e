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
