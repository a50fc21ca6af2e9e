"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu, for NVIDIA
Hopper (H100).

The JAX package ``paddle_tpu`` is the reference this package is held
against; this one imports neither it nor ``jax``.  Modules keep the
reference's structure and names (``core``, ``layers``, ``optimizer``,
``generation``, ``serving``, ``models``, ``ops``); inside they use
PyTorch's idiom: tensors, an explicit ``device``, explicit random state.
Every TPU kernel on a ported path becomes a kernel written by hand for
sm_90a under ``csrc/``, built with ``nvcc`` at first use (``_cuda``).

Ported so far: the serving path — ``generation.GenerationEngine`` (chunked
and legacy scheduling, paged / dense / prefix caches, speculation) and
``serving.InferenceServer`` — and training through the Program/Executor
front end: build a program with ``layers``, ``optimizer.Adam(lr)
.minimize(loss)``, run it with ``Executor``.  As in the JAX package the
GEMM-epilogue fusion pass is on by default (core/fusion.py: the fused
matmul-epilogue, FFN-chain and qkv-folded flash kernels); a
``CompiledProgram`` whose ``BuildStrategy`` sets ``fuse_epilogues =
False`` runs the unfused lowering.  ``parallel`` holds named meshes over
``torch.distributed`` and sequence parallelism (ring attention through
the flat flash kernels, Ulysses).  ``observability`` (the metrics
registry, spans, the flight recorder, ledger, SLO and scrape modules) and
``profiler`` (host events plus a torch.profiler device trace) instrument
the engine, the server, the Executor and the fusion pass as in the JAX
package.  No control flow, Executor meshes or AMP yet.
"""
from ._device import resolve_device, set_strict_fp32
from .core import (  # noqa: F401
    CPUPlace,
    CUDAPlace,
    Executor,
    Parameter,
    Place,
    Program,
    Scope,
    Variable,
    append_backward,
    data,
    default_main_program,
    default_startup_program,
    global_scope,
    program_guard,
    scope_guard,
)
from .core import unique_name  # noqa: F401
from . import ops  # noqa: F401  (registers all operators)
from . import compiler, initializer, io, layers, optimizer  # noqa: F401
from .compiler import BuildStrategy, CompiledProgram  # noqa: F401
from .param_attr import ParamAttr  # noqa: F401
from . import profiler  # noqa: F401
from . import resilience  # noqa: F401  (the atomic file-write protocol)
from . import observability  # noqa: F401  (metrics registry, span tracer)

__version__ = "0.1.0"


def new_program_scope():
    """Fresh main/startup programs, scope and name generator (parity:
    fluid tests' new_program_scope)."""
    import contextlib

    @contextlib.contextmanager
    def _guard():
        with scope_guard(Scope()):
            with program_guard(Program(), Program()):
                with unique_name.guard():
                    yield

    return _guard()


__all__ = ["resolve_device", "set_strict_fp32", "__version__",
           "Executor", "CPUPlace", "CUDAPlace", "Place", "Program",
           "Parameter", "Variable", "Scope", "data", "default_main_program",
           "default_startup_program", "global_scope", "program_guard",
           "scope_guard", "append_backward", "unique_name",
           "layers", "optimizer", "initializer", "io", "ParamAttr",
           "new_program_scope", "compiler", "BuildStrategy",
           "CompiledProgram"]
