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
front end: build a program with ``layers``, take an eval program with
``clone(for_test=True)``, ``optimizer.AdamW(lr, grad_clip=clip.
GradientClipByGlobalNorm(1.0)).minimize(loss)`` (every dense optimizer,
``regularizer``, ``clip``, the ``layers`` learning-rate schedules), run
it with ``Executor`` or under ``resilience.ResilientLoop`` (atomic
checkpoints, auto-resume, NaN rollback), save and load with ``io``.
As in the JAX package the GEMM-epilogue fusion pass is on by default
(core/fusion.py: the fused matmul-epilogue, FFN-chain and qkv-folded
flash kernels); a ``CompiledProgram`` whose ``BuildStrategy`` sets
``fuse_epilogues = False`` runs the unfused lowering.  ``parallel``
holds named meshes over ``torch.distributed`` and sequence parallelism
(ring attention through the flat flash kernels, Ulysses).  ``observability`` (the metrics
registry, spans, the flight recorder, ledger, SLO and scrape modules) and
``profiler`` (host events plus a torch.profiler device trace) instrument
the engine, the server, the Executor and the fusion pass as in the JAX
package.  Control flow (``layers.While``, ``cond``, ``Switch``,
``StaticRNN``) runs its sub-blocks in the Executor, and ``inference``
serves a frozen program (``io.save_inference_model``) through a
``Predictor``, also behind ``serving.InferenceServer``.  Dataset-driven training: a
``DatasetFactory`` dataset (``QueueDataset``, ``InMemoryDataset``) of
MultiSlot text files, parsed by the native slot parser (``native/``),
local or remote (``fs``), drives ``Executor.train_from_dataset``
(core/trainer.py: chunks of K steps of one lowered block); ``DataLoader``
and ``DataFeeder`` feed ``Executor.run``; ``get_flags``/``set_flags``
hold ``FLAGS_check_nan_inf`` and ``FLAGS_benchmark``.  No Executor
meshes, sparse gradients or AMP yet.
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
    gradients,
    program_guard,
    scope_guard,
)
from .core import unique_name  # noqa: F401
from . import ops  # noqa: F401  (registers all operators)
from . import compiler, initializer, io, layers, optimizer  # noqa: F401
from . import clip, regularizer  # noqa: F401
from . import inference  # noqa: F401  (Config, Predictor)
from .compiler import BuildStrategy, CompiledProgram  # noqa: F401
from .param_attr import ParamAttr  # noqa: F401
from . import profiler  # noqa: F401
from . import resilience  # noqa: F401  (checkpoints, resilient train loop)
from . import observability  # noqa: F401  (metrics registry, span tracer)
from . import dataio, fs  # noqa: F401  (data pipeline, local/HDFS files)
from .data_feeder import DataFeeder  # noqa: F401
from .dataio import DataLoader  # noqa: F401
from .dataset import (DatasetFactory, InMemoryDataset,  # noqa: F401
                      QueueDataset)
from .flags import get_flags, set_flags  # noqa: F401

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
           "CompiledProgram", "gradients", "clip", "regularizer",
           "resilience", "inference", "fs", "dataio", "DataLoader",
           "DataFeeder", "DatasetFactory", "InMemoryDataset", "QueueDataset",
           "get_flags", "set_flags"]
