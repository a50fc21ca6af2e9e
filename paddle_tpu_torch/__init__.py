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
Sparse (SelectedRows) gradients of ``layers.embedding(is_sparse=True)``
update through SGD and Adam (``lazy_mode``), the clips and the
regularizers; the wrappers ``RecomputeOptimizer``,
``GradientMergeOptimizer``, ``ExponentialMovingAverage``,
``ModelAverage``, ``LookaheadOptimizer`` and ``DGCMomentumOptimizer``
and the loss and metric layers are ported, and
``models.build_bert_pretrain(max_masked=...)`` builds the
masked-position head.
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
hold ``FLAGS_check_nan_inf`` and ``FLAGS_benchmark``.  A Predictor
exports its frozen program as a ``torch.export`` artifact that
``inference.load_exported`` runs without the program IR; ``fleet``
(autoscaler, supervisor, rolling swap) keeps a ``cluster`` of worker
processes serving, and ``tuning`` searches and distributes kernel
configurations (kernel #1's ``block_rows``, the FFN's fusion plan).
``CompiledProgram`` runs on meshes of ``torch.distributed`` ranks (data,
ZeRO-1, Megatron and expert rules, ``PipelineOptimizer``).
``distributed`` holds the native parameter server, GEO-SGD, the
collectives and the multi-process launcher, and ``incubate.fleet`` the
fleet's parameter-server and collective modes; ``contrib.
mixed_precision`` trains in bfloat16 or float16.  ``dygraph`` is the
imperative mode: ``dygraph.guard()``, ``VarBase`` over torch autograd,
``Layer`` and ``dygraph.nn``, the optimizers' eager ``minimize``,
``save_dygraph``/``load_dygraph``, ``TracedLayer``, ``to_static`` and
``DataParallel`` (like every subpackage, ``paddle_tpu_torch.dygraph``
loads at first access).  The sequence and recurrent tier takes a padded
batch plus a lengths tensor in place of LoD (``lod`` converts ragged
host data): the sequence ops and layers, ``lstm``/``gru`` and the fused
RNN ops, ``layers.dynamic_lstm``/``dynamic_gru``/``lstm``, and the
models ``seq2seq_*`` and ``word2vec_ngram``.
"""
import importlib

#: public names and the module each comes from.  They load at first
#: access (PEP 562): a process that only loads a serving artifact
#: (``inference.load_exported``) imports no Program, Executor, layers or
#: models, and a parameter-server process (``distributed.ps``) not even
#: torch.  Importing ``core`` registers every operator.
_LAZY = {
    "resolve_device": "._device", "set_strict_fp32": "._device",
    **dict.fromkeys((
        "CPUPlace", "CUDAPlace", "Executor", "Parameter", "Place",
        "Program", "Scope", "Variable", "append_backward", "data",
        "default_main_program", "default_startup_program",
        "global_scope", "gradients", "program_guard", "scope_guard",
        "unique_name"), ".core"),
    "BuildStrategy": ".compiler", "CompiledProgram": ".compiler",
    "ParamAttr": ".param_attr", "DataFeeder": ".data_feeder",
    "DataLoader": ".dataio", "DatasetFactory": ".dataset",
    "InMemoryDataset": ".dataset", "QueueDataset": ".dataset",
    "get_flags": ".flags", "set_flags": ".flags",
}


def __getattr__(name):
    target = _LAZY.get(name)
    if target is not None:
        value = getattr(importlib.import_module(target, __name__), name)
    else:
        try:
            value = importlib.import_module(f".{name}", __name__)
        except ModuleNotFoundError as e:
            if e.name != f"{__name__}.{name}":
                raise
            raise AttributeError(
                f"module {__name__!r} has no attribute {name!r}") from None
    globals()[name] = value
    return value


__version__ = "0.1.0"


def new_program_scope():
    """Fresh main/startup programs, scope and name generator (parity:
    fluid tests' new_program_scope)."""
    import contextlib

    from .core import Program, Scope, program_guard, scope_guard, \
        unique_name

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
           "get_flags", "set_flags", "dygraph", "lod"]
