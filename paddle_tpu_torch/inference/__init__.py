"""Inference API (counterpart of paddle_tpu.inference; parity:
paddle/fluid/inference/ — AnalysisConfig + AnalysisPredictor +
CreatePaddlePredictor, inference/api/analysis_predictor.h:47/.cc:898,
ZeroCopyRun :623).

A frozen program (``io.save_inference_model``) is loaded once into a
``Predictor``, which runs it through the port's Executor: lowered once
per input-shape signature, the GEMM-epilogue fusion pass on, the
hand-written kernels on the card (``Config.disable_gpu()`` asks for the
CPU).  Zero-copy handles hold host arrays.

The framework-free artifact: ``Predictor.export_stablehlo`` writes a
``torch.export`` program of the lowered block (the JAX package writes a
jax.export module) whose fused groups are the kernels' ``torch.library``
operators, and ``load_exported`` runs it with torch and those operators
alone; an unbaked export's weights live in a sidecar of the JAX
package's format (``sidecar``).  The JAX package's PJRT loader and C++
CLI (``native_serving``) are the TPU's native path and have no
counterpart here."""
from .config import Config
from .predictor import Predictor, create_predictor, load_exported

AnalysisConfig = Config  # reference alias
create_paddle_predictor = create_predictor

__all__ = ["Config", "AnalysisConfig", "Predictor", "create_predictor",
           "create_paddle_predictor", "load_exported"]
