"""Inference API (counterpart of paddle_tpu.inference; parity:
paddle/fluid/inference/ — AnalysisConfig + AnalysisPredictor +
CreatePaddlePredictor, inference/api/analysis_predictor.h:47/.cc:898,
ZeroCopyRun :623).

A frozen program (``io.save_inference_model``) is loaded once into a
``Predictor``, which runs it through the port's Executor: lowered once
per input-shape signature, the GEMM-epilogue fusion pass on, the
hand-written kernels on the card (``Config.disable_gpu()`` asks for the
CPU).  Zero-copy handles hold host arrays.  The JAX package's
framework-free artifact (``export_stablehlo``/``load_exported``, a
jax.export module) and its PJRT loader (``native_serving``) are not
ported (ROADMAP.md, Queue 1 item 4)."""
from .config import Config
from .predictor import Predictor, create_predictor, load_exported

AnalysisConfig = Config  # reference alias
create_paddle_predictor = create_predictor

__all__ = ["Config", "AnalysisConfig", "Predictor", "create_predictor",
           "create_paddle_predictor", "load_exported"]
