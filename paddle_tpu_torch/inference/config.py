"""Config (counterpart of paddle_tpu/inference/config.py; parity:
AnalysisConfig — inference/api/paddle_analysis_config.h).

The device is the card (``cuda:0``) unless the caller asks otherwise:
``enable_use_gpu(device_id=N)`` picks ``cuda:N`` and ``disable_gpu()``
the CPU.  ``enable_bfloat16`` runs the program under bfloat16 AMP (its
fused groups through the kernels' bfloat16 variants), as the JAX
package's Predictor does.  ``enable_mkldnn`` and the thread count are
accepted and do nothing, as in the JAX package;
``enable_tensorrt_engine`` raises."""
from __future__ import annotations

import os

__all__ = ["Config"]


class Config:
    def __init__(self, model_dir=None, prog_file=None, params_file=None):
        self._model_dir = model_dir
        self._prog_file = prog_file
        self._params_file = params_file
        self._ir_optim = True
        self._profile = False
        self._bf16 = False
        self._memory_optim = True
        self._use_gpu = True
        self._device_id = 0

    # -- model location (AnalysisConfig::SetModel) -------------------------
    def set_model(self, a, b=None):
        if b is None:
            self._model_dir = a
        else:
            self._prog_file, self._params_file = a, b

    def model_dir(self):
        return self._model_dir

    def prog_file(self):
        return self._prog_file

    def params_file(self):
        return self._params_file

    # -- optimization knobs ------------------------------------------------
    def switch_ir_optim(self, x=True):
        # off: the Predictor runs (and exports) the unfused lowering
        self._ir_optim = bool(x)

    def ir_optim(self):
        return self._ir_optim

    def enable_memory_optim(self):
        self._memory_optim = True

    def enable_profile(self):
        self._profile = True

    def enable_bfloat16(self):
        """Low-precision inference: the Predictor runs its program under
        bfloat16 AMP (``program._amp_dtype``)."""
        self._bf16 = True

    # -- placement ---------------------------------------------------------
    def enable_use_gpu(self, memory_pool_init_size_mb=100, device_id=0):
        self._use_gpu = True
        self._device_id = int(device_id)

    def disable_gpu(self):
        self._use_gpu = False

    def _place(self):
        """The Executor's place: the card unless ``disable_gpu()``."""
        from ..core.types import CPUPlace, CUDAPlace

        return CUDAPlace(self._device_id) if self._use_gpu else CPUPlace()

    # -- accepted no-ops for reference API compatibility -------------------
    def enable_mkldnn(self):
        pass

    def set_cpu_math_library_num_threads(self, n):
        pass

    def enable_tensorrt_engine(self, *args, **kwargs):
        raise NotImplementedError(
            "TensorRT is not part of paddle_tpu_torch: the fusion pass and "
            "the hand-written kernels play its role — remove "
            "enable_tensorrt_engine from the config")

    def _resolved_location(self):
        """Returns (dirname, model_filename, params_filename) for
        io.load_inference_model, handling both set_model forms."""
        if self._prog_file is not None:
            if not os.path.isfile(self._prog_file):
                raise ValueError(
                    f"Config.set_model: program file "
                    f"'{self._prog_file}' does not exist")
            if self._params_file is not None and \
                    not os.path.isfile(self._params_file):
                raise ValueError(
                    f"Config.set_model: params file "
                    f"'{self._params_file}' does not exist")
            dirname = os.path.dirname(self._prog_file) or "."
            # pass the params path ABSOLUTE so a different directory
            # still resolves (os.path.join ignores dirname then)
            params = os.path.abspath(self._params_file) \
                if self._params_file else None
            return dirname, os.path.basename(self._prog_file), params
        d = self._model_dir
        if d is None or not os.path.isdir(d):
            raise ValueError(
                f"Config.set_model: '{d}' is not a saved-model directory "
                f"(save with io.save_inference_model)")
        return d, None, None
