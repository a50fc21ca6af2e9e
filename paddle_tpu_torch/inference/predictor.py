"""Predictor (counterpart of paddle_tpu/inference/predictor.py; parity:
AnalysisPredictor — inference/api/analysis_predictor.cc: Init loads the
frozen program, ZeroCopy tensors hold the inputs and outputs,
ZeroCopyRun :623 executes; CreatePaddlePredictor :898 is the factory).

The frozen program is lowered once per input-shape signature and the
lowering cached on the program (``program._exec_cache``), as the JAX
package caches one jitted executable per signature; the fusion pass
runs by default.  ``export_stablehlo``/``load_exported`` (the JAX
package's jax.export artifact) are not ported."""
from __future__ import annotations

import numpy as np

__all__ = ["Predictor", "create_predictor", "load_exported"]

_NO_EXPORT = (
    "the framework-free serving artifact (the JAX package's jax.export "
    "StableHLO module) is not ported to paddle_tpu_torch yet (ROADMAP.md, "
    "Queue 1 item 4; torch.export is the candidate counterpart); serve "
    "the save_inference_model directory through a Predictor instead")


class _Handle:
    """ZeroCopy tensor handle (parity: ZeroCopyTensor —
    inference/api/details/zero_copy_tensor.cc)."""

    def __init__(self, name):
        self.name = name
        self._value = None

    def copy_from_cpu(self, arr):
        self._value = np.ascontiguousarray(arr)

    def reshape(self, shape):
        # reference API sets the shape before copy; ours infers from the
        # array, so this is a no-op kept for compatibility
        pass

    def copy_to_cpu(self):
        if self._value is None:
            raise RuntimeError(f"output '{self.name}' not computed yet; "
                               f"call run() first")
        return np.asarray(self._value)


class Predictor:
    def __init__(self, config):
        from .. import io
        from ..core.executor import Executor
        from ..core.scope import Scope, scope_guard

        self._config = config
        self._scope = Scope()
        self._exe = Executor(config._place())
        dirname, model_fn, params_fn = config._resolved_location()
        with scope_guard(self._scope):
            prog, feeds, fetches = io.load_inference_model(
                dirname, self._exe, model_filename=model_fn,
                params_filename=params_fn)
        self._profiling = False
        self._program = prog
        self._feed_names = list(feeds)
        self._fetch_vars = fetches
        self._fetch_names = [f.name if hasattr(f, "name") else str(f)
                             for f in fetches]
        self._inputs = {n: _Handle(n) for n in self._feed_names}
        self._outputs = {n: _Handle(n) for n in self._fetch_names}

    # -- zero-copy style API ----------------------------------------------
    def get_input_names(self):
        return list(self._feed_names)

    def get_output_names(self):
        return list(self._fetch_names)

    def get_input_handle(self, name):
        return self._inputs[name]

    def get_input_tensor(self, name):  # v1.x alias
        return self._inputs[name]

    def get_output_handle(self, name):
        return self._outputs[name]

    def get_output_tensor(self, name):  # v1.x alias
        return self._outputs[name]

    def run(self, inputs=None):
        """Either positional (list of arrays aligned with
        get_input_names(), reference PaddlePredictor::Run) or zero-copy
        (handles filled via copy_from_cpu, then run())."""
        from .. import profiler as prof

        if inputs is not None:
            if len(inputs) != len(self._feed_names):
                raise ValueError(
                    f"run() got {len(inputs)} inputs but the model has "
                    f"{len(self._feed_names)} feeds "
                    f"{self._feed_names} (reference PaddlePredictor "
                    f"errors on count mismatch too)")
            for n, a in zip(self._feed_names, inputs):
                self._inputs[n].copy_from_cpu(a)
        feed = {}
        for n in self._feed_names:
            if self._inputs[n]._value is None:
                raise RuntimeError(
                    f"input '{n}' not set (copy_from_cpu it or pass "
                    f"arrays to run())")
            feed[n] = self._inputs[n]._value
        if self._config._profile and not self._profiling:
            # start once; stop_profiler() prints the aggregated report
            prof.start_profiler("All" if self._exe.device.type == "cuda"
                                else "CPU")
            self._profiling = True
        outs = self._exe.run(self._program, feed=feed,
                             fetch_list=self._fetch_names, scope=self._scope)
        for n, v in zip(self._fetch_names, outs):
            self._outputs[n]._value = v
        return [np.asarray(v) for v in outs]

    # -- deployable artifact ----------------------------------------------
    def export_stablehlo(self, path, example_inputs=None,
                         bake_weights=True, write_sidecar=True):
        """Not ported: the JAX package writes a jax.export module here."""
        raise NotImplementedError(_NO_EXPORT)


def create_predictor(config) -> Predictor:
    """Factory (parity: CreatePaddlePredictor,
    analysis_predictor.cc:898)."""
    return Predictor(config)


def load_exported(path):
    """Not ported: the JAX package loads its jax.export module here."""
    raise NotImplementedError(_NO_EXPORT)
