"""TracedLayer: capture a dygraph Layer into a static Program (parity:
python/paddle/fluid/dygraph/jit.py:111 TracedLayer — dygraph→static
capture for saving/inference).

Counterpart of paddle_tpu/dygraph/jit.py.  Every eager op flows through
engine.run_eager_op, so tracing mirrors each dispatched op into a
Program as OpDescs with the eager tensors' names (the analog of
imperative/jit program-desc tracing).  The traced program runs through
the port's Executor on the device the layer was traced on, with the
GEMM-epilogue fusion pass on as for any program: a traced encoder's
qkv projections, attention, residual norms and FFNs run as the fused
groups."""
from __future__ import annotations

import numpy as np
import torch

from ..core.program import Program
from ..core.scope import Scope
from . import base, engine
from .varbase import VarBase

__all__ = ["TracedLayer"]


class _TraceRecorder:
    def __init__(self):
        self.program = Program()
        self.param_values = {}  # static var name -> tensor snapshot
        self.known = set()

    def ensure_var(self, v: VarBase, is_input=False):
        if v.name in self.known:
            return
        blk = self.program.global_block()
        persistable = bool(getattr(v, "persistable", False))
        blk.create_var(
            name=v.name, shape=list(v.shape), dtype=v.dtype,
            persistable=persistable, is_data=is_input, stop_gradient=True)
        if persistable and v.value is not None:
            self.param_values[v.name] = v.value.detach().clone()
        self.known.add(v.name)

    def record(self, op_type, inputs, attrs, outputs):
        for vs in inputs.values():
            for v in vs:
                self.ensure_var(v)
        blk = self.program.global_block()
        for vs in outputs.values():
            for v in vs:
                if v.name not in self.known:
                    blk.create_var(name=v.name, shape=list(v.shape),
                                   dtype=v.dtype, stop_gradient=True)
                    self.known.add(v.name)
        blk.append_op(
            type=op_type,
            inputs={s: [v.name for v in vs] for s, vs in inputs.items()},
            outputs={s: [v.name for v in vs] for s, vs in outputs.items()},
            attrs=dict(attrs),
            infer_shape=False,
        )


class TracedLayer:
    """Returned by ``TracedLayer.trace(layer, inputs)``; runs the captured
    static program and supports save_inference_model."""

    def __init__(self, program, feed_names, fetch_names, param_values,
                 device=None):
        self.program = program
        self._device = device if device is not None else \
            base.current_device()
        self._feed_names = feed_names
        self._fetch_names = fetch_names
        self._scope = Scope()
        for name, val in param_values.items():
            self._scope.set_var(name, val)
        self._exe = None

    @classmethod
    def trace(cls, layer, inputs):
        """Run layer(*inputs) once in dygraph, mirroring ops into a
        Program.  Returns (dygraph_outputs, traced_layer)."""
        if not base.enabled():
            raise RuntimeError("TracedLayer.trace must run inside "
                               "dygraph.guard()")
        if engine._TRACER is not None:
            raise RuntimeError("nested TracedLayer.trace is not supported")
        inputs = [base.to_variable(x) for x in inputs]
        rec = _TraceRecorder()
        for x in inputs:
            rec.ensure_var(x, is_input=True)
        engine._TRACER = rec
        try:
            with base.no_grad():
                outs = layer(*inputs)
        finally:
            engine._TRACER = None
        out_list = list(outs) if isinstance(outs, (list, tuple)) else [outs]
        traced = cls(rec.program,
                     [x.name for x in inputs],
                     [o.name for o in out_list],
                     rec.param_values, base.current_device())
        return outs, traced

    def _executor(self):
        from ..core.executor import Executor
        from ..core.types import CPUPlace, CUDAPlace

        if self._exe is None:
            self._exe = Executor(
                CPUPlace() if self._device.type == "cpu"
                else CUDAPlace(self._device.index or 0))
        return self._exe

    def __call__(self, inputs):
        if base.enabled():
            # static execution under a dygraph guard: temporarily drop to
            # graph mode (the program is self-contained)
            base._set_mode(False)
            try:
                return self._run(inputs)
            finally:
                base._set_mode(True)
        return self._run(inputs)

    def _run(self, inputs):
        from ..core.scope import scope_guard

        exe = self._executor()
        inputs = list(inputs) if isinstance(inputs, (list, tuple)) \
            else [inputs]
        feed = {n: (x.value.detach() if isinstance(x, VarBase)
                    else x if torch.is_tensor(x) else np.asarray(x))
                for n, x in zip(self._feed_names, inputs)}
        with scope_guard(self._scope):
            return exe.run(self.program, feed=feed,
                           fetch_list=self._fetch_names)

    def save_inference_model(self, dirname, feed=None, fetch=None):
        """Save the traced program + params for serving (parity:
        TracedLayer.save_inference_model; fluid/io.py:1022)."""
        from .. import io
        from ..core.scope import scope_guard

        feed_names = [self._feed_names[i] for i in (
            feed if feed is not None else range(len(self._feed_names)))]
        fetch_vars = [self.program.global_block().var(self._fetch_names[i])
                      for i in (fetch if fetch is not None
                                else range(len(self._fetch_names)))]
        prev = base.enabled()
        base._set_mode(False)
        try:
            with scope_guard(self._scope):
                io.save_inference_model(
                    dirname, feed_names, fetch_vars, self._executor(),
                    main_program=self.program)
        finally:
            base._set_mode(prev)
