"""Predictor (counterpart of paddle_tpu/inference/predictor.py; parity:
AnalysisPredictor — inference/api/analysis_predictor.cc: Init loads the
frozen program, ZeroCopy tensors hold the inputs and outputs,
ZeroCopyRun :623 executes; CreatePaddlePredictor :898 is the factory).

The frozen program is lowered once per input-shape signature and the
lowering cached on the program (``program._exec_cache``), as the JAX
package caches one jitted executable per signature; the fusion pass
runs unless ``Config.switch_ir_optim(False)``.

``export_stablehlo``/``load_exported`` write and read the serving
artifact.  Where the JAX package writes a jax.export StableHLO module,
the port writes a ``torch.export`` program (``.pt2``): the lowered
block, traced with the fusion pass as the Predictor runs it, whose
fused groups are the kernels' ``torch.library`` operators
(ops/_library.py).  ``load_exported`` imports torch, numpy, the sidecar
reader and those operators, never the program IR, ``layers`` or
``models``."""
from __future__ import annotations

import json
import os

import numpy as np
import torch

__all__ = ["Predictor", "create_predictor", "load_exported"]

#: the artifact's own description, saved beside the program
#: (``torch.export.save(extra_files=...)``)
_META = "paddle_tpu_torch.json"


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
        if config._bf16:
            prog._amp_dtype = "bfloat16"
        self._program = prog
        #: what the Executor runs: the program, or with the analysis
        #: passes off the unfused lowering (a CompiledProgram without
        #: fuse_epilogues)
        self._runnable = prog
        if not config.ir_optim():
            from ..compiler import BuildStrategy, CompiledProgram

            bs = BuildStrategy()
            bs.fuse_epilogues = False
            self._runnable = CompiledProgram(prog, build_strategy=bs)
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
        outs = self._exe.run(self._runnable, feed=feed,
                             fetch_list=self._fetch_names, scope=self._scope)
        for n, v in zip(self._fetch_names, outs):
            self._outputs[n]._value = v
        return [np.asarray(v) for v in outs]

    # -- deployable artifact ----------------------------------------------
    def export_stablehlo(self, path, example_inputs=None,
                         bake_weights=True, write_sidecar=True):
        """Serialize the frozen model as a ``torch.export`` program
        (``.pt2``, whatever ``path``'s suffix): the save_inference_model
        analog whose consumer needs only torch and the kernels'
        operators (:func:`load_exported`).  The name and signature are
        the JAX package's, whose artifact is StableHLO.  Returns the
        path of the graph's text, written beside it (``<path>.txt``) for
        inspection.

        The traced function is the Predictor's own lowering of the
        program at ``example_inputs``' shapes (fixed: one artifact per
        input signature), fusion pass included, so the artifact runs
        the same kernels in the same order.  bake_weights=True keeps the
        weights inside the artifact as buffers.  bake_weights=False
        makes them arguments after the feeds and writes a
        ``<path>.weights/`` sidecar (manifest.json + one .bin per
        parameter, the JAX package's format): the program stays small
        for any model size.  ``write_sidecar=False`` keeps an existing
        sidecar, checked against this predictor's parameters before
        anything is written — re-exporting the SAME predictor at a new
        input shape."""
        from ..core.executor import fusion_knobs
        from ..core.lowering import lower_block

        if example_inputs is None:
            raise ValueError("export_stablehlo needs example_inputs "
                             "(dict name->array) to fix shapes")
        block = self._program.global_block()
        feed = {n: self._exe._feed_tensor(block, n, example_inputs[n])
                for n in self._feed_names}
        program, _, fuse, fuse_block = fusion_knobs(self._runnable)
        lowered = lower_block(program, 0, tuple(feed),
                              tuple(self._fetch_names), self._exe.device,
                              fuse_epilogues=fuse,
                              fuse_block_epilogues=fuse_block)
        params = {n: self._exe._from_scope(self._scope, block, n)
                  for n in (lowered.mut_param_names
                            + lowered.const_param_names)}

        sidecar = path + ".weights"
        if not bake_weights and not write_sidecar:
            # verify the reused sidecar BEFORE the trace and before any
            # file is written: a mismatch must not leave an unloadable
            # artifact/sidecar pair
            self._check_sidecar_matches(sidecar, params)

        module = _Frozen(lowered.fn, self._feed_names, params, bake_weights)
        args = tuple(feed[n] for n in self._feed_names)
        if not bake_weights:
            args += tuple(params[n] for n in module.weight_names)
        with torch.no_grad():
            exported = torch.export.export(module, args, strict=False)
        # the program keeps its example inputs, which would save the
        # unbaked weights into it: only shapes and dtypes are needed
        exported.example_inputs = None
        meta = {"feeds": list(self._feed_names),
                "fetches": list(self._fetch_names),
                "inputs": [str(a.dtype).replace("torch.", "") for a in args],
                "device": str(self._exe.device),
                "weights": None if bake_weights else module.weight_names}
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "wb") as f:      # any suffix, not only .pt2
            torch.export.save(exported, f,
                              extra_files={_META: json.dumps(meta)})
        text_path = path + ".txt"
        with open(text_path, "w") as f:
            f.write(str(exported.graph))
        if bake_weights:
            # a stale sidecar from a previous unbaked export at this
            # path would make load_exported pass spurious weights
            if os.path.isdir(sidecar):
                import shutil
                shutil.rmtree(sidecar)
        elif write_sidecar:
            from .sidecar import write_weight_sidecar
            write_weight_sidecar(sidecar, params)
        return text_path

    @staticmethod
    def _check_sidecar_matches(sidecar, params):
        """The sidecar at ``sidecar`` must hold exactly ``params``
        (same names, dtype codes, shapes) for a write_sidecar=False
        export to be loadable."""
        from .sidecar import code_of, weight_cli_entries

        if not os.path.isdir(sidecar):
            raise ValueError(
                f"export_stablehlo(write_sidecar=False) requires an "
                f"existing weight sidecar at '{sidecar}' (produced by a "
                f"previous bake_weights=False export of this predictor); "
                f"none found — export once with write_sidecar=True first")
        expected = {name: (code_of(v), tuple(v.shape))
                    for name, v in params.items()}
        try:
            entries = weight_cli_entries(sidecar)
        except (OSError, ValueError, KeyError) as e:
            raise ValueError(
                f"weight sidecar '{sidecar}' is unreadable ({e}); "
                f"re-export with write_sidecar=True") from e
        found = {name: (code, shape) for name, code, shape, _ in entries}
        if found != expected:
            missing = sorted(set(expected) - set(found))
            stale = sorted(set(found) - set(expected))
            changed = sorted(
                n for n in set(found) & set(expected)
                if found[n] != expected[n])
            raise ValueError(
                f"weight sidecar '{sidecar}' does not match this "
                f"predictor's parameters (missing: {missing or 'none'}, "
                f"stale: {stale or 'none'}, dtype/shape changed: "
                f"{changed or 'none'}); it belongs to a different "
                f"model — re-export with write_sidecar=True")


class _Frozen(torch.nn.Module):
    """The lowered block as a module: feeds positional in the predictor's
    order, then (unbaked) the weights in sorted-name order, the sidecar's
    argument order; baked, the weights are buffers ``w<i>`` in that
    order.  Seed 0: an inference program draws nothing (the JAX export
    passes PRNGKey(0))."""

    def __init__(self, fn, feed_names, params, baked):
        super().__init__()
        self._fn = fn
        self._feed_names = list(feed_names)
        self.weight_names = sorted(params)
        self._baked = baked
        if baked:
            for i, n in enumerate(self.weight_names):
                self.register_buffer(f"w{i}", params[n])

    def forward(self, *args):
        feeds = dict(zip(self._feed_names, args))
        if self._baked:
            weights = {n: getattr(self, f"w{i}")
                       for i, n in enumerate(self.weight_names)}
        else:
            weights = dict(zip(self.weight_names,
                               args[len(self._feed_names):]))
        fetches, _ = self._fn(feeds, {}, weights, 0)
        return tuple(fetches)


def create_predictor(config) -> Predictor:
    """Factory (parity: CreatePaddlePredictor,
    analysis_predictor.cc:898)."""
    return Predictor(config)


def load_exported(path):
    """Load an artifact of :meth:`Predictor.export_stablehlo`; returns a
    callable taking {name: array} and returning the fetch list (tensors
    on the artifact's device).  Needs only torch and the kernels'
    operators.  A bake_weights=False artifact (a ``<path>.weights/``
    sidecar exists) has its weights read and placed on the device once,
    here."""
    from ..ops import _library  # noqa: F401  (the operators' targets)
    from .sidecar import read_raw_array, weight_cli_entries

    extra = {_META: ""}
    with open(path, "rb") as f:
        exported = torch.export.load(f, extra_files=extra)
    meta = json.loads(extra[_META])
    module = exported.module()
    n_module_args = len(exported.graph_signature.user_inputs)
    device = torch.device(meta["device"])
    names = meta["feeds"]
    dtypes = [getattr(torch, d) for d in meta["inputs"]]

    def args_of(feeds):
        return [torch.as_tensor(np.asarray(feeds[n]) if not
                                torch.is_tensor(feeds[n]) else feeds[n])
                .to(device=device, dtype=dt)
                for n, dt in zip(names, dtypes)]

    def run(args):
        with torch.no_grad():
            return list(module(*args))

    weights_dir = path + ".weights"
    if os.path.isdir(weights_dir):
        # placed ONCE: serving must not re-upload the weight set per
        # request (the cost the sidecar design exists to avoid)
        weights = [torch.as_tensor(read_raw_array(b, code, shape))
                   for _, code, shape, b in weight_cli_entries(weights_dir)]
        if len(names) + len(weights) == n_module_args:
            weights = [w.to(device=device, dtype=dt) for w, dt in
                       zip(weights, dtypes[len(names):])]

        def call(feeds):
            n_feeds = len(feeds)
            if n_feeds + len(weights) != n_module_args:
                raise ValueError(
                    f"exported module '{path}' takes {n_module_args} "
                    f"arguments but got {n_feeds} feeds + "
                    f"{len(weights)} sidecar weights from "
                    f"'{weights_dir}' — the sidecar belongs to a "
                    f"different export; regenerate both together")
            return run(args_of(feeds) + weights)
    else:
        def call(feeds):
            # arity guard BEFORE torch: a bake_weights=False artifact
            # whose sidecar vanished would otherwise fail deep inside
            # the argument matching with an opaque error
            if len(feeds) != n_module_args:
                raise ValueError(
                    f"exported module '{path}' takes {n_module_args} "
                    f"inputs but got {len(feeds)} feeds; if it was "
                    f"exported with bake_weights=False, its weight "
                    f"sidecar '{weights_dir}' is missing — restore the "
                    f"sidecar directory next to the artifact or "
                    f"re-export with bake_weights=True")
            return run(args_of(feeds))

    return call
