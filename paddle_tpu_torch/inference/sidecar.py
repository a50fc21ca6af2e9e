"""The weights-as-arguments sidecar of an exported artifact.

Counterpart of the sidecar helpers of paddle_tpu/inference/
native_serving.py (``write_weight_sidecar``, ``weight_cli_entries``,
``read_raw_array``, ``_DTYPE_TO_CODE``, ``_lowered_dtype``), byte for
byte the same format: a ``manifest.json`` (a list of ``{"name",
"dtype", "shape", "file"}`` in argument order, the sorted parameter
names) and one raw ``w<i>.bin`` per parameter, int64 narrowed to int32.
Either package reads the other's sidecar.

The JAX module's PJRT loader, its C++ CLI and ``export_train_step`` are
the TPU's native serving path and have no counterpart here.  This module
imports numpy only (torch for a bfloat16 entry).
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np

__all__ = ["write_weight_sidecar", "weight_cli_entries", "read_raw_array",
           "dtype_code", "code_of", "host_words"]

_DTYPE_TO_CODE = {"float32": "f32", "int32": "s32", "int64": "s64",
                  "bool": "pred", "bfloat16": "bf16"}
_CODE_TO_DTYPE = {"f32": np.float32, "s32": np.int32, "s64": np.int64,
                  "pred": np.bool_, "bf16": np.uint16}  # bf16: raw bits


def _lowered_dtype(dt):
    """The dtype an argument of the artifact's sidecar is stored as:
    int64 narrows to int32 (the JAX package's x64-off contract, kept so
    the files are the same)."""
    return np.int32 if np.dtype(dt) == np.int64 else np.dtype(dt)


def dtype_code(dt):
    """The manifest's dtype code of an array of dtype ``dt`` once
    lowered."""
    return _DTYPE_TO_CODE[str(np.dtype(_lowered_dtype(dt)))]


def code_of(value):
    """The manifest code a parameter (numpy array or tensor) is stored
    under, without copying it."""
    name = str(value.dtype).replace("torch.", "")
    return "bf16" if name == "bfloat16" else dtype_code(name)


def host_words(value):
    """(numpy array, manifest code) of one parameter as the sidecar
    stores it: a bfloat16 tensor as its raw 16-bit words (code "bf16"),
    anything else as a numpy array, int64 narrowed to int32."""
    if str(getattr(value, "dtype", "")) == "torch.bfloat16":
        import torch

        words = value.detach().cpu().contiguous().view(torch.int16)
        return words.numpy().view(np.uint16), "bf16"
    if hasattr(value, "detach"):
        value = value.detach().cpu().numpy()
    arr = np.ascontiguousarray(np.asarray(value))
    if arr.dtype == np.int64:
        arr = arr.astype(np.int32)   # x64-off lowering contract
    return arr, _DTYPE_TO_CODE[str(arr.dtype)]


def write_weight_sidecar(weights_dir, params):
    """Write {name: array} as the weights-as-arguments sidecar:
    manifest.json (argument ORDER = sorted names) + one raw .bin per
    parameter (``host_words``: numpy arrays or tensors; bfloat16 as raw
    16-bit words).  An existing sidecar at this path is REPLACED
    wholesale — stale w*.bin files from a bigger previous export must not
    linger."""
    if os.path.isdir(weights_dir):
        shutil.rmtree(weights_dir)
    os.makedirs(weights_dir)
    manifest = []
    for i, name in enumerate(sorted(params)):
        arr, code = host_words(params[name])
        fn = f"w{i}.bin"
        arr.tofile(os.path.join(weights_dir, fn))
        manifest.append({"name": name, "dtype": code,
                         "shape": list(arr.shape), "file": fn})
    with open(os.path.join(weights_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)


def weight_cli_entries(weights_dir):
    """Read a weight sidecar back as entries [(name, code, shape,
    bin_path)] in argument order."""
    with open(os.path.join(weights_dir, "manifest.json")) as f:
        manifest = json.load(f)
    return [(e["name"], e["dtype"], tuple(e["shape"]),
             os.path.join(weights_dir, e["file"])) for e in manifest]


def read_raw_array(bin_path, code, shape):
    """Read one raw .bin of a sidecar.  bf16 is stored as raw 16-bit
    words and must be reinterpreted, never handed to callers as uint16:
    it comes back as a torch.bfloat16 tensor (numpy has no bfloat16);
    every other code as a numpy array."""
    arr = np.fromfile(bin_path, _CODE_TO_DTYPE[code]).reshape(shape)
    if code == "bf16":
        import torch

        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return arr
