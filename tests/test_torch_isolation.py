"""The port stands alone: no module of ``paddle_tpu_torch`` and nothing in
``chip_smoke.py`` imports ``jax`` or the JAX package ``paddle_tpu``, and
its entry points run on the card unless the caller asks for the CPU.
"""
import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu_torch
from paddle_tpu_torch import resolve_device
from paddle_tpu_torch.generation import GenerationEngine
from paddle_tpu_torch.models import BertConfig, lm_random_params

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "paddle_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "paddle_tpu")


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_module_imports_jax_or_the_jax_package(path):
    roots = set(_imported_roots(ast.parse(path.read_text(), str(path))))
    assert not roots & set(FORBIDDEN), (path, roots & set(FORBIDDEN))


def test_importing_the_whole_port_leaves_jax_out():
    modules = sorted(
        "paddle_tpu_torch." + ".".join(p.relative_to(PORT).with_suffix("")
                                       .parts).replace(".__init__", "")
        for p in PORT.rglob("*.py"))
    code = ("import importlib, sys\n"
            f"for m in {modules!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', "
            "'paddle_tpu'))\n"
            "print(len(sys.modules), bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_entry_points_default_to_the_card():
    cfg = BertConfig.tiny()
    params = lm_random_params(cfg, np.random.RandomState(0))
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        GenerationEngine(cfg, params)
    with pytest.raises(RuntimeError, match="CUDA"):
        GenerationEngine(cfg, params, device="cuda")
    engine = GenerationEngine(cfg, params, device="cpu")
    assert engine.device.type == "cpu"
    assert all(t.device.type == "cpu" for t in engine.params.values())
    assert engine.cache.k.device.type == "cpu"


def test_strict_fp32_is_stated():
    paddle_tpu_torch.set_strict_fp32()
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"
