"""The port stands alone: no module of ``paddle_tpu_torch`` and nothing in
``chip_smoke.py`` imports ``jax`` or the JAX package ``paddle_tpu``, and
its entry points run on the card unless the caller asks for the CPU.
"""
import ast
import os
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


def test_executor_defaults_to_the_card():
    """``Executor()`` and ``Executor(CUDAPlace(0))`` run on the card and
    raise without one; ``Executor(CPUPlace())`` runs a program here."""
    if torch.cuda.is_available():
        assert paddle_tpu_torch.Executor().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        paddle_tpu_torch.Executor()
    with pytest.raises(RuntimeError, match="CUDA"):
        paddle_tpu_torch.Executor(paddle_tpu_torch.CUDAPlace(0))
    pt = paddle_tpu_torch
    with pt.new_program_scope():
        x = pt.data("x", [None, 3])
        y = pt.layers.fc(x, 2)
        exe = pt.Executor(pt.CPUPlace())
        exe.run(pt.default_startup_program())
        (got,) = exe.run(feed={"x": np.ones((4, 3), np.float32)},
                         fetch_list=[y])
    assert got.shape == (4, 2) and exe.device.type == "cpu"


def test_strict_fp32_is_stated():
    paddle_tpu_torch.set_strict_fp32()
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_parallel_stands_alone_and_defaults_to_the_card(tmp_path):
    """``paddle_tpu_torch.parallel`` imports no JAX, ``build_mesh`` is a
    CUDA (NCCL) mesh unless the caller asks for the CPU (gloo), and the
    one-rank ring is plain attention.  In a subprocess, so the process
    group it starts stays out of this one."""
    code = f"""
import sys
import torch
import torch.distributed as dist
from paddle_tpu_torch.ops.attention import attention
from paddle_tpu_torch.parallel import (build_mesh, ring_attention,
                                       single_device_mesh, ulysses_attention)
assert not [m for m in sys.modules if m.split('.')[0] in
            ('jax', 'jaxlib', 'paddle_tpu')]
dist.init_process_group("gloo", store=dist.FileStore({str(tmp_path / 's')!r},
                        1), rank=0, world_size=1)
if not torch.cuda.is_available():
    try:
        build_mesh({{"seq": 1}})
        raise SystemExit("build_mesh ran without a card")
    except RuntimeError as e:
        assert "CUDA" in str(e), e
mesh = build_mesh({{"data": 1, "seq": -1}}, device_type="cpu")
assert mesh.mesh_dim_names == ("data", "seq")
assert single_device_mesh("cpu").mesh_dim_names == ("data",)
g = torch.Generator().manual_seed(0)
q, k, v = (torch.randn(2, 4, 32, 8, generator=g) for _ in range(3))
for causal in (False, True):
    want = attention(q, k, v, causal=causal)
    for fn in (ring_attention, ulysses_attention):
        got = fn(q, k, v, mesh=mesh, axis="seq", causal=causal)
        torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-4)
dist.destroy_process_group()
print("ok")
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and "ok" in proc.stdout, \
        proc.stdout + proc.stderr


PS_TIER = ("paddle_tpu_torch.native", "paddle_tpu_torch.distributed",
           "paddle_tpu_torch.distributed.ps",
           "paddle_tpu_torch.distributed.ps_sharded",
           "paddle_tpu_torch.distributed.geo",
           "paddle_tpu_torch.distributed.collectives",
           "paddle_tpu_torch.distributed.launch",
           "paddle_tpu_torch.distributed.allreduce_bench",
           "paddle_tpu_torch.incubate",
           "paddle_tpu_torch.incubate.fleet.base",
           "paddle_tpu_torch.incubate.fleet.parameter_server",
           "paddle_tpu_torch.incubate.fleet.collective",
           "paddle_tpu_torch.incubate.fleet.collective.local_sgd",
           "paddle_tpu_torch.incubate.fleet.utils")


def test_the_ps_tier_imports_no_jax():
    """The parameter-server tier's modules, imported without the rest of
    the port in a fresh process (as the pserver child and the launcher's
    ranks start), leave JAX and the JAX package out."""
    code = ("import importlib, sys\n"
            f"for m in {PS_TIER!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', "
            "'paddle_tpu'))\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_the_pserver_child_sees_no_card(monkeypatch):
    """``PSServerProcess`` starts the port's server (never the JAX
    package's) with no card visible, and sets no JAX variable."""
    from paddle_tpu_torch.distributed import ps

    seen = {}

    class Popen:
        def __init__(self, cmd, env):
            seen.update(cmd=cmd, env=env)

    monkeypatch.setattr(ps, "get_ps_server", lambda: None)
    monkeypatch.setattr(ps.subprocess, "Popen", Popen)
    ps.PSServerProcess(1234, num_tables=2, dim=8)
    assert seen["env"]["CUDA_VISIBLE_DEVICES"] == ""
    assert not any(k.startswith("JAX_") and k not in os.environ
                   for k in seen["env"])
    assert "from paddle_tpu_torch.distributed.ps import serve_forever" \
        in seen["cmd"][2]
    assert "paddle_tpu." not in seen["cmd"][2]
    # the child's import line loads neither JAX nor torch
    monkeypatch.undo()
    line = seen["cmd"][2].split(";")[0]
    proc = subprocess.run(
        [sys.executable, "-c", line + "\nimport sys\nsys.exit(sorted(m for m "
         "in sys.modules if m.split('.')[0] in ('jax', 'paddle_tpu', "
         "'torch')) != [])"], cwd=ROOT, capture_output=True, text=True,
        timeout=60)
    assert proc.returncode == 0, proc.stdout + proc.stderr
