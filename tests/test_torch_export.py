"""The port's serving artifact (``Predictor.export_stablehlo`` /
``inference.load_exported``: a ``torch.export`` program) against the JAX
package's (a jax.export StableHLO module), on the CPU.

* The same saved model through both packages' export and load gives the
  same outputs within 1e-5 (the JAX package's own tolerance): the fc
  model of ``tests/test_inference.py`` (baked and unbaked), and BERT-tiny's
  ``build_lm_logits`` through the fusion pass (the JAX package's Pallas
  kernels in interpret mode at hidden 128, as its own tests run them;
  its logits, of order 4, within 1e-5 of their scale).
* The exported graph holds one ``paddle_tpu_torch::`` operator per fused
  group (#9, #10, #11 a layer) and, with the analysis passes off, #3 a
  layer; outside an export trace no operator is dispatched (the eager
  path calls the launch functions directly); inside one
  ``torch.compiler.is_exporting()`` reads True.
* The sidecar is one format: the JAX ``weight_cli_entries`` reads the
  port's sidecar and the port's reads the JAX package's (bf16 included).
* The JAX package's checks carry over: a missing sidecar is named at the
  call, a foreign one is refused at load and at a write_sidecar=False
  export, a baked re-export removes a stale one.
* A fresh process loads and runs an artifact without importing the
  program IR, ``layers`` or ``models``.
"""
import dataclasses
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as pt
from paddle_tpu import inference as jinference
from paddle_tpu.inference import native_serving as jns
from paddle_tpu_torch import inference
from paddle_tpu_torch.inference import sidecar

#: the JAX package's own check, np.allclose(got, want, atol=1e-5) (its
#: default rtol 1e-5 included)
ATOL = RTOL = 1e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def saved_model(tmp_path_factory):
    """The fc model of test_inference.py, saved by the JAX package."""
    d = str(tmp_path_factory.mktemp("m") / "model")
    with jpt.new_program_scope():
        main, startup = jpt.Program(), jpt.Program()
        startup.random_seed = 3
        with jpt.program_guard(main, startup):
            x = jpt.data("x", [None, 4])
            h = jpt.layers.fc(x, 8, act="relu")
            y = jpt.layers.fc(h, 2, act="softmax")
        exe, scope = jpt.Executor(), jpt.Scope()
        with jpt.scope_guard(scope):
            exe.run(startup)
            jpt.io.save_inference_model(d, ["x"], [y], exe,
                                        main_program=main)
    xv = np.random.RandomState(0).rand(5, 4).astype(np.float32)
    return d, xv


def _predictor(d, ir_optim=True):
    cfg = inference.Config(d)
    cfg.disable_gpu()
    cfg.switch_ir_optim(ir_optim)
    return inference.create_predictor(cfg)


def _jax_call(d, path, feeds, bake):
    pred = jinference.create_predictor(jinference.Config(d))
    pred.export_stablehlo(path, example_inputs=feeds, bake_weights=bake)
    return [np.asarray(o) for o in
            jinference.predictor.load_exported(path)(feeds)]


@pytest.mark.parametrize("bake", [True, False], ids=["baked", "unbaked"])
def test_fc_artifact_matches_the_jax_artifact(saved_model, tmp_path, bake):
    d, xv = saved_model
    pred = _predictor(d)
    want, = pred.run([xv])
    path = str(tmp_path / "m.stablehlo")
    text = pred.export_stablehlo(path, example_inputs={"x": xv},
                                 bake_weights=bake)
    assert text == path + ".txt" and os.path.isfile(text)
    assert os.path.isdir(path + ".weights") is (not bake)
    got, = inference.load_exported(path)({"x": xv})
    jax_out, = _jax_call(d, str(tmp_path / "j.stablehlo"), {"x": xv}, bake)
    np.testing.assert_allclose(got.numpy(), jax_out, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got.numpy(), want)


def _lm_cfg():
    from paddle_tpu_torch.models import BertConfig

    return dataclasses.replace(BertConfig.tiny(), hidden_size=128,
                               num_heads=4, ffn_size=256, hidden_dropout=0.0,
                               attn_dropout=0.0, initializer_range=0.2)


@pytest.fixture(scope="module")
def saved_lm(tmp_path_factory):
    """BERT-tiny's build_lm_logits at [2, 16], hidden 128, saved by the
    port (the JAX package reads the format)."""
    from paddle_tpu_torch.models import build_lm_logits

    d = str(tmp_path_factory.mktemp("lm") / "logits")
    cfg = _lm_cfg()
    main, startup = pt.Program(), pt.Program()
    startup.random_seed = 7
    with pt.program_guard(main, startup), pt.unique_name.guard():
        src = pt.data("src_ids", [2, 16], "int64")
        out = build_lm_logits(src, cfg)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    with pt.scope_guard(scope):
        pt.io.save_inference_model(d, ["src_ids"], [out], exe,
                                   main_program=main)
    ids = np.random.RandomState(1).randint(
        0, cfg.vocab_size, (2, 16)).astype(np.int64)
    return d, ids, cfg


def test_lm_artifact_matches_the_jax_artifact(saved_lm, tmp_path,
                                              monkeypatch):
    d, ids, cfg = saved_lm
    pred = _predictor(d)
    want, = pred.run([ids])
    path = str(tmp_path / "lm.pt2")
    text = open(pred.export_stablehlo(path, example_inputs={"src_ids": ids})
                ).read()
    got, = inference.load_exported(path)({"src_ids": ids})
    np.testing.assert_array_equal(got.numpy(), want)
    # one operator per fused group: the plan is #9, #10, #11 a layer
    L = cfg.num_layers
    plan = next(iter(pred._program._exec_cache.values())).fusion_plan
    assert sorted(g.kind for g in plan.groups) == sorted(
        ["attn", "gemm", "ffn_chain"] * L)
    counts = {k: text.count(f"paddle_tpu_torch.{k}.default") for k in (
        "flash_kernel_forward_qkv", "fused_matmul_kernel",
        "ffn_chain_kernel", "flash_kernel_forward")}
    assert counts == {"flash_kernel_forward_qkv": L,
                      "fused_matmul_kernel": L, "ffn_chain_kernel": L,
                      "flash_kernel_forward": 0}
    monkeypatch.setenv("PADDLE_TPU_FUSED_MATMUL_INTERPRET", "1")
    jax_out, = _jax_call(d, str(tmp_path / "lm.stablehlo"),
                         {"src_ids": ids}, True)
    # logits of order 4: 1e-5 of the array's scale (the two packages sum
    # in different f32 orders), as tests/test_torch_handoff.py holds K/V
    scale = float(np.abs(jax_out).max())
    np.testing.assert_allclose(got.numpy(), jax_out, rtol=0,
                               atol=ATOL * scale)


def test_unfused_export_holds_the_packed_flash_forward(saved_lm, tmp_path):
    """Config.switch_ir_optim(False): the unfused lowering, whose
    attention is #3 a layer, in the artifact and in the Predictor."""
    d, ids, cfg = saved_lm
    pred = _predictor(d, ir_optim=False)
    want, = pred.run([ids])
    assert all(lw.fusion_plan is None
               for lw in pred._program._exec_cache.values())
    path = str(tmp_path / "unfused.pt2")
    text = open(pred.export_stablehlo(path, example_inputs={"src_ids": ids})
                ).read()
    assert text.count("paddle_tpu_torch.flash_kernel_forward.default") \
        == cfg.num_layers
    for k in ("flash_kernel_forward_qkv", "fused_matmul_kernel",
              "ffn_chain_kernel"):
        assert f"paddle_tpu_torch.{k}." not in text
    got, = inference.load_exported(path)({"src_ids": ids})
    np.testing.assert_array_equal(got.numpy(), want)
    fused, = _predictor(d).run([ids])
    np.testing.assert_allclose(got.numpy(), fused, rtol=RTOL, atol=ATOL)


def test_is_exporting_holds_only_inside_the_trace():
    seen = []

    class M(torch.nn.Module):
        def forward(self, x):
            seen.append(torch.compiler.is_exporting())
            return x + 1

    assert not torch.compiler.is_exporting()
    torch.export.export(M(), (torch.ones(2),), strict=False)
    assert seen and all(seen)
    assert not torch.compiler.is_exporting()


def test_the_eager_path_dispatches_no_operator(saved_lm, monkeypatch):
    """Outside an export trace the wrappers never reach the
    torch.library operators (the host-bound steps pay no dispatch)."""
    from paddle_tpu_torch.ops import _library

    def trap(*a, **k):
        raise AssertionError("an operator dispatched on the eager path")

    for name in ("flash_forward", "flash_forward_qkv", "fused_matmul",
                 "ffn_chain"):
        monkeypatch.setattr(_library, name, trap)
    d, ids, _ = saved_lm
    out, = _predictor(d).run([ids])
    assert np.isfinite(out).all()


@pytest.mark.parametrize("op,impl", [
    ("fused_matmul_kernel", "reference_matmul_epilogue"),
    ("ffn_chain_kernel", "reference_ffn_chain")])
def test_operators_run_the_plain_version_on_the_cpu(op, impl):
    from paddle_tpu_torch.ops import _library  # noqa: F401
    from paddle_tpu_torch.ops import ffn_chain as fc
    from paddle_tpu_torch.ops import fused_matmul as fm

    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(8, 16).astype(np.float32))
    w1 = torch.from_numpy(rng.randn(16, 128).astype(np.float32))
    w2 = torch.from_numpy(rng.randn(128, 16).astype(np.float32))
    b = torch.from_numpy(rng.randn(128).astype(np.float32))
    ep = (0, "gelu", False, 0.0, "layer_norm", 1e-5)
    spec = fm.EpilogueSpec(act="gelu", norm="layer_norm")
    ops = torch.ops.paddle_tpu_torch
    if op == "fused_matmul_kernel":
        got = ops.fused_matmul_kernel(x, w1, b, None, None, None, *ep)
        want = fm.reference_matmul_epilogue(x, w1, b, spec=spec)[0]
    else:
        got = ops.ffn_chain_kernel(x, w1, b, w2, None, None, None, None,
                                   *ep)
        want = fc.reference_ffn_chain(x, w1, b, w2, spec=spec)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# -- the sidecar: one format ------------------------------------------------

def test_the_jax_reader_reads_the_ports_sidecar(tmp_path):
    w = {"b": np.arange(6, dtype=np.float32).reshape(2, 3),
         "a": np.arange(4, dtype=np.int64), "c": np.array([True, False])}
    d = str(tmp_path / "side")
    sidecar.write_weight_sidecar(d, w)
    entries = jns.weight_cli_entries(d)
    assert [e[0] for e in entries] == ["a", "b", "c"]
    assert entries == sidecar.weight_cli_entries(d)
    for name, code, shape, path in entries:
        got = jns.read_raw_array(path, code, shape)
        np.testing.assert_array_equal(got, w[name])
        assert code == sidecar.dtype_code(w[name].dtype)


def test_the_port_reads_the_jax_sidecar_bf16_included(tmp_path):
    import ml_dtypes

    w = {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
         "h": np.arange(6, dtype=np.float32).reshape(3, 2).astype(
             ml_dtypes.bfloat16)}
    d = str(tmp_path / "side")
    jns.write_weight_sidecar(d, w)
    entries = sidecar.weight_cli_entries(d)
    assert [(e[0], e[1], e[2]) for e in entries] == [("h", "bf16", (3, 2)),
                                                     ("w", "f32", (2, 3))]
    h = sidecar.read_raw_array(entries[0][3], "bf16", (3, 2))
    assert h.dtype == torch.bfloat16
    np.testing.assert_array_equal(h.float().numpy(),
                                  w["h"].astype(np.float32))
    np.testing.assert_array_equal(
        sidecar.read_raw_array(entries[1][3], "f32", (2, 3)), w["w"])


def test_unbaked_sidecars_are_byte_identical(saved_model, tmp_path):
    d, xv = saved_model
    _predictor(d).export_stablehlo(str(tmp_path / "p"), {"x": xv},
                                   bake_weights=False)
    jinference.create_predictor(jinference.Config(d)).export_stablehlo(
        str(tmp_path / "j"), example_inputs={"x": xv}, bake_weights=False)
    files = sorted(os.listdir(tmp_path / "j.weights"))
    assert files == sorted(os.listdir(tmp_path / "p.weights"))
    for f in files:
        assert (tmp_path / "j.weights" / f).read_bytes() \
            == (tmp_path / "p.weights" / f).read_bytes(), f


# -- the JAX package's checks ------------------------------------------------

def test_baked_reexport_removes_stale_sidecar(saved_model, tmp_path):
    d, xv = saved_model
    pred = _predictor(d)
    want, = pred.run([xv])
    path = str(tmp_path / "model.stablehlo")
    pred.export_stablehlo(path, example_inputs={"x": xv},
                          bake_weights=False)
    assert os.path.isdir(path + ".weights")
    pred.export_stablehlo(path, example_inputs={"x": xv})
    assert not os.path.isdir(path + ".weights")
    got, = inference.load_exported(path)({"x": xv})
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_write_sidecar_false_validates_existing_sidecar(saved_model,
                                                        tmp_path):
    d, xv = saved_model
    pred = _predictor(d)
    path = str(tmp_path / "unbaked.stablehlo")
    with pytest.raises(ValueError, match="existing weight sidecar"):
        pred.export_stablehlo(path, example_inputs={"x": xv},
                              bake_weights=False, write_sidecar=False)
    assert not os.path.exists(path)
    pred.export_stablehlo(path, example_inputs={"x": xv},
                          bake_weights=False)
    x2 = np.concatenate([xv, xv])      # a new input shape, same weights
    text = pred.export_stablehlo(path, example_inputs={"x": x2},
                                 bake_weights=False, write_sidecar=False)
    assert os.path.exists(text)
    got, = inference.load_exported(path)({"x": x2})
    np.testing.assert_allclose(got.numpy(), pred.run([x2])[0], atol=ATOL)
    sidecar.write_weight_sidecar(path + ".weights",
                                 {"w_other": np.zeros((3, 3), np.float32)})
    with pytest.raises(ValueError, match="does not match"):
        pred.export_stablehlo(path, example_inputs={"x": xv},
                              bake_weights=False, write_sidecar=False)


def test_load_exported_missing_sidecar_names_it(saved_model, tmp_path):
    d, xv = saved_model
    path = str(tmp_path / "unbaked.stablehlo")
    _predictor(d).export_stablehlo(path, example_inputs={"x": xv},
                                   bake_weights=False)
    shutil.rmtree(path + ".weights")
    call = inference.load_exported(path)
    with pytest.raises(ValueError, match=r"\.weights"):
        call({"x": xv})


def test_load_exported_refuses_a_foreign_sidecar(saved_model, tmp_path):
    d, xv = saved_model
    path = str(tmp_path / "baked.stablehlo")
    _predictor(d).export_stablehlo(path, example_inputs={"x": xv})
    sidecar.write_weight_sidecar(path + ".weights",
                                 {"w_other": np.zeros((3, 3), np.float32)})
    call = inference.load_exported(path)
    with pytest.raises(ValueError, match="belongs to a different export"):
        call({"x": xv})


def test_a_fresh_process_loads_without_the_program_ir(saved_lm, tmp_path):
    d, ids, _ = saved_lm
    pred = _predictor(d)
    want, = pred.run([ids])
    path = str(tmp_path / "lm.pt2")
    pred.export_stablehlo(path, example_inputs={"src_ids": ids},
                          bake_weights=False)
    np.save(tmp_path / "ids.npy", ids)
    code = (
        "import json, sys\n"
        "import numpy as np\n"
        "from paddle_tpu_torch.inference.predictor import load_exported\n"
        f"ids = np.load({str(tmp_path / 'ids.npy')!r})\n"
        f"out = load_exported({path!r})({{'src_ids': ids}})[0].numpy()\n"
        f"np.save({str(tmp_path / 'out.npy')!r}, out)\n"
        "mods = [m for m in sys.modules if m.startswith('paddle_tpu')]\n"
        "print(json.dumps(mods))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=ROOT))
    assert proc.returncode == 0, proc.stderr[-3000:]
    mods = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "paddle_tpu_torch.ops._library" in mods
    for heavy in ("paddle_tpu_torch.core", "paddle_tpu_torch.layers",
                  "paddle_tpu_torch.models"):
        assert not [m for m in mods
                    if m == heavy or m.startswith(heavy + ".")], heavy
    assert not [m for m in mods if m.split(".")[0] == "paddle_tpu"]
    np.testing.assert_array_equal(np.load(tmp_path / "out.npy"), want)
