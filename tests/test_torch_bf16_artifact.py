"""The bfloat16 Predictor's serving artifact, on the CPU.

* The kernels' ``torch.library`` fakes return what their launch
  functions (and, off the card, their plain versions) return: the output
  in the input's element type — float32, or bfloat16/float16 for the AMP
  variants — and the flash forwards' ``lse`` in float32.  A trace of a
  bf16 program carries the dtypes its run has.
* An ``enable_bfloat16()`` Predictor of build_lm_logits (BERT-tiny at
  hidden 128, where the fusion pass plans #9, #10, #11 a layer) exports
  baked and with its sidecar, loads back, and gives the Predictor's
  logits bit for bit; the graph holds one kernel operator a fused group.
  The Predictor's bfloat16 fetch comes back widened to float32 (numpy
  has no bfloat16; the widening is exact), within BF16_RTOL of the
  float32 Predictor's.  (tests/test_torch_inference.py holds a bf16
  Predictor against the JAX package's.)
* The sidecar stores a bfloat16 parameter as its raw 16-bit words under
  the code "bf16", the JAX package's format: the JAX reader gives the
  same values, the port's reader a bfloat16 tensor with the same bits.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu.inference import native_serving as jns
from paddle_tpu_torch import inference
from paddle_tpu_torch.inference import sidecar
from paddle_tpu_torch.ops import _library
from paddle_tpu_torch.ops import fused_matmul as fm

#: bf16 logits against float32 ones, as a fraction of their largest: the
#: products' inputs and outputs round to bfloat16 (2^-8 relative each)
#: through two layers; measured 1.6e-2 here
BF16_RTOL = 2.0 ** -5

DTYPES = [torch.float32, torch.bfloat16, torch.float16]


def _fake_and_plain(op, *args):
    """(the operator's fake outputs, its plain version's outputs)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    fn = getattr(torch.ops.paddle_tpu_torch, op)
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fake = fn(*(mode.from_tensor(a) if torch.is_tensor(a) else a
                    for a in args))
    real = fn(*args)
    to_list = (lambda x: list(x) if isinstance(x, (tuple, list)) else [x])
    return to_list(fake), to_list(real)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("op", sorted(_library._IMPLS))
def test_fakes_return_the_plain_versions_dtypes(op, dtype):
    g = torch.Generator().manual_seed(0)

    def r(*shape, dt=dtype):
        return torch.randn(*shape, generator=g).to(dt)

    ep = (0, "gelu", False, 0.0, "layer_norm", 1e-5)
    f32 = torch.float32
    args = {
        "flash_kernel_forward": (r(2, 16, 64), r(2, 16, 64), r(2, 16, 64),
                                 2, None, True, 0.125, 0.0, 0),
        "flash_kernel_forward_qkv": (r(2, 16, 192), r(192, dt=f32), 2,
                                     None, True, 0.125, 0.0, 0),
        "fused_matmul_kernel": (r(8, 16), r(16, 32), r(32, dt=f32), None,
                                r(32, dt=f32), r(32, dt=f32), *ep),
        "ffn_chain_kernel": (r(8, 16), r(16, 64), r(64, dt=f32), r(64, 16),
                             r(16, dt=f32), r(8, 16), r(16, dt=f32),
                             r(16, dt=f32), *ep),
    }[op]
    fake, real = _fake_and_plain(op, *args)
    assert [(t.dtype, tuple(t.shape)) for t in fake] == \
        [(t.dtype, tuple(t.shape)) for t in real]
    assert fake[0].dtype == dtype
    assert all(t.dtype == torch.float32 for t in fake[1:])


@pytest.fixture(scope="module")
def saved_lm(tmp_path_factory):
    """BERT-tiny's build_lm_logits at [2, 16], hidden 128, saved by the
    port (the JAX package reads the format)."""
    from paddle_tpu_torch.models import BertConfig, build_lm_logits

    cfg = dataclasses.replace(BertConfig.tiny(), hidden_size=128,
                              num_heads=4, ffn_size=256, hidden_dropout=0.0,
                              attn_dropout=0.0, initializer_range=0.2)
    d = str(tmp_path_factory.mktemp("lm") / "logits")
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


def _bf16_predictor(d):
    cfg = inference.Config(d)
    cfg.disable_gpu()
    cfg.enable_bfloat16()
    return inference.create_predictor(cfg)


@pytest.mark.parametrize("bake", [True, False], ids=["baked", "sidecar"])
def test_bf16_artifact_gives_the_predictors_logits(saved_lm, tmp_path,
                                                   bake):
    d, ids, cfg = saved_lm
    pred = _bf16_predictor(d)
    assert pred._program._amp_dtype == "bfloat16"
    want, = pred.run([ids])
    assert want.dtype == np.float32          # widened from the bf16 fetch
    assert np.array_equal(want, want.astype(np.float32).view(
        np.uint32).__and__(0xFFFF0000).view(np.float32))   # bf16 values
    path = str(tmp_path / "bf16.pt2")
    text = open(pred.export_stablehlo(path, {"src_ids": ids},
                                      bake_weights=bake)).read()
    got, = inference.load_exported(path)({"src_ids": ids})
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    L = cfg.num_layers
    counts = {k: text.count(f"paddle_tpu_torch.{k}.default") for k in (
        "flash_kernel_forward_qkv", "fused_matmul_kernel",
        "ffn_chain_kernel", "flash_kernel_forward")}
    assert counts == {"flash_kernel_forward_qkv": L,
                      "fused_matmul_kernel": L, "ffn_chain_kernel": L,
                      "flash_kernel_forward": 0}
    assert os.path.isdir(path + ".weights") == (not bake)


def test_bf16_predictor_is_the_f32_one_rounded(saved_lm):
    """The bf16 Predictor's logits part from the float32 Predictor's, by
    less than BF16_RTOL of their scale (the AMP gate of chip_smoke.py's
    phase 18 is 5e-2)."""
    d, ids, _ = saved_lm
    got, = _bf16_predictor(d).run([ids])
    cfg = inference.Config(d)
    cfg.disable_gpu()
    want, = inference.create_predictor(cfg).run([ids])
    assert not np.array_equal(got, want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=BF16_RTOL * np.abs(want).max())


def test_the_sidecar_stores_bf16_as_words_the_jax_reader_reads(tmp_path):
    g = torch.Generator().manual_seed(2)
    h = torch.randn(3, 4, generator=g).bfloat16()
    w = np.arange(6, dtype=np.float32).reshape(2, 3)
    d = str(tmp_path / "side")
    sidecar.write_weight_sidecar(d, {"h": h, "w": w})
    entries = sidecar.weight_cli_entries(d)
    assert [(e[0], e[1], e[2]) for e in entries] == [("h", "bf16", (3, 4)),
                                                     ("w", "f32", (2, 3))]
    assert os.path.getsize(entries[0][3]) == 2 * h.numel()
    jh = jns.read_raw_array(entries[0][3], "bf16", (3, 4))
    np.testing.assert_array_equal(np.asarray(jh, np.float32),
                                  h.float().numpy())
    th = sidecar.read_raw_array(entries[0][3], "bf16", (3, 4))
    assert th.dtype == torch.bfloat16
    assert torch.equal(th.view(torch.int16), h.view(torch.int16))
    assert sidecar.code_of(h) == "bf16" and sidecar.code_of(w) == "f32"


def test_fused_matmul_operator_runs_bf16_on_the_cpu():
    """The operator's plain version in bfloat16: the variant's rounding
    points, the output in bfloat16."""
    g = torch.Generator().manual_seed(3)
    x, w = (torch.randn(*s, generator=g).bfloat16() for s in ((8, 16),
                                                              (16, 32)))
    b = torch.randn(32, generator=g)
    ep = (0, None, False, 0.0, None, 1e-5)
    got = torch.ops.paddle_tpu_torch.fused_matmul_kernel(x, w, b, None,
                                                         None, None, *ep)
    want = fm.reference_matmul_epilogue(x, w, b, spec=fm.EpilogueSpec())[0]
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, want, rtol=0, atol=0)
