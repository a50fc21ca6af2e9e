"""The port's inference API (``paddle_tpu_torch.inference``) and its
``serving.PredictorBackend`` against the JAX package, on the CPU.

* The non-export cases of ``tests/test_inference.py``: one frozen fc
  model, saved by the JAX package's ``io.save_inference_model`` (the
  port reads its format); the port's Predictor (``disable_gpu()``) gives
  the port Executor's outputs on the loaded program and the JAX
  Predictor's, within 1e-6.
* The ``saved_model`` cases of ``tests/test_serving.py`` through the
  port's ``InferenceServer`` over a Predictor (wrapped in
  ``PredictorBackend``): coalescing, warmup then zero recompiles, batch
  and seq bucket padding, bad requests, stats, dtype coercion.
* The uncached greedy decoder (``build_lm_greedy_infer``, BERT-tiny)
  saved by the port and reloaded into a Predictor gives the Executor's
  tokens, and the JAX Predictor reading the same directory gives them
  too.
* ``export_stablehlo``/``load_exported`` round-trip the fc model (a
  ``torch.export`` artifact; tests/test_torch_export.py holds it against
  the JAX package's); ``enable_bfloat16`` runs the program under
  bfloat16 AMP, as the JAX package's Predictor does, matches the JAX
  bf16 Predictor, and its artifact loads back with its outputs; without
  ``disable_gpu()`` the Predictor runs on the card (and raises here).
"""
import dataclasses
import json
import os
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as pt
from paddle_tpu import inference as jinference
from paddle_tpu_torch import inference
from paddle_tpu_torch.models import BertConfig, build_lm_greedy_infer
from paddle_tpu_torch.serving import (BadRequestError, InferenceServer,
                                      PredictorBackend, ServingConfig)

ATOL = 1e-6


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
    ref, = jinference.create_predictor(jinference.Config(d)).run([xv])
    return d, xv, np.asarray(ref)


def _config(d=None):
    cfg = inference.Config(d)
    cfg.disable_gpu()
    return cfg


def _predictor(d):
    return inference.create_predictor(_config(d))


def test_predictor_run_matches_executor_and_the_jax_predictor(saved_model):
    d, xv, ref = saved_model
    config = _config(d)
    config.enable_memory_optim()
    config.switch_ir_optim(True)
    pred = inference.create_predictor(config)
    assert pred.get_input_names() == ["x"]
    assert pred._exe.device.type == "cpu"
    out, = pred.run([xv])
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    with pt.scope_guard(scope):
        prog, feeds, fetches = pt.io.load_inference_model(d, exe)
        want, = exe.run(prog, feed={"x": xv}, fetch_list=fetches)
    np.testing.assert_array_equal(out, want)


def test_zero_copy_handles(saved_model):
    d, xv, ref = saved_model
    pred = _predictor(d)
    h = pred.get_input_handle("x")
    h.copy_from_cpu(xv)
    pred.run()
    out_name = pred.get_output_names()[0]
    out = pred.get_output_handle(out_name).copy_to_cpu()
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)
    # repeated runs with new inputs reuse the lowering
    h.copy_from_cpu(xv * 2.0)
    out2, = pred.run()
    assert not np.allclose(out2, ref)
    assert len(pred._program._exec_cache) == 1


def test_uninitialized_input_errors(saved_model):
    d, _, _ = saved_model
    with pytest.raises(RuntimeError, match="not set"):
        _predictor(d).run()


def test_config_validation(tmp_path):
    cfg = _config(str(tmp_path / "nope"))
    with pytest.raises(ValueError, match="saved-model"):
        inference.create_predictor(cfg)
    with pytest.raises(NotImplementedError):
        cfg.enable_tensorrt_engine()
    cfg.enable_bfloat16()                   # AMP: tested below
    cfg.enable_mkldnn()                     # accepted, as in the JAX package
    assert isinstance(cfg._place(), pt.CPUPlace)


#: bf16 Predictor against the JAX one: both round the products' inputs
#: and outputs to bfloat16 at the same points and sum in float32, so only
#: the order of the sums may differ (bf16 against f32 differs by ~1e-3)
BF16_ATOL = 1e-4


def test_bfloat16_predictor_matches_the_jax_one(saved_model):
    d, xv, ref = saved_model
    cfg = _config(d)
    cfg.enable_bfloat16()
    pred = inference.create_predictor(cfg)
    assert pred._program._amp_dtype == "bfloat16"
    out, = pred.run([xv])
    jcfg = jinference.Config(d)
    jcfg.enable_bfloat16()
    jref, = jinference.create_predictor(jcfg).run([xv])
    assert out.dtype == np.float32          # softmax runs in float32
    np.testing.assert_allclose(out, np.asarray(jref), rtol=0,
                               atol=BF16_ATOL)
    assert not np.array_equal(out, ref)     # the products did round
    # the bf16 Predictor's artifact, baked and with its weight sidecar,
    # loads back and gives the Predictor's outputs bit for bit
    for bake in (True, False):
        path = os.path.join(d, f"bf16_{bake}.pt2")
        pred.export_stablehlo(path, {"x": xv}, bake_weights=bake)
        got, = inference.load_exported(path)({"x": xv})
        np.testing.assert_array_equal(got.float().numpy(), out)


def test_two_file_set_model_form(saved_model):
    d, xv, ref = saved_model
    files = os.listdir(d)
    model_file = next(f for f in files if "model" in f.lower())
    params_file = next(f for f in files if "params" in f.lower())
    cfg = _config()
    cfg.set_model(os.path.join(d, model_file),
                  os.path.join(d, params_file))
    out, = inference.create_predictor(cfg).run([xv])
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)


def test_run_input_count_validated(saved_model):
    d, xv, _ = saved_model
    with pytest.raises(ValueError, match="1"):
        _predictor(d).run([xv, xv])


def test_export_is_not_ported(saved_model, tmp_path):
    """Once the gap this test named, now the round trip: a baked export
    loads back and gives the Predictor's outputs bit for bit."""
    d, xv, _ = saved_model
    pred = _predictor(d)
    want, = pred.run([xv])
    path = str(tmp_path / "m.stablehlo")
    text = pred.export_stablehlo(path, example_inputs={"x": xv})
    assert os.path.isfile(path) and "placeholder" in open(text).read()
    got, = inference.load_exported(path)({"x": xv})
    np.testing.assert_array_equal(got.numpy(), want)


def test_the_predictor_runs_on_the_card_unless_asked(saved_model):
    d, _, _ = saved_model
    cfg = inference.Config(d)
    assert isinstance(cfg._place(), pt.CUDAPlace)
    cfg.enable_use_gpu(device_id=1)
    assert cfg._place().device_id == 1
    cfg.enable_use_gpu(device_id=0)
    if torch.cuda.is_available():
        assert inference.create_predictor(cfg)._exe.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            inference.create_predictor(cfg)


# -- the serving cases over the port's PredictorBackend -----------------------

def _x(rows, seed=0):
    return np.random.RandomState(seed).rand(rows, 4).astype(np.float32)


def test_concurrent_clients_coalesce_into_one_batch(saved_model):
    d = saved_model[0]
    pred, ref_pred = _predictor(d), _predictor(d)
    cfg = ServingConfig(batch_buckets=(1, 2, 4, 8),
                        max_batch_wait_ms=5000, max_queue_size=64)
    server = InferenceServer(pred, cfg).start()
    assert isinstance(server.backend, PredictorBackend)
    inputs = [_x(1, seed=i) for i in range(8)]
    results = [None] * 8
    errors = []

    def client(i):
        try:
            results[i] = server.infer({"x": inputs[i]})
        except Exception as e:  # noqa: BLE001 — collected for the assert
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    server.close()
    assert not errors, errors
    for i in range(8):
        ref, = ref_pred.run([inputs[i]])
        np.testing.assert_allclose(results[i][0], ref, rtol=1e-6,
                                   atol=1e-6)
    stats = server.stats()
    assert stats["requests_ok"] == 8
    assert server.backend.compile_count() == 1 < 8
    assert stats["batches"] == 1
    assert stats["mean_batch_size"] == 8.0


def test_warmup_compiles_every_bucket_then_zero_recompiles(saved_model):
    server = InferenceServer(_predictor(saved_model[0]), ServingConfig(
        batch_buckets=(1, 2, 4), max_batch_wait_ms=0)).start()
    assert server.warmup() == 3      # one lowering per batch bucket
    for rows in (1, 2, 3, 4, 1, 2):
        server.infer({"x": _x(rows, seed=rows)})
    server.close()
    stats = server.stats()
    assert stats["compiles_at_warmup"] == 3
    assert stats["compiles_after_warmup"] == 0
    assert server.backend.compile_count() == 3


def test_bucket_padding_matches_unpadded_reference(saved_model):
    d = saved_model[0]
    pred, ref_pred = _predictor(d), _predictor(d)
    server = InferenceServer(pred, ServingConfig(
        batch_buckets=(4,), max_batch_wait_ms=0)).start()
    x3 = _x(3, seed=9)
    out, = server.infer({"x": x3})
    server.close()
    assert out.shape == (3, 2)
    padded = np.zeros((4, 4), np.float32)
    padded[:3] = x3
    ref, = ref_pred.run([padded])
    np.testing.assert_allclose(out, ref[:3], rtol=1e-6, atol=1e-6)


def test_seq_bucket_padding(saved_model):
    d = saved_model[0]
    pred, ref_pred = _predictor(d), _predictor(d)
    server = InferenceServer(pred, ServingConfig(
        batch_buckets=(2,), seq_buckets=(4,), seq_axis=1,
        max_batch_wait_ms=0)).start()
    short = np.random.RandomState(3).rand(2, 3).astype(np.float32)
    out, = server.infer({"x": short})
    server.close()
    padded = np.zeros((2, 4), np.float32)
    padded[:, :3] = short
    ref, = ref_pred.run([padded])
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


def test_bad_request_rejected_at_submit(saved_model):
    server = InferenceServer(_predictor(saved_model[0]), ServingConfig(
        batch_buckets=(1, 2), max_batch_wait_ms=0)).start()
    with pytest.raises(BadRequestError, match="feed names"):
        server.submit({"nope": _x(1)})
    with pytest.raises(BadRequestError, match="dim"):
        server.submit({"x": np.zeros((1, 5), np.float32)})
    with pytest.raises(BadRequestError, match="batch"):
        server.submit({"x": _x(3)})
    ok, = server.infer({"x": _x(1)})
    assert ok.shape == (1, 2)
    server.close()


def test_stats_snapshot_and_json_export(saved_model, tmp_path):
    server = InferenceServer(_predictor(saved_model[0]), ServingConfig(
        batch_buckets=(1, 2, 4), max_batch_wait_ms=0,
        slo_ms=0.0001)).start()
    server.warmup()
    for rows in (1, 3, 2, 4):
        server.infer({"x": _x(rows, seed=rows)})
    server.close()
    s = server.stats()
    assert s["requests_ok"] == 4
    assert s["qps"] is None or s["qps"] > 0
    assert 0 < s["batch_occupancy"] <= 1.0
    assert 0 <= s["padding_waste"] < 1.0
    assert s["latency"]["count"] == 4
    assert s["latency"]["p99_ms"] >= s["latency"]["p50_ms"]
    assert s["slo_violations"] == 4
    assert s["compiles_after_warmup"] == 0
    p = str(tmp_path / "serving_stats.json")
    server.dump_stats(p)
    with open(p) as f:
        dumped = json.load(f)
    assert dumped["requests_ok"] == 4
    assert dumped["latency_buckets_ms"]


def test_dtype_coercion_and_seq_bucket_declared_mismatch(saved_model):
    server = InferenceServer(_predictor(saved_model[0]), ServingConfig(
        batch_buckets=(2,), seq_buckets=(2, 4),
        max_batch_wait_ms=0)).start()
    out, = server.infer({"x": np.random.RandomState(0).rand(1, 4)})  # f64
    assert out.shape == (1, 2)
    with pytest.raises(BadRequestError, match="seq bucket"):
        server.submit({"x": np.zeros((1, 2), np.float32)})
    server.close()
    assert server.backend.compile_count() == 1
    assert server.backend.input_spec() == {"x": ((4,), np.float32)}


# -- the greedy decoder, frozen and served ------------------------------------

def test_saved_greedy_decoder_gives_the_executors_tokens(tmp_path):
    """build_lm_greedy_infer (one StaticRNN over the LM) saved with
    io.save_inference_model and reloaded: its sub-block and block attrs
    survive the prune and the JSON round trip, the port's Predictor
    gives the Executor's tokens, and so does the JAX Predictor reading
    the same directory."""
    cfg = dataclasses.replace(BertConfig.tiny(), hidden_dropout=0.0,
                              attn_dropout=0.0, initializer_range=0.6)
    B, P, N = 2, 8, 4
    d = str(tmp_path / "greedy")
    main, startup = pt.Program(), pt.Program()
    startup.random_seed = 7
    with pt.program_guard(main, startup), pt.unique_name.guard():
        out = build_lm_greedy_infer(cfg, B, P, N)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    prompts = np.random.RandomState(12).randint(
        1, cfg.vocab_size, (B, P)).astype(np.int64)
    with pt.scope_guard(scope):
        exe.run(startup)
        ids, = exe.run(main, feed={"prompt_ids": prompts},
                       fetch_list=[out])
        pt.io.save_inference_model(d, ["prompt_ids"], [out], exe,
                                   main_program=main)
    with open(os.path.join(d, "__model__.json")) as f:
        desc = json.load(f)
    assert len(desc["blocks"]) == 2
    assert [op["type"] for op in desc["blocks"][0]["ops"]][-1] == \
        "static_rnn"
    assert ids.shape == (N, B)
    got, = _predictor(d).run([prompts])
    np.testing.assert_array_equal(got, ids)
    jgot, = jinference.create_predictor(jinference.Config(d)).run(
        [prompts])
    np.testing.assert_array_equal(np.asarray(jgot), ids)
