"""bfloat16 and float16 AMP in the port (``paddle_tpu_torch.contrib.
mixed_precision``, ``ops/amp_ops.py`` and the lowering's dtype policy)
against the JAX package, on the CPU, from the same numpy-seeded data.

* The four cases of ``tests/test_amp.py``: bf16 trains (float32 master
  weights), fp16 dynamic loss scaling, the bf16 loss curve within rtol
  0.05 of the float32 one (that test's bound), batch norm's running
  statistics in true float32 — each also against the JAX package from
  the JAX startup's weights: losses within ``SMALL_TOL``, the fp16
  scale and counters and the BN statistics too.
* The policy's decision (white, black, gray) for every op type
  registered in both packages, at both AMP dtypes, equals the JAX
  package's, and so do the cast dtypes of a gray op's inputs.
* ``check_finite_and_unscale`` and ``update_loss_scaling`` equal the JAX
  ops exactly on gradients holding inf and NaN, and across the
  counters' and the scale's transitions.
* float16 dynamic loss scaling from a scale that overflows: the scale,
  ``good_steps`` and ``bad_steps`` equal the JAX package's step for
  step, the overflowing steps included, and so do the losses.
* BERT-tiny at hidden 128 (4 heads, FFN 256), five bf16 AMP Adam steps
  at dropout 0, unfused (``fuse_epilogues=False``) and fused (the
  fusion pass; the JAX side runs its Pallas kernels in interpret mode
  through ``PADDLE_TPU_FUSED_MATMUL_INTERPRET=1``, the port's groups
  their kernels' plain versions at the AMP dtype): the first loss
  within ``BERT_FIRST_TOL`` relative and every loss within
  ``BERT_STEP_TOL`` relative of the JAX package's.  bf16 keeps 8
  significant bits, and the two packages round the same values at the
  same points but sum them in other orders, so a rounding can land on
  either side; over a vocabulary-wide softmax and five Adam steps those
  flips stay well under 1%.
"""
import dataclasses

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as pt
from paddle_tpu.compiler import BuildStrategy as JBuildStrategy
from paddle_tpu.compiler import CompiledProgram as JCompiledProgram
from paddle_tpu.contrib import mixed_precision as jamp
from paddle_tpu.contrib.mixed_precision import policy as jpolicy
from paddle_tpu.core.registry import REGISTRY as JREGISTRY
from paddle_tpu.models import BertConfig as JaxBertConfig
from paddle_tpu.models import build_bert_pretrain as jax_build
from paddle_tpu_torch.contrib import mixed_precision as amp
from paddle_tpu_torch.contrib.mixed_precision import policy
from paddle_tpu_torch.core.registry import REGISTRY
from paddle_tpu_torch.models import BertConfig, build_bert_pretrain

#: the port's loss against the JAX package's on the small models: both
#: round at the same points, only the orders of the float32 sums differ
SMALL_TOL = 2e-3
BERT_FIRST_TOL = 2e-3
BERT_STEP_TOL = 1e-2
SEQ, BATCH, STEPS = 32, 8, 5


def _model(pkg):
    x = pkg.data("x", [None, 16])
    label = pkg.data("label", [None, 1], "int64")
    h = pkg.layers.fc(x, 32, act="relu")
    logits = pkg.layers.fc(h, 4)
    return pkg.layers.mean(
        pkg.layers.softmax_with_cross_entropy(logits, label))


def _data(n=64, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, 16).astype(np.float32)
    y = (x.sum(1) > 8).astype(np.int64)[:, None]
    return x, y


def _persistables(program):
    return [v.name for v in program.list_vars() if v.persistable]


def _pair(build, feed, steps, fetch=None, seed=11):
    """Build ``build(pkg) -> (loss, extra)`` in both packages under the
    same names, run the JAX startup, carry its persistables into the
    port, and run ``steps`` steps of each.  Returns per package the loss
    per step, ``fetch(pkg, scope, extra)`` per step and the main
    program."""
    out = {}
    weights = None
    for pkg in (jpt, pt):
        main, startup = pkg.Program(), pkg.Program()
        startup.random_seed = seed
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            loss, extra = build(pkg)
        scope = pkg.Scope()
        with pkg.scope_guard(scope):
            if pkg is jpt:
                exe = jpt.Executor()
                exe.run(startup)
                weights = {n: np.asarray(scope.find_var(n))
                           for n in _persistables(main)}
            else:
                exe = pt.Executor(pt.CPUPlace())
                pt.io.load_params(scope, weights, "cpu", program=main)
            losses, seen = [], []
            for _ in range(steps):
                (lv,) = exe.run(main, feed=feed, fetch_list=[loss])
                losses.append(float(np.asarray(lv)))
                if fetch is not None:
                    seen.append(fetch(pkg, scope, extra))
        out[pkg] = (losses, seen, main)
    return out[jpt], out[pt]


def _scalar(scope, name):
    return np.asarray(scope.find_var(name)).item()


# -- the four cases of tests/test_amp.py -------------------------------------

def test_bf16_amp_trains_with_f32_master_weights():
    x, y = _data()

    def build(pkg):
        loss = _model(pkg)
        mp = jamp if pkg is jpt else amp
        mp.decorate(pkg.optimizer.Adam(1e-2), amp_dtype="bfloat16") \
            .minimize(loss)
        return loss, None

    def weight(pkg, scope, _):
        return np.asarray(scope.find_var("fc_0.w_0"))

    (jl, jw, jmain), (pl, pw, main) = _pair(
        build, {"x": x, "label": y}, 10, weight)
    assert main._amp_dtype == jmain._amp_dtype == "bfloat16"
    assert pl[-1] < pl[0]
    assert all(w.dtype == np.float32 for w in pw)
    np.testing.assert_allclose(pl, jl, rtol=SMALL_TOL)


def test_fp16_dynamic_loss_scaling():
    x, y = _data(seed=3)

    def build(pkg):
        loss = _model(pkg)
        mp = jamp if pkg is jpt else amp
        opt = mp.decorate(pkg.optimizer.SGD(0.1), amp_dtype="float16",
                          init_loss_scaling=2.0 ** 10,
                          use_dynamic_loss_scaling=True,
                          incr_every_n_steps=2)
        opt.minimize(loss)
        return loss, opt.get_loss_scaling().name

    def scale(pkg, scope, name):
        return _scalar(scope, name)

    (jl, js, _), (pl, ps, main) = _pair(build, {"x": x, "label": y}, 5,
                                        scale)
    assert np.isfinite(pl).all()
    assert ps[-1] >= 2.0 ** 11               # grew after good steps
    assert ps == js
    np.testing.assert_allclose(pl, jl, rtol=SMALL_TOL)
    names = _persistables(main)
    assert any(n.startswith("loss_scaling") for n in names)
    assert any(n.startswith("good_steps") for n in names)
    assert any(n.startswith("bad_steps") for n in names)


def test_amp_matches_f32_loss_curve_roughly():
    x, y = _data(seed=5)
    curves = {}
    for use_amp in (False, True):
        def build(pkg):
            loss = _model(pkg)
            opt = pkg.optimizer.SGD(0.1)
            if use_amp:
                opt = (jamp if pkg is jpt else amp).decorate(opt)
            opt.minimize(loss)
            return loss, None

        (jl, _, _), (pl, _, _) = _pair(build, {"x": x, "label": y}, 5)
        np.testing.assert_allclose(pl, jl, rtol=SMALL_TOL)
        curves[use_amp] = pl
    np.testing.assert_allclose(curves[False], curves[True], rtol=0.05)


def test_bf16_amp_batch_norm_stats_stay_true_f32():
    """bf16 AMP runs batch norm's normalisation in bf16 but its running
    mean and variance accumulate in float32 (AMP_KEEP_F32_SLOTS): an
    update below bf16's resolution still lands."""
    rng = np.random.RandomState(0)
    feed = {"x": rng.rand(8, 4, 8, 8).astype(np.float32)}

    def build(pkg):
        x = pkg.data("x", [None, 4, 8, 8])
        y = pkg.layers.batch_norm(pkg.layers.conv2d(x, 4, 3, padding=1))
        loss = pkg.layers.mean(y)
        (jamp if pkg is jpt else amp).decorate(
            pkg.optimizer.SGD(0.01), amp_dtype="bfloat16").minimize(loss)
        return loss, None

    def stats(pkg, scope, _):
        name = next(n for n in _persistables(scope_main[pkg])
                    if "batch_norm" in n and ".mean_" in n)
        return np.asarray(scope.find_var(name)).copy()

    scope_main = {}

    def build_keep(pkg):
        out = build(pkg)
        scope_main[pkg] = pkg.default_main_program()
        return out

    (_, jm, _), (_, pm, _) = _pair(build_keep, feed, 2, stats, seed=9)
    m1, m2 = pm
    assert m1.dtype == m2.dtype == np.float32
    assert np.abs(m2 - m1).max() > 0
    roundtrip = torch.from_numpy(m2).to(torch.bfloat16).float().numpy()
    assert not np.array_equal(roundtrip, m2)    # not bf16 values
    # the first step's statistics equal the JAX package's; the second's
    # are not compared: the loss is the mean of a normalised output, whose
    # gradient is zero up to rounding, so both packages' first updates
    # are rounding noise of bf16 (and differ)
    np.testing.assert_allclose(m1, jm[0], rtol=1e-5, atol=1e-7)


# -- the policy ---------------------------------------------------------------

@pytest.mark.parametrize("amp_dtype", ["bfloat16", "float16"])
def test_policy_decisions_equal_the_jax_package(amp_dtype, monkeypatch):
    import jax.numpy as jnp

    from paddle_tpu.core.lowering import _amp_cast as jax_amp_cast

    types = sorted(set(REGISTRY._ops) & set(JREGISTRY._ops))
    assert len(types) > 150
    for env in ("1", "0"):
        monkeypatch.setenv("PADDLE_TPU_BN_BF16", env)
        for t in types:
            assert policy.amp_runs_f32(t, amp_dtype) == \
                jpolicy.amp_runs_f32(t, amp_dtype), (t, env)
    assert policy.AMP_WHITE_LIST == jpolicy.AMP_WHITE_LIST
    assert policy.AMP_BLACK_LIST == jpolicy.AMP_BLACK_LIST
    assert policy.AMP_KEEP_F32_SLOTS == jpolicy.AMP_KEEP_F32_SLOTS
    monkeypatch.setenv("PADDLE_TPU_BN_BF16", "1")
    # the cast dtypes, per op kind: white, black, gray with and without
    # a compute-dtype input, and batch norm's kept slots
    low = jnp.dtype(amp_dtype)
    cases = [("mul", {"X": ["f32"], "Y": ["f32"]}),
             ("mean", {"X": [amp_dtype]}),
             ("elementwise_add", {"X": [amp_dtype], "Y": ["f32"]}),
             ("elementwise_add", {"X": ["f32"], "Y": ["f32"]}),
             ("relu", {"X": ["int32"]}),
             ("batch_norm", {"X": [amp_dtype], "Scale": ["f32"],
                             "Mean": ["f32"], "Variance": ["f32"]})]
    for op_type, slots in cases:
        def names(d):
            return {"f32": "float32"}.get(d, d)

        jins = {s: [jnp.zeros((2,), names(d)) for d in ds]
                for s, ds in slots.items()}
        pins = {s: [torch.zeros(2, dtype=getattr(torch, names(d)))
                    for d in ds] for s, ds in slots.items()}
        jout = jax_amp_cast(jins, op_type, low)
        pout = policy.amp_cast(pins, op_type, amp_dtype)
        for s in slots:
            assert [str(v.dtype) for v in jout[s]] == \
                [str(v.dtype).replace("torch.", "") for v in pout[s]], \
                (op_type, s)


# -- the two ops --------------------------------------------------------------

def _jax_op(type_, inputs, attrs):
    from paddle_tpu.core.registry import OpContext as JOpContext

    import jax.numpy as jnp

    ins = {s: [jnp.asarray(v) for v in vs] for s, vs in inputs.items()}
    outs = JREGISTRY.get(type_).compute(
        JOpContext(rng=None, is_test=False, attrs=attrs), ins, attrs)
    return {s: [np.asarray(v) for v in vs] for s, vs in outs.items()}


def _port_op(type_, inputs, attrs):
    from paddle_tpu_torch.core.registry import OpContext

    ins = {s: [torch.from_numpy(np.asarray(v)) for v in vs]
           for s, vs in inputs.items()}
    outs = REGISTRY.get(type_).compute(
        OpContext(rng=None, is_test=False, attrs=attrs, device="cpu"), ins,
        attrs)
    return {s: [v.numpy() for v in vs] for s, vs in outs.items()}


@pytest.mark.parametrize("poison", [None, np.inf, -np.inf, np.nan])
def test_check_finite_and_unscale_equals_the_jax_op(poison):
    rng = np.random.RandomState(1)
    xs = [rng.randn(3, 4).astype(np.float32) * 1024,
          rng.randn(5).astype(np.float16) * 64]
    if poison is not None:
        xs[1][2] = poison
    inputs = {"X": xs, "Scale": [np.float32(512.0)]}
    want = _jax_op("check_finite_and_unscale", inputs, {})
    got = _port_op("check_finite_and_unscale", inputs, {})
    assert bool(got["FoundInfinite"][0]) == (poison is not None)
    assert bool(got["FoundInfinite"][0]) == bool(want["FoundInfinite"][0])
    for g, w in zip(got["Out"], want["Out"]):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)


def test_update_loss_scaling_equals_the_jax_op():
    attrs = {"incr_every_n_steps": 3, "decr_every_n_nan_or_inf": 2,
             "incr_ratio": 2.0, "decr_ratio": 0.5}
    state = (np.float32(4.0), np.int32(0), np.int32(0))
    # finite steps until the scale grows, overflows until it shrinks,
    # and the floor at 1
    pattern = [False, False, False, True, False, True, True, True, True,
               True, True, True, True, False]
    for found in pattern:
        inputs = {"FoundInfinite": [np.bool_(found)],
                  "PrevLossScaling": [state[0]], "InGoodSteps": [state[1]],
                  "InBadSteps": [state[2]]}
        want = _jax_op("update_loss_scaling", inputs, attrs)
        got = _port_op("update_loss_scaling", inputs, attrs)
        for slot in ("LossScaling", "OutGoodSteps", "OutBadSteps"):
            np.testing.assert_array_equal(got[slot][0], want[slot][0])
        state = (got["LossScaling"][0], got["OutGoodSteps"][0],
                 got["OutBadSteps"][0])
    assert float(state[0]) == 1.0


# -- float16: an overflowing scale, step for step ----------------------------

def test_fp16_scale_and_counters_through_overflow_equal_the_jax_package():
    """From a scale of 2^24 the float16 gradients overflow: the first
    steps find inf, zero their gradients and quarter the scale until the
    gradients fit, then every two good steps double it.  The scale and both
    counters equal the JAX package's after every step."""
    x, y = _data(seed=3)

    def build(pkg):
        loss = _model(pkg)
        opt = (jamp if pkg is jpt else amp).decorate(
            pkg.optimizer.SGD(0.1), amp_dtype="float16",
            init_loss_scaling=2.0 ** 24, use_dynamic_loss_scaling=True,
            incr_every_n_steps=2, decr_every_n_nan_or_inf=1,
            decr_ratio=0.25)
        opt.minimize(loss)
        names = [n for n in _persistables(pkg.default_main_program())
                 if n.split("_")[0] in ("loss", "good", "bad")
                 and n.rsplit("_", 1)[0] in ("loss_scaling", "good_steps",
                                              "bad_steps")]
        return loss, sorted(names)

    def state(pkg, scope, names):
        return tuple(_scalar(scope, n) for n in names)

    (jl, js, _), (pl, ps, _) = _pair(build, {"x": x, "label": y}, 8, state)
    assert ps == js
    scales = [s[2] for s in ps]       # sorted: bad, good, loss_scaling
    assert scales[0] < 2.0 ** 24            # the first step overflowed
    assert max(scales[1:]) > min(scales)    # it grew again
    np.testing.assert_allclose(pl, jl, rtol=SMALL_TOL)


# -- BERT-tiny under bf16 AMP, fused and unfused ----------------------------

def _batch(rng, vocab):
    src = rng.randint(0, vocab, (BATCH, SEQ)).astype(np.int64)
    mask = np.ones((BATCH, SEQ), np.float32)
    mask[:3, SEQ - 6:] = 0.0
    labels = np.full((BATCH, SEQ, 1), -1, np.int64)
    pick = rng.rand(BATCH, SEQ) < 0.15
    labels[pick] = src[pick][:, None]
    return {"src_ids": src, "input_mask": mask, "masked_labels": labels}


@pytest.fixture(scope="module")
def monkeypatch_module():
    with pytest.MonkeyPatch.context() as mp:
        yield mp


@pytest.fixture(scope="module", params=["unfused", "fused"])
def bert_runs(request, monkeypatch_module):
    fused = request.param == "fused"
    jcfg = dataclasses.replace(JaxBertConfig.tiny(), hidden_dropout=0.0,
                               attn_dropout=0.0, hidden_size=128,
                               num_heads=4, ffn_size=256)
    cfg = BertConfig(**dataclasses.asdict(jcfg))
    feed = _batch(np.random.RandomState(3), cfg.vocab_size)
    out = {}
    weights = None
    for pkg in (jpt, pt):
        if pkg is jpt and fused:
            monkeypatch_module.setenv("PADDLE_TPU_FUSED_MATMUL_INTERPRET",
                                      "1")
        main, startup = pkg.Program(), pkg.Program()
        startup.random_seed = 7
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            loss, _ = (jax_build if pkg is jpt else build_bert_pretrain)(
                jcfg if pkg is jpt else cfg, seq_len=SEQ)
            (jamp if pkg is jpt else amp).decorate(
                pkg.optimizer.Adam(1e-3), amp_dtype="bfloat16") \
                .minimize(loss)
        bs = (JBuildStrategy if pkg is jpt else pt.BuildStrategy)()
        bs.fuse_epilogues = fused
        program = (JCompiledProgram if pkg is jpt else pt.CompiledProgram)(
            main, build_strategy=bs)
        scope = pkg.Scope()
        with pkg.scope_guard(scope):
            if pkg is jpt:
                exe = jpt.Executor()
                exe.run(startup)
                weights = {n: np.asarray(scope.find_var(n))
                           for n in _persistables(main)}
            else:
                exe = pt.Executor(pt.CPUPlace())
                pt.io.load_params(scope, weights, "cpu", program=main)
            losses = [float(np.asarray(exe.run(program, feed=feed,
                                               fetch_list=[loss])[0]))
                      for _ in range(STEPS)]
        monkeypatch_module.delenv("PADDLE_TPU_FUSED_MATMUL_INTERPRET",
                                  raising=False)
        plans = [lw.fusion_plan for lw in main._exec_cache.values()] \
            if pkg is pt else None
        out[pkg] = (losses, plans, main)
    return dict(fused=fused, jlosses=out[jpt][0], losses=out[pt][0],
                plans=out[pt][1], main=out[pt][2])


def test_bert_bf16_losses_match_the_jax_package(bert_runs):
    got = np.asarray(bert_runs["losses"])
    want = np.asarray(bert_runs["jlosses"])
    assert np.isfinite(got).all() and got[-1] < got[0]
    rel = np.abs(got - want) / np.abs(want)
    assert rel[0] < BERT_FIRST_TOL, (got, want)
    assert rel.max() < BERT_STEP_TOL, (got, want)


def test_bert_bf16_groups_are_the_f32_planners(bert_runs):
    """Under AMP the fusion pass plans the groups it plans in float32
    (2 layers: attention and FFN each, three GEMM groups)."""
    for plan in bert_runs["plans"]:
        if not bert_runs["fused"]:
            assert plan is None
            continue
        kinds = [g.kind for g in plan.groups]
        assert kinds.count("attn") == kinds.count("ffn_chain") == 2
        assert kinds.count("gemm") == 3
