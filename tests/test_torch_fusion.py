"""The port's GEMM-epilogue fusion pass (paddle_tpu_torch/core/fusion.py)
against the JAX package's planner, and its execution on the CPU.

Planning: the same program built in both packages (names and op uids
match) must give the same plan — every group's kind, pattern, member
uids, roles, final slot, activation, dropout and norm, and the plan's
``skip_uids`` — on BERT-tiny under both attention settings, the encoder
block of tests/test_block_fusion.py with block patterns on and off, the
negative cases of tests/test_fusion_pass.py, and a program whose
attention group has a dropout/residual/norm tail.

Execution (port only, CPU: the kernels' plain versions): fused and
unfused lowerings of the same program from the same weights give the
same losses and gradients (float32, summed in another order: atol 1e-5
/ rtol 1e-5), the groups route to the kernel entry their shapes allow,
and the executor's knobs select the plan.
"""
import math

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as pt
from paddle_tpu.core import fusion as jfusion
from paddle_tpu.models import BertConfig as JaxBertConfig
from paddle_tpu.models import build_bert_pretrain as jax_bert
from paddle_tpu_torch.core import fusion
from paddle_tpu_torch.models import BertConfig, build_bert_pretrain
from paddle_tpu_torch.observability import get_registry
from paddle_tpu_torch.ops import attention_epilogue as ae
from paddle_tpu_torch.ops import ffn_chain as fc
from paddle_tpu_torch.ops import fused_matmul as fm

TOL = dict(rtol=1e-5, atol=1e-5)


# ---- programs, built the same way in either package ----------------------

def _encoder_block(P, hidden=64, nh=4, seq=16, batch=4, dropout=0.1,
                   ffn_mult=2, act="gelu"):
    """tests/test_block_fusion.py's post-LN layer: packed qkv + slices +
    fused attention, attention output, FFN, a scalar loss, Adam."""
    x = P.data("x", [batch, seq, hidden])
    qkv = P.layers.fc(x, 3 * hidden, num_flatten_dims=2)
    q = P.layers.slice(qkv, [2], [0], [hidden])
    k = P.layers.slice(qkv, [2], [hidden], [2 * hidden])
    v = P.layers.slice(qkv, [2], [2 * hidden], [3 * hidden])
    ctxt = P.layers.fused_multihead_attention(
        q, k, v, dropout_rate=0.0, num_heads=nh,
        sm_scale=1.0 / math.sqrt(hidden // nh))
    attn_out = P.layers.fc(ctxt, hidden, num_flatten_dims=2)
    if dropout:
        attn_out = P.layers.dropout(
            attn_out, dropout, dropout_implementation="upscale_in_train")
    h = P.layers.layer_norm(P.layers.elementwise_add(x, attn_out),
                            begin_norm_axis=2)
    ffn = P.layers.fc(h, hidden * ffn_mult, num_flatten_dims=2, act=act)
    ffn = P.layers.fc(ffn, hidden, num_flatten_dims=2)
    if dropout:
        ffn = P.layers.dropout(
            ffn, dropout, dropout_implementation="upscale_in_train")
    out = P.layers.layer_norm(P.layers.elementwise_add(h, ffn),
                              begin_norm_axis=2)
    # a loss that depends on every element (the mean of a layer norm's
    # output would not: its rows have mean beta)
    loss = P.layers.mean(P.layers.elementwise_mul(out, out))
    P.optimizer.Adam(1e-3).minimize(loss)
    return ("x",), [loss.name]


def _encoder_block_fetch_gelu(P):
    feeds, fetches = _encoder_block(P)
    main = P.default_main_program()
    gelu = next(o for o in main.global_block().ops if o.type == "gelu")
    return feeds, fetches + [gelu.outputs["Out"][0]]


def _attention_tail(P, hidden=64, nh=4, seq=16, batch=4):
    """An attention group with a tail: no output projection, the
    attention output goes straight through dropout, the residual add and
    a layer norm (so the kernel covers the group up to fused_attention
    and the tail is replayed)."""
    x = P.data("x", [batch, seq, hidden])
    qkv = P.layers.fc(x, 3 * hidden, num_flatten_dims=2)
    q = P.layers.slice(qkv, [2], [0], [hidden])
    k = P.layers.slice(qkv, [2], [hidden], [2 * hidden])
    v = P.layers.slice(qkv, [2], [2 * hidden], [3 * hidden])
    ctxt = P.layers.fused_multihead_attention(
        q, k, v, dropout_rate=0.0, num_heads=nh, causal=True)
    h = P.layers.dropout(ctxt, 0.1, dropout_implementation="upscale_in_train")
    out = P.layers.layer_norm(P.layers.elementwise_add(x, h),
                              begin_norm_axis=2)
    loss = P.layers.mean(P.layers.elementwise_mul(out, out))
    P.optimizer.Adam(1e-3).minimize(loss)
    return ("x",), [loss.name]


def _classifier(P):
    """tests/test_fusion_pass.py: fc + gelu + dropout, then a classifier."""
    x = P.data("x", [32, 64])
    y = P.data("y", [32, 1], "int64")
    h = P.layers.fc(x, 128, act="gelu")
    h = P.layers.dropout(h, 0.3, dropout_implementation="upscale_in_train")
    logits = P.layers.fc(h, 16)
    loss = P.layers.mean(P.layers.softmax_with_cross_entropy(logits, y))
    P.optimizer.SGD(0.1).minimize(loss)
    return ("x", "y"), [loss.name]


def _fetched_preactivation(P):
    x = P.data("x", [8, 64])
    h = P.layers.fc(x, 64, act="gelu")
    m = P.layers.mean(h)
    pre = next(o for o in P.default_main_program().global_block().ops
               if o.type == "elementwise_add").outputs["Out"][0]
    return ("x",), [m.name, pre]


def _downgrade_dropout(P):
    x = P.data("x", [8, 64])
    h = P.layers.fc(x, 64, act="gelu")
    h = P.layers.dropout(h, 0.3)    # downgrade_in_infer (default)
    return ("x",), [P.layers.mean(h).name]


def _matmul_residual_only(P):
    x = P.data("x", [8, 64])
    h = P.layers.fc(x, 64, bias_attr=False)
    return ("x",), [P.layers.mean(P.layers.elementwise_add(x, h)).name]


def _residual_two_consumers(P):
    x = P.data("x", [8, 64])
    h1 = P.layers.fc(x, 128, act="gelu")
    h2 = P.layers.fc(h1, 64)
    out = P.layers.layer_norm(P.layers.elementwise_add(h2, x),
                              begin_norm_axis=1)
    loss = P.layers.elementwise_add(P.layers.mean(out), P.layers.mean(h2))
    return ("x",), [loss.name]


def _shared_input_residual(P, act="gelu"):
    """x feeds both the up-projection and the residual add."""
    x = P.data("x", [8, 64])
    x.stop_gradient = False
    h1 = P.layers.fc(x, 128, act=act)
    h2 = P.layers.fc(h1, 64)
    out = P.layers.layer_norm(P.layers.elementwise_add(h2, x),
                              begin_norm_axis=1)
    loss = P.layers.mean(P.layers.elementwise_mul(out, out))
    P.optimizer.Adam(1e-3).minimize(loss)
    return ("x",), [loss.name]


def _bert(P, fused_attention):
    cfg_cls = JaxBertConfig if P is jpt else BertConfig
    build = jax_bert if P is jpt else build_bert_pretrain
    cfg = cfg_cls.tiny()
    cfg.fused_attention = fused_attention
    loss, _ = build(cfg, seq_len=32)
    P.optimizer.Adam(1e-3).minimize(loss)
    return ("src_ids", "input_mask", "masked_labels"), [loss.name]


PROGRAMS = {
    "bert_tiny_fused_attention": lambda P: _bert(P, True),
    "bert_tiny_unfused_attention": lambda P: _bert(P, False),
    "encoder_block": _encoder_block,
    "encoder_block_relu_no_dropout": lambda P: _encoder_block(
        P, dropout=0.0, act="relu"),
    "encoder_block_fetch_gelu": _encoder_block_fetch_gelu,
    "attention_tail": _attention_tail,
    "classifier": _classifier,
    "fetched_preactivation": _fetched_preactivation,
    "downgrade_dropout": _downgrade_dropout,
    "matmul_residual_only": _matmul_residual_only,
    "residual_two_consumers": _residual_two_consumers,
    "shared_input_residual": _shared_input_residual,
}


def _build(P, name):
    main, startup = P.Program(), P.Program()
    startup.random_seed = 7
    main.random_seed = 11
    with P.program_guard(main, startup), P.unique_name.guard():
        feeds, fetches = PROGRAMS[name](P)
    return main, startup, feeds, fetches


def _describe(plan):
    if plan is None:
        return None
    groups = [dict(kind=g.kind, pattern=g.pattern,
                   members=[m.uid for m in g.members],
                   types=[m.type for m in g.members],
                   roles=sorted(g.roles.items()), final_slot=g.final_slot,
                   internal=sorted(g.internal), act=g.act,
                   act_attrs=g.act_attrs, dropout=g.dropout, norm=g.norm,
                   extra=g.extra)
              for g in plan.groups]
    return dict(groups=groups, skip=sorted(plan.skip_uids),
                by_last=sorted(plan.by_last),
                member_group=sorted((u, g.gid) for u, g in
                                    plan.member_group.items()))


def _plans(name, block):
    out = []
    for P, planner in ((jpt, jfusion), (pt, fusion)):
        main, _, feeds, fetches = _build(P, name)
        out.append(_describe(planner.plan_fusion(
            main, list(main.global_block().ops), feeds, fetches,
            block_patterns=block)))
    return out


@pytest.mark.parametrize("block", [True, False], ids=["blocks", "chains"])
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_plan_equals_the_jax_planners(name, block):
    want, got = _plans(name, block)
    assert got == want


def test_expected_groups():
    """The plans themselves, where the JAX tests pin them."""
    def kinds(name, block=True):
        plan = _plans(name, block)[1]
        return None if plan is None else [(g["kind"], g["pattern"])
                                          for g in plan["groups"]]

    assert kinds("encoder_block") == [
        ("attn", "mul+bias+slice3+attention"),
        ("gemm", "mul+bias+dropout+residual+layer_norm"),
        ("ffn_chain", "mul+bias+gelu+mul+bias+dropout+residual+layer_norm")]
    assert kinds("encoder_block", block=False) == [
        ("gemm", "mul+bias"),
        ("gemm", "mul+bias+dropout+residual+layer_norm"),
        ("gemm", "mul+bias+gelu"),
        ("gemm", "mul+bias+dropout+residual+layer_norm")]
    assert kinds("attention_tail") == [
        ("attn", "mul+bias+slice3+attention+dropout+residual+layer_norm")]
    assert kinds("matmul_residual_only") is None
    assert kinds("residual_two_consumers") == [
        ("ffn_chain", "mul+bias+gelu+mul+bias")]
    assert kinds("bert_tiny_fused_attention") == (
        [("attn", "mul+bias+slice3+attention"),
         ("gemm", "mul+bias+dropout+residual+layer_norm"),
         ("ffn_chain",
          "mul+bias+gelu+mul+bias+dropout+residual+layer_norm")] * 2
        + [("gemm", "mul+bias")])


def test_internal_grad_sum_of_qkv_is_skipped():
    """The qkv gradient's sum over its three slices is in skip_uids."""
    main, _, feeds, fetches = _build(pt, "encoder_block")
    ops = list(main.global_block().ops)
    plan = fusion.plan_fusion(main, ops, feeds, fetches, block_patterns=True)
    attn = plan.groups[0]
    qkv_out = attn.members[1].outputs["Out"][0]
    sums = [o for o in ops if o.type == "sum"
            and o.outputs["Out"][0] == qkv_out + "@GRAD"]
    assert len(sums) == 1 and sums[0].uid in plan.skip_uids


# ---- execution on the CPU -------------------------------------------------

def _feed(name, step):
    r = np.random.RandomState(50 + step)
    if name.startswith("bert"):
        src = r.randint(0, 1024, (4, 32)).astype(np.int64)
        labels = np.where(r.rand(4, 32, 1) < 0.3, src[..., None], -1)
        return {"src_ids": src, "input_mask": np.ones((4, 32), np.float32),
                "masked_labels": labels.astype(np.int64)}
    if name == "classifier":
        return {"x": r.randn(32, 64).astype(np.float32),
                "y": r.randint(0, 16, (32, 1)).astype(np.int64)}
    shape = (8, 64) if name == "shared_input_residual" else (4, 16, 64)
    return {"x": r.randn(*shape).astype(np.float32)}


def _train(name, fuse, steps=3, build=None):
    """Losses and first-step gradients of ``steps`` runs from the
    startup's weights, fused or not."""
    main, startup, feeds, fetches = _build(pt, name) if build is None \
        else build()
    grads = [v.name for v in main.list_vars() if v.name.endswith("@GRAD")
             and main.global_block().has_var(v.name[:-5])
             and main.global_block().var(v.name[:-5]).persistable]
    bs = pt.BuildStrategy()
    bs.fuse_epilogues = fuse
    prog = pt.CompiledProgram(main, build_strategy=bs)
    scope = pt.Scope()
    exe = pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    out = []
    for s in range(steps):
        out.append(exe.run(prog, feed=_feed(name, s), scope=scope,
                           fetch_list=fetches[:1] + (grads if s == 0
                                                     else [])))
    return out, main


@pytest.mark.parametrize("name", ["encoder_block",
                                  "encoder_block_relu_no_dropout",
                                  "attention_tail", "shared_input_residual",
                                  "bert_tiny_fused_attention"])
def test_fused_training_equals_unfused(name):
    """The fused groups — the kernels' plain versions, the replayed
    attention tail, the FFN input read by two members — give the
    unfused lowering's losses and gradients.  Dropout too: on the CPU a
    fused group draws its keep mask as the dropout op it replaces does,
    from the same op seed."""
    fused, _ = _train(name, True)
    unfused, _ = _train(name, False)
    for a, b in zip(fused, unfused):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_allclose(x, y, **TOL)
    assert np.isfinite(fused[0][0]).all()


def test_bert_groups_take_their_kernel_entries(monkeypatch):
    """BERT-tiny, fused: each layer's attention through the qkv-folded
    entry, attn.out through the fused matmul, the FFN through the chain;
    the MLM head (N = 1024) through the fused matmul too."""
    calls = {"qkv": 0, "gemm": 0, "chain": 0}

    def counted(key, fn):
        def wrapper(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapper

    monkeypatch.setattr(ae, "fused_qkv_attention",
                        counted("qkv", ae.fused_qkv_attention))
    monkeypatch.setattr(fm, "fused_matmul", counted("gemm", fm.fused_matmul))
    monkeypatch.setattr(fc, "fused_ffn_chain",
                        counted("chain", fc.fused_ffn_chain))
    _train("bert_tiny_fused_attention", True, steps=1)
    assert calls == {"qkv": 2, "gemm": 3, "chain": 2}


def test_ffn_routes_by_the_chain_predicate(monkeypatch):
    """An FFN whose N the chain kernel does not take (N > 768) runs as
    two fused matmul calls; one whose K the fused matmul does not take
    either (K % 8 != 0) is replayed; both train like the unfused
    program."""
    def build(hidden):
        main, startup = pt.Program(), pt.Program()
        startup.random_seed = 7
        with pt.program_guard(main, startup), pt.unique_name.guard():
            x = pt.data("x", [8, hidden])
            h1 = pt.layers.fc(x, 256, act="relu")
            h2 = pt.layers.fc(h1, hidden)
            out = pt.layers.layer_norm(pt.layers.elementwise_add(h2, x),
                                       begin_norm_axis=1)
            loss = pt.layers.mean(pt.layers.elementwise_mul(out, out))
            pt.optimizer.Adam(1e-3).minimize(loss)
        return main, startup, loss

    calls = {"gemm": 0, "chain": 0}

    def counted(key, fn):
        def wrapper(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapper

    monkeypatch.setattr(fm, "fused_matmul", counted("gemm", fm.fused_matmul))
    monkeypatch.setattr(fc, "fused_ffn_chain",
                        counted("chain", fc.fused_ffn_chain))
    for hidden, want in ((800, {"gemm": 4, "chain": 0}),     # 2 steps
                         (804, {"gemm": 0, "chain": 0})):
        runs = []
        for fuse in (True, False):
            calls.update(gemm=0, chain=0)
            main, startup, loss = build(hidden)
            bs = pt.BuildStrategy()
            bs.fuse_epilogues = fuse
            prog = pt.CompiledProgram(main, build_strategy=bs)
            scope = pt.Scope()
            exe = pt.Executor(pt.CPUPlace())
            exe.run(startup, scope=scope)
            runs.append([exe.run(prog, scope=scope, fetch_list=[loss],
                                 feed={"x": np.random.RandomState(s).randn(
                                     8, hidden).astype(np.float32)})[0]
                         for s in range(2)])
            if fuse:
                assert calls == want, hidden
        np.testing.assert_allclose(runs[0], runs[1], **TOL)


def test_executor_knobs_select_the_plan():
    """Fusion is on by default; BuildStrategy turns it (or its block
    patterns) off, and the knobs key the lowered-block cache."""
    main, startup, _, fetches = _build(pt, "encoder_block")
    scope = pt.Scope()
    exe = pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    feed = _feed("encoder_block", 0)
    exe.run(main, feed=feed, fetch_list=fetches, scope=scope)
    kinds = []
    for fuse, block in ((True, False), (False, True)):
        bs = pt.BuildStrategy()
        bs.fuse_epilogues, bs.fuse_block_epilogues = fuse, block
        exe.run(pt.CompiledProgram(main, build_strategy=bs), feed=feed,
                fetch_list=fetches, scope=scope)
    assert len(main._exec_cache) == 3
    for lowered in main._exec_cache.values():
        plan = lowered.fusion_plan
        kinds.append(None if plan is None else
                     sorted({g.kind for g in plan.groups}))
    assert kinds == [["attn", "ffn_chain", "gemm"], ["gemm"], None]


def test_compiled_program_has_no_mesh_yet():
    main, _, _, _ = _build(pt, "classifier")
    cp = pt.CompiledProgram(main)
    assert cp.build_strategy.fuse_epilogues is True
    assert cp.build_strategy.fuse_block_epilogues is True
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        cp.with_data_parallel()
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        cp.with_sharding(None)
    with pytest.raises(ValueError, match="already compiled"):
        pt.CompiledProgram(cp)


def test_hits_count_planned_groups():
    """A plan publishes its groups on the metrics registry under the JAX
    package's series: fused_epilogue_hits_total{pattern} per group and
    fused_block_hits_total{pattern} per block family."""
    reg = get_registry()

    def hits():
        epi = reg.counter("fused_epilogue_hits_total")
        blk = reg.counter("fused_block_hits_total")
        return {("epilogue", "mul+bias+slice3+attention"):
                epi.value(pattern="mul+bias+slice3+attention"),
                ("block", "attention_epilogue"):
                blk.value(pattern="attention_epilogue"),
                ("block", "ffn_chain"): blk.value(pattern="ffn_chain")}

    before = hits()
    _plans("encoder_block", True)
    after = hits()
    assert after["block", "attention_epilogue"] == \
        before["block", "attention_epilogue"] + 1
    assert after["block", "ffn_chain"] == \
        before["block", "ffn_chain"] + 1
    assert after["epilogue", "mul+bias+slice3+attention"] == \
        before["epilogue", "mul+bias+slice3+attention"] + 1
    assert not hasattr(fusion, "HITS")


def test_kernel_wrappers_refuse_cpu_tensors():
    """The kernel entries run on CUDA tensors only: a CPU tensor handed to
    one raises (the autograd functions take the plain versions instead)."""
    x = torch.zeros(32, 64)
    with pytest.raises(ValueError, match="CUDA"):
        fm.fused_matmul_kernel(x, torch.zeros(64, 64))
    with pytest.raises(ValueError, match="CUDA"):
        fc.ffn_chain_kernel(x, torch.zeros(64, 128), None,
                            torch.zeros(128, 64))
