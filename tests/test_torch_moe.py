"""Mixture-of-Experts in the port (``ops/moe.py`` ``moe_ffn``,
``layers.moe``, ``parallel.moe_sharding_rules``) against the JAX
package.

In this process: the op's output, aux loss and the gradients of every
input of a weighted sum of both against the JAX op (``jax.vjp``) on the
same numpy-seeded inputs — top-1, top-2, and a capacity that drops
tokens; and ``layers.moe`` training with its aux loss.

Over four gloo ranks (one spawn; the ranks import neither jax nor
paddle_tpu): ``test_moe.py``'s expert-parallel program (E 4, hidden 16,
top-2) at ``{data: 2, expert: 2}`` under ``moe_sharding_rules``, against
the JAX package's single device from the same weights; and a program
whose capacity drops tokens at ``{data: 4}``: the routing is global
(the global capacity, the global token order), so the fetched output and
three training losses equal the JAX single device's.  Two more programs
put an ``fc`` before the MoE layer, at ``{data: 2}`` (the model axis holds
no rule: its two ranks repeat the step) and ``{data: 2, expert: 2}``: a
rank's tokens reach every rank's experts, so the gradient below the
layer needs every rank's cotangent of the experts' inputs; the ``fc``'s
parameters after three steps equal the JAX single device's.

Tolerances: the op within rtol 1e-5 / atol 1e-6 forward and rtol 1e-4 /
atol 1e-6 for gradients (float32 on both sides); the mesh runs within
2e-4 (``test_moe.py``'s) of the JAX single device.
"""
import os
import time

import numpy as np
import pytest
import torch

FWD_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
MESH_TOL = 2e-4
SPAWN_TIMEOUT = 300
OP_CASES = {"top1": (1, 100.0), "top2": (2, 2.0), "drops": (2, 0.5)}


def _op_inputs(seed=0, n=24, d=8, e=4, h=16):
    rng = np.random.RandomState(seed)
    return {"X": rng.randn(n, d).astype(np.float32),
            "GateW": rng.randn(d, e).astype(np.float32),
            "W1": (rng.randn(e, d, h) * 0.3).astype(np.float32),
            "B1": (rng.randn(e, h) * 0.1).astype(np.float32),
            "W2": (rng.randn(e, h, d) * 0.3).astype(np.float32),
            "B2": (rng.randn(e, d) * 0.1).astype(np.float32)}


def _cot(seed, shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _jax_op(inputs, attrs):
    import jax
    import jax.numpy as jnp

    from paddle_tpu.core.registry import OpContext
    from paddle_tpu.ops.moe import moe_ffn

    names = sorted(inputs)
    dy = jnp.asarray(_cot(9, inputs["X"].shape))

    def f(*vals):
        o = moe_ffn(OpContext(), {n: [v] for n, v in zip(names, vals)},
                    attrs)
        return jnp.sum(o["Out"][0] * dy) + 3.0 * o["AuxLoss"][0], o

    (_, o), grads = jax.value_and_grad(f, argnums=tuple(
        range(len(names))), has_aux=True)(
        *[jnp.asarray(inputs[n]) for n in names])
    return (np.asarray(o["Out"][0]), float(o["AuxLoss"][0]),
            dict(zip(names, map(np.asarray, grads))))


def _port_op(inputs, attrs):
    from paddle_tpu_torch.core.registry import OpContext
    from paddle_tpu_torch.ops.moe import moe_ffn

    leaves = {n: torch.from_numpy(v).requires_grad_()
              for n, v in inputs.items()}
    o = moe_ffn(OpContext(), {n: [v] for n, v in leaves.items()}, attrs)
    total = (o["Out"][0] * torch.from_numpy(_cot(9, inputs["X"].shape))
             ).sum() + 3.0 * o["AuxLoss"][0]
    grads = torch.autograd.grad(total, list(leaves.values()))
    return (o["Out"][0].detach().numpy(), float(o["AuxLoss"][0].detach()),
            {n: g.numpy() for n, g in zip(leaves, grads)})


@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_moe_ffn_matches_jax(case):
    top_k, cf = OP_CASES[case]
    attrs = {"top_k": top_k, "capacity_factor": cf, "act": "gelu"}
    inputs = _op_inputs()
    out, aux, grads = _port_op(inputs, attrs)
    j_out, j_aux, j_grads = _jax_op(inputs, attrs)
    np.testing.assert_allclose(out, j_out, **FWD_TOL)
    np.testing.assert_allclose(aux, j_aux, **FWD_TOL)
    for n in inputs:
        np.testing.assert_allclose(grads[n], j_grads[n], err_msg=n,
                                   **GRAD_TOL)
    if case == "drops":
        # capacity int(2 * 24 / 4 * 0.5) = 6 slots an expert for 48 picks
        from paddle_tpu_torch.ops.moe import top_k_dispatch

        probs = torch.softmax(torch.from_numpy(
            inputs["X"] @ inputs["GateW"]), -1)
        assert top_k_dispatch(probs, 2, 6).sum() < 2 * 24


def test_moe_top_k_above_experts_raises():
    import paddle_tpu_torch as pt

    with pt.program_guard(pt.Program(), pt.Program()):
        x = pt.data("x", [None, 8])
        with pytest.raises(ValueError, match="cannot exceed num_experts"):
            pt.layers.moe(x, num_experts=2, hidden_size=4, top_k=3)


def test_moe_trains_with_aux_loss():
    import paddle_tpu_torch as pt

    main, startup = pt.Program(), pt.Program()
    startup.random_seed = 7
    with pt.program_guard(main, startup), pt.unique_name.guard():
        x = pt.data("x", [None, 8])
        y = pt.data("y", [None, 8])
        out, aux = pt.layers.moe(x, num_experts=4, hidden_size=32, top_k=2)
        loss = pt.layers.elementwise_add(
            pt.layers.mean(pt.layers.square_error_cost(out, y)),
            pt.layers.scale(aux, 0.01))
        pt.optimizer.Adam(0.01).minimize(loss)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    rng = np.random.RandomState(0)
    xv = rng.randn(32, 8).astype(np.float32)
    yv = np.tanh(xv[:, ::-1]).astype(np.float32)
    exe.run(startup, scope=scope)
    losses = [float(exe.run(main, feed={"x": xv, "y": yv},
                            fetch_list=[loss], scope=scope)[0])
              for _ in range(30)]
    assert losses[-1] < 0.5 * losses[0], (losses[0], losses[-1])
    names = [p.name for p in main.all_parameters()]
    assert sum(".expert_" in n for n in names) == 4, names


# -- programs built the same way by both packages ----------------------------

def _program(pkg, cf, train, fc=False):
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = 11
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.data("x", [None, 8])
        y = pkg.data("y", [None, 8])
        h = pkg.layers.fc(x, 8, act="tanh") if fc else x
        out, aux = pkg.layers.moe(h, num_experts=4, hidden_size=16,
                                  top_k=2, capacity_factor=cf)
        loss = pkg.layers.elementwise_add(
            pkg.layers.mean(pkg.layers.square_error_cost(out, y)),
            pkg.layers.scale(aux, 0.01))
        if train:
            # SGD below an fc: Adam's first steps barely see a
            # gradient's scale, SGD moves the fc by the gradient itself
            (pkg.optimizer.SGD(0.5) if fc else pkg.optimizer.Adam(1e-2)
             ).minimize(loss)
    return main, startup, out, loss


def _feed():
    rng = np.random.RandomState(2)
    x = rng.randn(16, 8).astype(np.float32)
    return {"x": x, "y": np.tanh(x[:, ::-1]).astype(np.float32)}


#: name -> (capacity factor, mesh, moe_sharding_rules, an fc below)
CASES = {"expert": (2.0, {"data": 2, "expert": 2}, True, False),
         "drops": (0.5, {"data": 4}, False, False),
         "fc_data": (2.0, {"data": 2, "model": 2}, False, True),
         "fc_expert": (2.0, {"data": 2, "expert": 2}, True, True)}
FC_CASES = sorted(n for n, c in CASES.items() if c[3])


def _fc_params(main):
    return [p.name for p in main.all_parameters() if p.name.startswith("fc")]


def _ranks(rank, wdir, out):
    import torch.distributed as dist

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.compiler import CompiledProgram
    from paddle_tpu_torch.parallel import build_mesh, moe_sharding_rules

    res = {}
    for name, (cf, axes, rules, fc) in CASES.items():
        main, _, y, loss = _program(pt, cf, True, fc)
        scope = pt.Scope()
        pt.io.load_params(scope, dict(np.load(os.path.join(
            wdir, f"{name}.npz"))), "cpu", program=main)
        target = CompiledProgram(main).with_sharding(
            build_mesh(axes, device_type="cpu"),
            param_rules=moe_sharding_rules() if rules else None)
        exe = pt.Executor(pt.CPUPlace())
        runs = [exe.run(target, feed=_feed(), fetch_list=[y, loss],
                        scope=scope) for _ in range(3)]
        res[name] = (runs[0][0], [float(r[1]) for r in runs])
        res[name + "_fc"] = {n: np.asarray(scope.find_var(n))
                             for n in _fc_params(main)}
        if rules and not fc:
            res["w1_shard"] = tuple(scope.find_var(next(
                p.name for p in main.all_parameters()
                if "expert_w1" in p.name)).shape)
    torch.save(res, os.path.join(out, f"moe{rank}.pt"))
    dist.barrier()


def _rank_main(rank, world, wdir, out):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(out, "store"), world),
        rank=rank, world_size=world)
    try:
        _ranks(rank, wdir, out)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import torch.multiprocessing as mp

    import paddle_tpu as jpt

    wdir = tmp_path_factory.mktemp("moe_weights")
    out = tmp_path_factory.mktemp("moe_ranks")
    ref = {}
    for name, (cf, _, _, fc) in CASES.items():
        main, startup, y, loss = _program(jpt, cf, True, fc)
        scope, exe = jpt.Scope(), jpt.Executor()
        with jpt.scope_guard(scope):
            exe.run(startup)
            np.savez(wdir / f"{name}.npz", **{
                v.name: np.asarray(scope.find_var(v.name))
                for v in main.list_vars() if v.persistable})
            r = [exe.run(main, feed=_feed(), fetch_list=[y, loss])
                 for _ in range(3)]
            ref[name + "_fc"] = {n: np.asarray(scope.find_var(n))
                                 for n in _fc_params(main)}
        ref[name] = (np.asarray(r[0][0]), [float(np.asarray(v[1]))
                                           for v in r])
    ctx = mp.start_processes(_rank_main, args=(4, str(wdir), str(out)),
                             nprocs=4, join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.terminate()
            raise TimeoutError(f"moe ranks still running after "
                               f"{SPAWN_TIMEOUT} s")
    return ref, [torch.load(os.path.join(out, f"moe{r}.pt"),
                            weights_only=False) for r in range(4)], str(wdir)


@pytest.mark.parametrize("name", sorted(CASES))
def test_moe_mesh_matches_jax_single_device(runs, name):
    ref, ranks, _ = runs
    for r in ranks:
        y, losses = r[name]
        assert np.abs(y - ref[name][0]).max() < MESH_TOL
        assert np.abs(np.subtract(losses, ref[name][1])).max() < MESH_TOL


@pytest.mark.parametrize("name", FC_CASES)
def test_moe_mesh_trains_the_layers_below(runs, name):
    """The fc below the MoE layer: after three steps its parameters equal
    the JAX single device's on every rank."""
    ref, ranks, _ = runs
    assert sorted(ref[name + "_fc"]) == ["fc_0.w_0", "fc_0.w_1"]   # w, b
    for r in ranks:
        for n, v in ref[name + "_fc"].items():
            assert np.abs(r[name + "_fc"][n] - v).max() < MESH_TOL, n


def test_expert_axis_holds_its_experts(runs):
    _, ranks, _ = runs
    for r in ranks:
        assert r["w1_shard"] == (2, 8, 16)     # E 4 over expert 2


def test_capacity_case_drops_tokens(runs):
    """The {data: 4} case's global capacity int(2 * 16 / 4 * 0.5) = 4
    drops tokens: its parity with the single device needs the global
    token order and capacity."""
    from paddle_tpu_torch.ops.moe import top_k_dispatch

    w = np.load(os.path.join(runs[2], "drops.npz"))
    gate = next(w[n] for n in w.files if w[n].shape == (8, 4))
    probs = torch.softmax(torch.from_numpy(_feed()["x"] @ gate), -1)
    assert top_k_dispatch(probs, 2, 4).sum() < 2 * 16
