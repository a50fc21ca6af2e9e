"""The port's dygraph (imperative) mode against the JAX package's, on the
CPU: the counterpart of each of tests/test_dygraph.py's 22 cases, plus
the autograd cases the two tapes could part on.

Each case runs the same numpy-seeded inputs through both packages under
``dygraph.guard()`` (the JAX package's CPU default, the port's
``guard("cpu")``); weights go from the JAX model to the port's through
``state_dict()`` → numpy → ``set_state_dict()``, after asserting both
packages name the same parameters.  Losses, outputs and gradients agree
within 1e-5 (absolute and relative), the tolerance of the JAX package's
own ``test_dygraph_static_parity``.  Random masks differ between the
packages (``jax.random`` against the port's Philox and torch
generators), so dropout is held by its statistics, as in the JAX case.

Also: gradients of intermediates and accumulation across backward
passes (torch keeps leaf gradients only), a second ``backward()`` after
the tape was cleared (torch raises on a freed graph; the JAX tape
reaches nothing and gives the root its seed), ``guard()`` raising
without a card, gradient clipping in eager mode, and ``.pdparams`` /
``.pdopt`` files written by each package and read by the other.
"""
import gc
import weakref

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as pt
from paddle_tpu import dygraph as jdg
from paddle_tpu.dygraph import nn as jnn
from paddle_tpu_torch import dygraph as dg
from paddle_tpu_torch.dygraph import nn as dnn

TOL = 1e-5


@pytest.fixture(autouse=True)
def _port_names():
    """Fresh port name generator per case (conftest gives the JAX
    package's), so both packages name parameters alike."""
    with pt.unique_name.guard():
        yield


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=tol, atol=tol)


def _carry(jmodel, pmodel):
    """JAX weights into the port's model (same key set asserted)."""
    jsd, psd = jmodel.state_dict(), pmodel.state_dict()
    assert set(jsd) == set(psd)
    pmodel.set_state_dict({k: np.asarray(v) for k, v in jsd.items()})


def _pguard():
    return dg.guard("cpu")


# -- the 22 cases of tests/test_dygraph.py ----------------------------------

def test_to_variable_and_arithmetic():
    a = np.array([1.0, 2.0, 3.0], np.float32)
    b = np.array([4.0, 5.0, 6.0], np.float32)
    with jdg.guard():
        jz = (jdg.to_variable(a) + jdg.to_variable(b)) * 2.0 - 1.0
        want, want_sg = jz.numpy(), jz.stop_gradient
    with _pguard():
        z = (dg.to_variable(a) + dg.to_variable(b)) * 2.0 - 1.0
        assert isinstance(z.value, torch.Tensor)
        _close(z.numpy(), want)
        assert z.stop_gradient and want_sg
        # float64 feeds become float32 (base.py:70-79)
        assert dg.to_variable(np.ones(2)).dtype == "float32"


def test_backward_simple_grads():
    xv = np.array([2.0, 3.0], np.float32)
    grads = []
    for D, guard in ((jdg, jdg.guard), (dg, _pguard)):
        with guard():
            x = D.to_variable(xv)
            x.stop_gradient = False
            (x * x + x).mean().backward()
            grads.append(x.gradient())
    _close(grads[1], grads[0])
    _close(grads[1], (2 * xv + 1) / 2)


def test_grad_accumulation_and_clear():
    with _pguard():
        x = dg.to_variable(np.ones(3, np.float32))
        x.stop_gradient = False
        (x * 2.0).mean().backward()
        g1 = x.gradient().copy()
        (x * 2.0).mean().backward()
        _close(x.gradient(), 2 * g1)  # grads accumulate
        x.clear_gradient()
        assert x.gradient() is None
    with jdg.guard():
        jx = jdg.to_variable(np.ones(3, np.float32))
        jx.stop_gradient = False
        (jx * 2.0).mean().backward()
    _close(g1, jx.gradient())


def test_no_grad_blocks_tape():
    with _pguard():
        x = dg.to_variable(np.ones(3, np.float32))
        x.stop_gradient = False
        with dg.no_grad():
            y = x * 5.0
        assert y.stop_gradient and not y.value.requires_grad
        z = x * 2.0
        assert not z.stop_gradient and z.value.requires_grad


def test_layers_functions_work_eagerly():
    xv = np.array([[1.0, -2.0]], np.float32)
    with jdg.guard():
        jx = jdg.to_variable(xv)
        want = [jpt.layers.relu(jx).numpy(), jpt.layers.softmax(jx).numpy(),
                jpt.layers.concat([jx, jx], axis=0).numpy()]
    with _pguard():
        x = dg.to_variable(xv)
        r = pt.layers.relu(x)
        s = pt.layers.softmax(x)
        c = pt.layers.concat([x, x], axis=0)
        assert c.shape == [2, 2]
        for got, w in zip((r, s, c), want):
            _close(got.numpy(), w)
        # param-creating layer functions must refuse dygraph, naming the
        # port's class-style layers
        with pytest.raises(RuntimeError,
                           match="dygraph.*paddle_tpu_torch.dygraph.nn"):
            pt.layers.fc(x, size=4)


def _mlp(D, N):
    class MLP(D.Layer):
        def __init__(self):
            super().__init__()
            self.l1 = N.Linear(4, 16, act="relu")
            self.l2 = N.Linear(16, 1)

        def forward(self, x):
            return self.l2(self.l1(x))

    return MLP()


def _mlp_run(P, D, N, guard, steps, weights=None):
    rng = np.random.RandomState(0)
    xs = rng.randn(32, 4).astype(np.float32)
    ys = (xs.sum(1, keepdims=True) * 0.5).astype(np.float32)
    with guard():
        D.seed(0)
        model = _mlp(D, N)
        assert len(model.parameters()) == 4
        if weights is not None:
            assert set(weights) == set(model.state_dict())
            model.set_state_dict(weights)
        w0 = {k: np.asarray(v).copy() for k, v in model.state_dict().items()}
        opt = P.optimizer.Adam(0.05, parameter_list=model.parameters())
        losses, grads0 = [], None
        for _ in range(steps):
            pred = model(D.to_variable(xs))
            loss = P.layers.mean(P.layers.square_error_cost(
                pred, D.to_variable(ys)))
            loss.backward()
            if grads0 is None:
                grads0 = {p.name: p.gradient() for p in model.parameters()}
            opt.minimize(loss)
            model.clear_gradients()
            losses.append(float(loss.numpy()))
    return w0, losses, grads0


def test_linear_and_mlp_training_loss_decreases():
    w0, jlosses, jgrads = _mlp_run(jpt, jdg, jnn, jdg.guard, 20)
    _, losses, grads = _mlp_run(pt, dg, dnn, _pguard, 20, weights=w0)
    assert losses[-1] < 0.1 * losses[0], losses
    _close(losses, jlosses)
    assert set(grads) == set(jgrads)
    for k in grads:
        _close(grads[k], jgrads[k])


def test_batchnorm_running_stats_and_eval():
    xv = (np.random.RandomState(0).randn(8, 3, 4, 4).astype(np.float32)
          * 3.0 + 1.0)
    with jdg.guard():
        jbn = jnn.BatchNorm(3, momentum=0.5)
        jbn.train()
        jy = jbn(jdg.to_variable(xv)).numpy()
        jmean = jbn._mean.numpy()
        jbn.eval()
        jye = jbn(jdg.to_variable(xv)).numpy()
    with _pguard():
        bn = dnn.BatchNorm(3, momentum=0.5)
        x = dg.to_variable(xv)
        mean0 = bn._mean.numpy().copy()
        bn.train()
        y = bn(x)
        # train mode: output normalized with batch stats
        assert abs(float(y.numpy().mean())) < 1e-4
        assert not np.allclose(bn._mean.numpy(), mean0)  # stats updated
        _close(y.numpy(), jy)
        _close(bn._mean.numpy(), jmean)
        bn.eval()
        m_after = bn._mean.numpy().copy()
        ye = bn(x)
        _close(bn._mean.numpy(), m_after)  # frozen in eval
        _close(ye.numpy(), jye)
        # running stats are excluded from the optimizer param list
        assert all(p.trainable for p in bn.parameters())
        assert len(bn.parameters()) == 2
        # eval mode is global: restore it for the cases after this one
        bn.train()
    with jdg.guard():
        jbn.train()


def test_dropout_modes():
    for D, N, guard in ((jdg, jnn, jdg.guard), (dg, dnn, _pguard)):
        with guard():
            drop = N.Dropout(0.5)
            x = D.to_variable(np.ones((100, 100), np.float32))
            drop.train()
            y = drop(x)
            zeros = float((y.numpy() == 0).mean())
            assert 0.3 < zeros < 0.7
            drop.eval()
            y = drop(x)  # downgrade_in_infer: scale by (1-p)
            assert np.allclose(y.numpy(), 0.5)
            drop.train()


def test_embedding_and_conv_pool():
    img = np.random.RandomState(3).rand(2, 1, 8, 8).astype(np.float32)
    ids = np.array([[1], [3]], np.int64)
    runs = []
    for D, N, guard in ((jdg, jnn, jdg.guard), (dg, dnn, _pguard)):
        with guard():
            emb = N.Embedding([10, 4])
            conv = N.Conv2D(1, 2, 3, padding=1, act="relu")
            pool = N.Pool2D(2, "max", 2)
            if runs:
                _carry(runs[0]["emb"], emb)
                _carry(runs[0]["conv"], conv)
            out = emb(D.to_variable(ids))
            assert out.shape[-1] == 4
            feat = pool(conv(D.to_variable(img)))
            assert feat.shape == [2, 2, 4, 4]
            # grads flow to conv weight
            feat.mean().backward()
            assert conv.weight.gradient() is not None
            runs.append(dict(emb=emb, conv=conv, out=out.numpy(),
                             feat=feat.numpy(),
                             g=conv.weight.gradient()))
    j, p = runs
    _close(p["out"], j["out"])
    _close(p["feat"], j["feat"])
    _close(p["g"], j["g"])


def test_state_dict_roundtrip_and_save_load(tmp_path):
    with _pguard():
        m1 = dnn.Linear(3, 2)
        m2 = dnn.Linear(3, 2)
        x = dg.to_variable(np.ones((1, 3), np.float32))
        assert not np.allclose(m1(x).numpy(), m2(x).numpy())
        # name-mapped state dicts: rename m1's values to m2's param names
        sd = {m2.weight.name: m1.weight.numpy(),
              m2.bias.name: m1.bias.numpy()}
        m2.set_state_dict(sd)
        _close(m1(x).numpy(), m2(x).numpy())

        path = str(tmp_path / "model")
        dg.save_dygraph(m1.state_dict(), path)
        params, opt_state = dg.load_dygraph(path)
        assert opt_state is None
        assert set(params) == set(m1.state_dict())
        with pytest.raises(KeyError, match="missing"):
            m1.set_state_dict({})


def _opt_case(D, N, P, guard, weights=None):
    with guard():
        m = N.Linear(2, 2)
        if weights is not None:
            m.set_state_dict(weights)
        w0 = {k: np.asarray(v).copy() for k, v in m.state_dict().items()}
        opt = P.optimizer.Adam(0.01, parameter_list=m.parameters())
        x = D.to_variable(np.ones((4, 2), np.float32))
        loss = m(x).mean()
        loss.backward()
        opt.minimize(loss)
        st = {k: np.asarray(v).copy() for k, v in opt.state_dict().items()}
    return w0, st, m, opt


def test_optimizer_state_dict(tmp_path):
    w0, jst, _, _ = _opt_case(jdg, jnn, jpt, jdg.guard)
    _, st, m, opt = _opt_case(dg, dnn, pt, _pguard, weights=w0)
    assert set(st) == set(jst)
    for k in st:
        _close(st[k], jst[k])
    with _pguard():
        assert any("moment1" in k for k in st)
        path = str(tmp_path / "opt")
        dg.save_dygraph(st, path)
        _, opt_state = dg.load_dygraph(path)
        assert opt_state is not None
        opt.set_state_dict(opt_state)

        # restore into a FRESH optimizer before its first minimize(): the
        # state must be applied lazily when accumulators are created
        m2 = dnn.Linear(2, 2)
        m2.set_state_dict({m2.weight.name: m.weight.numpy(),
                           m2.bias.name: m.bias.numpy()})
        opt2 = pt.optimizer.Adam(0.01, parameter_list=m2.parameters())

        def _rename(k):
            pname, acc = k.split("::")
            tgt = m2.weight.name if pname == m.weight.name else m2.bias.name
            return f"{tgt}::{acc}"

        opt2.set_state_dict({_rename(k) if "::" in k else k: v
                             for k, v in opt_state.items()})
        x = dg.to_variable(np.ones((4, 2), np.float32))
        m.clear_gradients()
        loss = m(x).mean()
        loss.backward()
        opt.minimize(loss)

        loss2 = m2(x).mean()
        loss2.backward()
        opt2.minimize(loss2)
        st2 = opt2.state_dict()
        for k, v in opt.state_dict().items():
            if "::" in k:
                _close(v, st2[_rename(k)], 1e-6)
        _close(m.weight.numpy(), m2.weight.numpy(), 1e-6)


def test_sgd_matches_manual():
    with _pguard():
        m = dnn.Linear(2, 1, bias_attr=False)
        w0 = m.weight.numpy().copy()
        opt = pt.optimizer.SGD(0.1, parameter_list=m.parameters())
        x = dg.to_variable(np.ones((4, 2), np.float32))
        loss = m(x).mean()
        loss.backward()
        opt.minimize(loss)
        # d(mean(xW))/dW = mean_i(x_ij) = 1
        _close(m.weight.numpy(), w0 - 0.1, 1e-6)


def test_regularization_in_dygraph():
    with _pguard():
        m = dnn.Linear(2, 1, bias_attr=False)
        w0 = m.weight.numpy().copy()
        opt = pt.optimizer.SGD(
            0.1, parameter_list=m.parameters(),
            regularization=pt.regularizer.L2DecayRegularizer(0.5))
        x = dg.to_variable(np.ones((4, 2), np.float32))
        loss = m(x).mean()
        loss.backward()
        opt.minimize(loss)
        _close(m.weight.numpy(), w0 - 0.1 * (1.0 + 0.5 * w0), 1e-6)


def _traced_net(D, N):
    class Net(D.Layer):
        def __init__(self):
            super().__init__()
            self.fc = N.Linear(4, 3, act="relu")
            self.out = N.Linear(3, 2)

        def forward(self, x):
            return self.out(self.fc(x))

    return Net()


def test_traced_layer_matches_and_serves(tmp_path):
    x = np.random.RandomState(0).rand(5, 4).astype(np.float32)
    with jdg.guard():
        jnet = _traced_net(jdg, jnn)
        jout = jnet(jdg.to_variable(x)).numpy()
    with _pguard():
        net = _traced_net(dg, dnn)
        _carry(jnet, net)
        dy_out, traced = dg.TracedLayer.trace(net, [dg.to_variable(x)])
        _close(dy_out.numpy(), jout)
        st_out, = traced(x)
        _close(dy_out.numpy(), st_out)
        assert [o.type for o in traced.program.global_block().ops] == [
            "matmul", "elementwise_add", "relu", "matmul",
            "elementwise_add"]

        dirname = str(tmp_path / "traced_model")
        traced.save_inference_model(dirname)

    # load back in static mode
    exe = pt.Executor(pt.CPUPlace())
    scope = pt.Scope()
    with pt.scope_guard(scope):
        prog, feeds, fetches = pt.io.load_inference_model(dirname, exe)
        out, = exe.run(prog, feed={feeds[0]: x}, fetch_list=fetches)
    _close(out, st_out)


def test_dygraph_static_parity():
    """Same constant-initialized net: dygraph loss == static loss, and
    both equal the JAX package's dygraph loss."""
    x = np.random.RandomState(1).rand(6, 4).astype(np.float32)
    losses = []
    for P, D, N, guard in ((jpt, jdg, jnn, jdg.guard),
                           (pt, dg, dnn, _pguard)):
        init = P.initializer.ConstantInitializer(0.3)
        with guard():
            lin = N.Linear(4, 2, param_attr=P.ParamAttr(initializer=init),
                           bias_attr=P.ParamAttr(
                               initializer=P.initializer.ConstantInitializer(
                                   0.1)))
            losses.append(float(P.layers.mean(
                P.layers.tanh(lin(D.to_variable(x)))).numpy()))

    main, startup = pt.Program(), pt.Program()
    init = pt.initializer.ConstantInitializer(0.3)
    with pt.program_guard(main, startup):
        xv = pt.data("x", [None, 4])
        h = pt.layers.fc(xv, 2, param_attr=pt.ParamAttr(initializer=init),
                         bias_attr=pt.ParamAttr(
                             initializer=pt.initializer.ConstantInitializer(
                                 0.1)))
        loss = pt.layers.mean(pt.layers.tanh(h))
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    st_loss, = exe.run(main, feed={"x": x}, fetch_list=[loss], scope=scope)
    _close(losses[1], losses[0])
    _close(losses[1], float(st_loss))


def test_backward_through_mixed_output_op():
    """Ops with integer side outputs (top_k Indices) must backprop."""
    with _pguard():
        x = dg.to_variable(np.array([3.0, 1.0, 2.0], np.float32))
        x.stop_gradient = False
        vals, idx = pt.layers.topk(x, 2)
        assert idx.dtype.startswith("int")
        vals.mean().backward()
        _close(x.gradient(), [0.5, 0.0, 0.5])  # top-2 are x[0], x[2]


def test_no_grad_layer_function_outputs():
    with _pguard():
        x = dg.to_variable(np.ones(3, np.float32))
        x.stop_gradient = False
        with dg.no_grad():
            y = pt.layers.relu(x)
        assert y.stop_gradient  # layer-fn path honors no_grad too


def test_batchnorm_stats_keep_stop_gradient():
    with _pguard():
        bn = dnn.BatchNorm(2)
        x = dg.to_variable(np.random.rand(4, 2, 3, 3).astype(np.float32))
        x.stop_gradient = False
        bn.train()
        bn(x).mean().backward()
        assert bn._mean.stop_gradient
        assert bn._variance.stop_gradient
        assert not bn._mean.value.requires_grad
        assert bn._mean.gradient() is None


def test_tape_pruning_bounds_memory():
    """A forward-only loop whose results are dropped keeps nothing alive:
    no strong list of recorded ops, so refcounts free every graph."""
    from paddle_tpu_torch.dygraph import engine

    with _pguard():
        engine.reset_tape()
        gc.collect()
        n0 = len(engine._NS)
        w = dg.to_variable(np.ones(4, np.float32))
        w.stop_gradient = False
        outs = []
        for _ in range(3000):  # forward-only loop, results dropped
            r = (w * 2.0).mean()
            outs.append(weakref.ref(r.value))
        assert r.value.grad_fn is not None   # recorded
        del r
        gc.collect()
        assert not [o for o in outs if o() is not None]
        # the namespace holds w and nothing else of the loop
        assert len(engine._NS) - n0 <= 1, len(engine._NS) - n0


def test_forward_hooks():
    with _pguard():
        lin = dnn.Linear(2, 2)
        calls = []
        h1 = lin.register_forward_pre_hook(
            lambda layer, ins: calls.append("pre"))
        h2 = lin.register_forward_post_hook(
            lambda layer, ins, out: calls.append("post"))
        lin(dg.to_variable(np.ones((1, 2), np.float32)))
        assert calls == ["pre", "post"]
        h1.remove()
        h2.remove()
        lin(dg.to_variable(np.ones((1, 2), np.float32)))
        assert calls == ["pre", "post"]


def _gan(P, D, N, guard, iters, weights=None):
    """tests/test_dygraph.py's GAN (reference test_imperative_gan.py):
    separate Adam optimizers for D and G, detach() isolating the
    generator from the discriminator's update."""
    rng = np.random.RandomState(7)

    class Net(D.Layer):
        def __init__(self, in_dim, hidden, out_dim, out_act=None):
            super().__init__()
            self.l1 = N.Linear(in_dim, hidden, act="relu")
            self.l2 = N.Linear(hidden, out_dim)
            self.out_act = out_act

        def forward(self, x):
            h = self.l2(self.l1(x))
            return P.layers.sigmoid(h) if self.out_act == "sigmoid" else h

    def bce(pred_prob, target_is_one):
        eps = 1e-6
        p = P.layers.clip(pred_prob, eps, 1.0 - eps)
        if target_is_one:
            return P.layers.mean(0.0 - P.layers.log(p))
        return P.layers.mean(0.0 - P.layers.log(1.0 - p))

    with guard():
        G = Net(2, 32, 1)
        Dn = Net(1, 32, 1, out_act="sigmoid")
        if weights is not None:
            G.set_state_dict(weights[0])
            Dn.set_state_dict(weights[1])
        w0 = (G.state_dict(), Dn.state_dict())
        g_opt = P.optimizer.Adam(0.005, parameter_list=G.parameters())
        d_opt = P.optimizer.Adam(0.02, parameter_list=Dn.parameters())
        checkpoints, losses = [], []
        for it in range(iters):
            real = D.to_variable(
                (rng.randn(32, 1) * 0.5 + 5.0).astype(np.float32))
            noise = D.to_variable(rng.randn(32, 2).astype(np.float32))
            fake = G(noise).detach()
            d_loss = bce(Dn(real), True) + bce(Dn(fake), False)
            d_loss.backward()
            d_opt.minimize(d_loss)
            Dn.clear_gradients()
            G.clear_gradients()
            g_loss = bce(Dn(G(noise)), True)
            g_loss.backward()
            g_opt.minimize(g_loss)
            Dn.clear_gradients()
            G.clear_gradients()
            losses.append((float(d_loss.numpy()), float(g_loss.numpy())))
            if it % 20 == 19:
                sample = G(D.to_variable(
                    rng.randn(128, 2).astype(np.float32))).numpy()
                checkpoints.append(float(sample.mean()))
    return w0, losses, checkpoints


def test_dygraph_gan_alternating_optimizers():
    """The first 3 iterations against the JAX package's from the same
    weights, then the port alone for the JAX case's 200 iterations
    (adversarial training orbits the data mean in a limit cycle, so the
    two runs are held to the JAX case's criterion, not to each other)."""
    w0, jlosses, _ = _gan(jpt, jdg, jnn, jdg.guard, 3)
    _, losses, _ = _gan(pt, dg, dnn, _pguard, 3, weights=w0)
    _close(losses, jlosses)
    with pt.unique_name.guard():
        _, _, checkpoints = _gan(pt, dg, dnn, _pguard, 200, weights=w0)
    assert np.isfinite(checkpoints).all()
    tail = float(np.mean(checkpoints[-5:]))
    assert abs(tail - 5.0) < 2.5, checkpoints


def _ptb(P, D, N, guard, steps, weights=None):
    """tests/test_dygraph.py's PTB-style LSTM LM (hand-rolled gates, T
    unrolled steps, the embedding tied to the softmax)."""

    class PtbLM(D.Layer):
        def __init__(self, vocab, hidden, steps):
            super().__init__()
            self.embed = N.Embedding([vocab, hidden])
            self.gates = N.Linear(2 * hidden, 4 * hidden)
            self.hidden = hidden
            self.steps = steps

        def forward(self, x, h, c):
            losses = []
            emb = self.embed(x)                     # [B, T, H]
            for t in range(self.steps):
                x_t = P.layers.reshape(
                    P.layers.slice(emb, axes=[1], starts=[t],
                                   ends=[t + 1]),
                    [-1, self.hidden])
                g = self.gates(P.layers.concat([x_t, h], axis=1))
                i, f, o, j = P.layers.split(g, 4, dim=1)
                c = (P.layers.sigmoid(f) * c
                     + P.layers.sigmoid(i) * P.layers.tanh(j))
                h = P.layers.sigmoid(o) * P.layers.tanh(c)
                losses.append(P.layers.matmul(
                    h, self.embed.weight, transpose_y=True))
            return losses, h, c

    vocab, hidden, T, B = 30, 16, 5, 8
    rng = np.random.RandomState(11)
    seq = np.arange(T + 1)[None, :] + rng.randint(0, vocab, (B, 1))
    seq = (seq % vocab).astype(np.int64)
    xs, ys = seq[:, :T], seq[:, 1:]
    with guard():
        model = PtbLM(vocab, hidden, T)
        if weights is not None:
            model.set_state_dict(weights)
        w0 = model.state_dict()
        opt = P.optimizer.Adam(0.05, parameter_list=model.parameters())
        losses, grads0 = [], None
        for _ in range(steps):
            h = D.to_variable(np.zeros((B, hidden), np.float32))
            c = D.to_variable(np.zeros((B, hidden), np.float32))
            logit_list, h, c = model(D.to_variable(xs), h, c)
            step_losses = [
                P.layers.mean(P.layers.softmax_with_cross_entropy(
                    logit_list[t], D.to_variable(ys[:, t:t + 1])))
                for t in range(T)]
            loss = step_losses[0]
            for sl in step_losses[1:]:
                loss = loss + sl
            loss = loss * (1.0 / T)
            loss.backward()
            if grads0 is None:
                grads0 = {p.name: p.gradient() for p in model.parameters()}
            opt.minimize(loss)
            model.clear_gradients()
            losses.append(float(loss.numpy()))
    return w0, losses, grads0


def test_dygraph_ptb_lstm_lm():
    """Two steps against the JAX package's (losses and the tied
    embedding's gradient, which sums both uses), then the port alone for
    the JAX case's 40 steps and its criterion."""
    w0, jlosses, jgrads = _ptb(jpt, jdg, jnn, jdg.guard, 2)
    _, losses, grads = _ptb(pt, dg, dnn, _pguard, 40, weights=w0)
    _close(losses[:2], jlosses)
    assert set(grads) == set(jgrads)
    for k in grads:
        _close(grads[k], jgrads[k])
    assert np.isfinite(losses).all()
    assert losses[-1] < 0.3 * losses[0], (losses[0], losses[-1])


# -- where torch autograd and the JAX tape part --------------------------

def _intermediates(D, guard, retain):
    with guard():
        x = D.to_variable(np.array([1.0, 2.0, 3.0], np.float32))
        x.stop_gradient = False
        h = x * x + x
        cut = h * 1.0
        cut.stop_gradient = True       # backward stops here
        loss = (h * 3.0).mean() + cut.mean()
        loss.backward(retain_graph=retain)
        if retain:
            loss.backward()
        return dict(x=x.gradient(), h=h.gradient(), loss=loss.gradient(),
                    cut=cut.gradient())


@pytest.mark.parametrize("retain", [False, True])
def test_intermediate_grads_and_accumulation(retain):
    """Every reached var with stop_gradient False gains .grad, the
    intermediates too (engine.py:258-264 of the JAX package); with
    retain_graph a second backward adds the same again."""
    want = _intermediates(jdg, jdg.guard, retain)
    got = _intermediates(dg, _pguard, retain)
    assert got["cut"] is None and want["cut"] is None
    for k in ("x", "h", "loss"):
        _close(got[k], want[k])
    _close(got["h"], np.full(3, (2.0 if retain else 1.0), np.float32))


def _twice(D, guard):
    with guard():
        x = D.to_variable(np.array([1.0, -2.0], np.float32))
        x.stop_gradient = False
        loss = (x * x).mean()
        loss.backward()
        g1 = x.gradient().copy()
        loss.backward()      # the tape was cleared: reaches nothing
        out = dict(g1=g1, g2=x.gradient(), loss=loss.gradient())
        # a new op on the old graph's output starts a new graph there
        y = loss * 2.0
        y.backward()
        out.update(loss_after=loss.gradient(), x_after=x.gradient())
        return out


def test_second_backward_after_the_tape_cleared():
    """JAX: a second backward() with the tape cleared reaches no
    parameter, gives the root its seed again and does not raise (torch
    raises on a freed graph)."""
    want = _twice(jdg, jdg.guard)
    got = _twice(dg, _pguard)
    for k in want:
        _close(got[k], want[k])
    _close(got["g2"], got["g1"])
    _close(got["loss"], 2.0)


def test_guard_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        with dg.guard():
            pass
    assert not dg.enabled()
    with dg.guard(pt.CPUPlace()):
        assert dg.enabled()
        assert dg.to_variable(np.ones(1)).value.device.type == "cpu"


def test_grad_clip_in_dygraph():
    """Clip first, then regularization, through the eager block, as the
    JAX optimizer orders them: the same update as the JAX package's."""
    xv = np.random.RandomState(5).randn(4, 3).astype(np.float32)
    runs = []
    for P, D, N, guard in ((jpt, jdg, jnn, jdg.guard),
                           (pt, dg, dnn, _pguard)):
        with guard():
            m = N.Linear(3, 2)
            if runs:
                m.set_state_dict(runs[0][0])
            w0 = m.state_dict()
            opt = P.optimizer.Momentum(
                0.5, 0.9, parameter_list=m.parameters(),
                grad_clip=P.clip.GradientClipByGlobalNorm(0.1),
                regularization=P.regularizer.L2DecayRegularizer(0.01))
            for _ in range(2):
                loss = P.layers.mean(P.layers.square(m(D.to_variable(xv))))
                loss.backward()
                opt.minimize(loss)
                m.clear_gradients()
            runs.append((w0, {k: np.asarray(v) for k, v in
                              m.state_dict().items()}))
    for k in runs[0][1]:
        _close(runs[1][1][k], runs[0][1][k])


def test_checkpoints_cross_between_packages(tmp_path):
    """.pdparams and .pdopt written by each package, read by the other:
    a model and optimizer restored from the other package's files take
    the same next step."""
    xv = np.random.RandomState(2).randn(5, 3).astype(np.float32)

    def step(P, D, N, guard, load=None, save=None):
        with guard():
            m = N.Linear(3, 2)
            opt = P.optimizer.Adam(0.01, parameter_list=m.parameters())
            if load is not None:
                params, state = D.load_dygraph(load)
                assert set(params) == set(m.state_dict())
                m.set_state_dict(params)
                opt.set_state_dict(state)
            loss = m(D.to_variable(xv)).mean()
            loss.backward()
            opt.minimize(loss)
            if save is not None:
                D.save_dygraph(m.state_dict(), save)
                D.save_dygraph(opt.state_dict(), save)
            return {k: np.asarray(v) for k, v in m.state_dict().items()}

    jpath, ppath = str(tmp_path / "jax"), str(tmp_path / "port")
    step(jpt, jdg, jnn, jdg.guard, save=jpath)
    with pt.unique_name.guard():
        from_jax = step(pt, dg, dnn, _pguard, load=jpath, save=ppath)
    with jpt.unique_name.guard():
        jax_next = step(jpt, jdg, jnn, jdg.guard, load=jpath)
    with jpt.unique_name.guard():
        from_port = step(jpt, jdg, jnn, jdg.guard, load=ppath)
    with pt.unique_name.guard():
        port_next = step(pt, dg, dnn, _pguard, load=ppath)
    for k in jax_next:
        _close(from_jax[k], jax_next[k])
        _close(from_port[k], port_next[k])
