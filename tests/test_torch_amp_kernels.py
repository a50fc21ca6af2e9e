"""The bfloat16 and float16 variants of the kernels that AMP runs, held
by their plain versions against the JAX kernels in interpret mode, on the
CPU, from the same numpy-seeded inputs.

* #3 the packed flash forward (o in the element type, lse float32) and
  #5/#6 its backward (dq, dk, dv in the element type, the key-padding
  bias's gradient): ``flash_attention_packed`` against the JAX
  ``flash_attention_packed(interpret=True)`` and its custom VJP, with a
  key-padding bias holding one fully padded row, causal and not.
* #9 the qkv-folded forward: ``qkv_ref_forward`` against the JAX
  ``_qkv_attn_fwd(interpret=True)``, and ``fused_qkv_attention``'s
  gradients (x, w, the qkv bias) against the JAX ``fused_qkv_attention``.
* #10 the GEMM epilogue: ``reference_matmul_epilogue`` against the JAX
  ``fused_matmul`` kernel in interpret mode for each epilogue (dropout's
  keep mask fed to the JAX ``reference_matmul_epilogue`` and to the
  port's through ``mask=``), and ``fused_matmul``'s gradients.
* #11 the FFN chain: ``reference_ffn_chain`` against the JAX
  ``fused_ffn_chain`` in interpret mode (the JAX ``reference_ffn_chain``
  with ``mask=`` under dropout) and the gradients.

Tolerances, as a fraction of the reference's largest magnitude: both
sides round the same values at the same points (the kernels' rounding
points: p and ds before their products, the activated FFN intermediate,
z0 and y) and sum in float32 in other orders, so an output in the
element type may land one unit of its last place away: ``ELEM_TOL``
(2^-7 for bfloat16's 8 significant bits, 2^-10 for float16's 11);
float32 outputs (lse, the biases' gradients) within ``F32_TOL``.
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from paddle_tpu.ops import attention_epilogue as jae
from paddle_tpu.ops import pallas_ffn_chain as jfc
from paddle_tpu.ops import pallas_matmul as jpm
from paddle_tpu.ops import pallas_ops as jpo
from paddle_tpu_torch.ops import attention_epilogue as ae
from paddle_tpu_torch.ops import ffn_chain as fc
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import fused_matmul as fm

DTYPES = {"bfloat16": (torch.bfloat16, jnp.bfloat16),
          "float16": (torch.float16, jnp.float16)}
ELEM_TOL = {"bfloat16": 2.0 ** -7, "float16": 2.0 ** -10}
F32_TOL = 1e-4


def _t(a, dt):
    """A numpy array as a torch tensor of torch dtype ``dt``."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(dt)


def _j(a, dt):
    return jnp.asarray(np.asarray(a, np.float32), dt)


def _np(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _opt(a):
    return None if a is None else torch.from_numpy(a)


def _close(got, want, tol, what):
    got, want = _np(got), _np(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max error {err} > {tol} * {scale}"


# -- #3, #5, #6: the packed flash forward and backward ------------------------

@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("causal", [False, True])
def test_packed_flash_matches_the_jax_kernel(name, causal):
    tdt, jdt = DTYPES[name]
    B, T, H, nh = 2, 128, 128, 2
    rng = np.random.RandomState(0)
    q, k, v, do = (rng.randn(B, T, H).astype(np.float32) for _ in range(4))
    bias = np.zeros((B, 1, 1, T), np.float32)
    bias[0, ..., T - 20:] = -1e4
    bias[1] = -1e4                                    # a fully padded row
    tq, tk, tv = (_t(a, tdt).requires_grad_() for a in (q, k, v))
    tb = torch.from_numpy(bias).requires_grad_()
    o = fa.flash_attention_packed(tq, tk, tv, nh, bias=tb, causal=causal)
    assert o.dtype == tdt
    o.backward(_t(do, tdt))

    def f(q_, k_, v_, b_):
        return jpo.flash_attention_packed(q_, k_, v_, nh, bias=b_,
                                          causal=causal, interpret=True)

    jo, vjp = jax.vjp(f, _j(q, jdt), _j(k, jdt), _j(v, jdt),
                      jnp.asarray(bias))
    jdq, jdk, jdv, jdb = vjp(_j(do, jdt))
    tol = ELEM_TOL[name]
    _close(o, jo, tol, "o")
    for g, w, what in ((tq.grad, jdq, "dq"), (tk.grad, jdk, "dk"),
                       (tv.grad, jdv, "dv")):
        assert g.dtype == tdt
        _close(g, w, tol, what)
    assert tb.grad.dtype == torch.float32
    _close(tb.grad, jdb, F32_TOL, "dbias")


@pytest.mark.parametrize("name", list(DTYPES))
def test_packed_flash_lse_and_backward_pieces(name):
    """lse (float32) and the backward's plain version on its own, against
    the JAX forward kernel's lse and the JAX backward kernels, T not a
    multiple of the CUDA kernels' tiles."""
    tdt, jdt = DTYPES[name]
    B, T, H, nh = 1, 96, 128, 4
    rng = np.random.RandomState(1)
    q, k, v, do = (rng.randn(B, T, H).astype(np.float32) for _ in range(4))
    o, lse = fa.flash_ref_forward(_t(q, tdt), _t(k, tdt), _t(v, tdt), nh)
    bias_f = jnp.zeros((B, 1, T), jnp.float32)
    seed = jnp.zeros((1,), jnp.int32)
    jo, jlse = jpo._flash_fwd_packed(_j(q, jdt), _j(k, jdt), _j(v, jdt),
                                     bias_f, seed, False, 1 / math.sqrt(32),
                                     0.0, True, nh)
    _close(o, jo, ELEM_TOL[name], "o")
    assert lse.dtype == torch.float32
    _close(lse, np.asarray(jlse).reshape(B, nh, T), F32_TOL, "lse")
    dq, dk, dv, db = fa.flash_ref_backward(
        _t(q, tdt), _t(k, tdt), _t(v, tdt), None, o, lse, _t(do, tdt), nh)
    jdq, jdk, jdv, _ = jpo._flash_bwd_packed(
        _j(q, jdt), _j(k, jdt), _j(v, jdt), bias_f, seed, jo, jlse,
        _j(do, jdt), False, 1 / math.sqrt(32), 0.0, True, nh)
    for g, w, what in ((dq, jdq, "dq"), (dk, jdk, "dk"), (dv, jdv, "dv")):
        assert g.dtype == tdt
        _close(g, w, ELEM_TOL[name], what)


# -- #9: the qkv-folded forward ----------------------------------------------

@pytest.mark.parametrize("name", list(DTYPES))
def test_qkv_attention_matches_the_jax_kernel(name):
    tdt, jdt = DTYPES[name]
    B, T, K, H, nh = 2, 64, 64, 128, 2
    rng = np.random.RandomState(2)
    x = rng.randn(B, T, K).astype(np.float32)
    w = (rng.randn(K, 3 * H) / 8).astype(np.float32)
    b = rng.randn(3 * H).astype(np.float32)
    do = rng.randn(B, T, H).astype(np.float32)
    mask = np.zeros((B, 1, 1, T), np.float32)
    mask[1, ..., T - 9:] = -1e4
    # the forward kernel alone, from one pre-bias qkv in the element type
    qkv = _t(x, torch.float32).reshape(B * T, K) @ _t(w, torch.float32)
    qkv = qkv.reshape(B, T, 3 * H).numpy()
    o, lse = ae.qkv_ref_forward(_t(qkv, tdt), torch.from_numpy(b), nh,
                                torch.from_numpy(mask.reshape(B, T)))
    jo, jlse = jae._qkv_attn_fwd(
        _j(qkv, jdt), jnp.asarray(b), jnp.asarray(mask.reshape(B, 1, T)),
        jnp.zeros((1,), jnp.int32), False, 1 / math.sqrt(H // nh), 0.0,
        True, nh)
    assert o.dtype == tdt
    _close(o, jo, ELEM_TOL[name], "o")
    _close(lse, np.asarray(jlse).reshape(B, nh, T), F32_TOL, "lse")
    # the entry and its gradients (x and w in the element type, the qkv
    # bias float32, as the fusion pass hands them)
    tx, tw = _t(x, tdt).requires_grad_(), _t(w, tdt).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    out = ae.fused_qkv_attention(tx, tw, tb, nh,
                                 attn_bias=torch.from_numpy(mask))
    out.backward(_t(do, tdt))

    def f(x_, w_, b_):
        return jae.fused_qkv_attention(x_, w_, b_, nh,
                                       attn_bias=jnp.asarray(mask),
                                       interpret=True)

    jout, vjp = jax.vjp(f, _j(x, jdt), _j(w, jdt), jnp.asarray(b))
    jdx, jdw, jdb = vjp(_j(do, jdt))
    tol = ELEM_TOL[name]
    _close(out, jout, tol, "out")
    _close(tx.grad, jdx, tol, "dx")
    _close(tw.grad, jdw, tol, "dw")
    assert tb.grad.dtype == torch.float32
    # db sums dqkv's [B*T] rows of element-type values in float32
    _close(tb.grad, jdb, tol, "db")


# -- #10: the GEMM epilogue --------------------------------------------------

EPILOGUES = [
    dict(act="gelu"),
    dict(act="relu", norm="layer_norm"),
    dict(norm="layer_norm", residual=True, dropout=0.1),
    dict(act="gelu", norm="rms_norm", residual=True),
]


def _specs(e, rate=None):
    kw = dict(act=e.get("act"), norm=e.get("norm"),
              dropout_rate=e.get("dropout", 0.0) if rate is None else rate)
    return fm.EpilogueSpec(**kw), jpm.EpilogueSpec(**kw, interpret=True)


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("e", EPILOGUES, ids=lambda e: "-".join(
    f"{k}={v}" for k, v in e.items()))
def test_gemm_epilogue_matches_the_jax_kernel(name, e):
    tdt, jdt = DTYPES[name]
    M, K, N = 96, 64, 128
    rng = np.random.RandomState(3)
    x = rng.randn(M, K).astype(np.float32)
    w = (rng.randn(K, N) / 8).astype(np.float32)
    bias, gamma, beta = (rng.randn(N).astype(np.float32) for _ in range(3))
    if not e.get("norm"):
        gamma = beta = None                # the fusion pass's groups
    res = rng.randn(M, N).astype(np.float32) if e.get("residual") else None
    spec, jspec = _specs(e)
    mask = None
    if spec.dropout_rate:
        mask = rng.rand(M, N) >= spec.dropout_rate
    y, z0 = fm.reference_matmul_epilogue(
        _t(x, tdt), _t(w, tdt), torch.from_numpy(bias),
        None if res is None else _t(res, tdt), _opt(gamma), _opt(beta),
        spec, None if mask is None else torch.from_numpy(mask))
    assert y.dtype == z0.dtype == tdt
    jargs = (_j(x, jdt), _j(w, jdt), jnp.asarray(bias),
             None if res is None else _j(res, jdt),
             None if gamma is None else jnp.asarray(gamma),
             None if beta is None else jnp.asarray(beta))
    if mask is None:
        jy = jpm.fused_matmul(*jargs, None, jspec)
    else:
        jy = jpm.reference_matmul_epilogue(*jargs, spec=jspec,
                                           mask=jnp.asarray(mask, jdt))
    _close(y, jy, ELEM_TOL[name], "y")
    if mask is not None:
        return
    # the gradients (the JAX custom VJP against the port's backward)
    rng2 = np.random.RandomState(4)
    dy = rng2.randn(M, N).astype(np.float32)
    targs = [_t(x, tdt), _t(w, tdt), torch.from_numpy(bias),
             None if res is None else _t(res, tdt), _opt(gamma),
             _opt(beta)]
    for t in targs:
        if t is not None:
            t.requires_grad_()
    fm.fused_matmul(*targs, spec=spec).backward(_t(dy, tdt))

    def f(*a):
        return jpm.fused_matmul(*a, None, jspec)

    live = [i for i, a in enumerate(jargs) if a is not None]

    def fl(*a):
        full = list(jargs)
        for i, v in zip(live, a):
            full[i] = v
        return f(*full)

    _, vjp = jax.vjp(fl, *(jargs[i] for i in live))
    jgrads = dict(zip(live, vjp(_j(dy, jdt))))
    for i, (t, what) in enumerate(zip(targs, ("dx", "dw", "dbias", "dres",
                                              "dgamma", "dbeta"))):
        g = jgrads.get(i)
        if t is None:
            continue
        assert t.grad.dtype == t.dtype, what
        _close(t.grad, g, ELEM_TOL[name], what)


# -- #11: the FFN chain ------------------------------------------------------

@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_ffn_chain_matches_the_jax_kernel(name, dropout):
    tdt, jdt = DTYPES[name]
    M, K, F, N = 64, 64, 256, 128
    rng = np.random.RandomState(5)
    x = rng.randn(M, K).astype(np.float32)
    w1 = (rng.randn(K, F) / 8).astype(np.float32)
    w2 = (rng.randn(F, N) / 16).astype(np.float32)
    b1 = rng.randn(F).astype(np.float32)
    b2, gamma, beta = (rng.randn(N).astype(np.float32) for _ in range(3))
    res = rng.randn(M, N).astype(np.float32)
    spec, jspec = _specs(dict(act="gelu", norm="layer_norm"), dropout)
    mask = rng.rand(M, N) >= dropout if dropout else None
    y = fc.reference_ffn_chain(
        _t(x, tdt), _t(w1, tdt), torch.from_numpy(b1), _t(w2, tdt),
        torch.from_numpy(b2), _t(res, tdt), torch.from_numpy(gamma),
        torch.from_numpy(beta), spec,
        None if mask is None else torch.from_numpy(mask))
    assert y.dtype == tdt
    jargs = (_j(x, jdt), _j(w1, jdt), jnp.asarray(b1), _j(w2, jdt),
             jnp.asarray(b2), _j(res, jdt), jnp.asarray(gamma),
             jnp.asarray(beta))
    if mask is None:
        jy = jfc.fused_ffn_chain(*jargs, None, jspec)
    else:
        jy = jfc.reference_ffn_chain(*jargs, spec=jspec,
                                     mask=jnp.asarray(mask, jdt))
    _close(y, jy, ELEM_TOL[name], "y")
    if mask is not None:
        return
    dy = np.random.RandomState(6).randn(M, N).astype(np.float32)
    targs = [_t(x, tdt), _t(w1, tdt), torch.from_numpy(b1), _t(w2, tdt),
             torch.from_numpy(b2), _t(res, tdt), torch.from_numpy(gamma),
             torch.from_numpy(beta)]
    for t in targs:
        t.requires_grad_()
    fc.fused_ffn_chain(*targs, spec=spec).backward(_t(dy, tdt))

    def f(*a):
        return jfc.fused_ffn_chain(*a, None, jspec)

    _, vjp = jax.vjp(f, *jargs)
    jgrads = vjp(_j(dy, jdt))
    for t, g, what in zip(targs, jgrads, ("dx", "dw1", "db1", "dw2", "db2",
                                          "dres", "dgamma", "dbeta")):
        assert t.grad.dtype == t.dtype, what
        _close(t.grad, g, ELEM_TOL[name], what)


def test_other_dtypes_still_raise():
    """float64 (and integer) tensors are refused by every rule."""
    assert not fm.fused_shapes_ok(64, 64, 64, torch.float64)
    assert not fc.ffn_chain_shapes_ok(64, 64, 128, 64, torch.float64)
    assert not ae.attn_epilogue_shapes_ok(64, 128, 2, torch.float64)
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        assert fm.fused_shapes_ok(64, 64, 64, dt)
        assert fc.ffn_chain_shapes_ok(64, 64, 128, 64, dt)
        assert ae.attn_epilogue_shapes_ok(64, 128, 2, dt)
