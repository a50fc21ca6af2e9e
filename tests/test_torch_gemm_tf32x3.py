"""The numerics the fused matmul epilogue kernel #10 (``gemm_epilogue``,
``paddle_tpu_torch/csrc/gemm_epilogue.cu``) rests on, emulated on the CPU:
it runs x w as 3xTF32 on the card's tensor cores.

Each float32 operand is split into big = tf32(x) and small = tf32(x -
big), tf32 being PTX's ``cvt.rna.tf32.f32`` (emulated with integer bit
operations, as in tests/test_torch_flash_tf32x3.py).  An ``mma.sync``
adds its eight exact products of k to its accumulator and rounds the sum
to float32 toward zero (the tensor cores' rounding; rounding to nearest
is not what the card does).  The kernel sums each k8 step from zero, its
three MMAs in the order big.small, small.big, big.big, and adds that step
to the running sum in IEEE float32, in K order.  Then the epilogue: bias,
the activation, dropout through a keep mask fed to both sides, the
residual, the layer or rms norm.

That must match the plain float32 version ``reference_matmul_epilogue``
within chip_smoke.py's EPI_ATOL / EPI_RTOL (1e-4, 1e-4), the tolerance
the kernel is held to on the card, in y and in z0; one TF32 product alone
(big.big) must be at least SPLIT_GAIN (10) times further off, which is
why the split is there.  It is in every case here.  The gradients that
the plain backward replays from the kernel's z0 must hold the same
tolerance at a training step's epilogue; they would not if the tensor
cores summed all of K in one accumulator, whose rounding toward zero
shrinks every element a little (the sums over rows in dgamma and dw then
add those shrinkages up), which is why each k8 step is added in IEEE.

The cases are chip_smoke.GEMM_CASES' epilogues at a small M, plus K 24
(a tail of the kernel's 32-deep stages) and N 132 (a tail of its 32-column
boxes).
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import fused_matmul as fm
from test_torch_flash_tf32x3 import SPLIT_GAIN, round_to_zero, split

#: chip_smoke.py's EPI_ATOL / EPI_RTOL (unchanged)
EPI_ATOL = EPI_RTOL = 1e-4

#: (M, K, N, options), options as chip_smoke._epi_case takes them
CASES = {
    "step": (64, 768, 768, dict(residual=True, gamma=True, beta=True,
                                dropout_rate=0.1, norm="layer_norm")),
    "no_bias": (64, 768, 768, dict(bias=False)),
    "relu": (48, 768, 3072, dict(act="relu")),
    "gelu_tanh": (48, 768, 1024, dict(act="gelu", act_approximate=True)),
    "no_norm": (64, 768, 768, dict(residual=True, dropout_rate=0.1)),
    "rms_norm": (64, 768, 768, dict(residual=True, gamma=True,
                                    norm="rms_norm")),
    "affine_only": (64, 768, 768, dict(residual=True)),
    "ragged": (40, 512, 1000, dict(act="gelu", residual=True, gamma=True,
                                   beta=True, dropout_rate=0.1,
                                   norm="layer_norm")),
    "n128": (96, 64, 128, dict(act="gelu", gamma=True, beta=True,
                               norm="layer_norm")),
    "k24": (33, 24, 768, dict(residual=True, gamma=True, beta=True,
                              dropout_rate=0.1, norm="layer_norm")),
    "n132": (33, 256, 132, dict(act="gelu", residual=True, gamma=True,
                                beta=True, dropout_rate=0.1,
                                norm="layer_norm")),
}
#: the gradient case: the training step's epilogue at 512 rows, enough for
#: the sums over rows to show a bias in z0
GRAD_CASE = (512, 768, 768, CASES["step"][3])


def _case(M, K, N, opts, seed):
    """Inputs as chip_smoke._epi_case makes them (x and the residual of
    unit scale, w scaled by 1 / sqrt(K), bias, gamma and beta near their
    BERT values), from numpy, and a keep mask when dropout is live."""
    opts = dict(opts)
    rng = np.random.RandomState(seed)

    def rnd(*shape, scale=1.0, shift=0.0):
        return torch.from_numpy(
            (rng.randn(*shape) * scale + shift).astype(np.float32))

    x, w = rnd(M, K), rnd(K, N, scale=K ** -0.5)
    bias = rnd(N, scale=0.1) if opts.pop("bias", True) else None
    residual = rnd(M, N) if opts.pop("residual", False) else None
    gamma = rnd(N, scale=0.1, shift=1.0) if opts.pop("gamma", False) else None
    beta = rnd(N, scale=0.1) if opts.pop("beta", False) else None
    spec = fm.EpilogueSpec(**opts)
    mask = (torch.from_numpy(rng.rand(M, N) >= spec.dropout_rate)
            if spec.dropout_rate else None)
    return (x, w, bias, residual, gamma, beta), spec, mask


def _named(name):
    return _case(*CASES[name], seed=sorted(CASES).index(name))


def tensor_core_gemm(x, w, passes, steps=True):
    """x w as the kernel's MMAs: per k8 step, 3xTF32 (big.small,
    small.big, big.big) or with passes=1 big.big alone, each MMA's exact
    products added to its accumulator and rounded toward zero; with
    ``steps`` each step is summed from zero and added to the running sum
    in IEEE float32, else all of K runs in one accumulator."""
    xb, xs = (t.double() for t in split(x.float()))
    wb, ws = (t.double() for t in split(w.float()))
    terms = ((xb, ws), (xs, wb), (xb, wb)) if passes == 3 else ((xb, wb),)
    c = torch.zeros(x.shape[0], w.shape[1], dtype=torch.float32)
    for k0 in range(0, x.shape[1], 8):
        t = torch.zeros_like(c) if steps else c
        for a, b in terms:
            t = round_to_zero(t.double() + a[:, k0:k0 + 8] @ b[k0:k0 + 8])
        c = c + t if steps else t
    return c


def emulated(x, w, bias, residual, gamma, beta, spec, mask, passes,
             steps=True):
    """The kernel's arithmetic: z0 = x w through ``tensor_core_gemm`` (+
    bias), then the epilogue -> (y, z0)."""
    z0 = tensor_core_gemm(x, w, passes, steps)
    if bias is not None:
        z0 = z0 + bias
    return fm._epilogue_from_z0(z0, mask, residual, gamma, beta, spec), z0


def _excess(got, want):
    """(max |got - want|, max (|got - want| - rtol |want|)) over pairs."""
    err = max(float((g - r).abs().max()) for g, r in zip(got, want))
    excess = max(float(((g - r).abs() - EPI_RTOL * r.abs()).max())
                 for g, r in zip(got, want))
    return err, excess


def _errors(name, passes):
    args, spec, mask = _named(name)
    got = emulated(*args, spec, mask, passes)
    want = fm.reference_matmul_epilogue(*args, spec=spec, mask=mask)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    return _excess(got, want)


@pytest.mark.parametrize("name", sorted(CASES))
def test_3xtf32_gemm_holds_the_kernel_tolerance(name):
    err, excess = _errors(name, passes=3)
    assert excess <= EPI_ATOL, (err, excess)


@pytest.mark.parametrize("name", sorted(CASES))
def test_1xtf32_gemm_is_ten_times_further_off(name):
    worst3, _ = _errors(name, passes=3)
    worst1, _ = _errors(name, passes=1)
    assert worst1 >= SPLIT_GAIN * worst3, (worst1, worst3)


def _grad_excess(steps):
    """The plain backward's gradients (x, w, bias, residual, gamma, beta)
    replayed from the emulated kernel's z0 and mask, against those of the
    plain forward, at GRAD_CASE: the worst excess over the tolerance."""
    args, spec, mask = _case(*GRAD_CASE, seed=len(CASES))
    dy = torch.from_numpy(np.random.RandomState(len(CASES) + 1).randn(
        GRAD_CASE[0], GRAD_CASE[2]).astype(np.float32))
    z0 = emulated(*args, spec, mask, passes=3, steps=steps)[1]
    x, w, bias = args[:3]

    def grads(z0):
        z0 = z0.detach().requires_grad_()
        extra = [t.clone().requires_grad_() for t in args[3:]]
        h = fm._epilogue_from_z0(z0, mask, *extra, spec)
        dz0, *rest = torch.autograd.grad(h, [z0, *extra], dy)
        return [dz0 @ w.t(), x.t() @ dz0, dz0.sum(0), *rest]

    want = grads(torch.matmul(x, w) + bias)
    return _excess(grads(z0), want)


def test_step_gradients_hold_the_kernel_tolerance():
    err, excess = _grad_excess(steps=True)
    assert excess <= EPI_ATOL, (err, excess)


def test_one_running_tensor_core_sum_would_miss_the_gradient_tolerance():
    err, excess = _grad_excess(steps=False)
    assert excess > EPI_ATOL, (err, excess)
