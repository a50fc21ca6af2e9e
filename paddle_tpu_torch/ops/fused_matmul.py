"""Fused matmul plus epilogue: ``y = epilogue(x @ w)`` in one kernel.

Counterpart of paddle_tpu/ops/pallas_matmul.py (its Pallas TPU kernel
``_fused_kernel`` and the custom VJP around it).  The epilogue is any
composition, chosen by a static ``EpilogueSpec``, of

    bias add -> gelu/relu -> dropout -> residual add -> layer/rms norm

applied to the float32 accumulator before the row leaves the kernel, so
core/fusion.py lowers every matched fc / attention-output chain onto
one call.  The norm reduces over the whole row: a row of N values is
owned by one two-CTA cluster, whose CTAs add their halves' sums through
distributed shared memory.

Two implementations behind one autograd function, chosen by where the
tensors live and nothing else:

* ``csrc/gemm_epilogue.cuh``, kernel ``gemm_epilogue`` (CUDA C++ for
  sm_90a, float32): x @ w on the tensor cores as 3xTF32 ``mma.sync``
  (each operand split into two TF32 parts, three products: float32's
  accuracy), the epilogue on the accumulators; it writes y, the
  post-bias pre-activation z0 when the epilogue is nonlinear in it (an
  activation or a norm), and the dropout keep mask (uint8) when
  dropout is live.  Dropout keeps an
  element where its Philox-4x32-10 bits, keyed by (seed, row, column),
  exceed rate * 2^32.  ``fused_matmul_kernel`` launches it, adds one to
  ``_cuda.LAUNCHES["gemm_epilogue"]`` and raises on anything the kernel
  does not take; there is no fallback.  In bfloat16 and float16 (AMP,
  ``gemm_epilogue_bf16``/``_f16`` from ``gemm_epilogue_amp.cu``): x, w,
  the residual, y and z0 in that type, bias, gamma and beta float32,
  one TF32 product a step, z0 and y rounded where the JAX kernel
  rounds them.
* ``reference_matmul_epilogue`` — the same arithmetic in plain PyTorch,
  given the keep mask, in the call's element type.  CPU tensors take it
  (their mask from a ``torch.Generator`` seeded by the op's seed);
  ``chip_smoke.py`` holds the kernel against it on the card.

Backward is plain PyTorch on both devices, as the JAX custom VJP's is
pure XLA: the epilogue is replayed under autograd from the saved z0 and
mask (no z0 when the epilogue is affine in it: its gradient does not
depend on the point), ``dbias`` is a sum, ``dx`` and ``dw`` are
``torch.matmul`` (``matmul_f32``: summed in float32 and rounded to the
element type, where the JAX VJP rounds them).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from .. import _cuda

__all__ = ["EpilogueSpec", "fused_shapes_ok", "reference_matmul_epilogue",
           "fused_matmul_kernel", "fused_matmul", "matmul_f32", "KERNEL",
           "LAUNCH", "DTYPES", "AMP_KERNEL"]

#: the kernels' source names (float32; bfloat16 and float16) and this
#: kernel's launch-counter key
KERNEL = "gemm_epilogue"
AMP_KERNEL = "gemm_epilogue_amp"
LAUNCH = "gemm_epilogue"

#: the kernel's whole-row limit (the norm epilogue reduces a row of N
#: values in one CTA) — the JAX kernel's limit too, so an N = 30522
#: vocabulary projection replays on both
MAX_N = 8192
#: K must be a multiple of this (the rule the JAX planner gates on; the
#: kernel zero-fills K's tail past its own 32-deep stages)
BLOCK_K = 8

_ACTS = {None: 0, "gelu": 1, "relu": 2}
_NORMS = {None: 0, "layer_norm": 1, "rms_norm": 2}


class EpilogueSpec(NamedTuple):
    """Static epilogue description.  act: None | "gelu" | "relu" (gelu
    exact erf unless ``act_approximate``); norm: None | "layer_norm" |
    "rms_norm" over the last axis (population variance, rsqrt(var +
    eps))."""

    act: Optional[str] = None
    act_approximate: bool = False
    dropout_rate: float = 0.0
    norm: Optional[str] = None
    norm_eps: float = 1e-5


#: the kernel's element types: x, w, the residual, y and z0 share one;
#: bias, gamma and beta are float32
DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def fused_shapes_ok(M, K, N, dtype=torch.float32):
    """The kernel's own rule, a static function of shapes and dtype:
    float32, bfloat16 or float16; K a multiple of BLOCK_K (16-byte rows
    of x in every element type); N a multiple of 4 and at most MAX_N
    (the whole-row epilogue); any M."""
    return (dtype in DTYPES and M >= 1 and K >= BLOCK_K
            and K % BLOCK_K == 0 and N >= 4 and N % 4 == 0 and N <= MAX_N)


# -- plain versions ----------------------------------------------------------

def _apply_act(h, act, approximate):
    if act == "relu":
        return torch.relu(h)
    if act == "gelu":
        return torch.nn.functional.gelu(
            h, approximate="tanh" if approximate else "none")
    return h


def _epilogue_from_z0(z0, mask, residual, gamma, beta, spec):
    """The epilogue as a function of the pre-activation (float32): what
    backward differentiates, and what the plain forward applies."""
    h = _apply_act(z0.float(), spec.act, spec.act_approximate)
    if spec.dropout_rate > 0.0:
        h = h * mask.to(h.dtype) / (1.0 - spec.dropout_rate)
    if residual is not None:
        h = h + residual.float()
    # PyTorch's own norms: one kernel each way on the card where the
    # written-out formula is a dozen elementwise kernels and reductions
    # (this replay runs in every fused group's backward)
    gamma = None if gamma is None else gamma.float()
    beta = None if beta is None else beta.float()
    if spec.norm == "layer_norm":
        return torch.nn.functional.layer_norm(h, h.shape[-1:], gamma, beta,
                                              spec.norm_eps)
    if spec.norm == "rms_norm":
        h = torch.nn.functional.rms_norm(h, h.shape[-1:], gamma,
                                         spec.norm_eps)
        return h if beta is None else h + beta
    return h


def reference_matmul_epilogue(x, w, bias=None, residual=None, gamma=None,
                              beta=None, spec=EpilogueSpec(), mask=None):
    """Plain forward of the kernel (the JAX package's
    reference_matmul_epilogue, with z0 too): x [M, K], w [K, N], keep
    mask [M, N] (needed when dropout is live) -> (y, z0) [M, N] in x's
    element type.  The product sums in float32 and the epilogue runs on
    the float32 z; z0 and y are rounded to the element type as the
    kernel stores them (the JAX kernel's ``z.astype`` and ``h.astype``)."""
    z = torch.matmul(x.float(), w.float())
    if bias is not None:
        z = z + bias.float()
    if spec.dropout_rate > 0.0 and mask is None:
        raise ValueError("dropout_rate > 0 needs the keep mask")
    y = _epilogue_from_z0(z, mask, residual, gamma, beta, spec)
    return y.to(x.dtype), z.to(x.dtype)


# -- the kernel --------------------------------------------------------------

_P, _I, _F, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint
_ARGTYPES = [_P] * 9 + [_I, _I, _I, _I, _I, _F, _I, _F, _U, _U, _P]
#: the bfloat16/float16 entries take the float32 scratch of the pre-norm
#: rows after the mask
_ARGTYPES_T = [_P] * 10 + _ARGTYPES[9:]
#: rows of N at most this wide are normalised in registers (one chunk
#: of the kernel: pick_nb in csrc/gemm_epilogue.cuh)
NORM_IN_REGISTERS = 768


def _fn(lib, suffix="f32"):
    fn = getattr(lib, f"gemm_epilogue_{suffix}")
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES if suffix == "f32" else _ARGTYPES_T
        fn.restype = _I
    return fn


def seed_words(seed):
    seed = int(seed) & ((1 << 64) - 1)
    return seed & 0xFFFFFFFF, seed >> 32


def check_operand(name, t, shape, device, dtype=torch.float32):
    """Raise unless ``t`` is a contiguous, 16-byte aligned tensor of
    ``dtype`` and ``shape`` on ``device`` (None passes)."""
    if t is None:
        return
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, the kernel "
                         f"needs {tuple(shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def fused_matmul_kernel(x, w, bias=None, residual=None, gamma=None,
                        beta=None, seed=0, spec=EpilogueSpec()):
    """Launch ``gemm_epilogue`` (CUDA tensors only) -> (y [M, N],
    z0 [M, N] or None, keep mask uint8 [M, N] or None)."""
    if x.device.type != "cuda":
        raise ValueError(f"the gemm_epilogue kernel runs on CUDA tensors; "
                         f"x is on {x.device}")
    if x.dim() != 2 or w.dim() != 2 or w.shape[0] != x.shape[1]:
        raise ValueError(f"x {tuple(x.shape)} @ w {tuple(w.shape)} is not "
                         f"an [M, K] x [K, N] product")
    M, K = x.shape
    N = w.shape[1]
    if not fused_shapes_ok(M, K, N, x.dtype):
        raise ValueError(f"gemm_epilogue does not take M={M} K={K} N={N} "
                         f"{x.dtype} (fused_shapes_ok)")
    if spec.act not in _ACTS or spec.norm not in _NORMS:
        raise ValueError(f"unknown epilogue {spec}")
    if not 0.0 <= spec.dropout_rate < 1.0:
        raise ValueError(f"dropout rate {spec.dropout_rate} not in [0, 1)")
    dev, dt = x.device, x.dtype
    for name, t, shape, tdt in (
            ("x", x, (M, K), dt), ("w", w, (K, N), dt),
            ("bias", bias, (N,), torch.float32),
            ("residual", residual, (M, N), dt),
            ("gamma", gamma, (N,), torch.float32),
            ("beta", beta, (N,), torch.float32)):
        check_operand(name, t, shape, dev, tdt)
    y = torch.empty((M, N), dtype=dt, device=dev)
    z0 = (torch.empty_like(y) if spec.act is not None or spec.norm
          is not None else None)
    # a bfloat16/float16 y is stored after the norm: rows wider than one
    # chunk of the kernel wait for it in float32 scratch
    ybuf = (torch.empty((M, N), dtype=torch.float32, device=dev)
            if dt != torch.float32 and spec.norm is not None
            and N > NORM_IN_REGISTERS else None)
    mask = (torch.empty((M, N), dtype=torch.uint8, device=dev)
            if spec.dropout_rate > 0.0 else None)
    s0, s1 = seed_words(seed)

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = _cuda.library(KERNEL if dt == torch.float32 else AMP_KERNEL)
    with torch.cuda.device(dev):
        args = (ptr(x), ptr(w), ptr(bias), ptr(residual), ptr(gamma),
                ptr(beta), ptr(y), ptr(z0), ptr(mask), M, K, N,
                _ACTS[spec.act], int(bool(spec.act_approximate)),
                float(spec.dropout_rate), _NORMS[spec.norm],
                float(spec.norm_eps), s0, s1,
                torch.cuda.current_stream(dev).cuda_stream)
        if dt == torch.float32:
            rc = _fn(lib)(*args)
        else:
            rc = _fn(lib, _cuda.type_suffix(dt))(*args[:9], ptr(ybuf),
                                                 *args[9:])
    _cuda.check(lib, rc, "gemm_epilogue launch")
    _cuda.LAUNCHES[_cuda.launch_key(LAUNCH, dt)] += 1
    return y, z0, mask


# -- autograd ----------------------------------------------------------------

def matmul_f32(a, b):
    """a @ b summed in float32 and rounded to a's element type (the JAX
    ``dot_general(..., preferred_element_type=float32).astype``): the
    card's bfloat16/float16 matmul reduces in float32
    (``set_strict_fp32``); on the CPU the operands are widened first."""
    if a.dtype == torch.float32 or a.device.type == "cuda":
        return torch.matmul(a, b)
    return torch.matmul(a.float(), b.float()).to(a.dtype)


def cpu_keep_mask(seed, rate, shape):
    """The CPU path's keep mask, drawn as the dropout op draws its own
    (ops/nn.py) from the same op seed, so on the CPU a fused group
    drops what the unfused program drops (the kernel's Philox bits
    exist only on the card)."""
    gen = torch.Generator().manual_seed(int(seed))
    return torch.rand(shape, generator=gen) < 1.0 - rate


def dense(t):
    """``t`` as a contiguous, 16-byte aligned tensor (a copy only when it
    is not one already) — the layout the kernels read."""
    if t is None or (t.is_contiguous() and t.data_ptr() % 16 == 0):
        return t
    return t.clone(memory_format=torch.contiguous_format)


class _FusedMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, bias, residual, gamma, beta, seed, spec):
        if x.device.type == "cuda":
            y, z0, mask = fused_matmul_kernel(
                *(dense(t) for t in (x, w, bias, residual, gamma, beta)),
                seed=seed, spec=spec)
        else:
            mask = (cpu_keep_mask(seed, spec.dropout_rate,
                                  (x.shape[0], w.shape[1]))
                    if spec.dropout_rate > 0.0 else None)
            y, z0 = reference_matmul_epilogue(x, w, bias, residual, gamma,
                                              beta, spec, mask)
            if spec.act is None and spec.norm is None:
                z0 = None
        ctx.save_for_backward(x, w, bias, residual, gamma, beta, z0, mask)
        ctx.spec = spec
        return y

    @staticmethod
    def backward(ctx, dy):
        """The JAX custom VJP's: the epilogue replayed in float32 from
        z0; in a bfloat16/float16 variant dz0 and dres come back in the
        element type (z0 and the residual are stored in it), dx and dw
        sum in float32 and are rounded to it, dbias stays float32."""
        x, w, bias, residual, gamma, beta, z0, mask = ctx.saved_tensors
        needs = ctx.needs_input_grad
        dy = dy.float()
        # affine epilogue: its gradient does not depend on z0
        z0p = (z0 if z0 is not None
               else torch.zeros(dy.shape, dtype=x.dtype, device=dy.device)) \
            .detach().requires_grad_()
        extra = [t.detach().requires_grad_() if t is not None and need
                 else t for t, need in ((residual, needs[3]),
                                        (gamma, needs[4]), (beta, needs[5]))]
        with torch.enable_grad():
            h = _epilogue_from_z0(z0p, mask, *extra, ctx.spec)
            wanted = [z0p] + [t for t in extra
                              if t is not None and t.requires_grad]
            got = iter(torch.autograd.grad(h, wanted, dy))
        dz0 = next(got)
        dres, dgamma, dbeta = (next(got) if t is not None
                               and t.requires_grad else None for t in extra)
        dx = matmul_f32(dz0, w.t()) if needs[0] else None
        dw = matmul_f32(x.t(), dz0) if needs[1] else None
        dbias = (dz0.float().sum(dim=0).to(bias.dtype)
                 if bias is not None and needs[2] else None)
        return dx, dw, dbias, dres, dgamma, dbeta, None, None


def fused_matmul(x, w, bias=None, residual=None, gamma=None, beta=None,
                 seed=0, spec=EpilogueSpec()):
    """Differentiable fused matmul + epilogue: x [M, K], w [K, N];
    bias/gamma/beta [N] or None; residual [M, N] or None; ``seed`` keys
    the dropout mask.  The kernel on CUDA tensors (or a raise), the
    plain version on CPU tensors."""
    if torch.compiler.is_exporting():
        from . import _library      # the traced forward (ops/_library.py)
        return _library.fused_matmul(x, w, bias, residual, gamma, beta,
                                     seed, spec)
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no fused matmul for device {x.device}")
    return _FusedMatmul.apply(x, w, bias, residual, gamma, beta, int(seed),
                              spec)

