"""The FFN as one chained two-GEMM kernel:

    x @ w1 + b1 -> gelu/relu -> (.) @ w2 + b2
      -> [dropout] -> [residual add] -> [layer/rms norm]

Counterpart of paddle_tpu/ops/pallas_ffn_chain.py (its Pallas TPU kernel
``_chain_kernel`` and the custom VJP around it).  The [M, F] activated
intermediate never reaches device memory: a cluster of two CTAs owns 64
rows and walks F in panels of 512; each CTA computes the activated half
of a panel, writes it into both CTAs' shared memory (Hopper's
distributed shared memory) and contracts the whole panel into its half
of the [64, N] output accumulator; the row norm of the output epilogue
sums across the pair.  The epilogue's arithmetic and its dropout mask
are ops/fused_matmul.py's.

* ``csrc/gemm_epilogue.cuh``, kernel ``ffn_chain`` (CUDA C++ for
  sm_90a, float32, and in bfloat16 and float16 for AMP, whose activated
  panel is rounded to that type before GEMM2): y and, when dropout is
  live, the keep mask (uint8), keyed by (seed, row, column) like
  ``gemm_epilogue``'s.  ``ffn_chain_kernel`` launches it, adds one to
  ``_cuda.LAUNCHES["ffn_chain"]`` (``ffn_chain_bf16``, ``_f16``) and
  raises on anything the kernel does not take.
* ``reference_ffn_chain`` — the same arithmetic in plain PyTorch, given
  the mask; CPU tensors take it.

``ffn_chain_shapes_ok`` is the kernel's real rule: where it fails,
core/fusion.py runs the chain as two fused matmul-epilogue calls.

Backward recomputes through the plain reference with the saved mask, as
the JAX custom VJP does: the [M, F] intermediate is never stored, at
the price of re-deriving it (two more GEMMs) in backward.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _cuda
from .fused_matmul import (DTYPES, EpilogueSpec, _ACTS, _NORMS,
                           _apply_act, _epilogue_from_z0, check_operand,
                           cpu_keep_mask, dense, seed_words)

__all__ = ["ffn_chain_shapes_ok", "ffn_chain_smem_bytes",
           "reference_ffn_chain", "ffn_chain_kernel", "fused_ffn_chain",
           "KERNEL", "LAUNCH"]

KERNEL, AMP_KERNEL = "gemm_epilogue", "gemm_epilogue_amp"
LAUNCH = "ffn_chain"

#: the kernel's tiles: rows of a two-CTA cluster, F panel (each CTA
#: computes half of it), K depth of a GEMM1 stage, F depth of a GEMM2
#: stage, stages of the ring of TMA loads; each CTA holds half of N, in
#: groups of 128 columns in registers (at most 3: 96 float32
#: accumulators a thread, so N <= 768)
BLOCK_M, BLOCK_F, BLOCK_K1, BLOCK_K2, STAGES = 64, 512, 32, 16, 2
MAX_N = 768
#: K and F must be multiples of these (a last stage or panel may be
#: partial)
K_MULTIPLE, F_MULTIPLE = 16, 128
#: dynamic shared memory a block may use on sm_90 (227 KB)
SMEM_LIMIT = 232448


def ffn_chain_smem_bytes():
    """Shared memory of one CTA, whatever the shapes: the ring of TMA
    loads (STAGES stages of x [64, 32] and w1 [32, 256], the larger of
    the two kinds of stage; a w2 stage [16, 128 * NV] fits in one), the
    activated panel [512, 64 + 4] (transposed, rows padded) and the row
    sums the pair exchanges [2, 2, 64], float32, and an 8-byte mbarrier
    a stage."""
    stage = max(BLOCK_K1 * (BLOCK_M + BLOCK_F // 2), BLOCK_K2 * MAX_N // 2)
    return (4 * (STAGES * stage + BLOCK_F * (BLOCK_M + 4) + 4 * BLOCK_M)
            + 8 * STAGES)


def ffn_chain_shapes_ok(M, K, F, N, dtype=torch.float32):
    """The chain kernel's rule, a static function of shapes and dtype:
    float32, bfloat16 or float16 (x, the weights, the residual and y;
    the biases, gamma and beta float32); K a multiple of 16 and F of
    128; N a multiple of 4, at most
    768 (each CTA of the pair holds half of the accumulator row in
    registers).  x is streamed in k tiles, so shared memory does not
    grow with K.  It takes BERT-base's FFN (M 4096, K 768, F 3072, N
    768)."""
    return (dtype in DTYPES and M >= 1
            and K >= K_MULTIPLE and K % K_MULTIPLE == 0
            and F >= F_MULTIPLE and F % F_MULTIPLE == 0
            and N >= 4 and N % 4 == 0 and N <= MAX_N)


# -- plain version -----------------------------------------------------------

def _chain(x, w1, b1, w2, b2, residual, gamma, beta, spec, mask):
    """The chain's arithmetic in float32 PyTorch (differentiable): what
    the plain forward computes and what backward recomputes.  In a
    bfloat16/float16 variant the activated intermediate is rounded to
    the element type before GEMM2 (the JAX kernel's ``h1.astype``) and y
    is returned in it."""
    z1 = torch.matmul(x.float(), w1.float())
    if b1 is not None:
        z1 = z1 + b1.float()
    h1 = _apply_act(z1, spec.act, spec.act_approximate)
    if x.dtype != torch.float32:
        h1 = h1.to(x.dtype).float()
    z2 = torch.matmul(h1, w2.float())
    if b2 is not None:
        z2 = z2 + b2.float()
    return _epilogue_from_z0(z2, mask, residual, gamma, beta,
                             spec._replace(act=None)).to(x.dtype)


def reference_ffn_chain(x, w1, b1=None, w2=None, b2=None, residual=None,
                        gamma=None, beta=None, spec=EpilogueSpec(),
                        mask=None):
    """Plain forward with the kernel's semantics: float32 GEMM1 + bias +
    activation, then GEMM2 + the fused matmul epilogue with the keep
    mask (needed when dropout is live).  Differentiable."""
    if spec.dropout_rate > 0.0 and mask is None:
        raise ValueError("dropout_rate > 0 needs the keep mask")
    return _chain(x, w1, b1, w2, b2, residual, gamma, beta, spec, mask)


# -- the kernel --------------------------------------------------------------

_P, _I, _F, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint
_ARGTYPES = [_P] * 10 + [_I] * 6 + [_F, _I, _F, _U, _U, _P]


def _fn(lib, suffix="f32"):
    fn = getattr(lib, f"ffn_chain_{suffix}")
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = _I
    return fn


def ffn_chain_kernel(x, w1, b1, w2, b2=None, residual=None, gamma=None,
                     beta=None, seed=0, spec=EpilogueSpec()):
    """Launch ``ffn_chain`` (CUDA tensors only) -> (y [M, N], keep mask
    uint8 [M, N] or None)."""
    if x.device.type != "cuda":
        raise ValueError(f"the ffn_chain kernel runs on CUDA tensors; x is "
                         f"on {x.device}")
    if x.dim() != 2 or w1.dim() != 2 or w2.dim() != 2 \
            or w1.shape[0] != x.shape[1] or w2.shape[0] != w1.shape[1]:
        raise ValueError(f"x {tuple(x.shape)} @ w1 {tuple(w1.shape)} @ w2 "
                         f"{tuple(w2.shape)} is not a two-GEMM chain")
    M, K = x.shape
    F, N = w2.shape
    if not ffn_chain_shapes_ok(M, K, F, N, x.dtype):
        raise ValueError(f"ffn_chain does not take M={M} K={K} F={F} N={N} "
                         f"{x.dtype} (ffn_chain_shapes_ok)")
    if spec.act not in _ACTS or spec.norm not in _NORMS:
        raise ValueError(f"unknown epilogue {spec}")
    if not 0.0 <= spec.dropout_rate < 1.0:
        raise ValueError(f"dropout rate {spec.dropout_rate} not in [0, 1)")
    dev, dt, f32 = x.device, x.dtype, torch.float32
    for name, t, shape, tdt in (
            ("x", x, (M, K), dt), ("w1", w1, (K, F), dt),
            ("b1", b1, (F,), f32), ("w2", w2, (F, N), dt),
            ("b2", b2, (N,), f32), ("residual", residual, (M, N), dt),
            ("gamma", gamma, (N,), f32), ("beta", beta, (N,), f32)):
        check_operand(name, t, shape, dev, tdt)
    y = torch.empty((M, N), dtype=dt, device=dev)
    mask = (torch.empty((M, N), dtype=torch.uint8, device=dev)
            if spec.dropout_rate > 0.0 else None)
    s0, s1 = seed_words(seed)

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = _cuda.library(KERNEL if dt == torch.float32 else AMP_KERNEL)
    with torch.cuda.device(dev):
        rc = _fn(lib, _cuda.type_suffix(dt))(
            ptr(x), ptr(w1), ptr(b1), ptr(w2), ptr(b2), ptr(residual),
            ptr(gamma), ptr(beta), ptr(y), ptr(mask), M, K, F, N,
            _ACTS[spec.act], int(bool(spec.act_approximate)),
            float(spec.dropout_rate), _NORMS[spec.norm],
            float(spec.norm_eps), s0, s1,
            torch.cuda.current_stream(dev).cuda_stream)
    _cuda.check(lib, rc, "ffn_chain launch")
    _cuda.LAUNCHES[_cuda.launch_key(LAUNCH, dt)] += 1
    return y, mask


# -- autograd ----------------------------------------------------------------

class _FFNChain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, residual, gamma, beta, seed, spec):
        if x.device.type == "cuda":
            y, mask = ffn_chain_kernel(
                *(dense(t) for t in (x, w1, b1, w2, b2, residual, gamma,
                                     beta)), seed=seed, spec=spec)
        else:
            mask = (cpu_keep_mask(seed, spec.dropout_rate,
                                  (x.shape[0], w2.shape[1]))
                    if spec.dropout_rate > 0.0 else None)
            y = reference_ffn_chain(x, w1, b1, w2, b2, residual, gamma,
                                    beta, spec, mask)
        # no [M, F] intermediate is saved: backward recomputes it
        ctx.save_for_backward(x, w1, b1, w2, b2, residual, gamma, beta,
                              mask)
        ctx.spec = spec
        return y

    @staticmethod
    def backward(ctx, dy):
        saved = ctx.saved_tensors
        mask = saved[-1]
        ins = [t.detach().requires_grad_() if t is not None and need
               else t for t, need in zip(saved[:-1], ctx.needs_input_grad)]
        with torch.enable_grad():
            y = _chain(*ins, ctx.spec, mask)
            wanted = [t for t in ins if t is not None and t.requires_grad]
            got = iter(torch.autograd.grad(y, wanted, dy.to(y.dtype)))
        grads = [next(got) if t is not None and t.requires_grad else None
                 for t in ins]
        return (*grads, None, None)


def fused_ffn_chain(x, w1, b1=None, w2=None, b2=None, residual=None,
                    gamma=None, beta=None, seed=0, spec=EpilogueSpec()):
    """Differentiable chained FFN: x [M, K], w1 [K, F], w2 [F, N]; b1 [F],
    b2/gamma/beta [N] or None; residual [M, N] or None; ``spec.act`` is
    the activation between the GEMMs, the rest the output epilogue.  The
    kernel on CUDA tensors (or a raise), the plain version on CPU
    tensors."""
    if torch.compiler.is_exporting():
        from . import _library      # the traced forward (ops/_library.py)
        return _library.ffn_chain(x, w1, b1, w2, b2, residual, gamma, beta,
                                  seed, spec)
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no FFN chain for device {x.device}")
    return _FFNChain.apply(x, w1, b1, w2, b2, residual, gamma, beta,
                           int(seed), spec)
