"""The kernels' forward entries as ``torch.library`` operators, for an
export trace.

``torch.export`` records a call it cannot look into (a ctypes launch)
only as an operator with a schema and a fake implementation.  Four
forward entries are registered here, in the ``paddle_tpu_torch``
namespace, each with the shapes and dtypes of its outputs:

* ``flash_kernel_forward`` — #3, the packed flash forward
  (ops/flash_attention.py ``flash_kernel_forward``) -> (o, lse);
* ``flash_kernel_forward_qkv`` — #9, the qkv-folded flash forward
  (``flash_kernel_forward_qkv``) -> (o, lse);
* ``fused_matmul_kernel`` — #10, the GEMM epilogue
  (ops/fused_matmul.py ``fused_matmul_kernel``) -> y;
* ``ffn_chain_kernel`` — #11, the FFN chain (ops/ffn_chain.py
  ``ffn_chain_kernel``) -> y.

Each fake returns what the launch function returns: the output in the
input's element type (float32, or bfloat16/float16 for the AMP
variants: #3's ``o`` in q's, #9's in qkv's, #10's and #11's ``y`` in
x's) and #3's and #9's ``lse`` in float32, so a bf16 Predictor's trace
carries the dtypes its run has.

On CUDA tensors each operator runs the existing launch function (which
counts ``_cuda.LAUNCHES``); on other tensors it runs the plain version,
the keep mask drawn from the seed as the CPU wrappers draw it.  There is
no second implementation.

Only tracing goes through the dispatcher: the wrappers
(``flash_attention_packed``, ``fused_qkv_attention``, ``fused_matmul``,
``fused_ffn_chain``) call these operators while
``torch.compiler.is_exporting()`` holds and their launch functions
directly otherwise, so an eager step pays no dispatch per launch.  A
traced call is a forward: the operators carry no backward.

Importing this module registers the operators; ``inference.load_exported``
does so before ``torch.export.load`` resolves their targets.  It imports
the kernel wrappers and ``_cuda``, never the program IR.
"""
import torch

from . import ffn_chain as _fc
from . import flash_attention as _fa
from . import fused_matmul as _fm
from . import attention_epilogue as _ae

__all__ = ["NAMESPACE", "flash_forward", "flash_forward_qkv",
           "fused_matmul", "ffn_chain"]

NAMESPACE = "paddle_tpu_torch"

_EPILOGUE = ("int seed, str? act, bool act_approximate, float dropout_rate, "
             "str? norm, float norm_eps")
_SCHEMAS = {
    "flash_kernel_forward": (
        "(Tensor q, Tensor k, Tensor v, int num_heads, Tensor? bias, "
        "bool causal, float sm_scale, float dropout_rate, int seed) "
        "-> (Tensor, Tensor)"),
    "flash_kernel_forward_qkv": (
        "(Tensor qkv, Tensor b_qkv, int num_heads, Tensor? bias, "
        "bool causal, float sm_scale, float dropout_rate, int seed) "
        "-> (Tensor, Tensor)"),
    "fused_matmul_kernel": (
        "(Tensor x, Tensor w, Tensor? bias, Tensor? residual, "
        f"Tensor? gamma, Tensor? beta, {_EPILOGUE}) -> Tensor"),
    "ffn_chain_kernel": (
        "(Tensor x, Tensor w1, Tensor? b1, Tensor w2, Tensor? b2, "
        "Tensor? residual, Tensor? gamma, Tensor? beta, "
        f"{_EPILOGUE}) -> Tensor"),
}


def _spec(act, act_approximate, dropout_rate, norm, norm_eps):
    return _fm.EpilogueSpec(act=act, act_approximate=act_approximate,
                            dropout_rate=dropout_rate, norm=norm,
                            norm_eps=norm_eps)


def _flash_mask(seed, rate, B, nh, Tq, Tk):
    return _fa._cpu_keep_mask(seed, rate, (B, nh, Tq, Tk)) if rate > 0 \
        else None


# -- #3 ----------------------------------------------------------------------

def _flash_plain(q, k, v, num_heads, bias, causal, sm_scale, dropout_rate,
                 seed):
    mask = _flash_mask(seed, dropout_rate, q.shape[0], num_heads,
                       q.shape[1], k.shape[1])
    return _fa.flash_ref_forward(q, k, v, num_heads, bias, causal, sm_scale,
                                 dropout_rate, mask)


def _flash_cuda(q, k, v, num_heads, bias, causal, sm_scale, dropout_rate,
                seed):
    return _fa.flash_kernel_forward(q, k, v, num_heads, bias, causal,
                                    sm_scale, dropout_rate, seed)


def _flash_fake(q, k, v, num_heads, bias, causal, sm_scale, dropout_rate,
                seed):
    B, Tq, H = q.shape
    return (q.new_empty((B, Tq, H)),
            q.new_empty((B, num_heads, Tq), dtype=torch.float32))


# -- #9 ----------------------------------------------------------------------

def _qkv_plain(qkv, b_qkv, num_heads, bias, causal, sm_scale, dropout_rate,
               seed):
    B, T, _ = qkv.shape
    mask = _flash_mask(seed, dropout_rate, B, num_heads, T, T)
    return _ae.qkv_ref_forward(qkv, b_qkv, num_heads, bias, causal, sm_scale,
                               dropout_rate, mask)


def _qkv_cuda(qkv, b_qkv, num_heads, bias, causal, sm_scale, dropout_rate,
              seed):
    return _fa.flash_kernel_forward_qkv(qkv, b_qkv.contiguous(), num_heads,
                                        bias, causal, sm_scale, dropout_rate,
                                        seed)


def _qkv_fake(qkv, b_qkv, num_heads, bias, causal, sm_scale, dropout_rate,
              seed):
    B, T, H3 = qkv.shape
    return (qkv.new_empty((B, T, H3 // 3)),
            qkv.new_empty((B, num_heads, T), dtype=torch.float32))


# -- #10 ---------------------------------------------------------------------

def _gemm_plain(x, w, bias, residual, gamma, beta, seed, act,
                act_approximate, dropout_rate, norm, norm_eps):
    spec = _spec(act, act_approximate, dropout_rate, norm, norm_eps)
    mask = (_fm.cpu_keep_mask(seed, dropout_rate, (x.shape[0], w.shape[1]))
            if dropout_rate > 0 else None)
    return _fm.reference_matmul_epilogue(x, w, bias, residual, gamma, beta,
                                         spec, mask)[0]


def _gemm_cuda(x, w, bias, residual, gamma, beta, seed, act,
               act_approximate, dropout_rate, norm, norm_eps):
    spec = _spec(act, act_approximate, dropout_rate, norm, norm_eps)
    return _fm.fused_matmul_kernel(
        *(_fm.dense(t) for t in (x, w, bias, residual, gamma, beta)),
        seed=seed, spec=spec)[0]


def _gemm_fake(x, w, *rest):
    return x.new_empty((x.shape[0], w.shape[1]))


# -- #11 ---------------------------------------------------------------------

def _chain_plain(x, w1, b1, w2, b2, residual, gamma, beta, seed, act,
                 act_approximate, dropout_rate, norm, norm_eps):
    spec = _spec(act, act_approximate, dropout_rate, norm, norm_eps)
    mask = (_fm.cpu_keep_mask(seed, dropout_rate, (x.shape[0], w2.shape[1]))
            if dropout_rate > 0 else None)
    return _fc.reference_ffn_chain(x, w1, b1, w2, b2, residual, gamma, beta,
                                   spec, mask)


def _chain_cuda(x, w1, b1, w2, b2, residual, gamma, beta, seed, act,
                act_approximate, dropout_rate, norm, norm_eps):
    spec = _spec(act, act_approximate, dropout_rate, norm, norm_eps)
    return _fc.ffn_chain_kernel(
        *(_fm.dense(t) for t in (x, w1, b1, w2, b2, residual, gamma, beta)),
        seed=seed, spec=spec)[0]


def _chain_fake(x, w1, b1, w2, *rest):
    return x.new_empty((x.shape[0], w2.shape[1]))


_IMPLS = {
    "flash_kernel_forward": (_flash_plain, _flash_cuda, _flash_fake),
    "flash_kernel_forward_qkv": (_qkv_plain, _qkv_cuda, _qkv_fake),
    "fused_matmul_kernel": (_gemm_plain, _gemm_cuda, _gemm_fake),
    "ffn_chain_kernel": (_chain_plain, _chain_cuda, _chain_fake),
}


def _register():
    for name, (plain, cuda, fake) in _IMPLS.items():
        qualname = f"{NAMESPACE}::{name}"
        torch.library.define(qualname, _SCHEMAS[name])
        # the plain version serves every device but CUDA
        torch.library.impl(qualname, "CompositeExplicitAutograd", plain)
        torch.library.impl(qualname, "CUDA", cuda)
        torch.library.register_fake(qualname, fake)


_register()
_ops = getattr(torch.ops, NAMESPACE)


# -- the traced calls the wrappers make --------------------------------------

def flash_forward(q, k, v, num_heads, bias, causal, sm_scale, dropout_rate,
                  seed):
    return _ops.flash_kernel_forward(q, k, v, int(num_heads), bias,
                                     bool(causal), float(sm_scale),
                                     float(dropout_rate), int(seed))


def flash_forward_qkv(qkv, b_qkv, num_heads, bias, causal, sm_scale,
                      dropout_rate, seed):
    return _ops.flash_kernel_forward_qkv(qkv, b_qkv, int(num_heads), bias,
                                         bool(causal), float(sm_scale),
                                         float(dropout_rate), int(seed))


def _epilogue_args(seed, spec):
    return (int(seed), spec.act, bool(spec.act_approximate),
            float(spec.dropout_rate), spec.norm, float(spec.norm_eps))


def fused_matmul(x, w, bias, residual, gamma, beta, seed, spec):
    return _ops.fused_matmul_kernel(x, w, bias, residual, gamma, beta,
                                    *_epilogue_args(seed, spec))


def ffn_chain(x, w1, b1, w2, b2, residual, gamma, beta, seed, spec):
    return _ops.ffn_chain_kernel(x, w1, b1, w2, b2, residual, gamma, beta,
                                 *_epilogue_args(seed, spec))
