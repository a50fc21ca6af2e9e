"""Where the flash kernels (``csrc/flash_attention.cu``) spend their time on
the card: the forwards #4 ``flash_fwd_flat``, #9 ``flash_fwd_qkv`` and #3
``flash_fwd_packed``, the flat backward pair #7 ``flash_bwd_dq_flat`` and
#8 ``flash_bwd_dkv_flat``, and the packed backward pair #5
``flash_bwd_dq_packed`` and #6 ``flash_bwd_dkv_packed``.

A per-instruction profiler (ncu) does not run where the kernels are
measured, so this script builds variants of the kernels from a patched
copy of their source, each with one part compiled out, and times them
beside the kernels as they are and PyTorch's fused attention (its forward
beside #4, #9 and #3, its autograd backward, dq + dk + dv, beside #7 and
#8 and beside #5 and #6): #4, #7 and #8 at phase 6's op step and phase
7's causal ring chunk (``chip_smoke.FLAT_CASES["op_step"]`` and
``["ring_p1"]``), #9, #3, #5 and #6 at one layer of the training step
(``chip_smoke.QKV_CASES["step"]``, and ``chip_smoke.FLASH_CASES["step"]``
with the model's dropout 0.1):

* ``as_is``     - the kernels, first held against their plain versions;
* ``no_mma``    - the tensor-core products compiled out (the fragment
  reads and splits that feed only them go with them);
* ``no_split``  - each operand passed to the MMAs as its raw float32 bits
  with a zero small part, so the 3xTF32 split's ALU work is gone and the
  three MMAs still issue;
* ``no_philox`` - every dropout keep bit true, without Philox (the same
  time as ``as_is`` where the case has no dropout);
* ``no_copies`` - the streamed tiles after the first never issued nor
  waited for (the MMAs run on whatever shared memory holds).

The switches sit in the helpers the kernels share, so each variant
changes all of them.  Only ``as_is`` computes the function; the rest are
timings.  Beside the parts, the backward pair's CTA shape at D <= 64:
``other_shape`` builds the other of its two shapes (4 warps, 64 rows,
two CTAs an SM, or 8 warps, 128 rows, one; ``kBwdWarps``), checked
against the plain backward too, and times #5 and #6 in six turns of each
(as is, other, other, as is, ...).  On the card: ``python3 -m
paddle_tpu_torch.tools.flash_breakdown``; it prints one line per variant
and case (the variants in order, then back) and writes
``chiprun_out/flash_breakdown.json``.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

#: (source text, times it occurs, the macro that switches it, the text
#: compiled under the macro instead)
_SWITCHES = (
    ("  mma_tf32(c, a.big, b.small);\n  mma_tf32(c, a.small, b.big);\n"
     "  mma_tf32(c, a.big, b.big);\n", 1, "FB_NO_MMA", ""),
    ("  big = tf32_rna(x);\n  small = tf32_rna(x - __uint_as_float(big));\n",
     1, "FB_NO_SPLIT", "  big = __float_as_uint(x);\n  small = 0u;\n"),
    ("  return keep_pair(P, key, query, bh);\n}\n", 1, "FB_NO_PHILOX",
     "  return true;\n}\n"),
    # the forward's and the dq kernel's key tiles
    ("    if (k0 + BK < k_end) issue(k0 + BK, (it + 1) & 1);\n", 2,
     "FB_NO_COPIES", ""),
    ("    if (q0 + BN < P.Tq) issue(q0 + BN, (it + 1) & 1);\n", 1,
     "FB_NO_COPIES", ""),
    # the backward pair's other CTA shape
    ("constexpr int kBwdWarps = 4;\n", 1, "FB_OTHER_SHAPE",
     "constexpr int kBwdWarps = 8;\n"),
)
VARIANTS = {
    "as_is": (),
    "no_mma": ("FB_NO_MMA",),
    "no_split": ("FB_NO_SPLIT",),
    "no_philox": ("FB_NO_PHILOX",),
    "no_copies": ("FB_NO_COPIES",),
}
#: the build with the packed backward's other CTA shape, and its turns
SHAPE_VARIANT = "other_shape"
SHAPE_TURNS = 6
FLAT_CASES = ("op_step", "ring_p1")
QKV_CASE = "step"
PACKED_CASE = "step"
#: the packed forward's dropout at a training layer (BertConfig's
#: attention dropout)
PACKED_RATE = 0.1


def patched_source(text):
    """The kernel source with each switched text under #ifdef."""
    for old, count, macro, new in _SWITCHES:
        if text.count(old) != count:
            raise RuntimeError(f"flash_attention.cu no longer holds {old!r} "
                               f"{count} time(s)")
        text = text.replace(old, f"#ifdef {macro}\n{new}#else\n{old}#endif\n")
    return text


def build(out_dir):
    """{variant: ctypes library}, every nvcc started together."""
    from paddle_tpu_torch import _cuda

    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "flash_attention_variants.cu"
    src.write_text(patched_source(
        _cuda.source_text("flash_attention")))
    procs = {}
    builds = {**VARIANTS, SHAPE_VARIANT: ("FB_OTHER_SHAPE",)}
    for name, macros in builds.items():
        so = out_dir / f"lib{name}.so"
        cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS,
               *(f"-D{m}" for m in macros), "-o", str(so), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True),
                       so)
    libs = {}
    for name, (proc, so) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{err}")
        lib = ctypes.CDLL(str(so))
        lib.paddle_cuda_error_string.argtypes = [ctypes.c_int]
        lib.paddle_cuda_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def sdpa_calls(c):
    """PyTorch's fused attention on the case's q, k, v with its bias (and
    the causal mask) as attn_mask: (a function that runs its forward, one
    that runs its autograd backward, dq + dk + dv)."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.attention import _NEG_INF

    q, k, v, do = (c[n] for n in ("q", "k", "v", "do"))
    Tq, Tk = q.shape[2], k.shape[2]
    attn_mask = c["bias_src"]
    if c["causal"]:
        vis = torch.ones(Tq, Tk, dtype=torch.bool, device=q.device).tril(
            Tk - Tq)
        cmask = torch.zeros(Tq, Tk, device=q.device).masked_fill(~vis,
                                                                 _NEG_INF)
        attn_mask = cmask if attn_mask is None else attn_mask + cmask
    rate = c["dropout_rate"]
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out = F.scaled_dot_product_attention(*leaves, attn_mask=attn_mask,
                                         dropout_p=rate)
    return (lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=attn_mask, dropout_p=rate),
        lambda: torch.autograd.grad(out, leaves, do, retain_graph=True))


def check_flat(c, cs, fa):
    """#4, #7 and #8 of the loaded library against their plain versions
    on the case: the worst excess over the forward's and the gradients'
    tolerances (raises past them); -> (o, lse, delta)."""
    import torch

    q, k, v, bias, do, dlse = (c[n] for n in ("q", "k", "v", "bias", "do",
                                              "dlse"))
    B, H, Tq, _ = q.shape
    Tk, rate, seed = k.shape[2], c["dropout_rate"], c["seed"]
    kw = dict(causal=c["causal"], dropout_rate=rate)
    mask = (fa.flash_kernel_dropout_mask(B, H, Tq, Tk, rate, seed, q.device)
            if rate > 0 else None)
    o, lse = fa.flash_kernel_forward_flat(q, k, v, bias, seed=seed, **kw)
    o_ref, lse_ref = fa.flash_ref_forward_flat(q, k, v, bias, keep_mask=mask,
                                               **kw)
    delta = fa.flash_delta_flat(o, do, dlse)
    got = (fa.flash_kernel_dq_flat(q, k, v, bias, do, lse, delta, seed=seed,
                                   **kw),
           *fa.flash_kernel_dkv_flat(q, k, v, bias, do, lse, delta,
                                     seed=seed, **kw))
    want = fa.flash_ref_backward_flat(q, k, v, bias, o, lse, do,
                                      keep_mask=mask, delta=delta, **kw)
    torch.cuda.synchronize()
    fwd_err = max(float((o - o_ref).abs().max()),
                  float((lse - lse_ref).abs().max()))
    excess = max(cs._tol_excess(a, b, cs.FLASH_GRAD_ATOL, cs.FLASH_GRAD_RTOL)
                 for a, b in zip(got, want))
    if not (fwd_err <= cs.FLASH_FWD_ATOL and excess <= cs.FLASH_GRAD_ATOL):
        raise AssertionError(f"as_is disagrees with the plain versions "
                             f"(forward {fwd_err:.3e}, gradients' excess "
                             f"{excess:.3e})")
    return o, lse, delta, dict(forward_err=fwd_err, grad_excess=excess)


def qkv_case(device, cs):
    """#9's inputs at QKV_CASES["step"]: the pre-bias qkv projection, its
    bias, the key padding, and the seed."""
    import torch

    B, T, nh, D, causal, with_bias, rate = cs.QKV_CASES[QKV_CASE]
    H = nh * D
    g = torch.Generator().manual_seed(cs.SEED + 700)
    qkv = torch.randn(B, T, 3 * H, generator=g).to(device)
    b = (torch.randn(3 * H, generator=g) * 0.1).to(device)
    kp = None
    if with_bias:
        kp = torch.zeros(B, T)
        kp[: B // 2, T - T // 4:] = -1e4
        kp = kp.to(device)
    return dict(qkv=qkv, b=b, kp=kp, nh=nh, causal=causal, rate=rate,
                seed=cs.SEED + 701)


def time_variants(libs, kernels, lib_fn, device, iters, label, cs, fa):
    """Each kernel under each variant (in order, then back) and the
    library call before and after: ({variant: {kernel: [ms, ms]}},
    [library ms, library ms])."""
    from paddle_tpu_torch import _cuda

    times = {name: {kn: [] for kn in kernels} for name in VARIANTS}
    lib_ms = [cs.time_ms(lib_fn, device, iters)]
    for name in [*VARIANTS, *reversed(VARIANTS)]:
        _cuda._libs[fa.KERNEL] = libs[name]
        for kn, fn in kernels.items():
            times[name][kn].append(cs.time_ms(fn, device, iters))
        print(f"  {label} {name}: " + ", ".join(
            f"{kn} {times[name][kn][-1]:.5f} ms" for kn in kernels),
            flush=True)
    lib_ms.append(cs.time_ms(lib_fn, device, iters))
    _cuda._libs[fa.KERNEL] = libs["as_is"]
    return times, lib_ms


def check_packed_bwd(c, do, o, lse, keep, cs, fa):
    """#5 and #6 of the loaded library against the plain backward on the
    case: the worst excess over the gradients' tolerance (raises past
    it)."""
    import torch

    q, k, v, kp, nh = c["q"], c["k"], c["v"], c["bias"], c["num_heads"]
    kw = dict(causal=c["causal"], dropout_rate=PACKED_RATE)
    got = fa.flash_kernel_backward(q, k, v, kp, o, lse, do, nh,
                                   seed=c["seed"], **kw)
    want = fa.flash_ref_backward(q, k, v, kp, o, lse, do, nh, keep_mask=keep,
                                 **kw)
    torch.cuda.synchronize()
    excess = max(cs._tol_excess(a, b, cs.FLASH_GRAD_ATOL, cs.FLASH_GRAD_RTOL)
                 for a, b in zip(got, want))
    if not excess <= cs.FLASH_GRAD_ATOL:
        raise AssertionError(f"the packed backward disagrees with its plain "
                             f"version (gradients' excess {excess:.3e})")
    return excess


def time_turns(libs, kernels, names, turns, device, label, cs, fa):
    """Each kernel under each named build in turns (a, b, then b, a, and
    so on): {build: {kernel: [ms] * turns}}."""
    from paddle_tpu_torch import _cuda

    times = {name: {kn: [] for kn in kernels} for name in names}
    for i in range(turns):
        for name in (names if i % 2 == 0 else names[::-1]):
            _cuda._libs[fa.KERNEL] = libs[name]
            for kn, fn in kernels.items():
                times[name][kn].append(cs.time_ms(fn, device))
            print(f"  {label} turn {i} {name}: " + ", ".join(
                f"{kn} {times[name][kn][-1]:.5f} ms" for kn in kernels),
                flush=True)
    _cuda._libs[fa.KERNEL] = libs["as_is"]
    return times


def main():
    import torch

    if not torch.cuda.is_available():
        print("flash_breakdown: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from paddle_tpu_torch import _cuda
    from paddle_tpu_torch.ops import attention_epilogue as ae
    from paddle_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    libs = build(_cuda.BUILD_DIR / "flash_breakdown")
    card = cs.card_line()
    print(card, flush=True)
    report = dict(card=card, cases={})
    for i, case in enumerate(FLAT_CASES):
        spec = cs.FLAT_CASES[case]
        c = cs.flat_case(device, *spec, seed=i)
        q, k, v, bias, do = (c[n] for n in ("q", "k", "v", "bias", "do"))
        B, H, Tq, _ = q.shape
        Tk, rate, seed = k.shape[2], c["dropout_rate"], c["seed"]
        kw = dict(causal=c["causal"], dropout_rate=rate, seed=seed)
        _cuda._libs[fa.KERNEL] = libs["as_is"]
        o, lse, delta, errors = check_flat(c, cs, fa)
        iters = 200 if Tq * Tk <= 512 * 512 else 20
        sdpa_fwd, sdpa_bwd = sdpa_calls(c)
        fwd_times, fwd_lib = time_variants(
            libs, {"fwd": lambda: fa.flash_kernel_forward_flat(
                q, k, v, bias, **kw)}, sdpa_fwd, device, iters, case, cs, fa)
        bwd_times, bwd_lib = time_variants(
            libs, {"dq": lambda: fa.flash_kernel_dq_flat(
                q, k, v, bias, do, lse, delta, **kw),
                "dkv": lambda: fa.flash_kernel_dkv_flat(
                q, k, v, bias, do, lse, delta, **kw)},
            sdpa_bwd, device, iters, case, cs, fa)
        print(f"  {case} SDPA forward: {fwd_lib[0]:.5f}, {fwd_lib[1]:.5f} "
              f"ms; backward: {bwd_lib[0]:.5f}, {bwd_lib[1]:.5f} ms",
              flush=True)
        report["cases"][case] = dict(
            shape=dict(B=B, H=H, Tq=Tq, Tk=Tk, D=q.shape[3],
                       causal=c["causal"], dropout=rate, bias=spec[6]),
            ms={name: {**fwd_times[name], **bwd_times[name]}
                for name in VARIANTS},
            sdpa_forward_ms=fwd_lib, sdpa_backward_ms=bwd_lib,
            as_is=errors)
        del c, q, k, v, bias, do, o, lse, delta, sdpa_fwd, sdpa_bwd

    import torch.nn.functional as F

    c = qkv_case(device, cs)
    qkv, b, kp, nh = c["qkv"], c["b"], c["kp"], c["nh"]
    B, T, H3 = qkv.shape
    H, rate, seed = H3 // 3, c["rate"], c["seed"]
    kw = dict(causal=c["causal"], dropout_rate=rate, seed=seed)
    keep = (fa.flash_kernel_dropout_mask(B, nh, T, T, rate, seed, device)
            if rate > 0 else None)
    o, lse = fa.flash_kernel_forward_qkv(qkv, b, nh, kp, **kw)
    o_ref, lse_ref = ae.qkv_ref_forward(qkv, b, nh, kp, c["causal"],
                                        dropout_rate=rate, keep_mask=keep)
    torch.cuda.synchronize()
    err = max(float((o - o_ref).abs().max()),
              float((lse - lse_ref).abs().max()))
    if not err <= cs.FLASH_FWD_ATOL:
        raise AssertionError(f"as_is flash_fwd_qkv disagrees with its plain "
                             f"version ({err:.3e})")
    heads = [t.reshape(B, T, nh, H // nh).transpose(1, 2)
             for t in (qkv + b).split(H, dim=-1)]
    mask4 = None if kp is None else kp[:, None, None, :]
    times, lib_ms = time_variants(
        libs, {"qkv": lambda: fa.flash_kernel_forward_qkv(qkv, b, nh, kp,
                                                          **kw)},
        lambda: F.scaled_dot_product_attention(*heads, attn_mask=mask4,
                                               dropout_p=rate),
        device, 200, f"qkv_{QKV_CASE}", cs, fa)
    print(f"  qkv_{QKV_CASE} SDPA forward: {lib_ms[0]:.5f}, {lib_ms[1]:.5f} "
          f"ms", flush=True)
    report["cases"][f"qkv_{QKV_CASE}"] = dict(
        shape=dict(B=B, T=T, nh=nh, D=H // nh, causal=c["causal"],
                   dropout=rate, bias=kp is not None),
        ms=times, sdpa_forward_ms=lib_ms, as_is=dict(forward_err=err))

    # #3 at a training layer: q, k, v column slices of one [B, T, 3H]
    # projection, the key padding, dropout
    spec = cs.FLASH_CASES[PACKED_CASE][:-1] + (PACKED_RATE,)
    c, do = cs.flash_case(device, *spec)
    q, k, v, kp, nh = c["q"], c["k"], c["v"], c["bias"], c["num_heads"]
    B, T, H = q.shape
    kw = dict(bias=kp, causal=c["causal"], dropout_rate=PACKED_RATE)
    keep = fa.flash_kernel_dropout_mask(B, nh, T, k.shape[1], PACKED_RATE,
                                        c["seed"], device)
    o, lse = fa.flash_kernel_forward(q, k, v, nh, seed=c["seed"], **kw)
    o_ref, lse_ref = fa.flash_ref_forward(q, k, v, nh, keep_mask=keep, **kw)
    torch.cuda.synchronize()
    err = max(float((o - o_ref).abs().max()),
              float((lse - lse_ref).abs().max()))
    if not err <= cs.FLASH_FWD_ATOL:
        raise AssertionError(f"as_is flash_fwd_packed disagrees with its "
                             f"plain version ({err:.3e})")
    heads = [t.reshape(B, -1, nh, H // nh).transpose(1, 2).contiguous()
             for t in (q, k, v)]
    mask4 = kp[:, None, None, :]
    times, lib_ms = time_variants(
        libs, {"packed": lambda: fa.flash_kernel_forward(
            q, k, v, nh, seed=c["seed"], **kw)},
        lambda: F.scaled_dot_product_attention(*heads, attn_mask=mask4,
                                               dropout_p=PACKED_RATE),
        device, 200, f"packed_{PACKED_CASE}", cs, fa)
    print(f"  packed_{PACKED_CASE} SDPA forward: {lib_ms[0]:.5f}, "
          f"{lib_ms[1]:.5f} ms", flush=True)
    report["cases"][f"packed_{PACKED_CASE}"] = dict(
        shape=dict(B=B, T=T, nh=nh, D=H // nh, causal=c["causal"],
                   dropout=PACKED_RATE, bias=True),
        ms=times, sdpa_forward_ms=lib_ms, as_is=dict(forward_err=err))

    # #5 and #6 on the same inputs: the parts beside SDPA's backward, then
    # the two CTA shapes in turns
    delta = fa.flash_delta(o, do, nh)
    bw = dict(causal=c["causal"], dropout_rate=PACKED_RATE, seed=c["seed"])
    bwd = {"dq": lambda: fa.flash_kernel_dq(q, k, v, kp, do, lse, delta, nh,
                                            **bw),
           "dkv": lambda: fa.flash_kernel_dkv(q, k, v, kp, do, lse, delta,
                                              nh, **bw)}
    excess = {}
    for name in ("as_is", SHAPE_VARIANT):
        _cuda._libs[fa.KERNEL] = libs[name]
        excess[name] = check_packed_bwd(c, do, o, lse, keep, cs, fa)
    _cuda._libs[fa.KERNEL] = libs["as_is"]
    leaves = [t.requires_grad_() for t in heads]
    lib_out = F.scaled_dot_product_attention(*leaves, attn_mask=mask4,
                                             dropout_p=PACKED_RATE)
    do_h = do.reshape(B, T, nh, H // nh).transpose(1, 2).contiguous()
    label = f"packed_bwd_{PACKED_CASE}"
    times, lib_ms = time_variants(
        libs, bwd, lambda: torch.autograd.grad(lib_out, leaves, do_h,
                                               retain_graph=True),
        device, 200, label, cs, fa)
    print(f"  {label} SDPA backward: {lib_ms[0]:.5f}, {lib_ms[1]:.5f} ms",
          flush=True)
    turns = time_turns(libs, bwd, ["as_is", SHAPE_VARIANT], SHAPE_TURNS,
                       device, label, cs, fa)
    report["cases"][label] = dict(
        shape=dict(B=B, T=T, nh=nh, D=H // nh, causal=c["causal"],
                   dropout=PACKED_RATE, bias=True),
        ms=times, sdpa_backward_ms=lib_ms, grad_excess=excess,
        shape_turns=turns)
    cs.OUT_DIR.mkdir(exist_ok=True)
    (cs.OUT_DIR / "flash_breakdown.json").write_text(
        json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
