"""Where kernel #11 (``ffn_chain``, ``csrc/gemm_epilogue.cu``) spends its
time on the card.

A per-instruction profiler (ncu) does not run where the kernel is
measured, so this script builds variants of the kernel from a patched
copy of its source, each with one part compiled out, and times them at
BERT-base's FFN (``chip_smoke.FFN_CASES["step"]``) beside the kernel as
it is and two cuBLAS ``addmm`` (the GEMMs alone):

* ``as_is``    - the kernel, first held against its plain version;
* ``no_gemm1`` - GEMM1's FMAs compiled out (loads, barriers, the panel
  exchange, GEMM2 and the epilogue stay);
* ``no_gemm2`` - GEMM2's FMAs compiled out;
* ``no_gemms`` - both: the loads, barriers and epilogue alone;
* ``no_loads`` - the TMA stages after the first three never issued nor
  waited for (the FMAs run on whatever shared memory holds).

Only ``as_is`` computes the function; the rest are timings.  On the
card: ``python3 -m paddle_tpu_torch.tools.ffn_chain_breakdown``; it
prints one line per variant (in the order as_is .. no_loads, then back)
and writes ``chiprun_out/ffn_chain_breakdown.json``.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

#: (source line, the macro that compiles it out)
_SWITCHES = (
    ("      ffn_gemm1(acc1, buf, buf + kRows * kBK1, warp, lane);\n",
     "FFN_NO_GEMM1"),
    ("      ffn_gemm2<NV>(acc, sH + (t - T1) * kBK2 * kLdh, buf, warp, lane);\n",
     "FFN_NO_GEMM2"),
    ("        issue(ip, it, (s + kStages - 1) % kStages);\n", "FFN_NO_LOADS"),
    ("    mbar_wait(full + s % kStages, (s / kStages) & 1);  // stage s landed\n",
     "FFN_NO_LOADS"),
)
VARIANTS = {
    "as_is": (),
    "no_gemm1": ("FFN_NO_GEMM1",),
    "no_gemm2": ("FFN_NO_GEMM2",),
    "no_gemms": ("FFN_NO_GEMM1", "FFN_NO_GEMM2"),
    "no_loads": ("FFN_NO_LOADS",),
}


def patched_source(text):
    """The kernel source with each switched line under #ifndef."""
    for line, macro in _SWITCHES:
        if text.count(line) != 1:
            raise RuntimeError(f"gemm_epilogue.cu no longer has exactly one "
                               f"line {line.strip()!r}")
        text = text.replace(line, f"#ifndef {macro}\n{line}#endif\n")
    return text


def build(out_dir):
    """{variant: ctypes library}, every nvcc started together."""
    from paddle_tpu_torch import _cuda

    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "gemm_epilogue_variants.cu"
    src.write_text(patched_source(
        _cuda.source_text("gemm_epilogue")))
    procs = {}
    for name, macros in VARIANTS.items():
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


def main():
    import torch

    if not torch.cuda.is_available():
        print("ffn_chain_breakdown: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from paddle_tpu_torch import _cuda
    from paddle_tpu_torch.ops import ffn_chain as fc

    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    libs = build(_cuda.BUILD_DIR / "ffn_chain_breakdown")
    M, K, F, N, opts = cs.FFN_CASES["step"]
    opts = dict(opts)
    c = cs._epi_case(M, K, F, 0, **opts)
    c2 = cs._epi_case(M, F, N, 50, residual=True, gamma=True, beta=True)
    args = [t.to(device) for t in (c["x"], c["w"], c["bias"], c2["w"],
                                   c2["bias"], c2["residual"], c2["gamma"],
                                   c2["beta"])]
    x, w1, b1, w2, b2 = args[:5]

    def chain():
        return fc.ffn_chain_kernel(*args, seed=c["seed"], spec=c["spec"])

    _cuda._libs[fc.KERNEL] = libs["as_is"]
    y, mask = chain()
    y_ref = fc.reference_ffn_chain(*args, spec=c["spec"], mask=mask)
    torch.cuda.synchronize()
    excess = cs._tol_excess(y, y_ref, cs.EPI_ATOL, cs.EPI_RTOL)
    if not excess <= cs.EPI_ATOL:
        raise AssertionError(f"as_is disagrees with the plain version "
                             f"(excess {excess:.3e})")
    card = cs.card_line()
    print(card, flush=True)
    flops = 2 * M * (K * F + F * N)
    times = {name: [] for name in VARIANTS}
    addmm = [cs.time_ms(lambda: torch.addmm(b2, torch.addmm(b1, x, w1), w2),
                        device, iters=50)]
    for name in [*VARIANTS, *reversed(VARIANTS)]:
        _cuda._libs[fc.KERNEL] = libs[name]
        ms = cs.time_ms(chain, device, iters=50)
        times[name].append(ms)
        print(f"  {name}: {ms:.5f} ms ({flops / ms / 1e9:.2f} TFLOP/s of "
              f"the whole chain's work)", flush=True)
    addmm.append(cs.time_ms(
        lambda: torch.addmm(b2, torch.addmm(b1, x, w1), w2), device,
        iters=50))
    print(f"  two addmm: {addmm[0]:.5f}, {addmm[1]:.5f} ms", flush=True)
    cs.OUT_DIR.mkdir(exist_ok=True)
    (cs.OUT_DIR / "ffn_chain_breakdown.json").write_text(json.dumps(dict(
        card=card, shape=dict(M=M, K=K, F=F, N=N, spec=str(c["spec"])),
        ms=times, two_addmm_ms=addmm, as_is_excess=excess), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
