"""Where kernel #10 (``gemm_epilogue``, ``csrc/gemm_epilogue.cu``) spends
its time on the card.

A per-instruction profiler (ncu) does not run where the kernel is
measured, so this script builds variants of the kernel from a patched
copy of its source, each with one part compiled out, and times them at
BERT-base's attention output (``chip_smoke.GEMM_CASES["step"]``: bias,
dropout 0.1, residual, layer norm) beside the kernel as it is and cuBLAS's
``addmm`` (the GEMM and bias alone):

* ``as_is``            - the kernel, first held against its plain version;
* ``no_mma``           - the tensor-core products compiled out (the
  fragment reads and splits that feed only them go with them);
* ``no_split``         - each operand passed to the MMAs as its raw
  float32 bits with a zero small part, so the 3xTF32 split's ALU work is
  gone and the three MMAs still issue;
* ``no_philox``        - every dropout keep bit true, without Philox;
* ``no_norm_exchange`` - the row sums neither written to the peer CTA nor
  waited for (each CTA normalises by its own half's sums);
* ``no_loads``         - the TMA stages after the first two never issued
  nor waited for (the MMAs run on whatever shared memory holds).

Only ``as_is`` computes the function; the rest are timings.  On the
card: ``python3 -m paddle_tpu_torch.tools.gemm_breakdown``; it prints one
line per variant (in the order as_is .. no_loads, then back) and writes
``chiprun_out/gemm_breakdown.json``.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

#: (source text, the macro that switches it, the text compiled under the
#: macro instead); each text occurs once in the source
_SWITCHES = (
    ("  mma_tf32(c, a.big, b.small);\n  mma_tf32(c, a.small, b.big);\n"
     "  mma_tf32(c, a.big, b.big);\n", "GE_NO_MMA", ""),
    ("  big = tf32_rna(x);\n  small = tf32_rna(x - __uint_as_float(big));\n",
     "GE_NO_SPLIT", "  big = __float_as_uint(x);\n  small = 0u;\n"),
    ("  return philox_bits((uint32_t)col, (uint32_t)row, 0u, E.seed0, "
     "E.seed1) >\n         E.drop_threshold;\n", "GE_NO_PHILOX",
     "  return true;\n"),
    ("      peer_red[o] = s[i];\n", "GE_NO_EXCHANGE", ""),
    ("  cluster_arrive();  // this CTA's partial sums are in both CTAs' red\n"
     "  cluster_wait();\n", "GE_NO_EXCHANGE", ""),
    ("        issue(s + kGStages - 1, (s + kGStages - 1) % kGStages);\n",
     "GE_NO_LOADS", ""),
    ("      mbar_wait(full + s % kGStages, (s / kGStages) & 1);  // stage s "
     "is in\n", "GE_NO_LOADS", ""),
)
VARIANTS = {
    "as_is": (),
    "no_mma": ("GE_NO_MMA",),
    "no_split": ("GE_NO_SPLIT",),
    "no_philox": ("GE_NO_PHILOX",),
    "no_norm_exchange": ("GE_NO_EXCHANGE",),
    "no_loads": ("GE_NO_LOADS",),
}


def patched_source(text):
    """The kernel source with each switched text under #ifdef."""
    for old, macro, new in _SWITCHES:
        if text.count(old) != 1:
            raise RuntimeError(f"gemm_epilogue.cu no longer holds {old!r} "
                               f"exactly once")
        text = text.replace(old, f"#ifdef {macro}\n{new}#else\n{old}#endif\n")
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
        print("gemm_breakdown: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from paddle_tpu_torch import _cuda
    from paddle_tpu_torch.ops import fused_matmul as fm

    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    libs = build(_cuda.BUILD_DIR / "gemm_breakdown")
    M, K, N, opts = cs.GEMM_CASES["step"]
    c = cs._epi_case(M, K, N, 0, **opts)
    c = {k: (v.to(device) if torch.is_tensor(v) else v) for k, v in c.items()}
    args = [c[k] for k in ("x", "w", "bias", "residual", "gamma", "beta")]

    def gemm():
        return fm.fused_matmul_kernel(*args, seed=c["seed"], spec=c["spec"])

    _cuda._libs[fm.KERNEL] = libs["as_is"]
    y, z0, mask = gemm()
    y_ref, z0_ref = fm.reference_matmul_epilogue(*args, spec=c["spec"],
                                                 mask=mask)
    torch.cuda.synchronize()
    excess = max(cs._tol_excess(y, y_ref, cs.EPI_ATOL, cs.EPI_RTOL),
                 cs._tol_excess(z0, z0_ref, cs.EPI_ATOL, cs.EPI_RTOL))
    if not excess <= cs.EPI_ATOL:
        raise AssertionError(f"as_is disagrees with the plain version "
                             f"(excess {excess:.3e})")
    card = cs.card_line()
    print(card, flush=True)
    flops = 2 * M * K * N
    times = {name: [] for name in VARIANTS}

    def addmm():
        return torch.addmm(c["bias"], c["x"], c["w"])

    lib_ms = [cs.time_ms(addmm, device)]
    for name in [*VARIANTS, *reversed(VARIANTS)]:
        _cuda._libs[fm.KERNEL] = libs[name]
        ms = cs.time_ms(gemm, device)
        times[name].append(ms)
        print(f"  {name}: {ms:.5f} ms ({flops / ms / 1e9:.2f} TFLOP/s of "
              f"x w)", flush=True)
    lib_ms.append(cs.time_ms(addmm, device))
    _cuda._libs[fm.KERNEL] = libs["as_is"]
    print(f"  addmm: {lib_ms[0]:.5f}, {lib_ms[1]:.5f} ms", flush=True)
    cs.OUT_DIR.mkdir(exist_ok=True)
    (cs.OUT_DIR / "gemm_breakdown.json").write_text(json.dumps(dict(
        card=card, shape=dict(M=M, K=K, N=N, spec=str(c["spec"])),
        ms=times, addmm_ms=lib_ms, as_is_excess=excess), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
