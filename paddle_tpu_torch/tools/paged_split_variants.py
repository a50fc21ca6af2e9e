"""The split-key serving kernels (#1 ``ragged_paged_attention``,
``csrc/ragged_attention.cu``, and #2 ``paged_decode_attention``,
``csrc/paged_decode.cu``, both from ``csrc/paged_split.cuh``) against
variants of their design, on the card.

Each build variant compiles both sources with the header's build switches
set otherwise; each span variant changes the wrappers' span rule
(``generation.attention.MAX_SPLIT``, ``MIN_SPAN_KEYS``).  All are timed at
``chip_smoke.py`` phase 2's step and long cases, and the paged decode
kernel also at ``decode_lone``: the long case's first 8 slots with one
of 2048 keys and the rest of 0..128 (the case a span split is for):

* ``as_is``            - the kernels;
* ``heads_inner``, ``rows_inner`` - the grid order (the ragged kernel
  runs rows inner, so its long case's decode and prefill rows overlap;
  the paged decode kernel heads inner: for each, one is its ``as_is``);
* ``precise_exp``      - ``expf`` for ``__expf``;
* ``stages3_unroll2``, ``stages2_unroll4``, ``stages4_unroll2`` - rings
  of stages x keys a lane group (the ragged kernel's is 3 x 2, the paged
  decode kernel's 2 x 4: for each, one of these is its ``as_is``);
* ``no_split``         - one span per (row, head), so no cluster;
* ``max_split_4``      - at most 4 spans;
* ``min_span_64``      - spans of at least 64 keys (the kernels: 128).

Every variant is first held against the plain versions (KERNEL_ATOL);
then the variants are timed in turns, as_is first and last.  On the card:
``python3 -m paddle_tpu_torch.tools.paged_split_variants``; it prints one
line per variant and turn and writes
``chiprun_out/paged_split_variants.json``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SOURCES = ("ragged_attention", "paged_decode")

#: build variant -> the header's switches it sets
BUILDS = {
    "as_is": (),
    "heads_inner": ("PAGED_SPLIT_HEADS_INNER=1",),
    "rows_inner": ("PAGED_SPLIT_HEADS_INNER=0",),
    "precise_exp": ("PAGED_SPLIT_PRECISE_EXP=1",),
    "stages3_unroll2": ("PAGED_SPLIT_STAGES=3", "PAGED_SPLIT_UNROLL=2"),
    "stages2_unroll4": ("PAGED_SPLIT_STAGES=2", "PAGED_SPLIT_UNROLL=4"),
    "stages4_unroll2": ("PAGED_SPLIT_STAGES=4", "PAGED_SPLIT_UNROLL=2"),
}
#: span variant -> (MAX_SPLIT, MIN_SPAN_KEYS), on the as_is build
SPANS = {
    "no_split": (1, 128),
    "max_split_4": (4, 128),
    "min_span_64": (8, 64),
}


def build(out_dir):
    """{(variant, source): ctypes library}, every nvcc started together."""
    from paddle_tpu_torch import _cuda

    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, switches in BUILDS.items():
        for src in SOURCES:
            so = out_dir / f"lib{src}_{name}.so"
            cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS,
                   *(f"-D{s}" for s in switches), "-o", str(so),
                   str(_cuda.CSRC / f"{src}.cu")]
            procs[name, src] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True), so)
    libs = {}
    for key, (proc, so) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {key}:\n{err}")
        lib = ctypes.CDLL(str(so))
        lib.paddle_cuda_error_string.argtypes = [ctypes.c_int]
        lib.paddle_cuda_error_string.restype = ctypes.c_char_p
        libs[key] = lib
    return libs


def main():
    import torch

    if not torch.cuda.is_available():
        print("paged_split_variants: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from paddle_tpu_torch import _cuda, set_strict_fp32
    from paddle_tpu_torch.generation import attention as att
    from paddle_tpu_torch.generation.ragged_attention import (
        ragged_paged_attention, ragged_ref_attention)
    from paddle_tpu_torch.models import BertConfig

    set_strict_fp32()
    device = torch.device("cuda")
    libs = build(_cuda.BUILD_DIR / "paged_split_variants")
    rules = (att.MAX_SPLIT, att.MIN_SPAN_KEYS)
    cfg = dataclasses.replace(BertConfig.base(), initializer_range=0.6)
    rc, dc = cs.ragged_cases(device, cfg), cs.decode_cases(device)
    calls = {
        f"ragged_{k}": (ragged_paged_attention, ragged_ref_attention, rc[k],
                        "row_lens") for k in ("step", "long")}
    calls.update({
        f"decode_{k}": (att.paged_decode_attention,
                        att.paged_plain_decode_attention, dc[k], "eff_lens")
        for k in ("step", "long")})
    lone = {k: (v[:8] if k in ("q", "page_table") else v)
            for k, v in dc["long"].items()}
    lone["eff_lens"] = torch.tensor([2048, 1, 16, 17, 64, 100, 128, 0],
                                    dtype=torch.int32, device=device)
    calls["decode_lone"] = (att.paged_decode_attention,
                            att.paged_plain_decode_attention, lone,
                            "eff_lens")
    wants = {name: plain(**c) for name, (_, plain, c, _) in calls.items()}

    def use(variant):
        build_name = variant if variant in BUILDS else "as_is"
        for src in SOURCES:
            _cuda._libs[src] = libs[build_name, src]
        att.MAX_SPLIT, att.MIN_SPAN_KEYS = SPANS.get(variant, rules)

    variants = [*BUILDS, *SPANS]
    errors = {}
    for variant in variants:
        use(variant)
        worst = 0.0
        for name, (fn, _, c, lens) in calls.items():
            live = c[lens] > 0
            err = float((fn(**c) - wants[name])[live].abs().max())
            if not err <= cs.KERNEL_ATOL:
                raise AssertionError(f"{variant} disagrees on {name}: {err}")
            worst = max(worst, err)
        errors[variant] = worst
    card = cs.card_line()
    print(card, flush=True)
    times = {v: {name: [] for name in calls} for v in variants}
    for variant in [*variants, *reversed(variants)]:
        use(variant)
        for name, (fn, _, c, _) in calls.items():
            times[variant][name].append(cs.time_ms(lambda: fn(**c), device))
        print(f"  {variant}: " + " ".join(
            f"{name}={t[-1]:.5f}" for name, t in times[variant].items())
            + " ms", flush=True)
    use("as_is")
    cs.OUT_DIR.mkdir(exist_ok=True)
    (cs.OUT_DIR / "paged_split_variants.json").write_text(json.dumps(dict(
        card=card, ms=times, max_abs_err=errors,
        span_rule=dict(max_split=rules[0], min_span_keys=rules[1])),
        indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
