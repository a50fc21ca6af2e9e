"""Time the training kernels of a checkout at ``chip_smoke.py`` phase 2's
cases: an A/B of two checkouts on one card.

    cd <checkout> && PYTHONPATH=. python3 <path>/kernel_turns.py <label>

The cases, the timing (CUDA events over calls queued behind a spin
kernel) and the kernels come from the working directory's
``chip_smoke.py`` (``flash_kernel_phase``, ``qkv_kernel_phase``,
``epilogue_kernel_phase``, ``flat_kernel_phase``) and its
``paddle_tpu_torch``, so one copy of this file times any checkout that
has them: run it from each checkout in turns (parent, change, change,
parent), in one call on one card.  Each phase also holds its kernels
against their plain versions, as in chip_smoke.py.  The last line
printed is one JSON object: the label, the card and each kernel's device
ms per call.  Exits non-zero without a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("label", help="names the checkout in the JSON line")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("kernel_turns: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path.cwd()))
    import chip_smoke as cs
    from paddle_tpu_torch import _cuda, set_strict_fp32

    set_strict_fp32()
    device = torch.device("cuda")
    _cuda.build(["flash_attention", "gemm_epilogue"])
    ms = {}
    for phase in (cs.flash_kernel_phase, cs.qkv_kernel_phase,
                  cs.epilogue_kernel_phase, cs.flat_kernel_phase):
        for name, r in phase(device).items():
            ms[name] = r["timing"]["ms"]
    print(json.dumps({"label": args.label, "card": cs.card_line(),
                      "ms": ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
