"""Time phase 5's fused BERT-base training step, untraced, in turns: an
A/B of two checkouts on one card.

    cd <checkout> && PYTHONPATH=. python3 <path>/train_step_turns.py \
        [--turns 3] [--steps 10]

The program, the batch and the step come from the working directory's
``chip_smoke.py`` (``build_train``, ``train_batch``: BERT-base
pretraining at 32 x 128, Adam(1e-4), the fusion pass's default program)
and its ``paddle_tpu_torch``, so one copy of this file times any
checkout that has them: run it from each checkout in turns, in one call
on one card.  After chip_smoke's warm-up steps, each turn runs
``--steps`` steps and synchronises; the last line printed is one JSON
object with each turn's ms/step, the program's op count and the card.
Exits non-zero without a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--turns", type=int, default=3)
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("train_step_turns: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path.cwd()))
    import chip_smoke as cs
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import BertConfig

    pt.set_strict_fp32()
    device = torch.device("cuda")
    cfg = BertConfig.base()
    main_prog, startup, loss, _, _ = cs.build_train(cfg)
    exe = pt.Executor(pt.CUDAPlace(0))
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    feed = cs.train_batch(cfg.vocab_size, device)
    for _ in range(cs.TRAIN_WARMUP):
        exe.run(main_prog, feed=feed, fetch_list=[loss], scope=scope)
    cs.sync(device)
    turns = []
    for _ in range(args.turns):
        t0 = time.perf_counter()
        for _ in range(args.steps):
            exe.run(main_prog, feed=feed, fetch_list=[loss], scope=scope,
                    return_numpy=False)
        cs.sync(device)
        turns.append((time.perf_counter() - t0) / args.steps * 1e3)
    print(json.dumps({"ms_per_step": turns,
                      "ops": len(main_prog.global_block().ops),
                      "card": cs.card_line(), "checkout": str(Path.cwd())}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
