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

``--data-parallel`` times, in one checkout, the same step through
``CompiledProgram(main).with_data_parallel()`` over a one-rank NCCL
group (a file store in a temporary directory) against the plain step,
both from the same weights at dropout 0, in turns (plain, data
parallel, data parallel, plain, ...): ``plain_ms_per_step`` and
``dp_ms_per_step`` in the JSON.
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
    ap.add_argument("--data-parallel", action="store_true")
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
    if args.data_parallel:
        return _data_parallel_turns(cs, pt, cfg, device, args)
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


def _data_parallel_turns(cs, pt, cfg, device, args):
    import tempfile

    import torch.distributed as dist

    cfg = cs._zero_dropout(cfg)
    main_prog, startup, loss, _, _ = cs.build_train(cfg)
    exe = pt.Executor(pt.CUDAPlace(0))
    scopes = {"plain": pt.Scope(), "dp": pt.Scope()}
    exe.run(startup, scope=scopes["plain"])
    cs._load(scopes["dp"], cs._snapshot(scopes["plain"], main_prog),
             main_prog)
    feed = cs.train_batch(cfg.vocab_size, device)
    turns = {"plain": [], "dp": []}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(
            f"{tmp}/store", 1), rank=0, world_size=1)
        try:
            targets = {"plain": main_prog, "dp": pt.CompiledProgram(
                main_prog).with_data_parallel(places=[exe.place])}
            for name in ("plain", "dp"):
                for _ in range(cs.TRAIN_WARMUP):
                    exe.run(targets[name], feed=feed, fetch_list=[loss],
                            scope=scopes[name])
            order = ["plain", "dp", "dp", "plain"] * ((args.turns + 1) // 2)
            for name in order:
                t0 = time.perf_counter()
                for _ in range(args.steps):
                    exe.run(targets[name], feed=feed, fetch_list=[loss],
                            scope=scopes[name], return_numpy=False)
                cs.sync(device)
                turns[name].append((time.perf_counter() - t0)
                                   / args.steps * 1e3)
        finally:
            dist.destroy_process_group()
    print(json.dumps({"plain_ms_per_step": turns["plain"],
                      "dp_ms_per_step": turns["dp"],
                      "card": cs.card_line(), "checkout": str(Path.cwd())}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
