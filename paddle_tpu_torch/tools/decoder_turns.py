"""Time phase 11a's StaticRNN greedy decoder, untraced, and the host cost
of the ``gelu``, ``lookup_table`` and ``cast`` ops at its shapes: an A/B
of two checkouts on one card.

    cd <checkout> && PYTHONPATH=. python3 <path>/decoder_turns.py <label> \
        [--runs 3] [--calls 500]

The program, the prompts and the config come from the working
directory's ``chip_smoke.py`` (``lm_graph_program``,
``build_lm_greedy_infer`` at BertConfig.base() width, initializer range
0.6 and dropout 0, N_PROMPTS x PROMPT_LEN prompts, MAX_NEW new tokens)
and its ``paddle_tpu_torch``, so one copy of this file times any
checkout that has them: run it from each checkout in turns, in one call
on one card.  After one warm run, each of ``--runs`` runs is timed
alone.  Then each op (the registry's ``compute``, as a decoder step
calls it, and the bare PyTorch call beside it) runs ``--calls`` times
back to back on the decoder step's shapes ([N_PROMPTS, PROMPT_LEN +
MAX_NEW, ffn] for gelu, [N_PROMPTS, PROMPT_LEN + MAX_NEW] ids for the
lookup and the float32 -> int64 cast) and the wall time per call is
taken after one synchronise: the decoder's step is bound by the host,
so this is the cost that adds up.
The last line printed is one JSON object: the label, the card, each
run's seconds and tokens/s, the µs per op call, and whether F.gelu
gives NaN at +inf on the card.  Exits non-zero without a CUDA card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np


def _per_call_us(fn, calls, device):
    import torch

    fn()
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize(device)
    return (time.perf_counter() - t0) / calls * 1e6


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("label", help="names the checkout in the JSON line")
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--calls", type=int, default=500)
    args = ap.parse_args(argv)

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("decoder_turns: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path.cwd()))
    import chip_smoke as cs
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.core.registry import REGISTRY, OpContext
    from paddle_tpu_torch.models import BertConfig, build_lm_greedy_infer

    pt.set_strict_fp32()
    device = torch.device("cuda")
    cfg = dataclasses.replace(BertConfig.base(), initializer_range=0.6,
                              hidden_dropout=0.0, attn_dropout=0.0)
    main_prog, startup, out = cs.lm_graph_program(
        build_lm_greedy_infer, cfg, cs.N_PROMPTS, cs.PROMPT_LEN, cs.MAX_NEW)
    exe, scope = pt.Executor(pt.CUDAPlace(0)), pt.Scope()
    exe.run(startup, scope=scope)
    feed = {"prompt_ids": np.asarray(cs.make_prompts(
        np.random.RandomState(cs.SEED + 1), cs.N_PROMPTS, cs.PROMPT_LEN,
        cfg.vocab_size), np.int64)}
    exe.run(main_prog, feed=feed, fetch_list=[out], scope=scope)
    run_s = []
    for _ in range(args.runs):
        cs.sync(device)
        t0 = time.perf_counter()
        exe.run(main_prog, feed=feed, fetch_list=[out], scope=scope)
        run_s.append(time.perf_counter() - t0)
    tokens = cs.N_PROMPTS * cs.MAX_NEW

    T = cs.PROMPT_LEN + cs.MAX_NEW
    gen = torch.Generator(device=device).manual_seed(cs.SEED)
    x = torch.randn(cs.N_PROMPTS, T, cfg.ffn_size, device=device,
                    generator=gen)
    table = torch.randn(cfg.vocab_size, cfg.hidden_size, device=device,
                        generator=gen)
    ids = torch.randint(0, cfg.vocab_size, (cs.N_PROMPTS, T),
                        device=device, generator=gen)
    ctx = OpContext(rng=None, is_test=True, attrs={}, device=device)
    buf = ids.to(torch.float32)
    gelu, lookup = REGISTRY.get("gelu"), REGISTRY.get("lookup_table")
    cast = REGISTRY.get("cast")
    with torch.no_grad():
        op_us = {
            "gelu_op": _per_call_us(
                lambda: gelu.compute(ctx, {"X": [x]}, {}), args.calls,
                device),
            "F.gelu": _per_call_us(lambda: F.gelu(x), args.calls, device),
            "lookup_table_op": _per_call_us(
                lambda: lookup.compute(ctx, {"W": [table], "Ids": [ids]},
                                       {}), args.calls, device),
            "F.embedding": _per_call_us(lambda: F.embedding(ids, table),
                                        args.calls, device),
            # the step's cast of its float token buffer back to int64
            "cast_op": _per_call_us(
                lambda: cast.compute(ctx, {"X": [buf]},
                                     {"out_dtype": "int64"}), args.calls,
                device),
            "Tensor.to": _per_call_us(lambda: buf.to(torch.int64),
                                      args.calls, device),
        }
    inf = torch.full((64,), float("inf"), device=device)
    raw = {form: bool(torch.isnan(F.gelu(inf, approximate=form)).any())
           for form in ("none", "tanh")}
    print(json.dumps({
        "label": args.label, "card": cs.card_line(), "run_s": run_s,
        "tokens_per_s": [tokens / s for s in run_s], "op_us": op_us,
        "f_gelu_inf_is_nan": raw, "checkout": str(Path.cwd())}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
