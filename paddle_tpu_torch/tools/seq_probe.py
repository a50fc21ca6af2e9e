"""Probes of ``chip_smoke.py``'s phase 21 on the card: where the host
time of the seq2seq step (21a) goes, and whether 21c's card-against-CPU
run repeats.

    python3 -m paddle_tpu_torch.tools.seq_probe phase21
        phase 21 alone (``chip_smoke.seq_phase``) in a fresh process;
    python3 -m paddle_tpu_torch.tools.seq_probe heap 3000000 12000000
        21a in a fresh process, then again with each count of extra
        tracked Python objects alive (a heap the size a long run leaves);
    python3 -m paddle_tpu_torch.tools.seq_probe repeat21c 12
        21c's classifier trained on the CPU twice and on the card 12
        times from the same weights: the card against itself and against
        the CPU, the four parameters that part most;
    python3 -m paddle_tpu_torch.tools.seq_probe bisect
        the whole of ``chip_smoke.main()`` with 21a's step re-timed (2
        warm-up and 5 timed steps) before each phase starts.

Each prints its lines (``PROBE ...`` for the bisect) and needs one card.
Run from the root of the repository.
"""
from __future__ import annotations

import re
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def _status():
    """This process's resident memory and OS thread count (/proc)."""
    out = {}
    for line in Path("/proc/self/status").read_text().splitlines():
        key, _, value = line.partition(":")
        if key in ("VmRSS", "Threads"):
            out[key] = value.strip()
    return out


def _retime_21a(cs, device, tag):
    """21a's program built afresh, 2 warm-up and 5 timed steps."""
    import paddle_tpu_torch as pt

    t0 = time.perf_counter()
    cs._free_card(device)
    main, startup, loss, _ = cs.build_s2s(cs.S2S)
    exe, scope = cs._executor(device), pt.Scope()
    exe.run(startup, scope=scope)
    feed = cs.s2s_feed(cs.S2S, device)
    _, ms, _, _, host = cs._timed_steps(exe, main, feed, loss, scope, device,
                                        2, 5)
    del exe, scope, feed
    cs._free_card(device)
    print(f"PROBE before {tag}: {ms:.2f} ms/step, process cpu "
          f"{host['cpu_ms_per_step']:.1f}, thread cpu "
          f"{host['thread_cpu_ms_per_step']:.1f}, gc "
          f"{host['gc_ms_per_step']:.2f}, objects "
          f"{host['gc_tracked_objects']}, py threads "
          f"{len(threading.enumerate())}, {_status()}; probe "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def _max_diffs(a, b, n=4):
    import numpy as np

    d = {k: float(np.abs(np.asarray(a[k], np.float64)
                         - np.asarray(b[k], np.float64)).max()) for k in a}
    return sorted(d.items(), key=lambda kv: -kv[1])[:n]


def _repeat21c(cs, device, runs):
    import torch

    import paddle_tpu_torch as pt

    cpu = torch.device("cpu")
    _, cls = cs._small_models()
    main, startup, loss = cs.build_lstm_classifier(cls)
    init = pt.Scope()
    cs._executor(cpu).run(startup, scope=init)
    weights = cs._host_arrays(init, main)

    def train(where):
        scope = cs._scope_from(weights, where, main)
        feed = cs.lstm_feed(cls, where)
        exe = cs._executor(where)
        losses = [float(exe.run(main, feed=feed, fetch_list=[loss],
                                scope=scope)[0])
                  for _ in range(cs.SEQ_PARITY_STEPS)]
        return losses, cs._host_arrays(scope, main)

    cpu_losses, cpu_w = train(cpu)
    print("cpu against cpu", _max_diffs(cpu_w, train(cpu)[1]), flush=True)
    first = None
    for k in range(runs):
        losses, w = train(device)
        print(k, "card against cpu", _max_diffs(w, cpu_w), "losses",
              losses, cpu_losses, flush=True)
        if first is not None:
            print(k, "card against the first card run",
                  _max_diffs(w, first), flush=True)
        first = first or w


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    mode = argv.pop(0) if argv else "phase21"
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from paddle_tpu_torch import _cuda, set_strict_fp32

    device = torch.device("cuda")
    if mode == "bisect":
        log = cs.log

        def probing_log(msg):
            m = re.match(r"\[(\d+)\] ", msg)
            if m and torch.cuda.is_initialized():
                _retime_21a(cs, device, m.group(1))
            log(msg)

        cs.log = probing_log
        sys.argv[1:] = []           # chip_smoke.main() reads its arguments
        rc = cs.main()
        _retime_21a(cs, device, "end")
        return rc
    print(cs.card_line(), flush=True)
    print(_cuda.build(["gemm_epilogue"]), flush=True)
    set_strict_fp32()
    if mode == "phase21":
        cs.seq_phase(device)
    elif mode == "heap":
        for n in [0] + [int(a) for a in argv]:
            junk = [[i] for i in range(n)]
            r = cs.s2s_phase(device)
            print(f"heap +{n} objects: {r['step_ms']:.2f} ms/step, host "
                  f"{ {k: v for k, v in r['host'].items() if k != 'top'} }",
                  flush=True)
            del junk
    elif mode == "repeat21c":
        _repeat21c(cs, device, int(argv[0]) if argv else 12)
    else:
        raise SystemExit(f"seq_probe: unknown mode {mode!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
