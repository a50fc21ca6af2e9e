"""Planted faults in ``chip_smoke.py``'s phase 23: which of its gates
sees which fault.

    python3 -m paddle_tpu_torch.tools.dps_faults [--cpu] [fault ...]

Each fault is planted in phase 23's two gloo ranks only, so the
one-rank runs that the ranks are held against stay sound.  Phase 23
(``chip_smoke.dp_seq_phase``, after 21b's plain steps) then runs as in
the script, and the tool prints one ``FAULT`` line a fault: every
job's gate values and the gates that failed.

Faults (default: all, the sound run first):

* ``none``: the sound run;
* ``no_grad_sum``: the gradient sum over ``data`` left out, so each
  rank steps on the gradient of its own rows;
* ``half_batch``: rank 1 sends zeros to the gradient sum, so each
  step follows the gradient of rank 0's half of the batch;
* ``grad_times_p``: the loss's seed not divided among the ranks, so
  the summed gradient counts each row P times.

Needs one card; ``--cpu`` runs on the CPU at whatever sizes the caller
set on ``chip_smoke`` (tests/test_torch_chip_phase23.py).  Run from the
root of the repository.
"""
from __future__ import annotations

import functools
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FAULTS = ("none", "no_grad_sum", "half_batch", "grad_times_p")


def plant(fault):
    """Break this process's data-parallel step as ``fault`` says."""
    from paddle_tpu_torch.core import spmd
    from paddle_tpu_torch.parallel import _collectives as col

    if fault == "no_grad_sum":
        col.sum_gradients = lambda tensors, group, **kw: list(tensors)
    elif fault == "half_batch":
        summed = col.sum_gradients

        def rank0_only(tensors, group, **kw):
            import torch
            import torch.distributed as dist

            if dist.get_rank(group) != 0:
                tensors = [torch.zeros_like(t) for t in tensors]
            return summed(tensors, group, **kw)

        col.sum_gradients = rank0_only
    elif fault == "grad_times_p":
        run = spmd.MeshExec.run

        def unscaled(self, opdef, ctx, ins, op):
            outs = run(self, opdef, ctx, ins, op)
            if op.uid not in self.plan.seeds:
                return outs
            return {slot: [v * self.batch_parts for v in vals]
                    for slot, vals in outs.items()}

        spmd.MeshExec.run = unscaled
    elif fault != "none":
        raise ValueError(f"dps_faults: unknown fault {fault!r}; the "
                         f"faults are {FAULTS}")


def _rank(fault, rank, *args):
    import chip_smoke as cs

    plant(fault)
    cs._dps_rank(rank, *args)


def run_faults(cs, device, plain, faults):
    """Phase 23 once for each fault, planted in the ranks -> {fault:
    (the phase's report, the gates it failed)}."""
    found = {}
    failures = cs.dp_seq_failures

    def record(out, on_card):
        failed = failures(out, on_card)
        found["last"] = (out, failed)
        return []

    rank, cs.dp_seq_failures = cs._dps_rank, record
    try:
        for fault in faults:
            cs._dps_rank = functools.partial(_rank, fault)
            cs.dp_seq_phase(device, plain)
            found[fault] = found.pop("last")
    finally:
        cs._dps_rank, cs.dp_seq_failures = rank, failures
    return found


def summary(out):
    """Each job's gate values in a phase 23 report."""
    keys = ("max_dloss", "max_dparam", "max_dchange_rel", "worst_leaf",
            "same_start")
    res = {name: {k: j[k] for k in keys} for name, j in out["jobs"].items()}
    for name, j in out["jobs"].items():
        if j["one_rank"]["scales"]:
            res[name]["scales"] = [g["scales"] for g in j["ranks"]]
    return res


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    on_cpu = "--cpu" in argv
    faults = [a for a in argv if a != "--cpu"] or list(FAULTS)
    for f in faults:
        if f not in FAULTS:
            raise SystemExit(f"dps_faults: unknown fault {f!r}; the faults "
                             f"are {FAULTS}")
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from paddle_tpu_torch import _cuda, set_strict_fp32

    device = torch.device("cpu" if on_cpu else "cuda")
    if not on_cpu:
        print(cs.card_line(), flush=True)
        print(_cuda.build(sorted({k["build"] for k in cs.KERNELS})),
              flush=True)
    set_strict_fp32()
    plain = cs.lstm_phase(device)
    for fault, (out, failed) in run_faults(cs, device, plain,
                                           faults).items():
        print("FAULT " + json.dumps(dict(fault=fault, failed=failed,
                                         jobs=summary(out))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
