"""Measured fusion-plan selection: whole-block chain vs per-GEMM.

Counterpart of paddle_tpu/tuning/plans.py.  ``core/fusion.py`` runs an
FFN group on the chain kernel (#11, ops/ffn_chain.py) wherever its
static shape rule (``ffn_chain_shapes_ok``) holds, else on two GEMM
epilogue launches (#10, ops/fused_matmul.py).  That rule answers "can
it run", not "is it faster".  :func:`autotune_fusion_plan` times BOTH
on the card for one geometry — each parity-gated against
``reference_ffn_chain`` first — and persists the faster as a store
entry

    plan|<device kind>|MxKxFxN|<dtype>  ->  {"plan": "chain"|"per_gemm"}

which :func:`fusion_plan_override` serves back to the fusion pass ahead
of the static rule, once per lowering.

Either plan runs the port's kernels; what degrades is the override.  The
lowering-time consult never raises — any store trouble reads as "no
override" — and a plan that is WRONG for this process (it names the
chain where the chain cannot run, or holds an unknown value)
permanently degrades ``tuning.fusion_plan:<geometry>`` via
:func:`reject_plan`: that override is ignored for the life of the
process and the static rule takes back over.
"""
from __future__ import annotations

import numpy as np

from ..resilience.retry import degradations

__all__ = ["DEGRADE_KEY", "PLANS", "plan_key", "cached_fusion_plan",
           "fusion_plan_override", "reject_plan", "autotune_fusion_plan"]

#: DegradationRegistry key family for fusion-plan overrides rejected at
#: lowering time; per-geometry keys are ``tuning.fusion_plan:<geom>``.
DEGRADE_KEY = "tuning.fusion_plan"

PLANS = ("chain", "per_gemm")


def plan_key(device_kind, M, K, F, N, dtype):
    return f"plan|{device_kind}|{M}x{K}x{F}x{N}|{dtype}"


def _geom(M, K, F, N, dtype):
    return f"{M}x{K}x{F}x{N}|{dtype}"


def cached_fusion_plan(M, K, F, N, dtype="float32", device_kind=None,
                       device=None):
    """The stored plan for one geometry on ``device`` (its device kind),
    or None.  An entry holding an unknown plan value is a rejected
    config: its geometry key degrades permanently and the caller sees
    None."""
    from ..ops import autotune as at

    dtype = at.dtype_name(dtype)
    if degradations.is_degraded(f"{DEGRADE_KEY}:{_geom(M, K, F, N, dtype)}"):
        return None
    if device_kind is None:
        device_kind = at.device_kind(device)
    entry = at._load(at.cache_path()).get(
        plan_key(device_kind, M, K, F, N, dtype))
    if not entry:
        return None
    plan = entry.get("plan")
    if plan not in PLANS:
        reject_plan(M, K, F, N, dtype,
                    reason=f"unknown plan value {plan!r}")
        return None
    return plan


def fusion_plan_override(M, K, F, N, dtype="float32", device=None):
    """Lowering-time consult for ``core/fusion.py`` — never raises;
    every failure reads as 'no override'."""
    try:
        return cached_fusion_plan(M, K, F, N, dtype=dtype, device=device)
    except Exception:  # noqa: BLE001 — the step must never crash
        return None


def reject_plan(M, K, F, N, dtype="float32", reason="rejected"):
    """Permanently ignore the stored plan for one geometry (wrong for
    this process: an ineligible chain, a bad value)."""
    from ..ops.autotune import dtype_name

    try:
        degradations.degrade(
            f"{DEGRADE_KEY}:{_geom(M, K, F, N, dtype_name(dtype))}",
            detail=reason)
    except Exception:  # noqa: BLE001
        pass


def ffn_probe(M, K, F, N, device, seed=0):
    """(x, w1, b1, w2, b2) float32 of one FFN geometry from a numpy
    seed (scaled as a trained layer's: unit activations)."""
    import torch

    rng = np.random.RandomState(seed)
    arrs = (rng.standard_normal((M, K)),
            rng.standard_normal((K, F)) / np.sqrt(K),
            np.linspace(-0.5, 0.5, F),
            rng.standard_normal((F, N)) / np.sqrt(F),
            np.linspace(-0.2, 0.2, N))
    return [torch.from_numpy(a.astype(np.float32)).to(device) for a in arrs]


def autotune_fusion_plan(M, K, F, N, dtype="float32", act="gelu",
                         norm=None, reps=10, seed=0, write=True,
                         force_time=False, rtol=2e-2, atol=2e-3,
                         device=None, store=None):
    """Time the chain (#11) against per-GEMM (two #10) for one FFN
    geometry and persist the faster.

    Both legs run through the kernels' wrappers and must match
    ``reference_ffn_chain`` within (rtol, atol) before their times
    count.  On the CPU the wrappers run the plain versions: parity is
    checked, nothing is timed or persisted unless ``force_time``.

    Returns ``{"plan", "chain_ms", "per_gemm_ms", "speedup",
    "parity_only", "chain_eligible", "entry", "max_abs_err"}`` (plan
    None when no leg passed parity)."""
    import torch

    from .._device import resolve_device
    from ..ops import autotune as at
    from ..ops import ffn_chain as fc
    from ..ops import fused_matmul as fm

    device = resolve_device(device)
    on_card = device.type == "cuda"
    parity_only = not on_card and not force_time
    x, w1, b1, w2, b2 = ffn_probe(M, K, F, N, device, seed)
    gamma = beta = None
    if norm is not None:
        gamma = torch.ones(N, device=device)
        beta = torch.zeros(N, device=device)
    spec = fm.EpilogueSpec(act=act, norm=norm)
    with torch.no_grad():
        ref = fc.reference_ffn_chain(x, w1, b1, w2, b2, None, gamma, beta,
                                     spec)
    report = {"plan": None, "chain_ms": None, "per_gemm_ms": None,
              "speedup": None, "parity_only": parity_only,
              "chain_eligible": fc.ffn_chain_shapes_ok(M, K, F, N),
              "entry": None, "max_abs_err": {}}

    legs = {}
    if report["chain_eligible"]:
        def run_chain():
            return fc.fused_ffn_chain(x, w1, b1, w2, b2, gamma=gamma,
                                      beta=beta, spec=spec)

        legs["chain"] = run_chain
    if fm.fused_shapes_ok(M, K, F) and fm.fused_shapes_ok(M, F, N):
        spec1 = fm.EpilogueSpec(act=act)
        spec2 = spec._replace(act=None)

        def run_per_gemm():
            h1 = fm.fused_matmul(x, w1, b1, spec=spec1)
            return fm.fused_matmul(h1, w2, b2, None, gamma, beta, 0, spec2)

        legs["per_gemm"] = run_per_gemm

    timed = {}
    with torch.no_grad():
        for plan, fn in legs.items():
            try:
                got = fn()
            except Exception as e:  # noqa: BLE001 — leg is unusable
                report[f"{plan}_error"] = repr(e)
                continue
            report["max_abs_err"][plan] = float((got - ref).abs().max())
            if not torch.allclose(got, ref, rtol=rtol, atol=atol):
                report[f"{plan}_error"] = "parity mismatch"
                continue
            timed[plan] = 0.0 if parity_only else at.time_ms(
                fn, device, reps=reps)
            if not parity_only:
                report[f"{plan}_ms"] = timed[plan]

    if not timed or parity_only:
        return report
    winner = min(timed, key=timed.get)
    report["plan"] = winner
    if len(timed) == 2:
        loser_ms = max(timed.values())
        report["speedup"] = (loser_ms / timed[winner]
                             if timed[winner] > 0 else None)
    if write:
        from .store import TuningStore

        kind = at.device_kind(device)
        dt = at.dtype_name(dtype)
        store = store if store is not None else TuningStore()
        report["entry"] = store.put(
            plan_key(kind, M, K, F, N, dt), {"plan": winner},
            kernel="fusion_plan", geometry=f"{M}x{K}x{F}x{N}", dtype=dt,
            device_kind=kind, ms=timed[winner],
            heuristic_ms=timed.get("chain"), speedup=report["speedup"],
            attestation={"parity": True, "rtol": rtol, "atol": atol,
                         "ref": "reference_ffn_chain",
                         "backend": device.type, "interpret": False})
    return report
