"""Cluster worker: one engine process serving RPC ops from the router.

Counterpart of paddle_tpu/cluster/worker.py, copied, the tuning verbs
included (``tuning_push`` merges attested configs into the worker's
``TuningStore``, ``tuning_pull`` reads it back, ``tuning_search`` runs
one parity-gated Hopper search on this worker: paddle_tpu_torch/
tuning).  The engine of a prefill/decode/generate worker is a port
`GenerationEngine`, on the card unless its factory asks for the CPU.

A worker is spawned with ``python -m paddle_tpu_torch.cluster.worker`` (the
pool builds the command line and the launch.py env contract:
PADDLE_TRAINER_ID / PADDLE_CURRENT_ENDPOINT / ...), loads its model via
a user factory spec ``module:function``, and serves one of three roles:

* ``infer``  — the factory returns an InferenceServer backend (or a
  ``(backend, ServingConfig)`` pair); the worker wraps it in a LOCAL
  InferenceServer, so requests the router fans to this worker still
  coalesce into shape-bucketed batches on the way into the device.
* ``prefill`` — the factory returns a GenerationEngine; the worker runs
  ``prefill_detached`` per prompt and ships PrefillHandoff (KV pages as
  host arrays) back over the control plane.
* ``decode`` — the factory returns a GenerationEngine; the worker
  admits shipped handoffs into its own paged cache and drives the
  continuous-batching decode loop to completion.

Page streaming (the chunk-granular handoff path): a prefill worker
also serves ``prefill_stream_start`` / ``prefill_pull`` /
``prefill_stream_abort`` — start spawns a background thread that
drives ``engine.prefill_stream`` into a queue (holding the engine
lock for the stream's duration), pull long-polls that queue so the
router overlaps wire transfer with the remaining prefill compute.  A
decode worker serves ``stream_open`` / ``stream_chunk`` /
``stream_commit`` / ``stream_abort``, pre-admitting a slot and
importing pages as they arrive; ``decode`` then resolves
``{"stream": id}`` handoff entries against the committed stream, so
the sequence starts decoding from pages that were never shipped as
one monolithic blob.  ``stream_open`` returns the decode pool's own
prefix-cache hit length, letting the router skip shipping a span the
decode worker already holds.

Tracing: every request message may carry ``trace=(trace_id, span_id)``
— the client span ids from the router process.  The worker attaches
that context before opening its own spans, so one Chrome trace (after
tools/trace_merge.py) shows router -> prefill -> decode as a single
parented chain across processes.  ``tracing.reseed_ids`` at boot keys
this process's span ids off its pid so ids cannot collide with the
router's.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import queue as _queue
import sys
import threading
import time

from ..observability import ledger as _ledger
from ..observability import tracing as _tracing
from ..resilience.faults import maybe_delay
from .rpc import RpcServer

__all__ = ["WorkerServicer", "resolve_factory", "main"]

#: Bound on remembered cancelled uids — cancellation is advisory (a
#: cancel for work that already finished must be a no-op), so the set
#: only needs to cover recently-in-flight requests.
_CANCEL_CAP = 4096


def _count_deadline_expired(site):
    """Worker-side deadline rejection: lands on THIS process's own
    registry (no router label) and reaches the fleet scrape via the
    telemetry plane's registry_snapshot merge."""
    from ..observability import get_registry
    from ..observability.monitor import CLUSTER_DEADLINE_EXPIRED

    get_registry().counter(
        CLUSTER_DEADLINE_EXPIRED,
        "work rejected after its deadline budget expired, by site"
    ).labels(site=site).inc()


def resolve_factory(spec):
    """``"pkg.mod:fn"`` -> the callable (the torchrun/launch-utils entry
    point convention)."""
    mod_name, _, fn_name = spec.partition(":")
    if not fn_name:
        raise ValueError(
            f"factory spec {spec!r} must look like 'module:function'")
    mod = importlib.import_module(mod_name)
    return getattr(mod, fn_name)


class WorkerServicer:
    """Op dispatch for one worker process.  Also usable IN-process (the
    loopback path in cluster.testing) — the servicer itself has no
    socket dependency; `serve` wires it to an RpcServer."""

    def __init__(self, role, factory, factory_kwargs=None, rank=0):
        from ..generation import GenerationEngine

        self.role = role
        self.rank = int(rank)
        self._lock = threading.Lock()   # engines are single-threaded
        self._server = None             # local InferenceServer (infer)
        self._engine = None             # GenerationEngine (prefill/decode)
        made = factory(**(factory_kwargs or {}))
        if role == "infer":
            from ..serving import InferenceServer
            from ..serving.config import ServingConfig

            if isinstance(made, tuple):
                backend, cfg = made
            else:
                backend, cfg = made, ServingConfig()
            self._server = InferenceServer(backend, cfg).start()
            self._server.warmup()
        elif role in ("prefill", "decode", "generate"):
            if not isinstance(made, GenerationEngine):
                raise TypeError(
                    f"role {role!r} needs a GenerationEngine factory, "
                    f"got {type(made).__name__}")
            self._engine = made
            self._engine.warmup()
        else:
            raise ValueError(f"unknown worker role {role!r}")
        # prefill-side page-stream state: stream id -> {"q", "abort",
        # "thread"}.  Guarded by its own small lock — pull must stay
        # responsive while the producer thread holds the ENGINE lock.
        self._pstreams = {}
        self._pstreams_lock = threading.Lock()
        # hedging support: uids the router cancelled (its other copy
        # won).  Work already past admission still completes — the set
        # only stops work that has not reached the engine yet.  A dict
        # used as an insertion-ordered set: the cancel fan-out reaches
        # EVERY worker of the model, so most entries are never consumed
        # and the cap must evict oldest-first — set.pop()'s arbitrary
        # eviction can drop the uid that was just added.
        self._cancelled = {}
        self._cancel_lock = threading.Lock()
        self._shutdown = threading.Event()

    # -- op handlers -------------------------------------------------------
    def handle(self, msg):
        op = msg.get("op")
        fn = getattr(self, f"_op_{op}", None)
        if fn is None:
            return {"ok": False, "error": f"unknown op {op!r}",
                    "error_type": "ValueError"}
        # chaos latency site: an armed plan with delays={"slow_worker":
        # s} turns this worker into a straggler before any dispatch
        maybe_delay("slow_worker", role=self.role, rank=self.rank)
        trace = msg.get("trace")
        ctx = _tracing.SpanContext(*trace) if trace else None
        try:
            with _tracing.attach(ctx), \
                    _tracing.span(f"cluster:worker_{op}",
                                  role=self.role, rank=self.rank):
                return fn(msg)
        except Exception as e:  # noqa: BLE001 — errors travel as data
            return {"ok": False, "error": str(e),
                    "error_type": type(e).__name__}

    def _op_health(self, msg):
        return {"ok": True, "role": self.role, "rank": self.rank,
                "pid": os.getpid()}

    def _op_cancel(self, msg):
        """Hedging's loser-cancellation verb: remember the uid so work
        that has NOT yet reached the engine is dropped at admission.
        Advisory — work already executing completes normally (the
        router's future is idempotent and ignores the late result)."""
        uid = msg.get("uid")
        with self._cancel_lock:
            if uid is not None:
                self._cancelled[uid] = None
                while len(self._cancelled) > _CANCEL_CAP:
                    # FIFO: stale never-consumed uids (cancels for work
                    # this worker never held) age out first
                    del self._cancelled[next(iter(self._cancelled))]
        return {"ok": True, "uid": uid}

    def _is_cancelled(self, uid):
        if uid is None:
            return False
        with self._cancel_lock:
            # one-shot: a uid is consumed by the first admission check
            # so the bounded set cannot fill with stale entries
            if uid in self._cancelled:
                del self._cancelled[uid]
                return True
        return False

    def _op_infer(self, msg):
        if self._is_cancelled(msg.get("uid")):
            return {"ok": True, "cancelled": True}
        b = msg.get("deadline_ms")
        if b is not None and b <= 0.0:
            _count_deadline_expired("worker_queue")
            return {"ok": True, "expired": True}
        t0 = time.monotonic()
        outs = self._server.infer(msg["feeds"],
                                  timeout_ms=msg.get("timeout_ms"))
        reply = {"ok": True, "outputs": outs}
        if _ledger.enabled():
            t1 = time.monotonic()
            ms = round((t1 - t0) * 1e3, 3)
            reply["ledger"] = {"service_ms": ms}
            _ledger.get_ledger().record(
                uid=msg.get("uid") or "", worker=str(self.rank),
                outcome="ok", t_admit=t0, t_dispatch=t0, t_done=t1,
                service_ms=ms)
        return reply

    def _op_prefill(self, msg):
        if self._is_cancelled(msg.get("uid")):
            return {"ok": True, "cancelled": True}
        b = msg.get("deadline_ms")
        if b is not None and b <= 0.0:
            _count_deadline_expired("worker_queue")
            return {"ok": True, "expired": True}
        led_on = _ledger.enabled()
        with self._lock:
            if led_on:
                t0 = time.monotonic()
                before = self._engine.ledger_counters()
            handoff, done, reason = self._engine.prefill_detached(
                msg["prompt"], sampling=msg.get("sampling"))
            if led_on:
                after = self._engine.ledger_counters()
        reply = {"ok": True, "handoff": handoff, "done": done,
                 "finish_reason": reason}
        if led_on:
            t1 = time.monotonic()
            led = {"service_ms": round((t1 - t0) * 1e3, 3)}
            for k in ("prefill_chunks", "prefix_tokens",
                      "spec_drafted", "spec_accepted"):
                led[k] = after[k] - before[k]
            reply["ledger"] = led
            _ledger.get_ledger().record(
                uid=msg.get("uid") or "", worker=str(self.rank),
                outcome="ok", t_admit=t0, t_dispatch=t0, t_done=t1,
                **led)
        return reply

    def _admission_status(self, msg, n):
        """Per-member admission state for a batched generation op.

        Returns ``(recv, status)`` where status[i] is None (live),
        "expired" (budget spent before the op arrived — counted at
        site=worker_queue) or "cancelled" (the router's hedge twin
        already won).  The worker_exec re-check happens under the
        engine lock with ``recv`` as the budget epoch."""
        recv = time.monotonic()
        uids = msg.get("uids") or [None] * n
        budgets = msg.get("deadline_ms") or [None] * n
        status = [None] * n
        for i in range(n):
            if self._is_cancelled(uids[i]):
                status[i] = "cancelled"
            elif budgets[i] is not None and budgets[i] <= 0.0:
                status[i] = "expired"
                _count_deadline_expired("worker_queue")
        return recv, uids, budgets, status

    def _recheck_exec(self, recv, uids, budgets, status):
        """Under the engine lock: the wait for the lock itself may have
        eaten the remaining budget (site=worker_exec), and a hedge twin
        may have won meanwhile."""
        now = time.monotonic()
        for i, s in enumerate(status):
            if s is not None:
                continue
            if self._is_cancelled(uids[i]):
                status[i] = "cancelled"
            elif (budgets[i] is not None
                    and now > recv + budgets[i] / 1e3):
                status[i] = "expired"
                _count_deadline_expired("worker_exec")

    @staticmethod
    def _reassemble(status, live_results, leds=None):
        """Zip engine results for the live subset back into request
        order; rejected members travel as marker dicts.  ``leds``
        (when the ledger is enabled) aligns with ``live_results`` and
        rides each live member's reply dict — the per-request work
        accounting reaches the router without a second round trip."""
        out, it, j = [], iter(live_results), 0
        for s in status:
            if s is None:
                r = next(it)
                d = {"tokens": r.tokens,
                     "finish_reason": r.finish_reason,
                     "prompt_len": r.prompt_len}
                if leds is not None:
                    d["ledger"] = leds[j]
                j += 1
                out.append(d)
            else:
                out.append({s: True})
        return out

    def _ledger_run(self, fn, uids, status):
        """Run ``fn`` (the engine call for the LIVE members, under the
        engine lock) with ledger accounting: diff the engine's
        cumulative work counters around the call, split the op-level
        deltas across the live members (exact decode tokens come from
        each member's own result; indivisible counts split evenly with
        the remainder on earlier members so the fleet totals stay
        conserved), append this worker's own per-member records to the
        process ledger, and return ``(results, leds)``."""
        if not _ledger.enabled():
            return fn(), None
        t0 = time.monotonic()
        before = self._engine.ledger_counters()
        results = fn()
        after = self._engine.ledger_counters()
        t1 = time.monotonic()
        n = len(results)
        if n == 0:
            return results, None
        live = [i for i, s in enumerate(status) if s is None]
        deltas = {k: after[k] - before[k] for k in after}
        exec_ms = (t1 - t0) * 1e3
        book, leds = _ledger.get_ledger(), []
        for j, r in enumerate(results):
            led = {"service_ms": round(exec_ms / n, 3),
                   "decode_tokens": len(r.tokens)}
            for k in ("prefill_chunks", "spec_drafted",
                      "spec_accepted", "prefix_tokens"):
                v = deltas.get(k, 0)
                led[k] = (v // n) + (1 if j < v % n else 0)
            leds.append(led)
            book.record(uid=uids[live[j]] or "",
                        worker=str(self.rank), outcome="ok",
                        t_admit=t0, t_dispatch=t0, t_done=t1, **led)
        return results, leds

    def _op_generate(self, msg):
        """Whole requests in one RPC (the single-pool chunked mode):
        the engine's continuous batch interleaves every prompt's chunks
        with the others' decode rows."""
        from ..generation import SamplingParams

        prompts = msg["prompts"]
        sampling = msg.get("sampling")
        if isinstance(sampling, (list, tuple)):
            sampling = [s if s is not None else SamplingParams()
                        for s in sampling]
        recv, uids, budgets, status = self._admission_status(
            msg, len(prompts))
        with self._lock:
            self._recheck_exec(recv, uids, budgets, status)
            live = [i for i, s in enumerate(status) if s is None]
            results, leds = [], None
            if live:
                results, leds = self._ledger_run(
                    lambda: self._engine.generate(
                        [prompts[i] for i in live],
                        sampling=([sampling[i] for i in live]
                                  if isinstance(sampling, list)
                                  else sampling)),
                    uids, status)
        return {"ok": True,
                "results": self._reassemble(status, results, leds)}

    def _op_decode(self, msg):
        handoffs_in = msg["handoffs"]
        recv, uids, budgets, status = self._admission_status(
            msg, len(handoffs_in))
        with self._lock:
            self._recheck_exec(recv, uids, budgets, status)
            # a handoff entry may be a {"stream": id} reference to a
            # committed page stream already resident in THIS engine's
            # pool — resolve it to the staged handoff (adoption skips
            # the inline KV import entirely).  A REJECTED member's
            # stream is never adopted, so its staged KV pages must be
            # released here or they stay resident for the worker's
            # lifetime (idempotent stream_abort — the leak guard).
            handoffs = []
            for i, h in enumerate(handoffs_in):
                if status[i] is None:
                    handoffs.append(
                        self._engine.stream_handoff(h["stream"])
                        if isinstance(h, dict) else h)
                elif isinstance(h, dict):
                    self._engine.stream_abort(h["stream"])
            results, leds = [], None
            if handoffs:
                results, leds = self._ledger_run(
                    lambda: self._engine.decode_prefilled(handoffs),
                    uids, status)
        return {"ok": True,
                "results": self._reassemble(status, results, leds)}

    # -- page streaming: prefill producer ----------------------------------
    def _op_prefill_stream_start(self, msg):
        """Begin a chunk-granular prefill: the engine runs on a
        background thread (holding the engine lock) and each retired
        chunk lands in a queue for ``prefill_pull`` — the RPC returns
        immediately so the router can start pulling/forwarding while
        the prefill is still computing."""
        b = msg.get("deadline_ms")
        if b is not None and b <= 0.0:
            _count_deadline_expired("worker_queue")
            return {"ok": True, "expired": True}
        sid = msg["stream_id"]
        with self._pstreams_lock:
            if sid in self._pstreams:
                raise ValueError(
                    f"prefill stream {sid!r} already started")
            state = {"q": _queue.Queue(), "abort": False}
            self._pstreams[sid] = state

        def produce():
            gen = self._engine.prefill_stream(
                msg["prompt"], sampling=msg.get("sampling"))
            try:
                with self._lock:
                    try:
                        for item in gen:
                            state["q"].put(item)
                            if state["abort"]:
                                break
                    finally:
                        # closing inside the lock: the generator's
                        # cleanup releases the engine slot
                        gen.close()
            except Exception as e:  # noqa: BLE001 — ship as data
                state["q"].put({"kind": "error", "error": str(e),
                                "error_type": type(e).__name__})

        t = threading.Thread(target=produce, daemon=True,
                             name=f"prefill-stream-{sid}")
        state["thread"] = t
        t.start()
        return {"ok": True, "stream_id": sid}

    def _op_prefill_pull(self, msg):
        """Long-poll the stream's queue: block for the first item (up
        to ``timeout_s``), then drain whatever else is ready.  The
        state is dropped once the final (or an error) item ships."""
        sid = msg["stream_id"]
        with self._pstreams_lock:
            state = self._pstreams.get(sid)
        if state is None:
            raise ValueError(f"unknown prefill stream {sid!r}")
        items = []
        try:
            items.append(state["q"].get(
                timeout=float(msg.get("timeout_s", 60.0))))
        except _queue.Empty:
            return {"ok": True, "items": [], "done": False}
        while True:
            try:
                items.append(state["q"].get_nowait())
            except _queue.Empty:
                break
        err = next((it for it in items if it["kind"] == "error"), None)
        done = err is not None or any(
            it["kind"] == "final" for it in items)
        if done:
            with self._pstreams_lock:
                self._pstreams.pop(sid, None)
        if err is not None:
            return {"ok": False, "error": err["error"],
                    "error_type": err["error_type"]}
        return {"ok": True, "items": items, "done": done}

    def _op_prefill_stream_abort(self, msg):
        """Drop a stream's state; the producer thread notices the
        abort flag at its next chunk and closes the generator (which
        releases the engine slot).  Idempotent."""
        with self._pstreams_lock:
            state = self._pstreams.pop(msg["stream_id"], None)
        if state is not None:
            state["abort"] = True
        return {"ok": True, "aborted": state is not None}

    # -- page streaming: decode importer -----------------------------------
    def _op_stream_open(self, msg):
        with self._lock:
            cached = self._engine.stream_open(
                msg["stream_id"], msg["prompt"],
                sampling=msg.get("sampling"))
        return {"ok": True, "cached_len": cached}

    def _op_stream_chunk(self, msg):
        with self._lock:
            received = self._engine.stream_chunk(
                msg["stream_id"], msg["start"], msg["k"], msg["v"])
        return {"ok": True, "received": received}

    def _op_stream_commit(self, msg):
        with self._lock:
            self._engine.stream_commit(msg["stream_id"],
                                       msg["last_token"])
        return {"ok": True}

    def _op_stream_abort(self, msg):
        with self._lock:
            released = self._engine.stream_abort(msg["stream_id"])
        return {"ok": True, "released": released}

    def _op_stats(self, msg):
        if self._server is not None:
            return {"ok": True, "stats": self._server.stats()}
        return {"ok": True, "stats": self._engine.stats.snapshot()}

    def _op_registry_snapshot(self, msg):
        """The telemetry-plane verb: this process's ENTIRE metrics
        registry (every subsystem's series), for the router tier's
        TelemetryScraper to merge into the fleet snapshot."""
        from ..observability import get_registry

        return {"ok": True, "snapshot": get_registry().snapshot(),
                "role": self.role, "rank": self.rank,
                "pid": os.getpid()}

    def _op_ledger_tail(self, msg):
        """The goodput-attribution verb: this process's request-ledger
        tail (most recent ``n`` records, all when absent), for the
        router tier's TelemetryScraper to merge into the fleet
        snapshot's fleet-wide ledger."""
        return {"ok": True,
                "records": _ledger.get_ledger().tail(msg.get("n")),
                "role": self.role, "rank": self.rank,
                "pid": os.getpid()}

    def _op_flight_dump(self, msg):
        """The incident verb: this process's flight-recorder ring,
        JSON-able, for IncidentManager to fold into a bundle."""
        from ..observability import flightrec

        return {"ok": True, "dump": flightrec.get_recorder().dump(),
                "armed": flightrec.armed(), "role": self.role,
                "rank": self.rank, "pid": os.getpid()}

    def _op_tuning_push(self, msg):
        """The tuning-plane distribution verb: the autotune daemon
        pushes parity-attested kernel configs fleet-wide; this worker
        merges them into its local TuningStore (version-arbitrated,
        attestation-gated) so the next resolve hits cache instead of
        searching on-path."""
        from ..tuning import TuningStore

        st = TuningStore(msg.get("path"))
        applied, rejected = st.merge(msg["entries"], distributed=True)
        return {"ok": True, "applied": applied, "rejected": rejected,
                "path": st.path, "role": self.role, "rank": self.rank}

    def _op_tuning_pull(self, msg):
        """Read back this worker's full versioned tuning store — the
        daemon's harvest side and `autotune_report --all` use it."""
        from ..tuning import TuningStore

        st = TuningStore(msg.get("path"))
        return {"ok": True, "entries": st.read(), "path": st.path,
                "role": self.role, "rank": self.rank}

    def _op_tuning_search(self, msg):
        """Run one parity-gated autotune search on THIS worker (the
        daemon targets an idle rank so the search never lands on a
        serving path) and persist the winner locally."""
        from ..tuning import search_geometry

        report = search_geometry(
            msg["kernel"], msg["geometry"],
            dtype=msg.get("dtype", "float32"),
            reps=int(msg.get("reps", 10)),
            force_time=bool(msg.get("force_time", False)),
            plan_search=bool(msg.get("plan_search", True)),
            device=msg.get("device"))
        return {"ok": True, "report": report, "role": self.role,
                "rank": self.rank}

    def _op_profile_start(self, msg):
        from .. import profiler as _prof

        _prof.start_profiler(msg.get("state", "All"))
        return {"ok": True}

    def _op_profile_dump(self, msg):
        from .. import profiler as _prof

        _prof.stop_profiler(quiet=True)
        path = _prof.export_chrome_tracing(msg["path"])
        return {"ok": True, "path": path}

    def _op_shutdown(self, msg):
        self._shutdown.set()
        return {"ok": True}

    # -- lifecycle ---------------------------------------------------------
    def close(self):
        if self._server is not None:
            self._server.close(drain=True)

    def serve(self, host, port):
        """Bind, serve until a shutdown op arrives, tear down."""
        srv = RpcServer(host, port, self.handle,
                        name=f"worker{self.rank}")
        srv.start()
        try:
            self._shutdown.wait()
        finally:
            srv.close()
            self.close()


def main(argv=None):
    ap = argparse.ArgumentParser(prog="paddle_tpu_torch.cluster.worker")
    ap.add_argument("--spec", required=True,
                    help="factory 'module:function'")
    ap.add_argument("--role", default="infer",
                    choices=("infer", "prefill", "decode", "generate"))
    ap.add_argument("--kwargs", default="{}",
                    help="JSON kwargs for the factory")
    ap.add_argument("--speculation", default=None,
                    choices=("ngram", "draft"),
                    help="speculative-decoding drafter for generation "
                         "engines (merged into the factory kwargs)")
    ap.add_argument("--spec-k", type=int, default=None,
                    help="max drafted tokens per sequence per step")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="enable the engine's refcounted prefix cache "
                         "(merged into the factory kwargs; the decode "
                         "role needs it for fleet-wide prefix reuse)")
    args = ap.parse_args(argv)
    factory_kwargs = json.loads(args.kwargs)
    # CLI knobs merge UNDER explicit --kwargs entries: the pool owner's
    # JSON wins over the flag defaults
    if args.speculation is not None:
        factory_kwargs.setdefault("speculation", args.speculation)
    if args.spec_k is not None:
        factory_kwargs.setdefault("spec_k", args.spec_k)
    if args.prefix_cache:
        factory_kwargs.setdefault("prefix_cache", True)

    # per-process span ids BEFORE any engine warmup records spans
    _tracing.reseed_ids()
    # flight recorder armed at boot (the always-on tier): the last
    # seconds before an incident are already ringed when the router
    # fans flight_dump out.  PADDLE_TPU_FLIGHTREC=0 disables; a
    # numeric value overrides the ring size.
    flightrec_env = os.environ.get("PADDLE_TPU_FLIGHTREC", "1")
    if flightrec_env != "0":
        from ..observability import flightrec

        flightrec.arm(int(flightrec_env) if flightrec_env.isdigit()
                      and int(flightrec_env) > 1 else None)

    # chaos straggler: PADDLE_TPU_CHAOS_SLOW_MS=<ms> arms a process-
    # lifetime FaultPlan whose slow_worker latency site delays every
    # dispatch — tools/chaos.py sets this on ONE spawned worker to
    # prove hedging cuts the tail it creates
    slow_ms = os.environ.get("PADDLE_TPU_CHAOS_SLOW_MS")
    if slow_ms:
        from ..resilience.faults import FaultPlan

        FaultPlan(delays={"slow_worker": float(slow_ms) / 1e3}).arm()

    endpoint = os.environ.get("PADDLE_CURRENT_ENDPOINT", "127.0.0.1:0")
    host, _, port = endpoint.rpartition(":")
    rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))

    servicer = WorkerServicer(
        args.role, resolve_factory(args.spec),
        factory_kwargs=factory_kwargs, rank=rank)
    # readiness marker for the pool's log tail (launch.py convention of
    # per-rank logs): printed only after warmup succeeded
    print(f"PADDLE_TPU_WORKER_READY rank={rank} role={args.role} "
          f"port={port}", flush=True)
    servicer.serve(host or "127.0.0.1", int(port))
    return 0


if __name__ == "__main__":
    sys.exit(main())
