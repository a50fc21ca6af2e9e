"""paddle_tpu_torch.cluster — disaggregated multi-process serving.

Counterpart of paddle_tpu.cluster, copied: the same router, pool, RPC
control plane and worker, whose engines are the port's
`GenerationEngine` on the card.

The serving story so far stops at one process: `serving.
InferenceServer` batches onto one backend, `generation.
GenerationEngine` decodes one continuous batch.  This package is the
tier above — a `Router` front-end speaking the same
``submit``/``infer`` surface, fanning requests over N worker PROCESSES
(each running its own server/engine), with:

* SLO-aware admission: per-tenant quotas, priority queues, and load
  shedding off queue depth and the router's p99;
* health-checked re-routing: a worker death re-queues its in-flight
  request onto the survivors (`resilience` retry semantics; provable
  with `FaultPlan(rpc_failures=...)` without killing a process);
* prefill/decode disaggregation: `GenerationRouter` sends prompts to a
  prefill pool, ships the resulting KV state
  (`generation.PrefillHandoff`) through the control plane, and retires
  sequences on a decode pool running the continuous-batching engine —
  the two fleets scale independently;
* cross-process tracing: trace context rides in every RPC, so one
  merged Chrome trace (tools/trace_merge.py) shows
  router -> prefill -> decode for a single request.

See README "Cluster serving" for topology and usage, and its port
section for running the port's workers on the CPU or the card.
"""
from .pool import WorkerHandle, WorkerPool, WorkerSpec
from .router import (ClusterConfig, ClusterOverloadError, GenerationRouter,
                     ModelUnavailableError, QuotaExceededError, Router)
from .rpc import RpcClient, RpcError, RpcServer, WorkerUnavailable
from .stats import ClusterStats
from .worker import WorkerServicer

__all__ = [
    "Router", "GenerationRouter", "ClusterConfig", "ClusterStats",
    "QuotaExceededError", "ClusterOverloadError",
    "ModelUnavailableError",
    "WorkerPool", "WorkerSpec", "WorkerHandle", "WorkerServicer",
    "RpcServer", "RpcClient", "RpcError", "WorkerUnavailable",
]
