"""paddle_tpu_torch.observability — unified telemetry.

Counterpart of paddle_tpu/observability: the same modules, copied (the
JAX package's modules import no jax, but its package does), over the
port's torch.profiler-backed :mod:`paddle_tpu_torch.profiler`.

* :mod:`registry` — the process-wide :class:`MetricsRegistry`
  (Counter/Gauge/Histogram, labeled series, JSON snapshot, Prometheus
  text export).  Serving, generation, the Executor and the fusion pass
  report through :func:`get_registry`, under the JAX package's metric
  names and labels.
* :mod:`tracing` — nested spans (trace/span/parent ids) layered on
  :mod:`paddle_tpu_torch.profiler`, with contextvar propagation across
  the serving batcher's worker thread; exported through the profiler's
  Chrome-trace format, and — while its torch.profiler session runs —
  opened as ``record_function`` ranges, so host spans and the CUDA
  kernels line up in one Kineto trace.
* :mod:`monitor` — the metric-name constants and
  :class:`TrainingMonitor`, per-step JSON-lines plus registry series.
* :mod:`flightrec` — the always-on flight recorder: a bounded ring of
  recent spans/events per process, a trigger bus for incident-class
  moments, and :class:`IncidentManager` assembling incident bundles.
* :mod:`scrape` — :class:`TelemetryScraper`: pulls registry snapshots
  from duck-typed worker handles into one worker-labeled snapshot.
* :mod:`ledger` — the per-request :class:`RequestLedger` (bounded ring
  of lifecycle records) and the per-tenant/per-model goodput
  :func:`ledger.rollup` over it.
* :mod:`slo` — :class:`SloEngine`, declarative objectives evaluated as
  multi-window error-budget burn rates off the registry's own series.

``set_enabled(False)`` turns off the OPTIONAL per-item instrumentation
(monitor emission); registry handles stay valid and spans already no-op
when profiling is off.
"""
from __future__ import annotations

from . import (export, flightrec, ledger, monitor, registry,  # noqa: F401,E501
               scrape, slo, tracing)
from .export import (format_diff, snapshot_diff, write_prometheus,  # noqa: F401
                     write_snapshot)
from .flightrec import FlightRecorder, IncidentManager  # noqa: F401
from .ledger import RequestLedger  # noqa: F401
from .monitor import TrainingMonitor  # noqa: F401
from .registry import (Counter, Gauge, Histogram,  # noqa: F401
                       MetricsRegistry, get_registry)
from .scrape import TelemetryScraper  # noqa: F401
from .slo import SloEngine, SloObjective, SloPolicy  # noqa: F401
from .tracing import (SpanContext, attach, current_span,  # noqa: F401
                      new_trace, record_span, span)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "get_registry",
    "SpanContext", "span", "attach", "current_span", "new_trace",
    "record_span", "TrainingMonitor", "write_prometheus",
    "write_snapshot", "snapshot_diff", "format_diff",
    "FlightRecorder", "IncidentManager", "TelemetryScraper",
    "RequestLedger", "SloEngine", "SloObjective", "SloPolicy",
    "enabled", "set_enabled",
]

_enabled = True


def enabled():
    """Fast gate for optional hot-path instrumentation (one global
    read)."""
    return _enabled


def set_enabled(value):
    global _enabled
    _enabled = bool(value)
