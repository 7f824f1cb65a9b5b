"""Observability: host-side tracing + metrics export for serving.

A copy of the reference package's ``obs`` (standard library only; the
port imports nothing of the reference). Three modules:

* ``obs.trace`` — a ring-buffered structured tracer (``Tracer`` /
  ``TraceConfig``). The serving engine emits per-request lifecycle
  spans (queued -> prefill -> decode-round* -> retired, plus
  preempted/resumed events and a ``resume`` flow linking a preempted
  request's two slot residencies) and per-round scheduler phase spans
  (admit / dispatch / sync / walk), all stamped from the engine's own
  clock. Exports Chrome/Perfetto ``trace_event`` JSON.
* ``obs.metrics`` — the single nearest-rank ``percentile`` definition
  (shared by ``serving.latency_percentiles`` and the SLA controller), a
  fixed log-bucket ``Histogram`` with merge, and Prometheus
  text-exposition renderers over ``EngineMetrics`` snapshots plus
  histograms. Metric names keep the reference's ``repro_serving``
  prefix, so one scrape configuration reads both packages.
* ``obs.promhttp`` — a stdlib daemon-thread HTTP server exposing any
  ``prometheus()``-shaped renderer at ``GET /metrics``, and a snapshot
  the serving loop refreshes where rendering is a collective.

This package imports nothing from ``serving`` (serving imports it).
"""

from .metrics import (Histogram, percentile, render_prometheus,
                      render_prometheus_labeled)
from .promhttp import MetricsServer, MetricsSnapshot
from .trace import PHASES, SCHED_TID, TraceConfig, TraceEvent, Tracer

__all__ = ["Histogram", "MetricsServer", "MetricsSnapshot", "percentile", "render_prometheus",
           "render_prometheus_labeled", "PHASES", "SCHED_TID",
           "TraceConfig", "TraceEvent", "Tracer"]
