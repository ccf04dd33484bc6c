"""Unified telemetry substrate: metrics registry, span tracing, profiling
hooks, exporters and training-dynamics probes. Twin of ``repro.obs``
(DESIGN.md §11-§12); the framework-free modules are copies of the
reference's, ``trace``, ``profiling`` and ``probes`` run on PyTorch.

The one import every instrumented subsystem makes::

    from repro_torch import obs

    with obs.span("train.epoch", epoch=epoch) as sp:
        params, losses = segment(...)
        sp.block_on((params, losses))   # close waits for device results

Instrumentation lives host-side *between* device calls: a span or point
never reads a device value (that would add a host synchronisation), and
the probes' reductions return device tensors that leave the card only in
``probes.record_snapshot``.

``obs.disabled()`` turns the whole telemetry layer into a no-op (zero
obs-owned allocations per call — checked by ``debug_allocs`` accounting in
tests). The reference's budget for the instrumented-vs-disabled delta is
< 2 % on the fused epoch.
"""
from __future__ import annotations

from repro_torch.obs._state import (
    debug_allocs,
    disabled,
    is_enabled,
    set_enabled,
)
from repro_torch.obs.detect import (
    Alert,
    AnomalyMonitor,
    DetectorThresholds,
    health_block,
)
from repro_torch.obs.export import (
    format_summary,
    prometheus_text,
    read_events,
    summarize_events,
    validate_events,
)
from repro_torch.obs.metrics import (
    DEFAULT_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    RollingWindow,
    default_registry,
)
from repro_torch.obs.profiling import (
    profile_trace,
    record_compile_counts,
    sample_device_memory,
)
from repro_torch.obs.probes import (
    record_snapshot,
    set_snapshot_transform,
)
from repro_torch.obs.timeline import (
    TIMELINE_SCHEMA_VERSION,
    TimelineWriter,
    read_timeline,
    render_diff,
    render_report,
    timeline_to,
    validate_timeline,
)
from repro_torch.obs.trace import (
    SCHEMA_VERSION,
    Span,
    Tracer,
    configure,
    current_span_name,
    current_tracer,
    event_span,
    point,
    shutdown,
    span,
    trace_to,
)

__all__ = [
    # switch / accounting
    "disabled", "is_enabled", "set_enabled", "debug_allocs",
    # metrics
    "Counter", "Gauge", "Histogram", "RollingWindow", "MetricsRegistry",
    "default_registry", "DEFAULT_BUCKETS",
    # tracing
    "SCHEMA_VERSION", "Span", "Tracer", "span", "point", "event_span",
    "configure", "shutdown", "trace_to", "current_tracer",
    "current_span_name",
    # profiling
    "profile_trace", "sample_device_memory", "record_compile_counts",
    # export
    "prometheus_text", "read_events", "validate_events",
    "summarize_events", "format_summary",
    # training-dynamics probes / timeline / anomaly detection (§12)
    "record_snapshot", "set_snapshot_transform",
    "TIMELINE_SCHEMA_VERSION", "TimelineWriter", "timeline_to",
    "read_timeline", "validate_timeline", "render_report", "render_diff",
    "AnomalyMonitor", "DetectorThresholds", "Alert", "health_block",
]
