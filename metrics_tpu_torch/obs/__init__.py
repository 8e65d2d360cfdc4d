"""Runtime observability (counterpart of ``metrics_tpu/obs/``): span
tracing, self-telemetry, scrapeable exporters, the flight recorder and
drift detection.

- ``obs/trace.py``: a bounded, thread-safe span ring at the host seams
  (metric update, sync and compute, the overlapped cycle's phases, the
  serving loop's offer, update and reduce, snapshot save and restore),
  enabled by ``METRICS_TPU_TRACE``, exportable as Chrome/Perfetto JSON.
- ``obs/runtime_metrics.py``: counters, gauges and latency histograms
  backed by the port's quantile sketch (K3 folds on the card).
- ``obs/export.py``: Prometheus text and JSON over health and telemetry,
  and a standard-library HTTP exporter; ``ServeLoop.scrape()`` is the
  in-process form.
- ``obs/flightrec.py``: the degradation flight recorder.
- ``obs/drift.py``: online drift detection against a frozen reference.

- ``obs/profile.py``: the step cost profiler — per analysis-registry entry,
  flops (``FlopCounterMode``), bytes accessed and collective payload bytes
  of one recorded step, joined with wall p50/p99 through a
  ``LatencyHistogram`` per entry and per padding-ladder tier, and on CUDA
  the card's time and K1-K3's launches (``python -m
  metrics_tpu_torch.analysis profile`` writes
  ``metrics_tpu_torch/analysis/COST_PROFILE.json``).
"""
from metrics_tpu_torch.obs.trace import (
    TraceContext,
    TraceRecord,
    add_trace_sink,
    chrome_events_for,
    chrome_trace_events,
    clear_trace,
    clock_sync,
    current_context,
    export_chrome_trace,
    force_tracing,
    instant,
    merge_chrome_sections,
    new_trace_id,
    records_since,
    remove_trace_sink,
    reset_trace_state,
    span,
    trace_context,
    trace_records,
    tracing_enabled,
)
from metrics_tpu_torch.obs.runtime_metrics import (
    HISTOGRAM_SEAMS,
    Counter,
    Gauge,
    LatencyHistogram,
    RuntimeMetrics,
    merged,
    note_jit_retrace,
    registry,
)
from metrics_tpu_torch.obs.export import TelemetryExporter, json_text, prometheus_text
from metrics_tpu_torch.obs.flightrec import (
    FlightRecordError,
    FlightRecorder,
    active_flight_recorder,
    attach_source,
    detach_source,
    install_flight_recorder,
    load_flight_record,
    load_flight_records,
    reset_flightrec_state,
)
from metrics_tpu_torch.obs.profile import (
    COST_PROFILE_FILENAME,
    default_profile_path,
    profile_entry,
    profile_registry,
    render_table,
    write_profile,
)
from metrics_tpu_torch.obs.drift import (
    DRIFT_SCORES,
    DriftMonitor,
    ReferenceWindow,
    reset_drift_env_state,
    resolve_drift_threshold,
)

__all__ = [
    "FlightRecorder",
    "FlightRecordError",
    "install_flight_recorder",
    "active_flight_recorder",
    "attach_source",
    "detach_source",
    "load_flight_record",
    "load_flight_records",
    "reset_flightrec_state",
    "DRIFT_SCORES",
    "DriftMonitor",
    "ReferenceWindow",
    "reset_drift_env_state",
    "resolve_drift_threshold",
    "TraceRecord",
    "TraceContext",
    "span",
    "instant",
    "tracing_enabled",
    "force_tracing",
    "current_context",
    "trace_context",
    "new_trace_id",
    "clock_sync",
    "trace_records",
    "records_since",
    "clear_trace",
    "chrome_trace_events",
    "chrome_events_for",
    "export_chrome_trace",
    "merge_chrome_sections",
    "add_trace_sink",
    "remove_trace_sink",
    "reset_trace_state",
    "Counter",
    "Gauge",
    "LatencyHistogram",
    "RuntimeMetrics",
    "registry",
    "merged",
    "note_jit_retrace",
    "HISTOGRAM_SEAMS",
    "TelemetryExporter",
    "prometheus_text",
    "json_text",
    "COST_PROFILE_FILENAME",
    "default_profile_path",
    "profile_entry",
    "profile_registry",
    "render_table",
    "write_profile",
]
