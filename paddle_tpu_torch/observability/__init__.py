"""Observability of the port (counterpart of paddle_tpu/observability/).

- ``flops``: the model-FLOPs accounting that MFU divides by.
- ``tracer``: thread-safe host span recorder -> chrome-trace JSON.
- ``metrics``: typed registry (counters/gauges/log-bucket histograms with
  p50/p90/p99) absorbing the ``core.monitor`` counters into one snapshot.
- ``step_telemetry``: ``StepTelemetry``, one record a train step (wall
  time, tokens/s, TFLOP/s, MFU, the card's memory, the counters), and the
  ``InMemorySink`` / ``JsonlSink`` record sinks (PADDLE_TPU_TELEMETRY_DIR).
- ``health``: the train step's health stats (grad, weight and update norms,
  non-finite attribution by parameter name) on interval steps, fetched as
  ONE packed buffer (FLAGS_health_monitor / PADDLE_TPU_HEALTH_DIR).
- ``exporter``: stdlib-HTTP pull endpoint (Prometheus text + JSON),
  enabled via PADDLE_TPU_METRICS_PORT.
- ``flight_recorder``: bounded ring of recent serve records dumped to disk
  on exception/explicit trigger (PADDLE_TPU_FLIGHT_DIR).
- ``fleet``: cross-process federation over the store (registry snapshots,
  lossless histogram merge) and ``TraceContext`` from router to engine.
- ``slo``: declarative SLOs with multi-window burn-rate alerting.
- ``capacity``: the closed-loop CapacityController acting through the
  ReplicaRouter's spawn/drain machinery.

Everything is off by default and stdlib-only at import time. Not ported
yet (ROADMAP.md Queue 1 item 10): ``exec_introspect``, which reads compiled
programs.
"""
from . import capacity, exporter, fleet, flight_recorder, health, metrics, slo  # noqa: F401
from .capacity import (  # noqa: F401
    CapacityController, CapacityPolicy, active_controller,
    install_controller, uninstall_controller,
)
from .exporter import (  # noqa: F401
    MetricsExporter, ensure_started_from_env, get_exporter, start_exporter,
    stop_exporter,
)
from .fleet import (  # noqa: F401
    FleetCollector, FleetPublisher, TraceContext, active_collector,
    fleet_to_prometheus, install_collector, merge_registry_snapshots,
    register_router, uninstall_collector,
)
from .flight_recorder import FlightRecorder  # noqa: F401
from .flops import (  # noqa: F401
    PEAK_TFLOPS, card_peak_flops_per_sec, peak_flops_per_sec,
    transformer_flops_per_token,
)
from .health import TrainingHealthMonitor, segment_layout  # noqa: F401
from .metrics import (  # noqa: F401
    Counter, Gauge, Histogram, MetricRegistry, active_registry,
    default_registry, estimate_percentile, log_buckets,
    merge_histogram_snapshots, subtract_histogram_snapshots,
    subtract_registry_snapshots,
)
from .slo import (  # noqa: F401
    AlertManager, BurnWindow, SloEngine, SloSpec, SnapshotRing,
    active_engine, default_serving_slos, default_slos, default_train_slos,
    default_windows, install_engine, latency_slo, ratio_slo,
    uninstall_engine,
)
from .step_telemetry import InMemorySink, JsonlSink, StepTelemetry  # noqa: F401
from .tracer import Tracer, enabled, get_tracer, span  # noqa: F401

__all__ = [
    "Tracer", "get_tracer", "span", "enabled",
    "CapacityController", "CapacityPolicy", "capacity",
    "install_controller", "uninstall_controller", "active_controller",
    "JsonlSink", "InMemorySink", "StepTelemetry",
    "TrainingHealthMonitor", "segment_layout", "health",
    "transformer_flops_per_token", "peak_flops_per_sec", "PEAK_TFLOPS",
    "card_peak_flops_per_sec",
    "Counter", "Gauge", "Histogram", "MetricRegistry",
    "default_registry", "active_registry", "estimate_percentile",
    "log_buckets", "merge_histogram_snapshots",
    "subtract_histogram_snapshots", "subtract_registry_snapshots",
    "SloSpec", "SloEngine", "SnapshotRing", "AlertManager", "BurnWindow",
    "ratio_slo", "latency_slo", "default_windows", "default_slos",
    "default_serving_slos", "default_train_slos", "install_engine",
    "uninstall_engine", "active_engine", "slo",
    "FleetCollector", "FleetPublisher", "TraceContext", "fleet",
    "install_collector", "uninstall_collector", "active_collector",
    "register_router", "merge_registry_snapshots", "fleet_to_prometheus",
    "MetricsExporter", "start_exporter", "stop_exporter", "get_exporter",
    "ensure_started_from_env",
    "FlightRecorder", "metrics", "exporter", "flight_recorder",
]
