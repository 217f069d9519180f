"""Observability: metrics registry, trace spans, exporters, time
attribution, the flight recorder and the fleet telemetry plane
(counterpart of paddle_tpu/observability/).

    from paddle_tpu_torch.observability import metrics, tracing, exporters

    STEPS = metrics.counter("paddle_tpu_trainer_steps_total", "steps")
    with tracing.span("trainer.step", batch_id=i):
        ...
        STEPS.inc()
    exporters.write_prometheus("/tmp/metrics.prom")
    tracing.write_chrome_trace("/tmp/trace.json")

The metric names, text formats and wire are the JAX package's, so one
collector scrapes members of either package.

Switches (env at import, or flags/`set_flags` at runtime):
  * ``PADDLE_TPU_METRICS=on`` — arm the gated instruments (metrics
    created with ``always=True`` count regardless).
  * ``PADDLE_TPU_TRACE=on`` / ``PADDLE_TPU_TRACE_DIR=<dir>`` — record
    spans; with a dir, auto-write ``trace_<pid>.json`` at exit.
  * ``PADDLE_TPU_METRICS_DUMP=<path>`` — auto-write the Prometheus text
    dump at exit.
  * ``PADDLE_TPU_FLIGHT_DIR=<dir>`` / ``PADDLE_TPU_FLIGHT=on`` — arm the
    flight recorder at import (flightrecorder.py).
  * ``PADDLE_TPU_TELEMETRY_REGISTRY=<host:port>`` — trainers, pservers
    and replicas announce themselves to the collector
    (collector.maybe_announce).
"""
from __future__ import annotations

from . import attribution, collector, exemplars, exporters, flightrecorder, metrics, slo, timeseries, tracing  # noqa: F401,E501
from .metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    counter,
    gauge,
    histogram,
    registry,
)
from .timeseries import TimeSeriesStore  # noqa: F401
from .tracing import SpanContext, activate, current_context, span  # noqa: F401

__all__ = [
    "metrics",
    "tracing",
    "exporters",
    "exemplars",
    "attribution",
    "timeseries",
    "flightrecorder",
    "slo",
    "collector",
    "TimeSeriesStore",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "counter",
    "gauge",
    "histogram",
    "registry",
    "SpanContext",
    "span",
    "activate",
    "current_context",
]


def _wire_flags():
    """Keep the module switches in step with the flag registry so
    `set_flags({"metrics": True})` / PADDLE_TPU_METRICS both work."""
    from ..core import flags as flags_mod
    from ..core.flags import get_flag

    flags_mod.on_flag_change(
        "metrics", lambda: metrics.set_enabled(get_flag("metrics")))

    def _trace_dir_changed():
        d = get_flag("trace_dir")
        if d:
            tracing.set_trace_dir(d)

    flags_mod.on_flag_change("trace_dir", _trace_dir_changed)
    metrics.set_enabled(bool(get_flag("metrics")) or metrics.enabled())
    d = get_flag("trace_dir")
    if d and not tracing.trace_dir():
        tracing.set_trace_dir(d)


_wire_flags()


flightrecorder.maybe_install_from_env()
