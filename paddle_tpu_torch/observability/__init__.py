"""Observability: metrics registry, trace spans, exemplars, time
attribution and the flight recorder (counterpart of
paddle_tpu/observability/; the exporters, collector, timeseries, slo and
fleet tools are not ported yet, ROADMAP A12's second part: until then
`maybe_announce`, the collector's announcement of a trainer or a
pserver, does nothing without PADDLE_TPU_TELEMETRY_REGISTRY and raises
with it).

Switches (env at import, or flags/`set_flags` at runtime):
  * ``PADDLE_TPU_METRICS=on`` — arm the gated instruments (metrics
    created with ``always=True`` count regardless).
  * ``PADDLE_TPU_TRACE=on`` / ``PADDLE_TPU_TRACE_DIR=<dir>`` — record
    spans; with a dir, auto-write ``trace_<pid>.json`` at exit.
  * ``PADDLE_TPU_FLIGHT_DIR=<dir>`` / ``PADDLE_TPU_FLIGHT=on`` — arm the
    flight recorder at import (flightrecorder.py).
"""
from __future__ import annotations

from . import attribution, exemplars, flightrecorder, metrics, tracing  # noqa: F401
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
from .tracing import SpanContext, activate, current_context, span  # noqa: F401

__all__ = [
    "metrics",
    "tracing",
    "exemplars",
    "attribution",
    "flightrecorder",
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
    "maybe_announce",
]


def maybe_announce(kind: str):
    """The fleet telemetry announcement of a `kind` member ("trainer",
    "pserver") to the collector: nothing while
    PADDLE_TPU_TELEMETRY_REGISTRY is unset."""
    import os

    if os.environ.get("PADDLE_TPU_TELEMETRY_REGISTRY"):
        raise NotImplementedError(
            f"PADDLE_TPU_TELEMETRY_REGISTRY is set: announcing this {kind} "
            "to the telemetry collector is not ported yet (ROADMAP A12's "
            "second part)")


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
