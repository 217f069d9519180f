"""Profiler, its host-event half: named range events with an aggregated
summary table (counterpart of paddle_tpu/profiler.py).

Reference: paddle/fluid/platform/profiler.{h,cc} (RecordEvent ranges,
EnableProfiler/DisableProfiler -> a table of calls/total/min/max/ave)
and python/paddle/v2/fluid/profiler.py (the `profiler` context
manager).  The input pipeline records its stages here (`feed.pack`,
`pipeline.h2d`, `pipeline.wait`, `pipeline.fetch_sync`); with tracing
on, each range is also a span.

The device half is not ported yet (ROADMAP A10c): `cuda_profiler` and
the JAX package's XLA tools (`xla_profiler`, `lowered_ir_text`,
`profile_compiled_ops`, `format_op_table`) are to be rebuilt on
`torch.profiler`, and raise NotImplementedError until then.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, Optional

from .observability import tracing as _tracing

__all__ = [
    "enable_profiler",
    "disable_profiler",
    "reset_profiler",
    "profiler",
    "cuda_profiler",
    "xla_profiler",
    "record_event",
    "profiler_summary",
    "profile_compiled_ops",
    "lowered_ir_text",
    "format_summary",
    "format_op_table",
    "event_totals",
    "host_blocked_fraction",
]

_enabled = False
_events: Dict[str, List[float]] = {}
# events are recorded from the prefetch worker thread too
# (reader/pipeline.py): the store must tolerate concurrent
# record_event vs event_totals/profiler_summary readers
_events_lock = threading.Lock()


def is_enabled() -> bool:
    return _enabled


@contextlib.contextmanager
def record_event(name: str, sync=None):
    """RAII range event (reference platform::RecordEvent).  `sync` is
    called before reading the clock (a device fence, e.g.
    torch.cuda.synchronize).

    When trace-span recording is on (observability.tracing), the range
    also opens a span, so profiler events land in the Chrome trace with
    real wall-clock placement alongside the subsystem spans."""
    if not _enabled and not _tracing.enabled():
        yield
        return
    t0 = time.perf_counter()
    span_cm = _tracing.span(name)
    span_cm.__enter__()
    try:
        yield
    finally:
        try:
            if sync is not None:
                sync()
        finally:
            # close the span AFTER the fence so span and event time the
            # same range, but ALWAYS close it (inner finally): a raising
            # fence must not leave the context pushed on the thread's
            # span stack, which would mis-parent every later span.  Exc
            # info deliberately not forwarded: a raising op still
            # records its range, same as the event list.
            span_cm.__exit__(None, None, None)
            if _enabled:
                dt = time.perf_counter() - t0
                with _events_lock:
                    _events.setdefault(name, []).append(dt)


def enable_profiler(state: str = "All"):
    global _enabled
    assert state in ("CPU", "GPU", "TPU", "All"), state
    _enabled = True


def reset_profiler():
    with _events_lock:
        _events.clear()


def disable_profiler(sorted_key: Optional[str] = None, print_table=True):
    """Stop profiling; print/return the aggregated table
    (reference DisableProfiler + PrintProfiler)."""
    global _enabled
    _enabled = False
    table = profiler_summary(sorted_key)
    if print_table:
        print(format_summary(table))
    return table


def profiler_summary(sorted_key: Optional[str] = None):
    """Aggregated rows; `sorted_key=None` defaults to "total" descending
    (the reference PrintProfiler's default ordering — insertion order was
    a bug: the table's point is ranking hotspots).  Pass "insertion" to
    keep recording order."""
    rows = []
    with _events_lock:
        snapshot = {name: list(ts) for name, ts in _events.items()}
    for name, ts in snapshot.items():
        rows.append({
            "name": name, "calls": len(ts), "total": sum(ts),
            "min": min(ts), "max": max(ts), "ave": sum(ts) / len(ts),
        })
    key = sorted_key if sorted_key is not None else "total"
    if key in ("calls", "total", "min", "max", "ave"):
        rows.sort(key=lambda r: -r[key])
    return rows


def event_totals() -> Dict[str, float]:
    """{event name: total seconds} recorded so far — the programmatic
    view of the summary table, for user telemetry over the pipeline
    stage events (feed.pack / pipeline.*)."""
    with _events_lock:
        return {name: sum(ts) for name, ts in _events.items()}


def host_blocked_fraction(wall_seconds: float, events) -> float:
    """Fraction of `wall_seconds` spent inside the named host-side
    events.  Which events block the loop depends on the pipeline mode:
    the serial loop blocks in `feed.pack` (DataFeeder) + `pipeline.h2d`;
    the prefetched loop's worker absorbs those, and the loop itself only
    blocks in `pipeline.wait` (queue empty) and `pipeline.fetch_sync`
    (LazyFetch reads) — pass the event set matching the mode measured."""
    if wall_seconds <= 0:
        return 0.0
    with _events_lock:
        total = sum(sum(_events.get(e, ())) for e in events)
    return min(total / wall_seconds, 1.0)


def format_summary(rows) -> str:
    out = [f"{'Event':<40}{'Calls':>8}{'Total(ms)':>12}{'Min(ms)':>10}"
           f"{'Max(ms)':>10}{'Ave(ms)':>10}"]
    for r in rows:
        out.append(
            f"{r['name']:<40}{r['calls']:>8}{r['total'] * 1e3:>12.3f}"
            f"{r['min'] * 1e3:>10.3f}{r['max'] * 1e3:>10.3f}"
            f"{r['ave'] * 1e3:>10.3f}")
    return "\n".join(out)


@contextlib.contextmanager
def profiler(state: str = "CPU", sorted_key: Optional[str] = None,
             print_table=True):
    """`with profiler.profiler('All', 'total'):` (reference
    fluid/profiler.py:76)."""
    enable_profiler(state)
    reset_profiler()
    try:
        yield
    finally:
        disable_profiler(sorted_key, print_table=print_table)


def _device_half(name):
    def not_ported(*args, **kwargs):
        raise NotImplementedError(
            f"profiler.{name}: the profiler's device half is not ported "
            "yet; it is to be rebuilt on torch.profiler (ROADMAP A10c)")
    not_ported.__name__ = name
    not_ported.__doc__ = ("The device half of the profiler, not ported "
                          "yet (ROADMAP A10c).")
    return not_ported


cuda_profiler = _device_half("cuda_profiler")
xla_profiler = _device_half("xla_profiler")
lowered_ir_text = _device_half("lowered_ir_text")
profile_compiled_ops = _device_half("profile_compiled_ops")
format_op_table = _device_half("format_op_table")
