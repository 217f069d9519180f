"""Flight recorder: an always-on ring of recent spans, structured
events and metric snapshots, readable after a crash (counterpart of
paddle_tpu/observability/flightrecorder.py).

Three bounded rings a process: finished trace spans (tapped off
tracing's recorder by a span listener, so arming the recorder makes
`span()` live with full tracing off), structured notes
(``note("trainer.step", step=i)``, injected faults) and a few compact
snapshots of the metrics registry.  With a directory the rings are
flushed to ``<dir>/flight_<pid>.json`` on a short period (default 0.5 s,
written to a temporary and renamed), so a SIGKILLed process leaves its
last seconds on disk; SIGTERM, an uncaught exception, an injected fault
(core/resilience calls :func:`on_fault`) and interpreter exit dump at
once.  A live pserver answers its dump over the wire (the FLIGHT verb,
parallel/pserver.py), a serving replica with its `flight` op
(serving/replica.py).

Arming: ``PADDLE_TPU_FLIGHT_DIR=<dir>`` at package import (a memory-only
ring with ``PADDLE_TPU_FLIGHT=on``), or ``flightrecorder.install(dir=...)``.
Armed, it costs one deque append a span or note and a small periodic
flush.
"""
from __future__ import annotations

import atexit
import json
import os
import signal
import sys
import threading
import time
from collections import deque
from typing import Optional

from . import metrics as metrics_mod
from . import tracing

__all__ = ["FlightRecorder", "install", "uninstall", "recorder",
           "armed", "note", "on_fault", "dump_dict"]

_REC: Optional["FlightRecorder"] = None


def _ring_snapshot(d: deque) -> list:
    """Copy a ring that other threads keep appending to.  Appends are
    deliberately lock-free (they sit on the span hot path); list()
    raises RuntimeError if the deque mutates mid-copy, so retry a few
    times and settle for the ring as-of the last attempt."""
    for _ in range(8):
        try:
            return list(d)
        except RuntimeError:
            continue
    return []


class FlightRecorder:
    """One process's always-on telemetry ring; use the module-level
    :func:`install` rather than constructing directly."""

    def __init__(self, dir: Optional[str] = None, flush_s: float = 0.5,
                 max_spans: int = 2048, max_events: int = 2048,
                 max_snapshots: int = 8, capture_spans: bool = True):
        self.dir = dir
        self.flush_s = float(flush_s)
        self._spans: deque = deque(maxlen=max_spans)
        self._events: deque = deque(maxlen=max_events)
        self._snaps: deque = deque(maxlen=max_snapshots)
        self._seq = 0            # bumped per append; flush skips idle
        self._flushed_seq = -1
        self._capture_spans = capture_spans
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._prev_sigterm = None
        self._prev_excepthook = None
        self._hooks_installed = False

    # -- ingestion (hot paths) ---------------------------------------------
    def _on_span(self, rec: dict) -> None:
        self._spans.append(rec)
        self._seq += 1

    def note(self, event: str, /, **data) -> None:
        # positional-only: the data dict may itself carry a "kind" key
        # (e.g. fault events)
        self._events.append({"ts": time.time(), "kind": event,
                             "data": data})
        self._seq += 1

    def _snapshot_metrics(self) -> None:
        try:
            snap = metrics_mod.registry().snapshot()
        except Exception:
            return  # a half-registered metric must not kill the flusher
        if self._snaps and self._snaps[-1]["metrics"] == snap:
            return  # idle registry: no new point, no flush
        self._snaps.append({"ts": time.time(), "metrics": snap})
        # counter movement alone (a span-less process like the router)
        # must still refresh the on-disk dump
        self._seq += 1

    # -- dump ---------------------------------------------------------------
    def dump_dict(self, reason: str = "on-demand") -> dict:
        return {
            "pid": os.getpid(),
            "time": time.time(),
            "reason": reason,
            "spans": _ring_snapshot(self._spans),
            "events": _ring_snapshot(self._events),
            "metric_snapshots": _ring_snapshot(self._snaps),
        }

    def default_path(self) -> Optional[str]:
        if not self.dir:
            return None
        return os.path.join(self.dir, f"flight_{os.getpid()}.json")

    def write(self, path: Optional[str] = None,
              reason: str = "on-demand") -> Optional[str]:
        """Write the dump atomically (tmp + rename: a reader — or the
        SIGKILL that interrupts the NEXT flush — never sees a torn
        file).  Returns the path, or None when no dir is configured."""
        path = path or self.default_path()
        if not path:
            return None
        payload = self.dump_dict(reason)
        d = os.path.dirname(path)
        try:
            if d:
                os.makedirs(d, exist_ok=True)
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(payload, f, default=str)
            os.replace(tmp, path)
        except OSError:
            return None  # best-effort: read-only FS etc.
        return path

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "FlightRecorder":
        if self._capture_spans:
            tracing.add_span_listener(self._on_span)
        self._snapshot_metrics()
        if self.dir and self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, daemon=True,
                name="paddle-tpu-flightrec")
            self._thread.start()
        self._install_hooks()
        return self

    def _run(self):
        while not self._stop.wait(self.flush_s):
            self._snapshot_metrics()
            if self._seq != self._flushed_seq:
                self._flushed_seq = self._seq
                self.write(reason="periodic")

    def _install_hooks(self):
        if self._hooks_installed:  # start() may run again (dir upgrade)
            return
        self._hooks_installed = True
        # SIGTERM: dump, then hand the signal to whoever owned it
        # (only the main thread may set handlers; a recorder installed
        # from a worker thread simply skips the hook)
        try:
            self._prev_sigterm = signal.signal(signal.SIGTERM,
                                               self._on_sigterm)
        except (ValueError, OSError):
            self._prev_sigterm = None
        hook = sys.excepthook

        def _crash_hook(exc_type, exc, tb):
            try:
                self.note("crash", type=exc_type.__name__,
                          message=str(exc))
                self.write(reason="crash")
            except Exception:
                pass
            hook(exc_type, exc, tb)

        self._prev_excepthook = hook
        sys.excepthook = _crash_hook
        atexit.register(self._atexit)

    def _on_sigterm(self, signum, frame):
        self.note("sigterm")
        self.write(reason="sigterm")
        prev = self._prev_sigterm
        if callable(prev):
            prev(signum, frame)
        elif prev == signal.SIG_IGN:
            return  # the process deliberately ignores SIGTERM: arming
            # the recorder must not turn an ignored signal fatal
        else:
            # restore the default disposition and re-deliver so the
            # process still dies of SIGTERM (exit status intact)
            signal.signal(signal.SIGTERM, signal.SIG_DFL)
            os.kill(os.getpid(), signal.SIGTERM)

    def _atexit(self):
        self._snapshot_metrics()
        self.write(reason="exit")

    def close(self):
        if self._capture_spans:
            tracing.remove_span_listener(self._on_span)
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None and t is not threading.current_thread():
            t.join(timeout=self.flush_s + 5)
        try:
            atexit.unregister(self._atexit)
        except Exception:
            pass
        if self._prev_excepthook is not None:
            sys.excepthook = self._prev_excepthook
            self._prev_excepthook = None
        if self._prev_sigterm is not None:
            try:
                signal.signal(signal.SIGTERM, self._prev_sigterm)
            except (ValueError, OSError):
                pass
            self._prev_sigterm = None
        self._hooks_installed = False


# ---------------------------------------------------------------------------
# module-level surface (what the runtimes call)
# ---------------------------------------------------------------------------


def install(dir: Optional[str] = None, flush_s: float = 0.5,
            max_spans: int = 2048, max_events: int = 2048,
            capture_spans: bool = True) -> FlightRecorder:
    """Arm the process flight recorder (idempotent: a second install
    with a dir upgrades a memory-only one; otherwise the existing
    recorder is returned).  With `dir`, the ring is flushed to
    ``<dir>/flight_<pid>.json`` every `flush_s` seconds."""
    global _REC
    if _REC is not None:
        if dir and not _REC.dir:
            _REC.dir = dir
            _REC.start()  # starts the flusher now that there is a dir
        return _REC
    _REC = FlightRecorder(dir=dir, flush_s=flush_s,
                          max_spans=max_spans, max_events=max_events,
                          capture_spans=capture_spans).start()
    return _REC


def uninstall() -> None:
    """Disarm and drop the recorder (tests)."""
    global _REC
    rec, _REC = _REC, None
    if rec is not None:
        rec.close()


def recorder() -> Optional[FlightRecorder]:
    return _REC


def armed() -> bool:
    return _REC is not None


def note(event: str, /, **data) -> None:
    """Append one structured event to the ring; a no-op costing one
    global read when no recorder is armed, so runtimes can call it
    unconditionally."""
    rec = _REC
    if rec is not None:
        rec.note(event, **data)


def on_fault(site: str, kind: str,
             trace_id: "str | None" = None) -> None:
    """Called by core/resilience when the chaos injector fires: the
    injected fault is exactly the moment whose surrounding seconds the
    post-mortem wants, so dump eagerly instead of waiting for a flush
    tick.  ``trace_id`` (the trace active at the fire site, when any)
    links the dump's fault event to the request trace it hit."""
    rec = _REC
    if rec is not None:
        if trace_id is not None:
            rec.note("fault", site=site, kind=kind, trace_id=trace_id)
        else:
            rec.note("fault", site=site, kind=kind)
        rec.write(reason=f"fault:{site}")


def dump_dict(reason: str = "on-demand") -> dict:
    """The current dump, armed or not (an un-armed process gives an
    empty ring, not an error)."""
    rec = _REC
    if rec is not None:
        return rec.dump_dict(reason)
    return {"pid": os.getpid(), "time": time.time(), "reason": reason,
            "armed": False, "spans": [], "events": [],
            "metric_snapshots": []}


def maybe_install_from_env() -> Optional[FlightRecorder]:
    """PADDLE_TPU_FLIGHT_DIR=<dir> arms the recorder at import;
    PADDLE_TPU_FLIGHT=on arms a memory-only ring (wire-verb dumps
    only)."""
    d = os.environ.get("PADDLE_TPU_FLIGHT_DIR", "")
    if d:
        return install(dir=d)
    raw = os.environ.get("PADDLE_TPU_FLIGHT", "").strip().lower()
    if raw in ("1", "on", "true", "yes"):
        return install()
    return None


def _after_fork_in_child():
    """A forked child shares the parent's ring object but not its
    flusher thread; re-arm cleanly so the child's dump carries its own
    pid and its flusher exists."""
    global _REC
    rec = _REC
    if rec is None:
        return
    tracing.remove_span_listener(rec._on_span)
    _REC = None
    install(dir=rec.dir, flush_s=rec.flush_s,
            capture_spans=rec._capture_spans)


if hasattr(os, "register_at_fork"):  # posix
    os.register_at_fork(after_in_child=_after_fork_in_child)
