"""Cross-process trace spans: span() context managers + wire propagation.

The reference attributes cost per op with `platform::profiler`
RecordEvent ranges inside ONE process; a distributed step (trainer ->
VariableClient -> VariableServer -> optimize block) needs ranges that
compose ACROSS processes.  This module provides the minimal
OpenTelemetry-shaped substrate for that:

  * ``span(name, **attrs)`` — a context manager carrying a 128-bit
    trace id, a 64-bit span id and its parent's span id.  Spans nest via
    a thread-local context stack, so `with span("trainer.step"):` makes
    every span opened inside it (same thread) a child.
  * thread handoff — ``ctx = current_context()`` in the producer,
    ``with activate(ctx):`` in the worker thread (used by the prefetch
    pipeline and the serving worker), so background work records under
    the step that scheduled it.
  * wire propagation — ``inject()`` returns a small dict to ship in a
    protocol header (the pserver frame protocol carries it in the JSON
    head; frames without it keep working), ``extract(head)`` +
    ``activate`` on the receiving side parents the server-side span
    under the remote caller: one training step yields a single coherent
    trace across trainer, pserver and master.

Finished spans collect in a bounded in-process buffer and export as
Chrome-trace JSON (``chrome://tracing`` / Perfetto; see
observability/exporters.py).  Tracing is off (spans cost one boolean
test) unless ``PADDLE_TPU_TRACE=on`` or ``PADDLE_TPU_TRACE_DIR`` is set
— the latter also auto-writes ``trace_<pid>.json`` into the directory
at process exit, so a multi-process run drops one merge-able trace file
per process.
"""
from __future__ import annotations

import atexit
import os
import random
import threading
import time
from typing import Dict, List, NamedTuple, Optional

__all__ = [
    "SpanContext",
    "span",
    "activate",
    "current_context",
    "current_trace_id",
    "inject",
    "extract",
    "enabled",
    "set_enabled",
    "add_span_listener",
    "remove_span_listener",
    "trace_dir",
    "finished_spans",
    "clear",
    "chrome_trace_events",
    "write_chrome_trace",
    "TailSampler",
    "arm_tail_sampler",
    "disarm_tail_sampler",
    "tail_sampler",
]

_TRACE_DIR = os.environ.get("PADDLE_TPU_TRACE_DIR", "")
_ENABLED = bool(_TRACE_DIR) or (os.environ.get("PADDLE_TPU_TRACE", "")
                                .strip().lower() in ("1", "on", "true",
                                                     "yes"))

# bounded buffer: a runaway loop under tracing must degrade (drop +
# count) instead of eating the host's memory
_MAX_SPANS = 100_000
_spans: List[dict] = []
_dropped = 0
_lock = threading.Lock()
_tls = threading.local()
_rng = random.Random()
# span listeners (the flight recorder's tap): when any is registered,
# spans are CREATED and delivered to listeners even with full tracing
# off — the recorder's always-on ring wants the last seconds of spans
# without paying for (or growing) the 100k export buffer
_listeners: List = []


def _after_fork_in_child():
    """A forked worker must not share the parent's id stream (identical
    trace/span ids across processes) nor its span buffer (the child
    would re-dump the parent's spans under its own pid), and the buffer
    lock may have been held by a parent thread at fork time."""
    global _spans, _dropped, _lock, _TAIL
    _rng.seed()  # fresh OS entropy
    _lock = threading.Lock()
    _spans = []
    _dropped = 0
    # a forked child shares the parent's tail buffer: re-arm with a
    # fresh one so the child's dump carries only its own spans
    t = _TAIL
    if t is not None:
        remove_span_listener(t)
        _TAIL = None
        arm_tail_sampler(threshold_s=t.threshold_s, out_dir=t._dir,
                         max_open=t._max_open,
                         max_spans_per_trace=t._max_spans,
                         max_kept=t._max_kept, flush_s=t._flush_s)


if hasattr(os, "register_at_fork"):  # posix
    os.register_at_fork(after_in_child=_after_fork_in_child)


class SpanContext(NamedTuple):
    trace_id: str  # 32 hex chars
    span_id: str   # 16 hex chars


def enabled() -> bool:
    return _ENABLED


def set_enabled(on: bool) -> None:
    global _ENABLED
    _ENABLED = bool(on)


def set_trace_dir(path: str) -> None:
    """Point the exit-time auto-dump at `path` (also enables tracing)."""
    global _TRACE_DIR
    _TRACE_DIR = path
    if path:
        set_enabled(True)


def trace_dir() -> str:
    return _TRACE_DIR


def _new_trace_id() -> str:
    return f"{_rng.getrandbits(128):032x}"


def _new_span_id() -> str:
    return f"{_rng.getrandbits(64):016x}"


def _stack() -> list:
    s = getattr(_tls, "stack", None)
    if s is None:
        s = _tls.stack = []
    return s


def current_context() -> Optional[SpanContext]:
    """The active span's context on THIS thread (or an activated remote
    context), else None."""
    s = _stack()
    return s[-1] if s else None


def current_trace_id() -> Optional[str]:
    """The active trace id on this thread (exemplar hook), else None."""
    s = _stack()
    return s[-1].trace_id if s else None


def inject() -> Optional[Dict[str, str]]:
    """Wire header for the current context: ``{"tid": ..., "sid": ...}``
    — small enough to ride in any JSON protocol head.  None when there
    is no active span (callers must omit the field, keeping old peers'
    parsers untouched)."""
    ctx = current_context()
    if ctx is None:
        return None
    return {"tid": ctx.trace_id, "sid": ctx.span_id}


def extract(header) -> Optional[SpanContext]:
    """SpanContext from a wire header produced by inject(); tolerant of
    None / missing / malformed values (old peers)."""
    if not isinstance(header, dict):
        return None
    tid, sid = header.get("tid"), header.get("sid")
    if not (isinstance(tid, str) and isinstance(sid, str) and tid and sid):
        return None
    return SpanContext(tid, sid)


class Span:
    """Mutable handle yielded by span() — attrs set during the block are
    recorded at exit."""

    __slots__ = ("name", "context", "parent_id", "attrs",
                 "_t0", "_wall")

    def __init__(self, name: str, context: SpanContext,
                 parent_id: Optional[str], attrs: dict):
        self.name = name
        self.context = context
        self.parent_id = parent_id
        self.attrs = attrs
        self._wall = time.time()
        self._t0 = time.perf_counter()

    def set_attr(self, key: str, value) -> None:
        self.attrs[key] = value


def add_span_listener(fn) -> None:
    """Register `fn(rec_dict)` to receive every finished span.  While
    any listener is registered, span() is live even when full tracing
    is off — records then flow ONLY to listeners, not the export
    buffer.  Listeners must be cheap and must not raise."""
    if fn not in _listeners:
        _listeners.append(fn)


def remove_span_listener(fn) -> None:
    if fn in _listeners:
        _listeners.remove(fn)


def _record(s: Span, duration: float) -> None:
    global _dropped
    rec = {
        "name": s.name,
        "trace_id": s.context.trace_id,
        "span_id": s.context.span_id,
        "parent_id": s.parent_id,
        "ts": s._wall,
        "dur": duration,
        "pid": os.getpid(),
        "tid": threading.get_ident(),
        "thread": threading.current_thread().name,
        "attrs": dict(s.attrs),
    }
    if _ENABLED:
        with _lock:
            if len(_spans) >= _MAX_SPANS:
                _dropped += 1
            else:
                _spans.append(rec)
    for fn in _listeners:
        fn(rec)


class _NoopCtx:
    """Singleton returned on every disabled span()/activate(): hot paths
    pay one boolean test + a pre-built `with` target, never a generator
    frame (contextlib.contextmanager costs ~µs per entry — too much for
    per-op/per-request sites when tracing is off)."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _NoopCtx()


class _SpanCtx:
    __slots__ = ("_name", "_attrs", "_span")

    def __init__(self, name: str, attrs: dict):
        self._name = name
        self._attrs = attrs

    def __enter__(self) -> Span:
        stack = _stack()
        parent = stack[-1] if stack else None
        ctx = SpanContext(
            parent.trace_id if parent is not None else _new_trace_id(),
            _new_span_id())
        s = Span(self._name, ctx,
                 parent.span_id if parent is not None else None,
                 self._attrs)
        stack.append(ctx)
        self._span = s
        return s

    def __exit__(self, *exc):
        _stack().pop()
        _record(self._span, time.perf_counter() - self._span._t0)
        return False


def span(name: str, **attrs):
    """Open a trace span around the block.  No-op (yields None) when
    tracing is off and no listener is tapped; otherwise the `with`
    target is the Span (set_attr for values known only mid-block)."""
    if not (_ENABLED or _listeners):
        return _NOOP
    return _SpanCtx(name, attrs)


class _ActivateCtx:
    __slots__ = ("_ctx",)

    def __init__(self, ctx: SpanContext):
        self._ctx = ctx

    def __enter__(self):
        _stack().append(self._ctx)
        return self._ctx

    def __exit__(self, *exc):
        _stack().pop()
        return False


def activate(ctx: Optional[SpanContext]):
    """Install `ctx` as this thread's current context WITHOUT recording
    a span — the receiving half of a thread handoff or wire extract.
    `None` is a no-op so call sites need no conditional."""
    if ctx is None or not (_ENABLED or _listeners):
        return _NOOP
    return _ActivateCtx(ctx)


def record_span(name: str, ts: float, dur: float,
                parent: Optional[SpanContext] = None,
                **attrs) -> Optional[SpanContext]:
    """Record an already-timed span WITHOUT touching the thread's
    context stack — for ranges that outlive a `with` frame (e.g. a
    generator-held work window, where an abandoned consumer would leave
    a context-managed span permanently pushed).  `ts` is wall-clock
    seconds (time.time()), `dur` seconds; `parent` parents it into an
    existing trace, else it starts its own.  Returns the recorded
    context (None when tracing is off)."""
    global _dropped
    if not (_ENABLED or _listeners):
        return None
    ctx = SpanContext(
        parent.trace_id if parent is not None else _new_trace_id(),
        _new_span_id())
    rec = {
        "name": name,
        "trace_id": ctx.trace_id,
        "span_id": ctx.span_id,
        "parent_id": parent.span_id if parent is not None else None,
        "ts": ts,
        "dur": dur,
        "pid": os.getpid(),
        "tid": threading.get_ident(),
        "thread": threading.current_thread().name,
        "attrs": dict(attrs),
    }
    if _ENABLED:
        with _lock:
            if len(_spans) >= _MAX_SPANS:
                _dropped += 1
            else:
                _spans.append(rec)
    for fn in _listeners:
        fn(rec)
    return ctx


def finished_spans() -> List[dict]:
    with _lock:
        return list(_spans)


def dropped_spans() -> int:
    with _lock:
        return _dropped


def clear() -> None:
    global _dropped
    with _lock:
        _spans.clear()
        _dropped = 0


# ---------------------------------------------------------------------------
# tail sampling: keep full span trees only for slow or errored traces
# ---------------------------------------------------------------------------


class TailSampler:
    """Span listener that retains complete span trees ONLY for traces
    that breach a latency threshold or carry an error attr — head
    sampling decides before the outcome is known, tail sampling after.

    Buffering is bounded everywhere: at most `max_open` in-progress
    traces (oldest evicted first), at most `max_spans_per_trace` spans
    buffered per trace (extras counted, not stored), at most `max_kept`
    finalized kept traces (oldest dropped).  A trace is MARKED for
    keeping the moment any of its finished spans qualifies (duration >=
    threshold_s, or an `error` attr), and finalized when its root span
    (parent_id None) completes or it is evicted.  Marked traces —
    including still-open ones, e.g. the remote half of a cross-process
    trace whose root lives elsewhere — are flushed to
    ``<dir>/trace_tail_<pid>.json`` (Chrome-trace JSON, same shape as
    the atexit dump) on a debounced cadence, so a live replica's tail
    traces are joinable by the collector without waiting for exit.

    Arm via :func:`arm_tail_sampler` or ``PADDLE_TPU_TAIL_SAMPLE``
    (``on`` or a threshold in seconds; docs/observability.md "Time
    attribution")."""

    def __init__(self, threshold_s: float = 0.25,
                 max_open: int = 256,
                 max_spans_per_trace: int = 512,
                 max_kept: int = 64,
                 out_dir: Optional[str] = None,
                 flush_s: float = 0.5):
        self.threshold_s = float(threshold_s)
        self._max_open = int(max_open)
        self._max_spans = int(max_spans_per_trace)
        self._max_kept = int(max_kept)
        self._dir = out_dir
        self._flush_s = float(flush_s)
        self._lock = threading.Lock()
        # trace_id -> {"spans": [...], "keep": bool, "dropped": int};
        # plain dicts keep insertion (= first-seen) order for eviction
        self._open: Dict[str, dict] = {}
        self._kept: Dict[str, dict] = {}
        self._kept_total = 0
        self._evicted_open = 0
        self._dirty = False
        self._last_flush = 0.0

    # -- listener hot path --------------------------------------------------
    def __call__(self, rec: dict) -> None:
        tid = rec.get("trace_id")
        if not tid:
            return
        qualifies = ((rec.get("dur") or 0.0) >= self.threshold_s
                     or bool(rec.get("attrs", {}).get("error")))
        do_flush = False
        with self._lock:
            buf = self._open.get(tid)
            if buf is None:
                kept = self._kept.get(tid)
                if kept is not None:
                    # straggling span of an already-finalized keeper
                    if len(kept["spans"]) < self._max_spans:
                        kept["spans"].append(rec)
                        self._dirty = True
                    do_flush = self._flush_due_locked()
                else:
                    buf = self._open[tid] = {"spans": [rec],
                                             "keep": qualifies,
                                             "dropped": 0}
                    while len(self._open) > self._max_open:
                        old_tid = next(iter(self._open))
                        old = self._open.pop(old_tid)
                        self._evicted_open += 1
                        if old["keep"]:
                            self._keep_locked(old_tid, old)
            if buf is not None:
                if buf is not self._open.get(tid):
                    pass  # already finalized by eviction above
                elif len(buf["spans"]) < self._max_spans:
                    if buf["spans"][-1] is not rec:
                        buf["spans"].append(rec)
                else:
                    buf["dropped"] += 1
                if qualifies:
                    buf["keep"] = True
                if rec.get("parent_id") is None:
                    # local root completed: the trace's fate is decided
                    self._open.pop(tid, None)
                    if buf["keep"]:
                        self._keep_locked(tid, buf)
                elif buf["keep"]:
                    # cross-process half with a remote root: stream it
                    # out on the debounce so the fleet join sees it
                    self._dirty = True
                do_flush = self._flush_due_locked()
        if do_flush:
            self.flush()

    def _keep_locked(self, tid: str, buf: dict) -> None:
        self._kept[tid] = buf
        self._kept_total += 1
        self._dirty = True
        while len(self._kept) > self._max_kept:
            self._kept.pop(next(iter(self._kept)))

    def _flush_due_locked(self) -> bool:
        return (self._dirty and self._dir is not None
                and time.monotonic() - self._last_flush
                >= self._flush_s)

    # -- introspection / export --------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            return {
                "open_traces": len(self._open),
                "open_spans": sum(len(b["spans"])
                                  for b in self._open.values()),
                "kept_traces": len(self._kept),
                "kept_spans": sum(len(b["spans"])
                                  for b in self._kept.values()),
                "kept_total": self._kept_total,
                "evicted_open": self._evicted_open,
            }

    def kept_trace_ids(self) -> List[str]:
        with self._lock:
            return list(self._kept)

    def _sampled_spans_locked(self) -> List[dict]:
        spans: List[dict] = []
        for buf in self._kept.values():
            spans.extend(buf["spans"])
        for buf in self._open.values():
            if buf["keep"]:
                spans.extend(buf["spans"])
        return spans

    def flush(self, path: Optional[str] = None,
              force: bool = False) -> Optional[str]:
        """Write the sampled traces as Chrome-trace JSON (atomic tmp +
        rename).  Default path ``<out_dir>/trace_tail_<pid>.json`` —
        the ``trace_*`` prefix is what the collector's assemble_traces
        globs, so tail files join the fleet dump like any other
        process dump.  Debounced unless `force`."""
        import json

        with self._lock:
            if path is None and self._dir is None:
                return None
            if not force and not self._dirty:
                return None
            self._dirty = False
            self._last_flush = time.monotonic()
            spans = self._sampled_spans_locked()
        out = path or os.path.join(self._dir,
                                   f"trace_tail_{os.getpid()}.json")
        events = [{
            "ph": "X", "cat": "span", "name": s["name"],
            "ts": s["ts"] * 1e6, "dur": s["dur"] * 1e6,
            "pid": s["pid"], "tid": s["tid"],
            "args": {"trace_id": s["trace_id"],
                     "span_id": s["span_id"],
                     "parent_id": s["parent_id"], **s["attrs"]},
        } for s in spans]
        payload = {"traceEvents": events, "displayTimeUnit": "ms",
                   "otherData": {"producer":
                                 "paddle_tpu.observability.tail",
                                 "threshold_s": self.threshold_s}}
        d = os.path.dirname(out)
        try:
            if d:
                os.makedirs(d, exist_ok=True)
            tmp = f"{out}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(payload, f)
            os.replace(tmp, out)
        except OSError:
            return None  # best-effort, like the flight recorder
        return out


_TAIL: Optional[TailSampler] = None


def arm_tail_sampler(threshold_s: float = 0.25,
                     out_dir: Optional[str] = None,
                     **kw) -> TailSampler:
    """Install the process tail sampler as a span listener (making
    span() live even with full tracing off, like the flight recorder's
    tap).  Re-arming replaces the previous sampler.  `out_dir` defaults
    to the trace dir when one is configured."""
    global _TAIL
    disarm_tail_sampler()
    _TAIL = TailSampler(threshold_s=threshold_s,
                        out_dir=out_dir or (_TRACE_DIR or None), **kw)
    add_span_listener(_TAIL)
    return _TAIL


def disarm_tail_sampler() -> None:
    global _TAIL
    t, _TAIL = _TAIL, None
    if t is not None:
        remove_span_listener(t)
        t.flush(force=True)


def tail_sampler() -> Optional[TailSampler]:
    return _TAIL


def maybe_arm_tail_from_env() -> Optional[TailSampler]:
    """``PADDLE_TPU_TAIL_SAMPLE=on`` arms at the default threshold;
    a numeric value is the threshold in seconds."""
    raw = os.environ.get("PADDLE_TPU_TAIL_SAMPLE", "").strip().lower()
    if not raw:
        return None
    if raw in ("1", "on", "true", "yes"):
        return arm_tail_sampler()
    try:
        return arm_tail_sampler(threshold_s=float(raw))
    except ValueError:
        return None


# ---------------------------------------------------------------------------
# Chrome-trace ("catapult") export — open in chrome://tracing or Perfetto
# ---------------------------------------------------------------------------


def chrome_trace_events(include_profiler: bool = True) -> List[dict]:
    """Finished spans (and, optionally, the profiler's aggregated range
    events) as Chrome-trace event dicts (`ph: "X"`, microsecond ts/dur,
    trace/span ids in args)."""
    events = []
    for s in finished_spans():
        events.append({
            "ph": "X",
            "cat": "span",
            "name": s["name"],
            "ts": s["ts"] * 1e6,
            "dur": s["dur"] * 1e6,
            "pid": s["pid"],
            "tid": s["tid"],
            "args": {
                "trace_id": s["trace_id"],
                "span_id": s["span_id"],
                "parent_id": s["parent_id"],
                **s["attrs"],
            },
        })
    if include_profiler:
        events.extend(_profiler_chrome_events())
    return events


def _profiler_chrome_events() -> List[dict]:
    """The profiler's per-name duration lists as back-to-back events on
    one synthetic track per name.  The profiler stores durations only
    (no wall placement), so these tracks visualize per-event COST
    distribution, not real concurrency — the span tracks carry the
    wall-clock story."""
    from .. import profiler

    events = []
    pid = os.getpid()
    with profiler._events_lock:
        snapshot = {name: list(ts) for name, ts in
                    profiler._events.items()}
    for i, (name, durations) in enumerate(sorted(snapshot.items())):
        tid = 1_000_000 + i
        events.append({
            "ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
            "args": {"name": f"profiler:{name}"},
        })
        ts = 0.0
        for dur in durations:
            events.append({
                "ph": "X", "cat": "profiler", "name": name,
                "ts": ts, "dur": dur * 1e6, "pid": pid, "tid": tid,
            })
            ts += dur * 1e6
    return events


def write_chrome_trace(path: Optional[str] = None,
                       include_profiler: bool = True) -> str:
    """Write `{"traceEvents": [...]}` JSON; default path is
    ``<trace_dir>/trace_<pid>.json``.  Returns the path written."""
    import json

    if path is None:
        if not _TRACE_DIR:
            raise ValueError(
                "no path given and PADDLE_TPU_TRACE_DIR is not set")
        os.makedirs(_TRACE_DIR, exist_ok=True)
        path = os.path.join(_TRACE_DIR, f"trace_{os.getpid()}.json")
    payload = {
        "traceEvents": chrome_trace_events(include_profiler),
        "displayTimeUnit": "ms",
        "otherData": {"producer": "paddle_tpu_torch.observability",
                      "dropped_spans": dropped_spans()},
    }
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(payload, f)
    return path


def _atexit_dump():
    # only when the env asked for it AND something was recorded — an
    # idle import must not litter the trace dir with empty files
    if _TRACE_DIR and finished_spans():
        try:
            write_chrome_trace()
        except OSError:
            pass  # exit-time dump is best-effort (read-only FS, etc.)
    if _TAIL is not None:
        _TAIL.flush(force=True)


atexit.register(_atexit_dump)
maybe_arm_tail_from_env()
