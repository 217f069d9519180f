"""Profiler: named range events with an aggregated summary table, and
the device half on torch.profiler (counterpart of
paddle_tpu/profiler.py).

Reference: paddle/fluid/platform/profiler.{h,cc} (RecordEvent ranges,
EnableProfiler/DisableProfiler -> a table of calls/total/min/max/ave)
and python/paddle/v2/fluid/profiler.py (the `profiler` and
`cuda_profiler` context managers).

Host half: the input pipeline records its stages here (`feed.pack`,
`pipeline.h2d`, `pipeline.wait`, `pipeline.fetch_sync`), the
interpreter one event per op (named by its type), the compiled mode
one per block (`compiled_block`) or device segment (`segment_<i>`);
each is timed after the card is synchronised.  With tracing on, each
range is also a span.

Device half: `xla_profiler` (kept under the JAX package's name, and
`cuda_profiler`) writes a torch.profiler Chrome trace with CPU and CUDA
activity; `profile_compiled_ops` ranks a run's kernels by op in the
reference's calls/total/min/max/ave table; `lowered_ir_text` prints a
block's exported graph with each node's op scope.  While either is on,
every op runs inside its scope "<type>:<first output>" (the JAX
package's `jax.named_scope`; core/execution.py `op_scopes`): a
torch.profiler range, or fx node metadata for an export.  Off, an op
runs with no range at all.

Scopes in a replayed CUDA graph.  A replay runs no Python per op: every
kernel of it correlates to one `cudaGraphLaunch`, so no range can name
its op.  While profiling, each replay runs inside a range naming its
cache entry (core/executor.py `observe_replays`); after the profiled
steps, every graph that was replayed is re-run once eagerly, as its
capture ran it but on copies of its buffers (`_Entry.rerun`: nothing
the graph reads changes), with one range per op.  The replay launches
the same kernels in the same order, so the n-th launch of each kernel
name in a replay takes the scope of the n-th launch of that name in the
re-run (a device copy by its kind: captured, it runs as a `memcpy<N>`
kernel).  A kernel with no counterpart there (a replay launching more
of a name than the re-run) keeps an empty scope, never a guessed one;
so do kernels launched outside any op (a replay's input copies).  A
launch on a thread with no range of its own (the autograd engine's
worker, which runs a generic gradient's backward while the op's thread
waits inside the op's range) takes the range open at its time.
"""
from __future__ import annotations

import contextlib
import json
import os
import re
import shutil
import tempfile
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


# ---------------------------------------------------------------------------
# device half: torch.profiler captures and the per-op kernel table
# ---------------------------------------------------------------------------

# the names of the per-op ranges opened while a capture is on, so the
# trace's digest tells them from any other user range
_scope_names: set = set()
_REPLAY = "graph_replay:"
# {entry key: the cache entry} of the graphs replayed while capturing
_replayed: Dict[int, object] = {}


def _range(name):
    import torch

    _scope_names.add(name)
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def _ranges():
    """Per-op ranges in every eager op run, and a range naming its entry
    around every graph replay (`_replayed` keeps the entries)."""
    import torch

    from .core import executor as _executor
    from .core.execution import op_scopes

    def observe(entry):
        _replayed[id(entry)] = entry
        return torch.profiler.record_function(f"{_REPLAY}{id(entry)}")

    outer = _executor.observe_replays(observe)
    try:
        with op_scopes(_range):
            yield
    finally:
        _executor.observe_replays(outer)


def _activities():
    import torch
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


def _sync():
    import torch

    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def _capture(path):
    """torch.profiler over the block, with per-op ranges, its Chrome
    trace written to `path` at the end (the card synchronised first)."""
    from torch.profiler import profile

    with _ranges():
        with profile(activities=_activities()) as prof:
            yield
            _sync()
    prof.export_chrome_trace(path)


def _trace_events(path):
    with open(path) as f:
        return [e for e in json.load(f).get("traceEvents", [])
                if e.get("ph") == "X"]


@contextlib.contextmanager
def xla_profiler(log_dir: Optional[str] = None):
    """Capture a device trace of the block: torch.profiler with CPU and
    CUDA activity and per-op ranges, written as a Chrome trace
    (`trace.json`, viewable in Perfetto or chrome://tracing) under
    `log_dir` (None = `paddle_tpu_torch_trace` in the temporary
    directory).  Yields `log_dir`, as the JAX package's does; the name
    is kept so its scripts run unchanged."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(),
                                      "paddle_tpu_torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    with _capture(os.path.join(log_dir, "trace.json")):
        yield log_dir


# API-compat alias: reference scripts say cuda_profiler (nvprof there)
@contextlib.contextmanager
def cuda_profiler(output_file=None, output_mode=None, config=None):
    with xla_profiler() as d:
        yield d


_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _scope_map(events) -> Dict:
    """Each host event's op scope -> ({correlation id of a launch: scope,
    or ("replay", entry key) for a launch inside a graph-replay range},
    [(cpu op event, its scope, its self time in us)]).

    The scope is the innermost per-op range around the event on its own
    thread; an event with none there takes the innermost per-op range
    open on any thread at its time.  That is where the autograd engine's
    worker thread launches a generic gradient's backward kernels: the
    op's thread waits inside the op's range meanwhile (an op runs
    synchronously, one at a time)."""
    by_thread: Dict = {}
    for e in events:
        cat = e.get("cat")
        if cat in ("user_annotation", "cpu_op") or cat in _LAUNCH_CATS:
            by_thread.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    launches, cpu_ops, ranges, orphans = {}, [], [], []
    for evs in by_thread.values():
        evs.sort(key=lambda e: (e["ts"], -e.get("dur", 0)))
        stack = []  # [event, end, scope, children's time]
        for e in evs:
            while stack and stack[-1][1] <= e["ts"]:
                _close(stack.pop(), stack, cpu_ops)
            scope = stack[-1][2] if stack else ""
            cat, name = e["cat"], e["name"]
            if cat == "user_annotation":
                if name in _scope_names:
                    scope = name
                    ranges.append((e["ts"], e["ts"] + e.get("dur", 0),
                                   name))
                elif name.startswith(_REPLAY):
                    scope = ("replay", int(name[len(_REPLAY):]))
            elif cat in _LAUNCH_CATS:
                corr = (e.get("args") or {}).get("correlation")
                if corr is not None:
                    launches[corr] = scope
                    if scope == "":
                        orphans.append((e["ts"], corr))
            if stack and cat == "cpu_op" and stack[-1][0]["cat"] == "cpu_op":
                stack[-1][3] += e.get("dur", 0)
            stack.append([e, e["ts"] + e.get("dur", 0), scope, 0.0])
        while stack:
            _close(stack.pop(), stack, cpu_ops)
    found = _open_range_at(ranges, orphans)
    launches.update(found)
    at = _open_range_at(ranges, [(e["ts"], i) for i, (e, sc, _)
                                 in enumerate(cpu_ops) if not sc])
    for i, scope in at.items():
        e, _, self_us = cpu_ops[i]
        cpu_ops[i] = (e, scope, self_us)
    return launches, cpu_ops


def _open_range_at(ranges, queries) -> Dict:
    """{key: the innermost of the nested `ranges` (start, end, scope)
    open at its time} for `queries` [(time, key)], where one is open."""
    ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))
    out, stack, i = {}, [], 0
    for t, key in sorted(queries, key=lambda q: q[0]):
        while i < len(ranges) and ranges[i][0] <= t:
            while stack and stack[-1][1] <= ranges[i][0]:
                stack.pop()
            stack.append(ranges[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        if stack:
            out[key] = stack[-1][2]
    return out


def _close(item, stack, cpu_ops):
    e, _, scope, children = item
    if e["cat"] == "cpu_op":
        cpu_ops.append((e, scope if isinstance(scope, str) else "",
                        e.get("dur", 0) - children))


def _kernels(events):
    """The trace's device activities (kernels, copies, fills), in device
    order."""
    ks = [e for e in events if e.get("cat") in _DEVICE_CATS]
    ks.sort(key=lambda e: e["ts"])
    return ks


# the kernels a captured copy or fill runs as (memcpy32_post, memcpy128)
_GRAPH_COPY = re.compile(r"memcpy\d*(_\w+)?$")
_GRAPH_FILL = re.compile(r"memset\d*(_\w+)?$")


def _align_key(e) -> str:
    """What a replayed activity is matched on: its name, but a device
    copy or fill by its kind (a copy captured into a graph runs as a
    `memcpy<N>` or `memcpy<N>_post` kernel where the eager run shows a
    `Memcpy DtoD`)."""
    name = e["name"]
    if e.get("cat") == "gpu_memcpy" or _GRAPH_COPY.match(name):
        return "memcpy"
    if e.get("cat") == "gpu_memset" or _GRAPH_FILL.match(name):
        return "memset"
    return name


def _sequences(events) -> Dict[str, List[str]]:
    """{alignment key: the scopes of its launches, in launch order} of an
    eager re-run's trace."""
    launches, _ = _scope_map(events)
    seqs: Dict[str, List[str]] = {}
    for k in _kernels(events):
        scope = launches.get((k.get("args") or {}).get("correlation"), "")
        seqs.setdefault(_align_key(k), []).append(
            scope if isinstance(scope, str) else "")
    return seqs


def _attribute(events, reference) -> List:
    """[(kernel name, scope, seconds)] of a trace: a kernel launched
    inside a per-op range takes its scope; a kernel of a graph replay
    takes the scope of the same-numbered launch of its name in its
    entry's re-run (`reference[entry key]`), else ""."""
    launches, _ = _scope_map(events)
    out, nth = [], {}
    for k in _kernels(events):
        corr = (k.get("args") or {}).get("correlation")
        scope = launches.get(corr, "")
        if not isinstance(scope, str):
            key = (corr, _align_key(k))   # one graph launch, one name
            n = nth.get(key, 0)
            nth[key] = n + 1
            seq = reference.get(scope[1], {}).get(key[1], ())
            scope = seq[n] if n < len(seq) else ""
        out.append((k["name"], scope, k.get("dur", 0) / 1e6))
    return out


def profile_compiled_ops(run_fn, steps: int = 3, print_table: bool = True):
    """Per-op device table of `steps` calls of `run_fn` (an Executor run,
    a `program_to_fn` call, in any mode): torch.profiler with per-op
    ranges, digested into the reference's sorted calls/total/min/max/ave
    table (profiler.h:120-146).  On a card a row is a kernel (its device
    time, from CUPTI) under one op scope "<type>:<first output>"; a
    replayed CUDA graph's kernels take their scopes from an eager re-run
    of the graph's plan (see the module docstring), an unattributed
    kernel an empty scope.  With no kernel in the capture (the CPU) a
    row is an aten op's self time under its scope.

    Returns rows [{"name", "scope", "calls", "total", "min", "max",
    "ave"}] sorted by total descending (seconds, like
    profiler_summary)."""
    tmp = tempfile.mkdtemp(prefix="ptt_prof_")
    _replayed.clear()
    try:
        path = os.path.join(tmp, "run.json")
        with _capture(path):
            for _ in range(steps):
                run_fn()
        events = _trace_events(path)
        entries = dict(_replayed)
        _replayed.clear()
        reference = {}
        for key, entry in entries.items():
            ref = os.path.join(tmp, f"rerun_{key}.json")
            inputs = entry.rerun_inputs()   # their copies outside it
            with _capture(ref):
                entry.rerun(inputs)
            del inputs
            reference[key] = _sequences(_trace_events(ref))
        per_op: Dict = {}
        kernels = _attribute(events, reference)
        if kernels:
            for name, scope, sec in kernels:
                per_op.setdefault((name, scope), []).append(sec)
        else:
            for e, scope, self_us in _scope_map(events)[1]:
                if self_us > 0:
                    per_op.setdefault((e["name"], scope), []).append(
                        self_us / 1e6)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rows = [{"name": name, "scope": scope, "calls": len(ts),
             "total": sum(ts), "min": min(ts), "max": max(ts),
             "ave": sum(ts) / len(ts)}
            for (name, scope), ts in per_op.items()]
    rows.sort(key=lambda r: -r["total"])
    if print_table:
        print(format_op_table(rows))
    return rows


def format_op_table(rows, limit: int = 30) -> str:
    out = [f"{'Kernel':<44}{'Scope':<36}{'Calls':>6}{'Total(ms)':>11}"
           f"{'Min(ms)':>9}{'Max(ms)':>9}{'Ave(ms)':>9}"]
    for r in rows[:limit]:
        out.append(
            f"{r['name'][:43]:<44}{r['scope'][-35:]:<36}{r['calls']:>6}"
            f"{r['total'] * 1e3:>11.3f}{r['min'] * 1e3:>9.3f}"
            f"{r['max'] * 1e3:>9.3f}{r['ave'] * 1e3:>9.3f}")
    return "\n".join(out)


# ---------------------------------------------------------------------------
# a block's graph with its op scopes
# ---------------------------------------------------------------------------


def export_program_fn(fn, feeds, states):
    """A `program_to_fn` function exported over (feeds, states) as
    `io.export_aot_model` exports a forward: its resolved plan run
    under torch.export (not strict), each node carrying its op's scope
    in `node.meta["custom"]["scope"]`.  torch.export's default (training)
    IR cannot trace the generic gradient's `torch.autograd.grad`, so a
    block is exported to the ATen IR (`pre_dispatch=False`), where
    gradients are traced through."""
    import torch
    import torch.fx.traceback as fx_traceback
    from torch.export._trace import _export

    from .core.execution import ExecContext, op_scopes

    class _Block(torch.nn.Module):
        def forward(self, feeds, states):
            env = fn._plan.run(ExecContext(fn.device, seed=0),
                               {**states, **feeds}, None, fn._frees)
            return tuple(env[n] for n in fn._outputs)

    def annotate(name):
        return fx_traceback.annotate({"scope": name})

    with fx_traceback.preserve_node_meta(), op_scopes(annotate), \
            torch.no_grad():
        return _export(_Block(), (dict(feeds), dict(states)), strict=False,
                       pre_dispatch=False)


def lowered_ir_text(lowered, feeds=None, states=None) -> str:
    """The text of a block's exported graph, one node a line, each with
    its op scope "<type>:<first output>" (the JAX package's debug-info
    MLIR with named scopes).  `lowered` is a torch.export
    ExportedProgram, or a `program_to_fn` function, exported over
    (`feeds`, `states`) first (`export_program_fn`)."""
    if not hasattr(lowered, "graph_module"):
        lowered = export_program_fn(lowered, feeds, states)
    lines = []
    for node in lowered.graph.nodes:
        scope = (node.meta.get("custom") or {}).get("scope", "")
        lines.append(f"{node.format_node()}  # scope: {scope}" if scope
                     else node.format_node())
    return "\n".join(lines)
