"""Executor: runs a Program's block against a Scope, and the places.

Counterpart of paddle_tpu/core/executor.py.  `CUDAPlace(i)` is a real
CUDA device and the default of every entry point; `CPUPlace()` must be
asked for.  Persistable values (parameters, optimizer state, learning
rates) live in the root scope.  The JAX package's three modes, over the
same op lowerings (core/execution.py):

  * **interpreted** — ops run one by one, eagerly (`run_op`), every
    non-persistable value in a local scope that lives for one run;
  * **compiled** — the whole block is resolved once into a plan (each
    op's lowering, merged attrs, slots and random-stream tag, and the
    states it reads and writes), cached under the key (program
    fingerprint, block, feed and state shapes and dtypes, fetch list,
    device, the run-time flags, the lowering generation).  On the CPU a
    plan runs eagerly.  On a CUDA place the miss runs it eagerly (the
    warm-up a capture needs: kernels built, cuBLAS handles made), the
    first hit captures it into a `torch.cuda.CUDAGraph`, and every later
    hit replays that graph;
  * **segmented** — each maximal run of device ops is a cache entry of
    its own, run like a compiled block; host ops, and on a CUDA place
    ops that draw random numbers (their generators are seeded anew each
    run, which a graph would freeze), run eagerly between them.

`run(compiled=None)` picks the mode as the JAX package does: compiled
for a block without host ops, segmented with them, the interpreter
under `jit_granularity="op"`; an explicit `compiled` wins.
`cache_stats()` counts lookups as the JAX package counts them.
"""
from __future__ import annotations

import itertools
import time
import warnings
import weakref
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from . import registry
from ..observability import metrics as obs_metrics
from ..observability import tracing as obs_tracing
from .execution import (DictEnv, ExecContext, ScopeEnv, _mix,
                        gather_inputs, resolve_op, run_op, scatter_outputs)
from .flags import get_flag
from .framework import EMPTY_VAR_NAMES as _EMPTY
from .framework import Program, Variable, default_main_program
from .scope import Scope, tensor_from_numpy

__all__ = ["CPUPlace", "CUDAPlace", "resolve_place", "Executor",
           "global_scope", "scope_guard", "switch_scope"]


class CPUPlace:
    accelerator = False

    def torch_device(self) -> torch.device:
        return torch.device("cpu")

    def __repr__(self):
        return "CPUPlace"

    def __eq__(self, o):
        return isinstance(o, CPUPlace)

    def __hash__(self):
        return hash("CPUPlace")


class CUDAPlace:
    """One CUDA device; `device_id` indexes torch.cuda devices.
    `torch_device()` raises when the device does not exist — there is no
    silent fallback to the CPU."""

    accelerator = True

    def __init__(self, device_id: int = 0):
        self.device_id = int(device_id)

    def torch_device(self) -> torch.device:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{self!r}: no CUDA device is available — pass "
                "place=CPUPlace() to run on the CPU")
        if self.device_id >= torch.cuda.device_count():
            raise RuntimeError(
                f"{self!r}: only {torch.cuda.device_count()} CUDA "
                "device(s) are visible")
        return torch.device("cuda", self.device_id)

    def __repr__(self):
        return f"CUDAPlace({self.device_id})"

    def __eq__(self, o):
        return isinstance(o, CUDAPlace) and o.device_id == self.device_id

    def __hash__(self):
        return hash(("CUDAPlace", self.device_id))


def resolve_place(place=None) -> torch.device:
    """The torch device of `place`; None means CUDAPlace(0).  A
    `torch.device` passes through."""
    if place is None:
        place = CUDAPlace(0)
    if isinstance(place, torch.device):
        return place
    return place.torch_device()


# ---------------------------------------------------------------------------
# scopes
# ---------------------------------------------------------------------------

_global_scope = Scope()


def global_scope() -> Scope:
    return _global_scope


def switch_scope(scope: Scope) -> Scope:
    """Replace the global scope, returning the previous one."""
    global _global_scope
    prev = _global_scope
    _global_scope = scope
    return prev


class scope_guard:
    """`with scope_guard(scope): ...` — run with a different global
    scope."""

    def __init__(self, scope: Scope):
        self._scope = scope
        self._prev = None

    def __enter__(self):
        self._prev = switch_scope(self._scope)
        return self._scope

    def __exit__(self, *exc):
        switch_scope(self._prev)
        return False


# ---------------------------------------------------------------------------
# Executor
# ---------------------------------------------------------------------------


def _feed_tensor(v):
    """Feed value -> a tensor where it stays (numpy arrays, bf16 ones
    included, and Python scalars on the host, without a copy where numpy
    allows); opaque host objects pass."""
    if isinstance(v, torch.Tensor):
        return v
    if isinstance(v, (np.ndarray, np.generic)):
        return tensor_from_numpy(v)
    if isinstance(v, (bool, int, float)):
        return torch.tensor(v)
    return v


def _to_device_value(v, device):
    """Feed value -> tensor on `device` (opaque host objects pass)."""
    v = _feed_tensor(v)
    return v.to(device) if isinstance(v, torch.Tensor) else v


def _to_numpy(v):
    if isinstance(v, torch.Tensor):
        if v.dtype == torch.bfloat16:
            v = v.float()
        return v.detach().cpu().numpy()
    return v


def _aval(v):
    """The part of a value a cache key holds: shape and dtype."""
    if isinstance(v, torch.Tensor):
        return tuple(v.shape), v.dtype
    return (type(v).__name__,)


def _run_flags():
    """Flags the lowerings read at run time, so part of every cache key:
    amp changes compute dtypes, serving_kernels the CPU's MoE route,
    conv_layout the convolutions' memory format."""
    return (get_flag("amp_bf16"), get_flag("serving_kernels"),
            get_flag("conv_layout"))


def _owns_storage(t) -> bool:
    return (t.is_contiguous() and t.storage_offset() == 0
            and t.untyped_storage().nbytes() == t.numel() * t.element_size())


def _ptr(t) -> int:
    return t.untyped_storage().data_ptr()


class _Plan:
    """A run of ops resolved once (`resolve_op`: what `run_op` looks up
    at every call), with the names the run reads before writing them
    (`reads`), the names it writes (`writes`), the last op reading each
    name, the names each op writes for the last time (`finals`) and the
    program's persistable names (`persistable`)."""

    def __init__(self, ops, persistable=frozenset()):
        self.persistable = persistable
        self.steps, self.reads, self.writes = [], [], []
        self.last_read, last_write = {}, {}
        self.at = None  # index of the op running (capture errors name it)
        self.through_bytes = 0
        written, read = set(), set()
        for i, op in enumerate(ops):
            self.steps.append((op, *resolve_op(op)))
            for n in op.input_names():
                if n in _EMPTY:
                    continue
                self.last_read[n] = i
                if n not in written and n not in read:
                    read.add(n)
                    self.reads.append(n)
            for n in op.output_names():
                if n in _EMPTY:
                    continue
                last_write[n] = i
                if n not in written:
                    written.add(n)
                    self.writes.append(n)
        self.finals = {}
        for n, i in last_write.items():
            self.finals.setdefault(i, []).append(n)

    def write_through(self, bufs, keep):
        """-> an `after` for run() (a capture's): donation, the JAX
        package's in-place state update.  Each new value of a name read
        from a buffer in `bufs` is copied into that buffer right after
        the op that writes the name last, unless a value still live (read
        by a later op, or named in `keep`) shares the buffer's memory: it
        must keep the old value.  The new value's memory is then free for
        the ops after.  A name not copied here is written back at the end
        of the graph (_Entry._write_back)."""
        def after(i, names, env):
            pairs = [(n, bufs[n]) for n in names if n in bufs]
            if pairs:
                live = [m for m, r in self.last_read.items() if r > i]
                self._write_through(env, pairs, live + list(keep))

        return after

    def _write_through(self, env, pairs, live):
        held = {_ptr(env[m]) for m in live
                if isinstance(env.get(m), torch.Tensor)}
        for n, b in pairs:
            v = env.get(n)
            if not (isinstance(v, torch.Tensor) and v.shape == b.shape
                    and v.dtype == b.dtype) or _ptr(b) in held | {_ptr(v)}:
                continue
            b.copy_(v)
            env[n] = b
            self.through_bytes += b.numel() * b.element_size()

    def run(self, ctx, env: Dict, after=None) -> Dict:
        """Run every op against the dict `env`, updated in place;
        `after(i, names, env)` runs after each op i that writes `names`
        for the last time (a state can then be published or donated)."""
        self.at, self.through_bytes = None, 0
        denv = DictEnv()
        denv.d = env    # the dict itself: what the caller holds is the env
        for i, (op, fn, attrs, tag) in enumerate(self.steps):
            self.at = i
            scatter_outputs(op, denv, fn(ctx.child(tag),
                                         gather_inputs(op, env), attrs))
            if after is not None and i in self.finals:
                after(i, self.finals[i], env)
        self.at = None
        return env


class _Entry:
    """One cache entry: a plan and, on a CUDA place after its first hit,
    the CUDA graph it was captured into.  `outputs` names the values a
    graph must keep (fetches, written states, a segment's writes)."""

    def __init__(self, plan: _Plan, outputs):
        self.plan = plan
        self.outputs = list(dict.fromkeys(outputs))
        self.graph = self.bufs = self.outs = None
        self.write_back_bytes = 0

    def capture(self, ctx, vals, where):
        """Capture the plan into a CUDA graph with `vals` as its inputs,
        then replay it once -> (outputs, {name: buffer} of the inputs the
        caller must rebind to the buffer the graph reads)."""
        # state at fixed addresses: the graph reads each input from the
        # tensor it was captured with, one buffer per input, each its
        # own storage (a view or a second name of one tensor is cloned)
        bufs, rebind, seen = {}, {}, set()
        for n, v in vals.items():
            if not isinstance(v, torch.Tensor):
                raise TypeError(f"CUDA graph capture of {where}: input "
                                f"{n!r} is a {type(v).__name__}, not a "
                                "tensor")
            if _ptr(v) in seen or not _owns_storage(v):
                v = rebind[n] = v.clone(memory_format=torch.contiguous_format)
            seen.add(_ptr(v))
            bufs[n] = v
        graph, failed = torch.cuda.CUDAGraph(), []
        try:
            with torch.cuda.graph(graph):
                try:
                    env = self.plan.run(ctx, dict(bufs),
                                        self.plan.write_through(
                                            bufs, self.outputs))
                    outs = {n: env[n] for n in self.outputs if n in env}
                    self.write_back_bytes = (self.plan.through_bytes
                                             + self._write_back(bufs, outs))
                except BaseException as e:
                    failed.append(e)
                    raise
        except Exception as e:
            err = failed[0] if failed else e
            at = self.plan.at
            what = ("the write-back of read-write states" if at is None
                    else f"op #{at} {self.plan.steps[at][0].type!r}")
            raise RuntimeError(f"CUDA graph capture of {where} failed at "
                               f"{what}: {type(err).__name__}: {err}"
                               ) from err
        graph.replay()
        self.graph, self.bufs, self.outs = graph, bufs, outs
        return outs, rebind

    @staticmethod
    def _write_back(bufs, outs) -> int:
        """Read-write values written back into their input buffers inside
        the graph, so the next replay reads them there (the analogue of
        the JAX package's donated states) -> the bytes written back.  Any
        output that shares memory with one of those buffers is copied
        out first: it must keep the value it had before the write-back."""
        names = [n for n, v in outs.items()
                 if n in bufs and v is not bufs[n]
                 and isinstance(v, torch.Tensor)
                 and v.shape == bufs[n].shape and v.dtype == bufs[n].dtype]
        ptrs = {_ptr(bufs[n]) for n in names}
        for n, v in outs.items():
            if isinstance(v, torch.Tensor) and _ptr(v) in ptrs:
                outs[n] = v.clone()
        for n in names:
            bufs[n].copy_(outs[n])
            outs[n] = bufs[n]
        return sum(bufs[n].numel() * bufs[n].element_size() for n in names)

    def replay(self, vals):
        """Copy each input that is not its captured buffer into that
        buffer (feeds always; a state the scope rebound since), then
        replay -> (outputs, {name: buffer} of the inputs copied)."""
        rebind = {}
        for n, v in vals.items():
            b = self.bufs[n]
            if v is b:
                continue
            if v.device.type == "cpu":
                # a host feed goes through pinned memory, asynchronously
                # (the host allocator keeps the block until the copy ran)
                b.copy_(v.pin_memory(), non_blocking=True)
            else:
                b.copy_(v)
            rebind[n] = b
        self.graph.replay()
        return self.outs, rebind

    def free(self):
        if self.graph is not None:
            self.graph.reset()
        self.graph = self.bufs = self.outs = None


_EXE_IDS = itertools.count()
_M_LOOKUPS = obs_metrics.counter(
    "paddle_tpu_executor_cache_lookups_total",
    "executable-cache lookups by result (hit/miss)",
    ("exe", "result"), always=True)
_M_COMPILE_S = obs_metrics.counter(
    "paddle_tpu_executor_compile_seconds_total",
    "wall seconds of first invocations (the miss's eager run; on a CUDA "
    "place also the capture at the first hit)", ("exe",), always=True)
_M_RECOMPILES = obs_metrics.counter(
    "paddle_tpu_executor_recompiles_after_warmup_total",
    "cache misses for a program that already reached steady state",
    ("exe",), always=True)
_M_ENTRIES = obs_metrics.gauge(
    "paddle_tpu_executor_cache_entries",
    "live entries in the cache", ("exe",), always=True)
_M_RUN_SECONDS = obs_metrics.histogram(
    "paddle_tpu_executor_run_seconds",
    "Executor.run wall latency by execution mode", ("exe", "mode"))
_MODES = ("interpreted", "segmented", "compiled")


class Executor:
    """Runs Programs on one place: CUDAPlace(0) unless told otherwise,
    raising at construction when that device does not exist."""

    def __init__(self, place=None, seed: int = 0):
        self.place = CUDAPlace(0) if place is None else place
        self.device = resolve_place(self.place)
        self._seed = seed
        self._step = 0
        self._cache: Dict = {}
        # weakref-keyed, as the JAX package's: program -> (version, fp)
        self._fp_cache = weakref.WeakKeyDictionary()
        self._segs: Dict = {}       # a block's (is_host, ops, plan) runs
        self._exe_id = str(next(_EXE_IDS))
        self._m_hits = _M_LOOKUPS.labels(exe=self._exe_id, result="hit")
        self._m_misses = _M_LOOKUPS.labels(exe=self._exe_id,
                                           result="miss")
        self._m_compile_s = _M_COMPILE_S.labels(exe=self._exe_id)
        self._m_recompiles = _M_RECOMPILES.labels(exe=self._exe_id)
        self._m_entries = _M_ENTRIES.labels(exe=self._exe_id)
        self._warm_fps: set = set()
        self._graph_stats = {"captures": 0, "replays": 0, "capture_s": 0.0,
                             "write_back_bytes": 0}

    def cache_stats(self) -> Dict:
        """The cache's telemetry, with the JAX package's keys: `hits` and
        `misses` (lookups across compiled and segmented modes),
        `compile_s` (the misses' eager runs and, on a CUDA place, the
        captures), `entries` (live entries) and `recompiles_after_warmup`
        (misses for a program that already had a hit: a feed shape or a
        run-time flag changing on the hot path; the `log_recompiles` flag
        also warns at each)."""
        return {"hits": int(self._m_hits.value),
                "misses": int(self._m_misses.value),
                "compile_s": self._m_compile_s.value,
                "recompiles_after_warmup": int(self._m_recompiles.value),
                "entries": len(self._cache)}

    def graph_stats(self) -> Dict:
        """CUDA graphs: `captures`, `replays` (hits that only replayed),
        `capture_s` (seconds in captures, their first replay included),
        `write_back_bytes` (read-write state bytes the captured graphs
        copy back into their buffers, a replay of each) and `graphs`
        (live)."""
        return {**self._graph_stats,
                "graphs": sum(e.graph is not None
                              for e in self._cache.values())}

    def _note_lookup(self, hit: bool, fp, cache_key, once=None) -> None:
        """`once`: a per-run set, so a segmented run counts at most one
        recompile however many segments miss."""
        if hit:
            self._m_hits.inc()
            self._warm_fps.add(fp)
            return
        self._m_misses.inc()
        if fp in self._warm_fps and (once is None or fp not in once):
            if once is not None:
                once.add(fp)
            self._m_recompiles.inc()
            if get_flag("log_recompiles"):
                warnings.warn(
                    "Executor recompile after warmup: program fingerprint "
                    f"{fp[:12]}… missed the cache with key {cache_key!r} — "
                    "a feed shape/dtype or a run-time flag changed on the "
                    "hot path", RuntimeWarning, stacklevel=5)

    def run(self, program: Optional[Program] = None,
            feed: Optional[Dict] = None,
            fetch_list: Optional[Sequence] = None,
            scope: Optional[Scope] = None, return_numpy: bool = True,
            compiled: Optional[bool] = None):
        """Execute block 0 of `program` with `feed`, returning the
        values of `fetch_list` (numpy arrays unless return_numpy=False).
        Random ops draw from a stream keyed by (program seed or the
        executor's seed, run index, op identity), in every mode."""
        program = program or default_main_program()
        scope = scope or global_scope()
        feed = feed or {}
        fetch_names = [v.name if isinstance(v, Variable) else str(v)
                       for v in (fetch_list or [])]
        block = program.global_block()
        fp = self._fingerprint(program)
        # the JAX package's choice: 'block' = a compiled block when no
        # op is host, segments otherwise; 'segment' = segments even then;
        # 'op' = the interpreter.  An explicit `compiled` wins.
        gran = str(get_flag("jit_granularity") or "block").lower()
        if compiled is False or (compiled is None and gran == "op"):
            mode, segs = "interpreted", None
        else:
            segs = self._segments(block, fp)
            host = any(h for h, _, _ in segs)
            mode = "segmented" if host or gran == "segment" else "compiled"
        seed = _mix(program.seed or self._seed, self._step)
        self._step += 1
        t0 = time.perf_counter()
        with obs_tracing.span("executor.run", mode=mode):
            if mode == "compiled":
                # no host op: one device segment, the whole block
                plan = segs[0][2] if segs else _Plan([])
                outs = self._run_compiled(block, fp, plan, scope, feed,
                                          fetch_names, seed)
            elif mode == "segmented":
                outs = self._run_segmented(program, fp, segs, scope, feed,
                                           fetch_names, seed)
            else:
                outs = self._run_interpreted(program, scope, feed,
                                             fetch_names, seed)
        if obs_metrics.enabled():
            _M_RUN_SECONDS.labels(exe=self._exe_id, mode=mode).observe(
                time.perf_counter() - t0)
        if return_numpy:
            outs = [_to_numpy(v) for v in outs]
        return outs

    def close(self):
        """Free every CUDA graph and its memory pool, empty the cache and
        the resolved plans, and drop this instance's registry series
        (cache_stats() keeps reading the held children)."""
        graphs = any(e.graph is not None for e in self._cache.values())
        for e in self._cache.values():
            e.free()
        self._cache.clear()
        self._segs.clear()
        self._m_entries.set(0)
        if graphs:
            torch.cuda.empty_cache()
        _M_LOOKUPS.remove(exe=self._exe_id, result="hit")
        _M_LOOKUPS.remove(exe=self._exe_id, result="miss")
        for fam in (_M_COMPILE_S, _M_RECOMPILES, _M_ENTRIES):
            fam.remove(exe=self._exe_id)
        for mode in _MODES:
            _M_RUN_SECONDS.remove(exe=self._exe_id, mode=mode)

    # -- shared by the modes -------------------------------------------------
    def _fingerprint(self, program) -> str:
        ent = self._fp_cache.get(program)
        if ent is not None and ent[0] == program._version:
            return ent[1]
        fp = program.fingerprint()
        self._fp_cache[program] = (program._version, fp)
        return fp

    def _scope_env(self, program, scope, local):
        """ScopeEnv routing persistable writes to the root scope and
        every other write to the run's local scope."""
        persistable = {v.name for v in program.list_vars() if v.persistable}
        root = scope
        while root.parent is not None:
            root = root.parent

        class _Env(ScopeEnv):
            def get(self, name):
                v = super().get(name)
                if v is None and name in persistable \
                        and name not in self.written:
                    raise RuntimeError(
                        f"persistable variable {name!r} has no value in "
                        "scope — run the startup program first")
                return v

            def set(self, name, value):
                if name in persistable:
                    root.set_var(name, value)
                else:
                    self.scope.set_var(name, value, local=True)
                self.written.add(name)

        return _Env(local)

    @staticmethod
    def _fetch(env, fetch_names):
        missing = [n for n in fetch_names if not env.has(n)]
        if missing:
            raise KeyError(
                f"fetch variable(s) {missing} were never produced by "
                "the program")
        return [env.get(n) for n in fetch_names]

    def _lookup(self, key, fp, make, once=None):
        """-> (entry, miss): the cache entry for `key`, made by `make()`
        on a miss."""
        entry = self._cache.get(key)
        miss = entry is None
        self._note_lookup(not miss, fp, key, once)
        if miss:
            entry = self._cache[key] = make()
            self._m_entries.set(len(self._cache))
        return entry, miss

    def _run_entry(self, entry, miss, vals, seed, where, publish):
        """Run a cache entry: eagerly on a miss or on the CPU (`vals`
        becoming its env, `publish` storing each value it writes for the
        last time, so an old state's memory goes as the interpreter's
        does); on a CUDA place captured at the first hit, replayed after
        -> (outputs, {name: buffer} to rebind)."""
        ctx = ExecContext(self.device, seed=seed)
        t0 = time.perf_counter()
        if miss or self.device.type != "cuda":
            for n, v in vals.items():
                vals[n] = _to_device_value(v, self.device)
            with torch.no_grad():
                out = entry.plan.run(ctx, vals, publish), {}
        elif entry.graph is None:
            with torch.no_grad():
                out = entry.capture(ctx, {n: _to_device_value(v, self.device)
                                          for n, v in vals.items()}, where)
            dt = time.perf_counter() - t0
            self._graph_stats["captures"] += 1
            self._graph_stats["capture_s"] += dt
            self._graph_stats["write_back_bytes"] += entry.write_back_bytes
            self._m_compile_s.inc(dt)
            return out
        else:
            self._graph_stats["replays"] += 1
            return entry.replay(vals)
        if miss:
            self._m_compile_s.inc(time.perf_counter() - t0)
        return out

    @staticmethod
    def _copied_out(graphed, values):
        """A graph's outputs are overwritten by its next replay: fetches
        are cloned out of its pool."""
        if not graphed:
            return values
        return [v.clone() if isinstance(v, torch.Tensor) else v
                for v in values]

    # -- interpreter ---------------------------------------------------------
    def _run_interpreted(self, program, scope, feed, fetch_names, seed):
        local = scope.new_scope()
        try:  # finally: a raising op must not leak the local scope
            env = self._scope_env(program, scope, local)
            with torch.no_grad():
                for name, v in feed.items():
                    env.set(name, _to_device_value(v, self.device))
                ctx = ExecContext(self.device, seed=seed)
                for op in program.global_block().ops:
                    run_op(ctx, op, env)
                return self._fetch(env, fetch_names)
        finally:
            scope.kids.remove(local)

    # -- segmented: cached device segments between eager host ops -----------
    def _op_is_host(self, op) -> bool:
        try:
            info = registry.get_op_info(op.type)
        except KeyError:
            return True
        if info.host or op.attrs.get("force_cpu"):
            return True
        if info.random and self.device.type == "cuda":
            # the op's generator is seeded from (seed, run, op): a graph
            # would replay the captured draws every run
            return True
        sub = op.sub_block() if "sub_block" in op.attrs else None
        return sub is not None and any(self._op_is_host(o) for o in sub.ops)

    def _segments(self, block, fp):
        """Maximal (is_host, ops, plan) runs of the block's ops; a device
        run's plan is resolved here, once per program version and
        lowering generation."""
        key = (fp, block.idx, registry.lowering_generation())
        segs = self._segs.get(key)
        if segs is None:
            segs = []
            for op in block.ops:
                h = self._op_is_host(op)
                if segs and segs[-1][0] == h:
                    segs[-1][1].append(op)
                else:
                    segs.append((h, [op]))
            persistable = frozenset(v.name for v in block.program.list_vars()
                                    if v.persistable)
            segs = self._segs[key] = [
                (h, ops, None if h else _Plan(ops, persistable))
                for h, ops in segs]
        return segs

    def _run_segmented(self, program, fp, segs, scope, feed, fetch_names,
                       seed):
        local = scope.new_scope()
        try:  # finally: a raising op must not leak the local scope
            env = self._scope_env(program, scope, local)
            with torch.no_grad():
                for name, v in feed.items():
                    env.set(name, _to_device_value(v, self.device))
                ctx = ExecContext(self.device, seed=seed)
                once, graphed = set(), False  # one recompile count a run
                for i, (host, ops, plan) in enumerate(segs):
                    if host:
                        for op in ops:
                            run_op(ctx, op, env)
                    else:
                        graphed |= self._run_segment(fp, i, plan, env, seed,
                                                     once)
                return self._copied_out(graphed,
                                        self._fetch(env, fetch_names))
        finally:
            scope.kids.remove(local)

    def _run_segment(self, fp, seg_idx, plan, env, seed, once) -> bool:
        """One device segment through the cache -> whether it ran as a
        CUDA graph (fetches must then be copied out)."""
        vals = {}
        for n in plan.reads:
            v = env.get(n)   # raises for a persistable with no value
            if v is not None:
                vals[n] = v
        key = (fp, "seg", seg_idx,
               tuple((n, _aval(v)) for n, v in sorted(vals.items())),
               *_run_flags(), registry.lowering_generation())
        entry, miss = self._lookup(key, fp,
                                   lambda: _Entry(plan, plan.writes), once)

        def publish(i, names, seg_env):
            for n in names:
                env.set(n, seg_env[n])

        outs, rebind = self._run_entry(entry, miss, vals, seed,
                                       f"segment {seg_idx}", publish)
        for n in plan.writes:
            if n in outs:
                env.set(n, outs[n])
        for n, b in rebind.items():
            if n not in outs:
                env.set(n, b)
        return entry.graph is not None

    # -- compiled ------------------------------------------------------------
    @staticmethod
    def _states(plan, feeds, fetch_names):
        """-> (states the block reads before writing them, states it
        writes), from its plan: the persistables among the plan's reads
        that are not fed, and among its writes; a fetched persistable no
        op touches is read, as the interpreter reads it."""
        persistable = plan.persistable
        reads = [n for n in plan.reads if n in persistable and n not in feeds]
        writes = [n for n in plan.writes if n in persistable]
        touched = set(plan.reads) | set(plan.writes)
        reads += [n for n in dict.fromkeys(fetch_names)
                  if n in persistable and n not in feeds
                  and n not in touched]
        return reads, writes

    @staticmethod
    def _read_states(scope, names):
        """{name: the scope's value} of the states a block reads."""
        states = {}
        for n in names:
            v = scope.find_var(n) if scope.has_var(n) else None
            if v is None:
                raise RuntimeError(
                    f"persistable variable {n!r} has no value in scope — "
                    "run the startup program first")
            states[n] = v
        return states

    def _compiled_key(self, fp, block, feeds, states, fetch_names):
        return (fp, block.idx,
                tuple(sorted((n, _aval(v)) for n, v in feeds.items())),
                tuple((n, _aval(v)) for n, v in states.items()),
                tuple(fetch_names), str(self.device), *_run_flags(),
                registry.lowering_generation())

    def _run_compiled(self, block, fp, plan, scope, feed, fetch_names,
                      seed):
        feeds = {n: _feed_tensor(v) for n, v in feed.items()}
        reads, writes = self._states(plan, feeds, fetch_names)
        vals = self._read_states(scope, reads)
        key = self._compiled_key(fp, block, feeds, vals, fetch_names)
        vals.update(feeds)
        entry, miss = self._lookup(
            key, fp, lambda: _Entry(plan, fetch_names + writes))
        states = set(writes)

        def publish(i, names, env):
            for n in names:
                if n in states:
                    scope.set_var(n, env[n])

        outs, rebind = self._run_entry(entry, miss, vals, seed,
                                       "the compiled block", publish)
        for n in writes:
            if n in outs:
                scope.set_var(n, outs[n])
        for n, b in rebind.items():
            if n in reads and n not in states:
                scope.set_var(n, b)
        missing = [n for n in fetch_names if n not in outs]
        if missing:
            raise KeyError(
                f"fetch variable(s) {missing} were never produced by "
                "the program")
        return self._copied_out(entry.graph is not None,
                                [outs[n] for n in fetch_names])
