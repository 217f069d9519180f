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

A LoDTensor feed is placed as its data with its LoD kept; the LoD is
part of every cache key (compiled blocks and device segments alike), so
each distinct LoD is an entry of its own (a miss, then a capture at its
first hit, replays after), and a CUDA graph reads the LoDTensor's data
from a buffer as it reads any tensor.  An entry owns what its plan
builds on the host (the sequence ops' index tables: `ExecContext.tables`)
from its eager first run on, so its capture copies nothing from the
host, and the tables go with the entry.  The cache holds at most
CACHE_MAX entries (a block's device segments each take one), the least
recently used going first with its graph and tables.  At most
GRAPHS_MAX graphs are live: a capture never frees another entry's
graph, so once GRAPHS_MAX are live a hit of an entry without one runs
its plan eagerly, as at its miss (`graph_stats()["eager_hits"]`),
until an entry holding a graph leaves the cache.  So more recurring
LoDs than GRAPHS_MAX never recapture on every hit, and a stream of new
LoDs grows neither without end.  A fetched LoDTensor comes back as a
LoDTensor with numpy data.
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
                        current_op_scopes, gather_inputs, op_context,
                        op_scope_name, resolve_op, run_op, scatter_outputs)
from .flags import get_flag
from .framework import EMPTY_VAR_NAMES as _EMPTY
from .framework import Program, Variable, default_main_program
from .lod import LoDTensor, SelectedRows, TensorArray
from .scope import Scope, tensor_from_numpy

__all__ = ["CPUPlace", "CUDAPlace", "resolve_place", "Executor",
           "global_scope", "scope_guard", "switch_scope", "program_to_fn"]


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


# cache entries an Executor keeps (least recently used evicted first),
# and of them the entries that may hold a captured CUDA graph (first
# come: a graph goes only with its entry)
CACHE_MAX, GRAPHS_MAX = 1024, 32


def _feed_tensor(v):
    """Feed value -> a tensor where it stays (numpy arrays, bf16 ones
    included, and Python scalars on the host, without a copy where numpy
    allows; a LoDTensor's data, its LoD kept); opaque host objects
    pass."""
    if isinstance(v, LoDTensor):
        return v.map(_feed_tensor)
    if isinstance(v, torch.Tensor):
        return v
    if isinstance(v, (np.ndarray, np.generic)):
        return tensor_from_numpy(v)
    if isinstance(v, (bool, int, float)):
        return torch.tensor(v)
    return v


def _to_device_value(v, device):
    """Feed value -> tensor on `device` (a LoDTensor's data; opaque host
    objects pass)."""
    v = _feed_tensor(v)
    if isinstance(v, LoDTensor):
        return v.map(lambda d: d.to(device))
    return v.to(device) if isinstance(v, torch.Tensor) else v


def _to_numpy(v):
    """A fetched value on the host: a tensor as a numpy array, a
    SelectedRows as one with numpy rows and values, a LoDTensor as one
    with numpy data, a TensorArray as one of such values."""
    if isinstance(v, (SelectedRows, LoDTensor)):
        return v.map(_to_numpy)
    if isinstance(v, TensorArray):
        return TensorArray([_to_numpy(t) for t in v.tensors])
    if isinstance(v, torch.Tensor):
        if v.dtype == torch.bfloat16:
            v = v.float()
        return v.detach().cpu().numpy()
    return v


def _aval(v):
    """The part of a value a cache key holds: shape and dtype (a
    SelectedRows': its rows' and values' shapes and its height; a
    LoDTensor's: its data's and its LoD)."""
    if isinstance(v, torch.Tensor):
        return tuple(v.shape), v.dtype
    if isinstance(v, LoDTensor):
        return ("LoDTensor", tuple(v.data.shape), v.data.dtype, v.lod)
    if isinstance(v, SelectedRows):
        return ("SelectedRows", tuple(v.rows.shape), tuple(v.value.shape),
                v.value.dtype, v.height)
    return (type(v).__name__,)


def _tensors(v):
    """The tensors a value holds: itself, a LoDTensor's data, or a
    SelectedRows' two."""
    if isinstance(v, torch.Tensor):
        return (v,)
    if isinstance(v, LoDTensor):
        return (v.data,)
    if isinstance(v, SelectedRows):
        return (v.rows, v.value)
    return ()


def _run_flags():
    """Flags the lowerings read at run time, so part of every cache key:
    amp changes compute dtypes, serving_kernels the CPU's MoE route,
    conv_layout the convolutions' memory format."""
    return (get_flag("amp_bf16"), get_flag("serving_kernels"),
            get_flag("conv_layout"))


def _clone(v):
    if isinstance(v, torch.Tensor):
        return v.clone()
    if isinstance(v, (SelectedRows, LoDTensor)):
        return v.map(torch.clone)
    return v


def _data(v):
    """A value's tensor and its LoD (None for a plain tensor)."""
    if isinstance(v, LoDTensor):
        return v.data, v.lod
    return v, None


def _rewrap(t, lod):
    return t if lod is None else LoDTensor(t, lod)


def _owns_storage(t) -> bool:
    return (t.is_contiguous() and t.storage_offset() == 0
            and t.untyped_storage().nbytes() == t.numel() * t.element_size())


def _ptr(t) -> int:
    return t.untyped_storage().data_ptr()


def _sub_names(program) -> frozenset:
    """Every name a sub-block of `program` references."""
    from ..memory_optimization_transpiler import _sub_block_names

    return frozenset(_sub_block_names(program))


def _bounded_put(cache: Dict, key, value, cap: int = 256):
    """Insert into a plan cache, dropping the oldest entry past `cap`."""
    if key not in cache and len(cache) >= cap:
        cache.pop(next(iter(cache)))
    cache[key] = value


class _Plan:
    """A run of ops resolved once (`resolve_op`: what `run_op` looks up
    at every call), with the names the run reads before writing them
    (`reads`), the names it writes (`writes`), the last op reading each
    name, the names each op writes for the last time (`finals`), the
    program's persistable names (`persistable`) and the names its
    sub-blocks reference (`sub_names`: a sub-block op reads them through
    its context's env, so they are never dropped early)."""

    def __init__(self, ops, persistable=frozenset(), sub_names=frozenset()):
        self.persistable = persistable
        self.sub_names = sub_names
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

    def dead_after(self, keep) -> Dict[int, list]:
        """{op index: names} a run may drop right after that op: each
        name at the last op that reads or writes it, unless it is in
        `keep` (the values the run hands back), persistable (a state),
        or referenced by a sub-block.  The compiled mode's counterpart
        of XLA reusing a dead buffer inside a compiled block: inside a
        CUDA-graph capture the dropped memory goes back to the graph's
        pool, and later ops of the same capture reuse it."""
        from ..memory_optimization_transpiler import dead_frees

        return dead_frees([s[0] for s in self.steps],
                          set(keep) | self.persistable | self.sub_names)

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
        held = {_ptr(t) for m in live for t in _tensors(env.get(m))}
        for n, b in pairs:
            v = env.get(n)
            if not (isinstance(v, torch.Tensor) and v.shape == b.shape
                    and v.dtype == b.dtype) or _ptr(b) in held | {_ptr(v)}:
                continue
            b.copy_(v)
            env[n] = b
            self.through_bytes += b.numel() * b.element_size()

    def run(self, ctx, env: Dict, after=None, frees=None) -> Dict:
        """Run every op against the dict `env`, updated in place;
        `after(i, names, env)` runs after each op i that writes `names`
        for the last time (a state can then be published or donated);
        then the names `frees[i]` (`dead_after`) leave `env`."""
        self.at, self.through_bytes = None, 0
        denv = DictEnv()
        denv.d = env    # the dict itself: what the caller holds is the env
        frees = frees or {}
        scopes = current_op_scopes()
        for i, step in enumerate(self.steps):
            self.at = i
            if scopes is None:
                self._step(ctx, denv, i, step, after, frees)
            else:   # the op's write-through copies inside its scope too
                with scopes(op_scope_name(step[0])):
                    self._step(ctx, denv, i, step, after, frees)
        self.at = None
        return env

    def _step(self, ctx, denv, i, step, after, frees):
        op, fn, attrs, tag = step
        env = denv.d
        scatter_outputs(op, denv, fn(op_context(ctx, op, denv, tag),
                                     gather_inputs(op, env), attrs))
        if after is not None and i in self.finals:
            after(i, self.finals[i], env)
        for n in frees.get(i, ()):
            env.pop(n, None)


def _op_is_host(op, device) -> bool:
    """Whether `op` runs eagerly between device segments: a host op
    (`while`, `conditional_block`, the tensor-array and beam-search
    ops), an op placed on the CPU, a random op on a card, or an op with
    any such op in its sub-block, at any depth of nesting (a
    `dynamic_rnn` or `recompute` whose block holds a `print` or, on a
    card, a dropout)."""
    try:
        info = registry.get_op_info(op.type)
    except KeyError:
        return True
    if info.host or op.attrs.get("force_cpu"):
        return True
    if info.random and device.type == "cuda":
        # the op's generator is seeded from (seed, run, op): a graph
        # would replay the captured draws every run
        return True
    sub = op.sub_block() if "sub_block" in op.attrs else None
    return sub is not None and any(_op_is_host(o, device) for o in sub.ops)


def _input_buffers(vals, where):
    """A capture's inputs at fixed addresses: the graph reads each from
    the tensor it was captured with, one buffer per input, each its own
    storage (a view or a second name of one tensor is cloned).  A
    LoDTensor's buffer is its data, its LoD fixed by the cache key; a
    SelectedRows (a sparse gradient crossing a host op between segments)
    is two buffers, its rows and its values, their shapes fixed by the
    key -> ({name: buffer}, {name: LoD}, {name: SelectedRows of
    buffers}, {name: value} the caller must rebind)."""
    bufs, rebind, seen, lods, sparse = {}, {}, set(), {}, {}

    def own(t):
        if _ptr(t) in seen or not _owns_storage(t):
            t = t.clone(memory_format=torch.contiguous_format)
        seen.add(_ptr(t))
        return t

    for n, v in vals.items():
        if isinstance(v, SelectedRows):
            sr = SelectedRows(own(v.rows), own(v.value), v.height)
            sparse[n] = sr
            if sr.rows is not v.rows or sr.value is not v.value:
                rebind[n] = sr
            continue
        t, lods[n] = _data(v)
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"CUDA graph capture of {where}: input {n!r} "
                            f"is a {type(t).__name__}, not a tensor")
        bufs[n] = own(t)
        if bufs[n] is not t:
            rebind[n] = _rewrap(bufs[n], lods[n])
    return bufs, lods, sparse, rebind


def _copy_in(dst, src):
    if src.device.type == "cpu" and dst.device.type != "cpu":
        # a host feed goes through pinned memory, asynchronously (the
        # host allocator keeps the block until the copy ran)
        dst.copy_(src.pin_memory(), non_blocking=True)
    else:
        dst.copy_(src)


def _copy_inputs(vals, bufs, lods, sparse):
    """A replay's inputs copied into the captured buffers where they are
    not those buffers already -> {name: value} to rebind."""
    rebind = {}
    for n, v in vals.items():
        if n in sparse:
            sr = sparse[n]
            if v.rows is not sr.rows or v.value is not sr.value:
                _copy_in(sr.rows, v.rows)
                _copy_in(sr.value, v.value)
                rebind[n] = sr
            continue
        b = bufs[n]
        v = _data(v)[0]
        if v is b:
            continue
        _copy_in(b, v)
        rebind[n] = _rewrap(b, lods[n])
    return rebind


class _Entry:
    """One cache entry: a plan, the host-built tables its runs read
    (`tables`, the ExecContext's: built at the miss, read by the
    capture) and, on a CUDA place after its first hit, the CUDA graph
    it was captured into.  `outputs` names the values a graph must keep
    (fetches, written states, a segment's writes); every other value a
    run drops after its last reader (`frees`: _Plan.dead_after)."""

    def __init__(self, plan: _Plan, outputs):
        self.plan = plan
        self.outputs = list(dict.fromkeys(outputs))
        self.frees = plan.dead_after(self.outputs)
        self.tables = {}
        self.graph = self.bufs = self.outs = self.lods = self.sparse = None
        self.donate = True
        self.write_back_bytes = 0

    def capture(self, ctx, vals, where, donate=True):
        """Capture the plan into a CUDA graph with `vals` as its inputs,
        then replay it once -> (outputs, {name: buffer} of the inputs the
        caller must rebind to the buffer the graph reads).  With
        `donate=False` the graph writes no input buffer (no state is
        copied back into the buffer it was read from)."""
        bufs, lods, sparse, rebind = _input_buffers(vals, where)
        graph, failed = torch.cuda.CUDAGraph(), []
        try:
            with torch.cuda.graph(graph):
                try:
                    env = self.plan.run(
                        ctx, {**{n: _rewrap(b, lods[n])
                                 for n, b in bufs.items()}, **sparse},
                        self.plan.write_through(bufs, self.outputs)
                        if donate else None, self.frees)
                    outs = {n: env[n] for n in self.outputs if n in env}
                    self.write_back_bytes = (
                        self.plan.through_bytes
                        + self._write_back(bufs, outs)) if donate else 0
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
        self.graph, self.bufs, self.outs, self.lods = graph, bufs, outs, lods
        self.sparse, self.donate = sparse, donate
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
            if any(_ptr(t) in ptrs for t in _tensors(v)):
                outs[n] = _clone(v)
        for n in names:
            bufs[n].copy_(outs[n])
            outs[n] = bufs[n]
        return sum(bufs[n].numel() * bufs[n].element_size() for n in names)

    def replay(self, vals):
        """Copy each input that is not its captured buffer into that
        buffer (feeds always; a state the scope rebound since), then
        replay -> (outputs, {name: buffer} of the inputs copied)."""
        rebind = _copy_inputs(vals, self.bufs, self.lods, self.sparse)
        if _replay_observer is None:
            self.graph.replay()
        else:
            with _replay_observer(self):
                self.graph.replay()
        return self.outs, rebind

    def rerun_inputs(self):
        """Copies of the graph's input buffers, for `rerun`."""
        return ({n: b.clone() for n, b in self.bufs.items()},
                {n: sr.map(torch.clone) for n, sr in self.sparse.items()})

    def rerun(self, inputs):
        """Run the captured plan eagerly as its capture ran it (the same
        write-through and write-back) on `inputs` (`rerun_inputs()`): the
        kernels every replay launches, in their order, with per-op scopes
        when they are on (the profiler's device half attributes a
        replay's kernels by it).  Nothing the graph reads or writes
        changes."""
        bufs, sparse = inputs
        env = {**{n: _rewrap(b, self.lods[n]) for n, b in bufs.items()},
               **sparse}
        device = next(iter(bufs.values())).device if bufs else None
        ctx = ExecContext(device, seed=0, tables=self.tables)
        with torch.no_grad():
            env = self.plan.run(
                ctx, env, self.plan.write_through(bufs, self.outputs)
                if self.donate else None, self.frees)
            if self.donate:
                self._write_back(bufs, {n: env[n] for n in self.outputs
                                        if n in env})

    def free(self):
        if self.graph is not None:
            self.graph.reset()
        self.graph = self.bufs = self.outs = self.lods = self.sparse = None


# None, or while the profiler's device half is on, a callable(entry) ->
# a context manager each replay of `entry`'s graph runs inside
_replay_observer = None


def observe_replays(observer):
    """Install `observer` (or None) for every replay -> the one it
    replaces."""
    global _replay_observer
    outer, _replay_observer = _replay_observer, observer
    return outer


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
        # the memory layer's cached plans (memory_optimization_transpiler):
        # the rename pass's clones, the dead-value frees and the donation
        # checks, each per (program, feeds, fetches)
        self._memopt_cache: Dict = {}
        self._free_plans: Dict = {}
        self._donation_plans: Dict = {}
        self._graph_stats = {"captures": 0, "replays": 0, "eager_hits": 0,
                             "capture_s": 0.0, "write_back_bytes": 0}

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
        `eager_hits` (hits run eagerly: GRAPHS_MAX graphs were live),
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
        # static pre-flight (PADDLE_TPU_VERIFY=warn|error, default off —
        # preflight gates internally): a bad graph fails here, before
        # any op runs; cached per (program, version) so steady-state
        # loops pay one flag read + dict probe
        from ..analysis import preflight

        preflight(program, feed_names=feed.keys(),
                  fetch_names=fetch_names)
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
        if any(getattr(block.vars.get(n), "donate", False) for n in feed):
            # an unsafe donate=True hint fails here, in every mode,
            # before any op runs
            self._donation_plan(program, fp, feed.keys(), fetch_names)
        memopt = bool(get_flag("memory_optimize")) and mode != "compiled"
        if memopt:
            # the rename pass on a cached clone (the caller's Program is
            # never changed), the current feeds and fetches skipped
            program = self._memopt_program(program, fp, feed.keys(),
                                           fetch_names)
            block = program.global_block()
            fp = self._fingerprint(program)
            if segs is not None:
                segs = self._segments(block, fp)
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
                                           fetch_names, seed, memopt)
            else:
                outs = self._run_interpreted(program, fp, scope, feed,
                                             fetch_names, seed, memopt)
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
        for plans in (self._memopt_cache, self._free_plans,
                      self._donation_plans):
            plans.clear()
        self._m_entries.set(0)
        if graphs:
            torch.cuda.empty_cache()
        _M_LOOKUPS.remove(exe=self._exe_id, result="hit")
        _M_LOOKUPS.remove(exe=self._exe_id, result="miss")
        for fam in (_M_COMPILE_S, _M_RECOMPILES, _M_ENTRIES):
            fam.remove(exe=self._exe_id)
        for mode in _MODES:
            _M_RUN_SECONDS.remove(exe=self._exe_id, mode=mode)

    # -- memory layer (memory_optimization_transpiler) ----------------------
    def _memopt_program(self, program, fp, feed_names, fetch_names):
        """The rename pass's clone of `program` for one (feeds, fetches),
        cached: the feeds and fetches are skipped, so a fetched
        temporary is never renamed away."""
        key = (fp, tuple(sorted(feed_names)), tuple(fetch_names))
        clone = self._memopt_cache.get(key)
        if clone is None:
            from ..memory_optimization_transpiler import memory_optimize

            clone = program.clone()
            memory_optimize(clone, skip_vars=list(feed_names)
                            + list(fetch_names))
            _bounded_put(self._memopt_cache, key, clone)
        return clone

    def _free_plan(self, program, fp, fetch_names):
        """{op index: names dead after it} (plan_dead_frees), cached."""
        key = (fp, tuple(fetch_names))
        plan = self._free_plans.get(key)
        if plan is None:
            from ..memory_optimization_transpiler import plan_dead_frees

            plan = plan_dead_frees(program, fetch_names)
            _bounded_put(self._free_plans, key, plan)
        return plan

    def _donation_plan(self, program, fp, feed_names, fetch_names):
        """The donation plan of the `donate=True` feeds, cached; raises
        DonationError for an unsafe hint (a fetched feed, a persistable,
        a feed nothing reads)."""
        key = (fp, tuple(sorted(feed_names)), tuple(fetch_names))
        plan = self._donation_plans.get(key)
        if plan is None:
            from ..memory_optimization_transpiler import plan_donation

            block = program.global_block()
            hinted = [n for n in feed_names
                      if getattr(block.vars.get(n), "donate", False)]
            plan = plan_donation(program, feed_names, fetch_names,
                                 requested=hinted)
            _bounded_put(self._donation_plans, key, plan)
        return plan.check()

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
        entry = self._cache.pop(key, None)
        miss = entry is None
        self._note_lookup(not miss, fp, key, once)
        if miss:
            entry = make()
            while len(self._cache) >= CACHE_MAX:
                self._cache.pop(next(iter(self._cache))).free()
        self._cache[key] = entry     # the most recently used goes last
        self._m_entries.set(len(self._cache))
        return entry, miss

    def _run_entry(self, entry, miss, vals, seed, where, publish):
        """Run a cache entry with its own tables: eagerly on a miss, on
        the CPU, or when GRAPHS_MAX graphs are live (`vals` becoming its
        env, `publish` storing each value it writes for the last time,
        so an old state's memory goes as the interpreter's does); on a
        CUDA place captured at the first hit, replayed after ->
        (outputs, {name: buffer} to rebind)."""
        ctx = ExecContext(self.device, seed=seed, tables=entry.tables)
        if entry.graph is not None:
            self._graph_stats["replays"] += 1
            return entry.replay(vals)
        t0 = time.perf_counter()
        if not miss and self.device.type == "cuda":
            if sum(e.graph is not None
                   for e in self._cache.values()) < GRAPHS_MAX:
                with torch.no_grad():
                    out = entry.capture(ctx, {
                        n: _to_device_value(v, self.device)
                        for n, v in vals.items()}, where)
                dt = time.perf_counter() - t0
                self._graph_stats["captures"] += 1
                self._graph_stats["capture_s"] += dt
                self._graph_stats["write_back_bytes"] += \
                    entry.write_back_bytes
                self._m_compile_s.inc(dt)
                return out
            self._graph_stats["eager_hits"] += 1
        for n, v in vals.items():
            vals[n] = _to_device_value(v, self.device)
        with torch.no_grad():
            out = entry.plan.run(ctx, vals, publish, entry.frees), {}
        if miss:
            self._m_compile_s.inc(time.perf_counter() - t0)
        return out

    @staticmethod
    def _copied_out(graphed, values):
        """A graph's outputs are overwritten by its next replay: fetches
        are cloned out of its pool (a SelectedRows' rows and values)."""
        if not graphed:
            return values
        return [_clone(v) for v in values]

    # -- interpreter ---------------------------------------------------------
    def _run_interpreted(self, program, fp, scope, feed, fetch_names, seed,
                         memopt=False):
        local = scope.new_scope()
        # under memory_optimize each dead local value is erased right
        # after its last op, so the scope holds live values only
        frees = self._free_plan(program, fp, fetch_names) if memopt else {}
        try:  # finally: a raising op must not leak the local scope
            env = self._scope_env(program, scope, local)
            with torch.no_grad():
                for name, v in feed.items():
                    env.set(name, _to_device_value(v, self.device))
                ctx = ExecContext(self.device, seed=seed)
                for i, op in enumerate(program.global_block().ops):
                    self._run_op(ctx, op, env)
                    for n in frees.get(i, ()):
                        local.erase(n)
                return self._fetch(env, fetch_names)
        finally:
            scope.kids.remove(local)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _run_op(self, ctx, op, env):
        """run_op, timed as a profiler event named by the op's type while
        the profiler's host half is on (reference executor.cc:124
        RecordEvent; the card is synchronised before the clock is read)."""
        from .. import profiler

        if not profiler.is_enabled():
            run_op(ctx, op, env)
            return
        with profiler.record_event(op.type, sync=self._sync):
            run_op(ctx, op, env)

    def _timed_entry(self, event, entry, miss, vals, seed, where, publish):
        """_run_entry, timed as the profiler event `event` while the
        profiler's host half is on (the JAX package's `xla_block` /
        `xla_segment_<i>`: here `compiled_block` / `segment_<i>`)."""
        from .. import profiler

        if not profiler.is_enabled():
            return self._run_entry(entry, miss, vals, seed, where, publish)
        with profiler.record_event(event, sync=self._sync):
            return self._run_entry(entry, miss, vals, seed, where, publish)

    # -- segmented: cached device segments between eager host ops -----------
    def _op_is_host(self, op) -> bool:
        return _op_is_host(op, self.device)

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
            sub = _sub_names(block.program)
            segs = self._segs[key] = [
                (h, ops, None if h else _Plan(ops, persistable, sub))
                for h, ops in segs]
        return segs

    def _run_segmented(self, program, fp, segs, scope, feed, fetch_names,
                       seed, memopt=False):
        local = scope.new_scope()
        # under memory_optimize the dead local values are erased after
        # each segment, host or device (segment granularity)
        frees = self._free_plan(program, fp, fetch_names) if memopt else {}
        try:  # finally: a raising op must not leak the local scope
            env = self._scope_env(program, scope, local)
            with torch.no_grad():
                for name, v in feed.items():
                    env.set(name, _to_device_value(v, self.device))
                ctx = ExecContext(self.device, seed=seed)
                once, graphed = set(), False  # one recompile count a run
                op_idx = 0
                for i, (host, ops, plan) in enumerate(segs):
                    if host:
                        for op in ops:
                            self._run_op(ctx, op, env)
                    else:
                        graphed |= self._run_segment(fp, i, plan, env, seed,
                                                     once)
                    for j in range(op_idx, op_idx + len(ops)):
                        for n in frees.get(j, ()):
                            local.erase(n)
                    op_idx += len(ops)
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
                if n in seg_env:    # an op may leave an output unset
                    env.set(n, seg_env[n])

        outs, rebind = self._timed_entry(f"segment_{seg_idx}", entry, miss,
                                         vals, seed, f"segment {seg_idx}",
                                         publish)
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

        outs, rebind = self._timed_entry("compiled_block", entry, miss,
                                         vals, seed, "the compiled block",
                                         publish)
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


# ---------------------------------------------------------------------------
# program_to_fn
# ---------------------------------------------------------------------------


def _analyze_states(program, block, feed_names):
    """The persistables a block reads before writing them, and those it
    writes, sub-blocks included (the JAX package's
    Executor._analyze_states)."""
    persistable = {v.name for v in program.list_vars() if v.persistable}

    def visit(blk, written, reads, writes):
        for op in blk.ops:
            for n in op.input_names():
                if n in persistable and n not in written:
                    reads.add(n)
            sub = op.sub_block() if "sub_block" in op.attrs else None
            if sub is not None:
                visit(sub, written, reads, writes)
            for n in op.output_names():
                if n in persistable:
                    writes.add(n)
                    written.add(n)

    reads, writes = set(), set()
    visit(block, set(feed_names), reads, writes)
    return sorted(reads), sorted(writes)


class _ProgramFn:
    """`program_to_fn`'s function: one resolved plan of the block, run
    eagerly on the CPU; on a CUDA place each distinct set of input shapes
    is a cache entry whose first call runs eagerly, whose second is
    captured into a CUDA graph, and whose later calls replay it.

    A graph reads its inputs from buffers of its own (cloned at the
    capture) and writes no input: every call copies every input in, so
    the caller's tensors are never changed.  (A tensor's identity and
    in-place version cannot tell that it is unchanged: a replay, of this
    graph or another, rewrites its outputs and donated buffers without
    bumping their versions.)  Blocks with host ops, or on the card
    random ops (their draws are seeded per call), run eagerly on every
    call."""

    def __init__(self, program, feed_names, fetch_names, block_idx, place):
        from ..memory_optimization_transpiler import plan_donation

        block = program.blocks[block_idx]
        self.feed_names = list(feed_names)
        self.fetch_names = [v.name if isinstance(v, Variable) else str(v)
                            for v in fetch_names]
        self.state_in_names, self.state_out_names = _analyze_states(
            program, block, self.feed_names)
        rw = [n for n in self.state_in_names if n in self.state_out_names]
        # which buffers die inside the step; an unsafe donate=True hint
        # raises here, at build time
        hinted = [n for n in self.feed_names
                  if getattr(block.vars.get(n), "donate", False)]
        self.donation_plan = plan_donation(
            program, self.feed_names, self.fetch_names, state_rw_names=rw,
            requested=hinted).check()
        self.device = resolve_place(place)
        self.program = program
        persistable = frozenset(v.name for v in program.list_vars()
                                if v.persistable)
        self._plan = _Plan(block.ops, persistable, _sub_names(program))
        self._outputs = self.fetch_names + [
            n for n in self.state_out_names if n not in self.fetch_names]
        self._frees = self._plan.dead_after(self._outputs)
        self._graphs = self.device.type == "cuda" and not any(
            _op_is_host(op, self.device) for op in block.ops)
        self._entries: Dict = {}
        self.stats = {"eager_runs": 0, "captures": 0, "replays": 0}

    def _ctx(self, generator):
        if isinstance(generator, torch.Generator):
            seed = generator.initial_seed()
        else:
            seed = int(generator or 0)
        return ExecContext(self.device, seed=seed)

    def __call__(self, feeds, states, generator=None):
        """-> ({fetch name: value}, {state name: value}): the written
        states' new values and the read-only states as given.  After a
        replay the fetches and new states are the graph's own outputs,
        which the next call overwrites: clone what must outlive it."""
        vals = {n: _to_device_value(v, self.device)
                for n, v in {**states, **feeds}.items()}
        key = tuple(sorted((n, _aval(v)) for n, v in vals.items()))
        ctx = self._ctx(generator)
        entry = self._entries.get(key) if self._graphs else None
        with torch.no_grad():
            if entry is None:
                if self._graphs:
                    self._entries[key] = _Entry(self._plan, self._outputs)
                self.stats["eager_runs"] += 1
                outs = self._plan.run(ctx, dict(vals), None, self._frees)
            elif entry.graph is None:
                private = {n: _clone(v) for n, v in vals.items()}
                outs = entry.capture(ctx, private, "program_to_fn",
                                     donate=False)[0]
                self.stats["captures"] += 1
            else:
                outs, _ = entry.replay(vals)
                self.stats["replays"] += 1
        missing = [n for n in self.fetch_names if n not in outs]
        if missing:
            raise KeyError(f"fetch variable(s) {missing} were never "
                           "produced by the program")
        fetches = {n: outs[n] for n in self.fetch_names}
        new_states = {n: outs[n] if n in self.state_out_names and n in outs
                      else vals[n]
                      for n in sorted(set(self.state_in_names)
                                      | set(self.state_out_names))
                      if n in outs or n in vals}
        return fetches, new_states

    def close(self):
        """Free the captured graphs and their memory pools."""
        for e in self._entries.values():
            e.free()
        self._entries.clear()


def program_to_fn(program: Program, feed_names, fetch_names, block_idx=0,
                  place=None):
    """A Program block as a function `(feeds, states, generator) ->
    (fetches, new_states)` over tensors on `place`'s device (None =
    CUDAPlace(0)); `generator` is a torch.Generator or an int whose
    seed keys the random ops' draws, as an Executor run's seed does.
    `new_states` holds every state the block reads or writes (read-only
    ones as given), so `states = fn(...)[1]` loops.  The function
    carries `state_in_names`, `state_out_names` and `donation_plan`
    (an unsafe `donate=True` feed raises DonationError here, at build
    time); on a card each set of input shapes is captured into one CUDA
    graph at its second call and replayed after (`_ProgramFn`): a
    replay's fetches and new states are the graph's own outputs, valid
    until the next call."""
    return _ProgramFn(program, feed_names, fetch_names, block_idx, place)
