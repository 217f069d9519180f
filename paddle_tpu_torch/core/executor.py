"""Executor: runs a Program's block against a Scope, and the places.

Counterpart of paddle_tpu/core/executor.py.  `CUDAPlace(i)` is a real
CUDA device and the default of every entry point; `CPUPlace()` must be
asked for.  The Executor has the JAX module's interpreter mode: ops run
one by one, eagerly, each through its PyTorch lowering
(core/execution.run_op), with persistable values (parameters, optimizer
state, learning rates) in the root scope and every other value in a
local scope that lives for one run.  The compiled and segmented modes
are not ported (ROADMAP A4): `run(..., compiled=True)` raises.
"""
from __future__ import annotations

import itertools
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..observability import metrics as obs_metrics
from ..observability import tracing as obs_tracing
from .execution import ExecContext, ScopeEnv, _mix, run_op
from .framework import Program, Variable, default_main_program
from .scope import Scope

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


def _to_device_value(v, device):
    """Feed value -> tensor on `device` (opaque host objects pass)."""
    if isinstance(v, torch.Tensor):
        return v.to(device)
    if isinstance(v, (np.ndarray, np.generic)):
        a = np.ascontiguousarray(v)
        if not a.flags.writeable:
            a = a.copy()
        return torch.from_numpy(a).to(device)
    if isinstance(v, (bool, int, float)):
        return torch.tensor(v, device=device)
    return v


def _to_numpy(v):
    if isinstance(v, torch.Tensor):
        if v.dtype == torch.bfloat16:
            v = v.float()
        return v.detach().cpu().numpy()
    return v


_EXE_IDS = itertools.count()
_M_RUN_SECONDS = obs_metrics.histogram(
    "paddle_tpu_executor_run_seconds",
    "Executor.run wall latency by execution mode", ("exe", "mode"))


class Executor:
    """Runs Programs on one place: CUDAPlace(0) unless told otherwise,
    raising at construction when that device does not exist."""

    def __init__(self, place=None, seed: int = 0):
        self.place = CUDAPlace(0) if place is None else place
        self.device = resolve_place(self.place)
        self._seed = seed
        self._step = 0
        self._exe_id = str(next(_EXE_IDS))

    def run(self, program: Optional[Program] = None,
            feed: Optional[Dict] = None,
            fetch_list: Optional[Sequence] = None,
            scope: Optional[Scope] = None, return_numpy: bool = True,
            compiled: Optional[bool] = None):
        """Execute block 0 of `program` with `feed`, returning the
        values of `fetch_list` (numpy arrays unless return_numpy=False).
        Random ops draw from a stream keyed by (program seed or the
        executor's seed, run index, op identity)."""
        if compiled:
            raise NotImplementedError(
                "compiled/segmented Executor modes are not ported yet "
                "(ROADMAP A4); run with compiled=False, the interpreter")
        program = program or default_main_program()
        scope = scope or global_scope()
        feed = feed or {}
        fetch_names = [v.name if isinstance(v, Variable) else str(v)
                       for v in (fetch_list or [])]
        seed = _mix(program.seed or self._seed, self._step)
        self._step += 1
        t0 = time.perf_counter()
        with obs_tracing.span("executor.run", mode="interpreted"):
            outs = self._run_interpreted(program, scope, feed, fetch_names,
                                         seed)
        if obs_metrics.enabled():
            _M_RUN_SECONDS.labels(exe=self._exe_id,
                                  mode="interpreted").observe(
                time.perf_counter() - t0)
        if return_numpy:
            outs = [_to_numpy(v) for v in outs]
        return outs

    def close(self):
        """Drop this instance's registry series."""
        _M_RUN_SECONDS.remove(exe=self._exe_id, mode="interpreted")

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
