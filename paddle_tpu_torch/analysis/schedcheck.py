"""Deterministic-schedule checker: explore thread interleavings
(counterpart of paddle_tpu/analysis/schedcheck.py).

The AST analyzer (concurrency.py) catches lock-order and lock-discipline
bugs statically; this module catches the PROTOCOL bugs — lost wakeups,
stop/accept races, drain/swap ordering — by actually running small
threaded models under a cooperative scheduler that serializes execution
and explores interleavings (CHESS-style):

* inside a `run()` / `explore()` call, `threading.Lock/RLock/Condition/
  Event/Semaphore/Thread` are patched to cooperative shims (code under
  test needs NO changes; `queue.Queue` built during the run composes,
  since it builds on `threading` primitives at construction time);
* exactly ONE thread runs at a time; every primitive operation is a
  yield point where the scheduler picks the next runnable thread —
  bounded DFS over the choice tree first (systematic), then seeded
  random schedules (diversity past the bound);
* a schedule with live threads and nothing runnable is a DEADLOCK,
  reported with each thread's blocked-on state and the full decision
  trace (replayable: pass the trace back as `prefix`);
* timed waits (`wait(timeout=...)`, `join(timeout)`) never block a
  schedule forever: when nothing else is runnable the scheduler wakes
  one timed waiter with a timeout result — exploring the timeout path
  without real time.

Invariant hooks: the model callable returns a state object; each
schedule's state is passed to `invariant(state)` which raises (any
AssertionError/Exception) to flag the schedule.  `explore()` collects
the first violation with its schedule trace; `check()` raises it.

Protocol models for the distributed runtime (FENCE->MIGRATE->COMMIT,
elastic_round replay, GenerationServer admit/finish/swap over the REAL
PagedKVCache, CommPool.send_round ordering) live in schedmodels.py;
regression pins for previously hand-fixed races re-run the REAL serving
code (GenerationStream) under this scheduler with the old bug
reintroduced via `arm_fault` (docs/analysis.md "Schedule checking").
"""
from __future__ import annotations

import contextlib
import dataclasses
import random
import threading as _threading
from typing import Callable, List, Optional, Sequence, Tuple

__all__ = [
    "DeadlockError",
    "ScheduleViolation",
    "ExplorationResult",
    "explore",
    "check",
    "run_schedule",
    "yield_point",
    "arm_fault",
    "fault_armed",
]

# the REAL primitives (captured before any patching)
_RealThread = _threading.Thread
_RealLock = _threading.Lock
_RealRLock = _threading.RLock
_RealCondition = _threading.Condition
_RealEvent = _threading.Event
_RealSemaphore = _threading.Semaphore
_RealBoundedSemaphore = _threading.BoundedSemaphore
_real_current = _threading.current_thread

_MAX_STEPS = 20_000   # runaway-schedule backstop (livelock guard)


class DeadlockError(AssertionError):
    """All live threads blocked with no timed waiter to wake."""


class ScheduleViolation(AssertionError):
    """One schedule violated an invariant (or deadlocked).

    `trace` replays it: `run_schedule(model, prefix=violation.trace)`.
    """

    def __init__(self, message: str, trace: List[int],
                 schedule_index: int):
        super().__init__(message)
        self.trace = list(trace)
        self.schedule_index = schedule_index


# ---------------------------------------------------------------------------
# fault toggles: reintroduce previously-fixed bugs for regression pins
# ---------------------------------------------------------------------------

_ARMED_FAULTS: set = set()


def fault_armed(name: str) -> bool:
    """Production modules guard their regression-pin code paths on this
    (serving/generation.py's GenerationStream, through
    core/resilience.sched_fault_armed).  Always False outside a test
    that armed the fault."""
    return name in _ARMED_FAULTS


@contextlib.contextmanager
def arm_fault(name: str):
    """Reintroduce one historical bug while the context is active — the
    schedule checker must then find its race deterministically."""
    _ARMED_FAULTS.add(name)
    try:
        yield
    finally:
        _ARMED_FAULTS.discard(name)


# ---------------------------------------------------------------------------
# the scheduler
# ---------------------------------------------------------------------------


class _Abort(BaseException):
    """Raised inside coop threads to unwind them on teardown (BaseException
    so model code's `except Exception` cannot swallow the teardown)."""


class _Coop:
    """One cooperative thread: a real thread gated on a semaphore the
    scheduler controls; at most one gate is open at any time."""

    __slots__ = ("name", "gate", "state", "blocked_on", "timed",
                 "real", "exc", "result", "target", "daemon", "joiners")

    def __init__(self, name: str, target: Callable):
        self.name = name
        self.joiners: List["_Coop"] = []
        # the gate must be a fully REAL semaphore even when created
        # while the patch is installed (its internals resolve
        # threading.Condition at construction time)
        with _pause_patch():
            self.gate = _RealSemaphore(0)
        self.state = "new"        # new|runnable|blocked|finished
        self.blocked_on = ""      # human description when blocked
        self.timed = False        # blocked in a TIMED wait/join
        self.real: Optional[_threading.Thread] = None
        self.exc: Optional[BaseException] = None
        self.target = target
        self.daemon = True


class Scheduler:
    def __init__(self, prefix: Sequence[int], rng: random.Random):
        self.threads: List[_Coop] = []
        self.current: Optional[_Coop] = None
        self.sched_gate = _RealSemaphore(0)
        self.prefix = list(prefix)
        self.rng = rng
        self.trace: List[int] = []
        self.choice_counts: List[int] = []
        self.steps = 0
        self.aborting = False
        self.deadlock: Optional[str] = None
        # maps real thread ident -> coop (for current-thread dispatch)
        self._by_ident = {}

    # -- thread lifecycle ----------------------------------------------------
    def spawn(self, coop: _Coop):
        def body():
            self._by_ident[_real_current().ident] = coop
            coop.gate.acquire()      # wait to be scheduled first
            try:
                if not self.aborting:
                    coop.target()
            except _Abort:
                pass
            except BaseException as e:
                coop.exc = e
            finally:
                coop.state = "finished"
                for j in coop.joiners:
                    self.unblock(j)
                coop.joiners.clear()
                self.sched_gate.release()

        # real Thread construction/start resolves threading.Event &co.
        # at call time — pause the patch so its internals stay real
        with _pause_patch():
            coop.real = _RealThread(target=body, daemon=True,
                                    name=f"sched-{coop.name}")
            self.threads.append(coop)
            coop.state = "runnable"
            coop.real.start()

    def current_coop(self) -> Optional[_Coop]:
        return self._by_ident.get(_real_current().ident)

    # -- core switch ---------------------------------------------------------
    def yield_point(self, reason: str = "yield"):
        """Called from inside a coop thread: hand control back to the
        scheduler and wait to be rescheduled."""
        me = self.current_coop()
        if me is None:
            return   # unmanaged thread (e.g. real metrics internals)
        if self.aborting:
            raise _Abort()
        me.blocked_on = reason
        self.sched_gate.release()
        me.gate.acquire()
        if self.aborting:
            raise _Abort()

    def block(self, reason: str, timed: bool = False):
        me = self.current_coop()
        if me is None or self.aborting:
            if me is not None and self.aborting:
                raise _Abort()
            return
        me.state = "blocked"
        me.blocked_on = reason
        me.timed = timed
        self.sched_gate.release()
        me.gate.acquire()
        if self.aborting:
            raise _Abort()

    def unblock(self, coop: _Coop):
        if coop.state == "blocked":
            coop.state = "runnable"
            coop.timed = False

    # -- main loop -----------------------------------------------------------
    def loop(self):
        """Run until every coop thread finishes (or deadlock/abort)."""
        while True:
            live = [t for t in self.threads if t.state != "finished"]
            if not live:
                return
            if all(t.daemon for t in live):
                # only daemon threads left (the model body finished):
                # process-exit semantics — a parked accept loop or
                # worker is not a deadlock
                self.abort()
                return
            runnable = [t for t in live if t.state == "runnable"]
            if not runnable:
                timed = [t for t in live if t.timed]
                if not timed:
                    self.deadlock = "; ".join(
                        f"{t.name}: blocked on {t.blocked_on}"
                        for t in live)
                    self.abort()
                    return
                # wake one timed waiter with a timeout result: real
                # time never passes, the timeout path is just another
                # scheduling choice
                runnable = timed
            self.steps += 1
            if self.steps > _MAX_STEPS:
                self.deadlock = (
                    f"schedule exceeded {_MAX_STEPS} steps — livelock "
                    "(threads spinning on timed waits?)")
                self.abort()
                return
            idx = self._choose(len(runnable))
            t = runnable[idx]
            if t.state == "blocked":    # a timed waiter woken by choice
                t.state = "runnable"
                t.timed = False
                t.blocked_on = "timeout-wakeup"
            self.current = t
            t.gate.release()
            self.sched_gate.acquire()

    def _choose(self, n: int) -> int:
        self.choice_counts.append(n)
        if n == 1:
            self.trace.append(0)
            return 0
        d = len(self.trace)
        if d < len(self.prefix):
            idx = min(self.prefix[d], n - 1)
        elif self.rng is not None:
            idx = self.rng.randrange(n)
        else:
            idx = 0
        self.trace.append(idx)
        return idx

    def abort(self):
        """Unwind every live coop thread (they raise _Abort at their
        next gate release) and join them."""
        self.aborting = True
        for t in self.threads:
            if t.state != "finished":
                t.gate.release()
        for t in self.threads:
            if t.real is not None:
                t.real.join(timeout=5)


_SCHED: Optional[Scheduler] = None


def _sched() -> Optional[Scheduler]:
    return _SCHED


def yield_point(reason: str = "model"):
    """Public yield point for models/fakes (e.g. a fake socket's accept)
    so the scheduler can interleave around non-threading operations."""
    s = _SCHED
    if s is not None:
        s.yield_point(reason)


# ---------------------------------------------------------------------------
# cooperative primitive shims (installed by _patched during a run)
# ---------------------------------------------------------------------------


class CoopLock:
    _reentrant = False

    def __init__(self):
        self._owner: Optional[_Coop] = None
        self._count = 0
        self._waiters: List[_Coop] = []
        self._real = _RealLock()   # fallback for unmanaged threads

    def acquire(self, blocking: bool = True, timeout: float = -1):
        s = _SCHED
        me = s.current_coop() if s is not None else None
        if me is None:
            # pass timeout through verbatim: 0 is a valid poll, and
            # the default -1 already means "no timeout"
            return self._real.acquire(blocking, timeout)
        s.yield_point(f"acquire {id(self):#x}")
        while self._owner is not None and self._owner is not me:
            if not blocking:
                return False
            self._waiters.append(me)
            s.block(f"lock {id(self):#x} held by {self._owner.name}",
                    timed=timeout is not None and timeout >= 0)
            if me in self._waiters:
                self._waiters.remove(me)
            if (timeout is not None and timeout >= 0
                    and self._owner is not None
                    and self._owner is not me):
                return False   # woken by timeout choice
        if self._owner is me:
            if not self._reentrant:
                raise RuntimeError(
                    "cooperative Lock re-acquired by its owner "
                    "(self-deadlock in real threading)")
            self._count += 1
            return True
        self._owner = me
        self._count = 1
        return True

    def release(self):
        s = _SCHED
        me = s.current_coop() if s is not None else None
        if me is None:
            return self._real.release()
        if self._owner is not me:
            if s.aborting:
                return   # unwinding a with-block torn mid-acquire
            raise RuntimeError("release of un-owned cooperative lock")
        self._count -= 1
        if self._count == 0:
            self._owner = None
            for w in list(self._waiters):
                s.unblock(w)

    def locked(self):
        return self._owner is not None or self._real.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False


class CoopRLock(CoopLock):
    _reentrant = True


class CoopCondition:
    def __init__(self, lock=None):
        self._lock = lock if lock is not None else CoopRLock()
        self._waiting: List[Tuple[_Coop, list]] = []

    # delegate lock protocol
    def acquire(self, *a, **k):
        return self._lock.acquire(*a, **k)

    def release(self):
        return self._lock.release()

    def __enter__(self):
        self._lock.acquire()
        return self

    def __exit__(self, *exc):
        self._lock.release()
        return False

    def _is_owned(self):
        s = _SCHED
        me = s.current_coop() if s is not None else None
        return getattr(self._lock, "_owner", None) is me \
            and me is not None

    def wait(self, timeout: Optional[float] = None):
        s = _SCHED
        me = s.current_coop() if s is not None else None
        if me is None:
            raise RuntimeError(
                "cooperative Condition.wait from unmanaged thread")
        if getattr(self._lock, "_owner", None) is not me:
            raise RuntimeError("wait() on un-acquired Condition")
        token = [False]   # [notified]
        self._waiting.append((me, token))
        # release fully (even through RLock reentrancy)
        count = getattr(self._lock, "_count", 1)
        for _ in range(count):
            self._lock.release()
        s.block(f"cond-wait {id(self):#x}", timed=timeout is not None)
        if (me, token) in self._waiting:
            self._waiting.remove((me, token))
        for _ in range(count):
            self._lock.acquire()
        return token[0]

    def wait_for(self, predicate, timeout: Optional[float] = None):
        # bounded: a timed wait_for can return a False predicate (the
        # timeout path); an untimed one loops until the predicate holds
        while not predicate():
            if not self.wait(timeout) and timeout is not None:
                return predicate()
        return True

    def notify(self, n: int = 1):
        s = _SCHED
        woken = 0
        for (w, token) in list(self._waiting):
            if woken >= n:
                break
            token[0] = True
            self._waiting.remove((w, token))
            if s is not None:
                s.unblock(w)
            woken += 1

    def notify_all(self):
        self.notify(len(self._waiting))


class CoopEvent:
    def __init__(self):
        self._flag = False
        self._waiters: List[_Coop] = []
        # real mirror: unmanaged threads wait on the real event instead
        with _pause_patch():
            self._real = _RealEvent()

    def is_set(self):
        return self._flag

    def set(self):
        s = _SCHED
        self._flag = True
        self._real.set()
        for w in list(self._waiters):
            if s is not None:
                s.unblock(w)
        self._waiters.clear()

    def clear(self):
        self._flag = False
        self._real.clear()

    def wait(self, timeout: Optional[float] = None):
        s = _SCHED
        me = s.current_coop() if s is not None else None
        if me is None:
            return self._real.wait(timeout)
        s.yield_point("event-check")
        while not self._flag:
            self._waiters.append(me)
            s.block(f"event {id(self):#x}", timed=timeout is not None)
            if me in self._waiters:
                self._waiters.remove(me)
            if timeout is not None and not self._flag:
                return False   # timeout path chosen
        return True


class CoopSemaphore:
    def __init__(self, value: int = 1):
        self._value = int(value)
        self._waiters: List[_Coop] = []

    def acquire(self, blocking: bool = True,
                timeout: Optional[float] = None):
        s = _SCHED
        me = s.current_coop() if s is not None else None
        if me is None:
            raise RuntimeError(
                "cooperative Semaphore from unmanaged thread")
        s.yield_point("sem-acquire")
        while self._value <= 0:
            if not blocking:
                return False
            self._waiters.append(me)
            s.block(f"semaphore {id(self):#x}",
                    timed=timeout is not None)
            if me in self._waiters:
                self._waiters.remove(me)
            if timeout is not None and self._value <= 0:
                return False
        self._value -= 1
        return True

    def release(self, n: int = 1):
        s = _SCHED
        self._value += n
        for w in list(self._waiters):
            if s is not None:
                s.unblock(w)
        self._waiters.clear()

    __enter__ = lambda self: self.acquire() and self  # noqa: E731

    def __exit__(self, *exc):
        self.release()
        return False


class CoopThread:
    """threading.Thread stand-in: registers with the active scheduler on
    start(); runs as a gated real thread."""

    _counter = [0]

    def __init__(self, group=None, target=None, name=None, args=(),
                 kwargs=None, *, daemon=None):
        self._target = target
        self._args = tuple(args)
        self._kwargs = dict(kwargs or {})
        CoopThread._counter[0] += 1
        self.name = name or f"CoopThread-{CoopThread._counter[0]}"
        self.daemon = bool(daemon) if daemon is not None else False
        self._coop: Optional[_Coop] = None

    def run(self):
        if self._target is not None:
            self._target(*self._args, **self._kwargs)

    def start(self):
        s = _SCHED
        if s is None:
            raise RuntimeError(
                "CoopThread.start outside a schedcheck run")
        if self._coop is not None:
            raise RuntimeError("threads can only be started once")
        self._coop = _Coop(self.name, self.run)
        self._coop.daemon = self.daemon
        s.spawn(self._coop)
        s.yield_point("thread-start")

    def is_alive(self):
        return self._coop is not None \
            and self._coop.state != "finished"

    def join(self, timeout: Optional[float] = None):
        s = _SCHED
        me = s.current_coop() if s is not None else None
        if self._coop is None:
            return
        if me is None:
            self._coop.real.join(timeout)
            return
        while self._coop.state != "finished":
            self._coop.joiners.append(me)
            s.block(f"join {self.name}", timed=timeout is not None)
            if me in self._coop.joiners:
                self._coop.joiners.remove(me)
            if timeout is not None \
                    and self._coop.state != "finished":
                return   # timeout path chosen
        s.yield_point("joined")


_COOP_CLASSES = {
    "Thread": CoopThread,
    "Lock": CoopLock,
    "RLock": CoopRLock,
    "Condition": CoopCondition,
    "Event": CoopEvent,
    "Semaphore": CoopSemaphore,
    "BoundedSemaphore": CoopSemaphore,
}
_SAVED: Optional[dict] = None


def _apply_coop():
    for n, v in _COOP_CLASSES.items():
        setattr(_threading, n, v)


@contextlib.contextmanager
def _pause_patch():
    """Temporarily restore the REAL threading primitives (a scheduler
    internal constructing real threads/events mid-run).  No-op when the
    patch is not installed.  Safe because exactly one coop thread (or
    the scheduler) runs at any instant."""
    if _SAVED is None:
        yield
        return
    for n, v in _SAVED.items():
        setattr(_threading, n, v)
    try:
        yield
    finally:
        _apply_coop()


@contextlib.contextmanager
def _patched():
    global _SAVED
    _SAVED = {n: getattr(_threading, n) for n in _COOP_CLASSES}
    saved = _SAVED
    _apply_coop()
    try:
        yield
    finally:
        for n, v in saved.items():
            setattr(_threading, n, v)
        _SAVED = None


# ---------------------------------------------------------------------------
# exploration drivers
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ScheduleResult:
    trace: List[int]
    choice_counts: List[int]
    state: object = None
    error: Optional[BaseException] = None
    deadlock: Optional[str] = None


def run_schedule(model: Callable[[], object],
                 prefix: Sequence[int] = (),
                 seed: Optional[int] = None) -> ScheduleResult:
    """Run `model` once under the cooperative scheduler.  Decisions
    follow `prefix`, then a seeded RNG (or first-runnable when seed is
    None).  The model body itself runs as the first coop thread."""
    global _SCHED
    if _SCHED is not None:
        raise RuntimeError("schedcheck runs cannot nest")
    rng = random.Random(seed) if seed is not None else None
    sched = Scheduler(prefix, rng)
    res = ScheduleResult([], [])

    def main_body():
        res.state = model()

    main = _Coop("main", main_body)
    main.daemon = False   # the model body is the process's main thread
    _SCHED = sched
    try:
        with _patched():
            sched.spawn(main)
            sched.loop()
    finally:
        _SCHED = None
    res.trace = sched.trace
    res.choice_counts = sched.choice_counts
    if sched.deadlock is not None:
        res.deadlock = sched.deadlock
    for t in sched.threads:
        if t.exc is not None and res.error is None:
            res.error = t.exc
    return res


@dataclasses.dataclass
class ExplorationResult:
    schedules: int
    violation: Optional[ScheduleViolation]

    @property
    def ok(self) -> bool:
        return self.violation is None


def explore(model: Callable[[], object],
            invariant: Optional[Callable[[object], None]] = None,
            *, max_schedules: int = 200, seed: int = 0,
            random_schedules: int = 50) -> ExplorationResult:
    """Bounded DFS over the schedule tree, then seeded random schedules.

    DFS: replay a recorded decision prefix, take the FIRST branch past
    it, and push every untaken alternative of the completed schedule
    onto the stack (deepest first) — systematic coverage of the
    low-order interleavings where protocol races live.  Random: seeds
    `seed`..`seed+random_schedules-1` shake out deeper orderings.
    Returns the first violation (invariant failure, model exception, or
    deadlock) with its replayable trace."""
    schedules = 0

    def attempt(prefix, seed_):
        nonlocal schedules
        res = run_schedule(model, prefix, seed_)
        schedules += 1
        problem: Optional[str] = None
        if res.deadlock is not None:
            problem = f"deadlock: {res.deadlock}"
        elif res.error is not None:
            problem = (f"{type(res.error).__name__}: {res.error}")
        elif invariant is not None:
            try:
                invariant(res.state)
            except BaseException as e:
                problem = f"invariant violated: {e}"
        if problem is not None:
            return res, ScheduleViolation(
                f"schedule {schedules - 1} "
                f"(trace {res.trace}): {problem}",
                res.trace, schedules - 1)
        return res, None

    # DFS phase (deterministic: first-runnable past the prefix); each
    # completed schedule contributes every untaken branch along its
    # trace, deepest pushed last so the stack pops depth-first
    stack: List[List[int]] = [[]]
    explored = {()}
    while stack and schedules < max_schedules:
        prefix = stack.pop()
        res, v = attempt(prefix, None)
        if v is not None:
            return ExplorationResult(schedules, v)
        for d in range(len(prefix), len(res.trace)):
            n = res.choice_counts[d]
            for alt in range(n):
                if alt == res.trace[d]:
                    continue
                cand = res.trace[:d] + [alt]
                key = tuple(cand)
                if key not in explored:
                    explored.add(key)
                    stack.append(cand)

    # random phase: seeded diversity past the DFS bound
    for i in range(random_schedules):
        res, v = attempt((), seed + i)
        if v is not None:
            return ExplorationResult(schedules, v)
    return ExplorationResult(schedules, None)


def check(model: Callable[[], object],
          invariant: Optional[Callable[[object], None]] = None,
          **kw) -> int:
    """explore() that RAISES the violation; returns schedules explored."""
    res = explore(model, invariant, **kw)
    if res.violation is not None:
        raise res.violation
    return res.schedules
