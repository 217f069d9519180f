"""Unified resilience layer: retry/backoff policies + fault injection.

Reference: the Go master re-dispatches timed-out tasks and snapshots its
queues (the reference's go/master/service.go checkTimeoutFunc), and the
Go pserver checkpoints its shard for crash recovery
(go/pserver/service.go:120-203).  Those recovery paths were exercised by
killing processes under a supervisor; this module gives our reproduction
the same two primitives, shared by every networked/durable subsystem:

  * `RetryPolicy` — exponential backoff with jitter, an attempt cap and
    an overall deadline.  Each knob is overridable per subsystem via
    ``PADDLE_TPU_<PREFIX>_<KNOB>`` environment variables (prefixes:
    ``MASTER_RETRY``, ``PSERVER_RETRY``, ``DOWNLOAD_RETRY``,
    ``REGISTRY_RETRY`` — RegistryClient heartbeat/resolve roundtrips —
    and ``CLUSTER_RETRY`` — ClusterClient view roundtrips; the bare
    ``RETRY`` prefix is the cross-subsystem fallback).
  * `FaultInjector` — process-local chaos hooks compiled into the hot
    paths (no-ops when no rules are armed).  Call sites `fire(site)` to
    give the injector a chance to drop the connection / delay, or
    `mangle(site, data)` to let it truncate/corrupt outgoing bytes.
    Rules come from test code (`fault_injector().inject(...)`) or from
    the ``PADDLE_TPU_FAULTS`` environment variable, so chaos runs work
    on unmodified entry points.

Injection site wired in this package: serving.decode (inside every
GenerationServer tick).  The rule syntax and env var are the JAX
package's, so one chaos spec drives both.
"""
from __future__ import annotations

import fnmatch
import logging
import os
import random
import threading
import time
from typing import Callable, Dict, List, Optional

from ..observability import metrics as obs_metrics

# retries and injected faults used to be invisible until a policy
# exhausted — every retry, backoff sleep and fired fault now emits a
# structured warning here (configure/silence via the standard logging
# tree) and counts in the process metrics registry
_LOG = logging.getLogger("paddle_tpu.resilience")

_M_RETRY_ATTEMPTS = obs_metrics.counter(
    "paddle_tpu_resilience_retry_attempts_total",
    "failed attempts recorded by retry policies")
_M_BACKOFF_SECONDS = obs_metrics.counter(
    "paddle_tpu_resilience_backoff_seconds_total",
    "seconds slept in retry backoff")
_M_EXHAUSTED = obs_metrics.counter(
    "paddle_tpu_resilience_retries_exhausted_total",
    "RetryError raises (attempt/deadline budget exhausted)")
_M_FAULTS = obs_metrics.counter(
    "paddle_tpu_resilience_faults_fired_total",
    "chaos faults fired, by injection site and kind",
    ("site", "kind"))

__all__ = [
    "RetryPolicy",
    "RetryState",
    "RetryError",
    "FaultInjector",
    "FaultRule",
    "FaultError",
    "fault_injector",
    "sched_fault_armed",
]


# ---------------------------------------------------------------------------
# retry / backoff
# ---------------------------------------------------------------------------


class RetryError(OSError):
    """A RetryPolicy ran out of attempts or deadline.  Subclasses OSError
    so existing `except OSError` handlers around networked calls keep
    working; the message always carries attempt count and elapsed time."""

    def __init__(self, what: str, attempts: int, elapsed: float,
                 last_error: Optional[BaseException] = None):
        self.attempts = attempts
        self.elapsed = elapsed
        self.last_error = last_error
        detail = f": {type(last_error).__name__}: {last_error}" \
            if last_error is not None else ""
        super().__init__(
            f"{what} (gave up after {attempts} attempt"
            f"{'s' if attempts != 1 else ''} over {elapsed:.2f}s{detail})")
        _M_EXHAUSTED.inc()
        _LOG.warning("retry exhausted: %s", self)


class RetryPolicy:
    """Exponential backoff + jitter + overall deadline.

    delay(n) = min(max_delay, base_delay * multiplier**(n-1)), scaled by
    a uniform jitter factor in [1-jitter, 1+jitter].  A call sequence
    stops at `max_attempts` attempts or when `deadline` seconds have
    elapsed since the first attempt, whichever comes first; either is
    disabled by passing None.

    `sleep`/`clock`/`rng` are injectable for deterministic tests.
    """

    _ENV_FIELDS = ("max_attempts", "base_delay", "max_delay", "multiplier",
                   "jitter", "deadline")

    def __init__(self, max_attempts: Optional[int] = 8,
                 base_delay: float = 0.2, max_delay: float = 5.0,
                 multiplier: float = 2.0, jitter: float = 0.25,
                 deadline: Optional[float] = 60.0,
                 sleep: Callable[[float], None] = time.sleep,
                 clock: Callable[[], float] = time.monotonic,
                 rng: Optional[random.Random] = None):
        if max_attempts is not None and max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {max_attempts}")
        self.max_attempts = max_attempts
        self.base_delay = float(base_delay)
        self.max_delay = float(max_delay)
        self.multiplier = float(multiplier)
        self.jitter = float(jitter)
        self.deadline = deadline
        self._sleep = sleep
        self._clock = clock
        self._rng = rng or random.Random()

    @classmethod
    def from_env(cls, prefix: str = "RETRY", **defaults) -> "RetryPolicy":
        """Build a policy whose knobs read ``PADDLE_TPU_<prefix>_<KNOB>``
        env vars, falling back to ``PADDLE_TPU_RETRY_<KNOB>`` and then to
        the passed/ctor defaults.  "none"/"inf" disable max_attempts or
        deadline."""
        kw = dict(defaults)
        for field in cls._ENV_FIELDS:
            for p in (prefix, "RETRY"):
                raw = os.environ.get(f"PADDLE_TPU_{p}_{field.upper()}")
                if raw is None or not raw.strip():
                    continue  # unset/empty: fall through, keep defaults
                raw = raw.strip()
                if raw.lower() in ("none", "inf"):
                    # only the cap-style knobs are disableable; "none" on
                    # e.g. MULTIPLIER keeps the default rather than
                    # poisoning the constructor with a None float
                    if field in ("max_attempts", "deadline"):
                        kw[field] = None
                elif field == "max_attempts":
                    kw[field] = int(raw)
                else:
                    kw[field] = float(raw)
                break
        return cls(**kw)

    def delay(self, attempt: int) -> float:
        """Backoff before attempt `attempt`+1 (attempt counts from 1)."""
        d = min(self.max_delay,
                self.base_delay * self.multiplier ** (attempt - 1))
        if self.jitter:
            d *= 1.0 + self._rng.uniform(-self.jitter, self.jitter)
        return max(d, 0.0)

    def begin(self) -> "RetryState":
        return RetryState(self)

    def call(self, fn: Callable, retry_on=(OSError,),
             what: str = "operation failed"):
        """Run `fn()` until it returns; exceptions in `retry_on` back off
        and retry, anything else propagates.  Raises RetryError (chained
        to the last error) when the policy is exhausted."""
        state = self.begin()
        while True:
            try:
                return fn()
            except retry_on as e:
                state.record(e, what=what)
                state.sleep()


class RetryState:
    """One retry sequence: tracks attempts + elapsed, raises RetryError
    on exhaustion.  Usage:

        state = policy.begin()
        while True:
            try:
                return do_io()
            except OSError as e:
                state.record(e, what="master at host:port unreachable")
                state.sleep()
    """

    def __init__(self, policy: RetryPolicy):
        self.policy = policy
        self.attempts = 0
        self._start = policy._clock()
        self._next_delay = 0.0

    @property
    def elapsed(self) -> float:
        return self.policy._clock() - self._start

    def record(self, err: Optional[BaseException] = None,
               what: str = "operation failed"):
        """Count a failed attempt; raise RetryError when no budget is
        left for another one."""
        self.attempts += 1
        _M_RETRY_ATTEMPTS.inc()
        p = self.policy
        delay = p.delay(self.attempts)
        exhausted = (p.max_attempts is not None
                     and self.attempts >= p.max_attempts)
        if not exhausted and p.deadline is not None:
            exhausted = self.elapsed + delay >= p.deadline
        if exhausted:
            raise RetryError(what, self.attempts, self.elapsed,
                             last_error=err) from err
        _LOG.warning(
            "%s — attempt %d failed (%s: %s), retrying in %.2fs "
            "(%.2fs elapsed)", what, self.attempts,
            type(err).__name__ if err is not None else "error", err,
            delay, self.elapsed)
        self._next_delay = delay

    def sleep(self):
        if self._next_delay > 0:
            _M_BACKOFF_SECONDS.inc(self._next_delay)
            self.policy._sleep(self._next_delay)
        self._next_delay = 0.0


# ---------------------------------------------------------------------------
# fault injection
# ---------------------------------------------------------------------------


class FaultError(ConnectionError):
    """Raised by an armed `error` rule — a stand-in for the peer dying
    mid-call.  Subclasses ConnectionError so production retry/reconnect
    paths treat it exactly like a real network failure."""


class FaultRule:
    """One armed fault: fires at calls nth..nth+count-1 of `site`.

    kinds:
      error     fire() raises `exc` (default FaultError) — models a
                dropped connection / dead peer
      delay     fire() sleeps `delay_s` — models a stall
      truncate  mangle() returns a prefix of the data (`arg` bytes, or
                half the frame) — models a mid-write crash
      corrupt   mangle() flips bytes starting at offset `arg` (default
                middle) — models wire/disk corruption
    """

    KINDS = ("error", "delay", "truncate", "corrupt")

    def __init__(self, site: str, kind: str = "error", nth: int = 1,
                 count: int = 1, delay_s: float = 0.0,
                 exc: Optional[BaseException] = None,
                 arg: Optional[int] = None):
        if kind not in self.KINDS:
            raise ValueError(f"fault kind {kind!r}: expected {self.KINDS}")
        if nth < 1:
            raise ValueError(f"nth counts from 1, got {nth}")
        self.site = site
        self.kind = kind
        self.nth = nth
        self.count = count
        self.delay_s = delay_s
        self.exc = exc
        self.arg = arg
        self.fired = 0

    def _matches(self, site: str, call_no: int) -> bool:
        return (fnmatch.fnmatchcase(site, self.site)
                and self.nth <= call_no < self.nth + self.count)

    def __repr__(self):
        return (f"FaultRule({self.site!r}, {self.kind!r}, nth={self.nth}, "
                f"count={self.count}, fired={self.fired})")


class FaultInjector:
    """Process-local chaos hooks.  Disabled (zero-cost fast path) until a
    rule is armed via `inject()` or the ``PADDLE_TPU_FAULTS`` env var:

        PADDLE_TPU_FAULTS="master.connect:error:1,pserver.send:truncate:2"

    i.e. comma-separated ``site:kind[:nth[:count]]`` specs (site may be
    an fnmatch pattern).  Call counters are per site name and
    thread-safe."""

    def __init__(self):
        self._rules: List[FaultRule] = []
        self._calls: Dict[str, int] = {}
        self._lock = threading.Lock()
        # rate limiter for the fired-fault log line + eager flight
        # dump: a high-frequency rule (e.g. a per-decode-tick delay
        # simulating a slow accelerator) must not hose the disk or the
        # log — the metric counter still counts every firing
        self._last_note: Dict[tuple, float] = {}

    # -- configuration ------------------------------------------------------
    def inject(self, site: str, kind: str = "error", nth: int = 1,
               count: int = 1, delay_s: float = 0.0,
               exc: Optional[BaseException] = None,
               arg: Optional[int] = None) -> FaultRule:
        rule = FaultRule(site, kind, nth, count, delay_s, exc, arg)
        with self._lock:
            self._rules.append(rule)
        return rule

    def clear(self):
        """Drop all rules and reset call counters."""
        with self._lock:
            self._rules = []
            self._calls = {}
            self._last_note = {}

    def rules(self) -> List[FaultRule]:
        with self._lock:
            return list(self._rules)

    def load_env(self, spec: Optional[str] = None):
        """Arm rules from a ``PADDLE_TPU_FAULTS``-style spec string:
        comma-separated ``site:kind[:nth[:count[:arg]]]`` entries.  The
        trailing arg is the stall seconds for ``delay`` rules and the
        byte position/length for ``truncate``/``corrupt`` (a
        delay armed without seconds would be a silent no-op, so it is
        rejected)."""
        spec = spec if spec is not None else os.environ.get(
            "PADDLE_TPU_FAULTS", "")
        for part in filter(None, (p.strip() for p in spec.split(","))):
            fields = part.split(":")
            if len(fields) < 2:
                raise ValueError(
                    f"PADDLE_TPU_FAULTS entry {part!r}: expected "
                    "site:kind[:nth[:count[:arg]]]")
            site, kind = fields[0], fields[1]
            nth = int(fields[2]) if len(fields) > 2 else 1
            count = int(fields[3]) if len(fields) > 3 else 1
            arg = fields[4] if len(fields) > 4 else None
            if kind == "delay":
                if arg is None:
                    raise ValueError(
                        f"PADDLE_TPU_FAULTS entry {part!r}: delay needs "
                        "its seconds as the 5th field "
                        "(site:delay:nth:count:seconds)")
                self.inject(site, kind, nth=nth, count=count,
                            delay_s=float(arg))
            else:
                self.inject(site, kind, nth=nth, count=count,
                            arg=int(arg) if arg is not None else None)

    # -- hot-path hooks -----------------------------------------------------
    def _next_call(self, site: str) -> int:
        with self._lock:
            n = self._calls.get(site, 0) + 1
            self._calls[site] = n
            return n

    def _active_rule(self, site: str, kinds) -> Optional[FaultRule]:
        call_no = self._next_call(site)
        with self._lock:
            for rule in self._rules:
                if rule.kind in kinds and rule._matches(site, call_no):
                    rule.fired += 1
                    return rule
        return None

    def _note_fired(self, site: str, rule: FaultRule):
        _M_FAULTS.labels(site=site, kind=rule.kind).inc()
        now = time.monotonic()
        with self._lock:
            last = self._last_note.get((site, rule.kind), float("-inf"))
            if now - last < 1.0:
                return  # noted within the last second: count only
            self._last_note[(site, rule.kind)] = now
        _LOG.warning("fault injected at %s: kind=%s (rule %r)",
                     site, rule.kind, rule)
        try:
            # the moment a fault fires is the window a post-mortem
            # wants: dump the flight ring now (a no-op when none is
            # armed), with the trace active at the site
            from ..observability import flightrecorder, tracing
            flightrecorder.on_fault(site, rule.kind,
                                    trace_id=tracing.current_trace_id())
        except Exception as e:  # must not mask the fault being raised
            _LOG.debug("flight-recorder fault dump failed: %r", e)

    def fire(self, site: str):
        """Give error/delay rules a shot at this call site."""
        if not self._rules:
            return
        rule = self._active_rule(site, ("error", "delay"))
        if rule is None:
            return
        self._note_fired(site, rule)
        if rule.kind == "delay":
            time.sleep(rule.delay_s)
        else:
            raise rule.exc if rule.exc is not None else FaultError(
                f"fault injected at {site} "
                f"(call {self._calls.get(site)})")

    def mangle(self, site: str, data: bytes) -> bytes:
        """Give truncate/corrupt rules a shot at outgoing bytes; returns
        the (possibly modified) data.  Callers compare lengths/identity
        to decide whether to fail the connection afterwards."""
        if not self._rules:
            return data
        rule = self._active_rule(site, ("truncate", "corrupt"))
        if rule is None or not data:
            return data
        self._note_fired(site, rule)
        if rule.kind == "truncate":
            cut = rule.arg if rule.arg is not None else max(len(data) // 2, 1)
            return data[:min(cut, len(data) - 1)]
        off = rule.arg if rule.arg is not None else len(data) // 2
        off = min(off, len(data) - 1)
        return data[:off] + bytes([data[off] ^ 0xFF]) + data[off + 1:]


_INJECTOR: Optional[FaultInjector] = None
_INJECTOR_LOCK = threading.Lock()


def fault_injector() -> FaultInjector:
    """The process-wide injector (rules from PADDLE_TPU_FAULTS are armed
    on first access)."""
    global _INJECTOR
    if _INJECTOR is None:
        with _INJECTOR_LOCK:
            if _INJECTOR is None:
                inj = FaultInjector()
                inj.load_env()
                _INJECTOR = inj
    return _INJECTOR


def sched_fault_armed(name: str) -> bool:
    """Schedule-checker regression-pin hook: True only inside a test
    that reintroduces a historical race via
    analysis.schedcheck.arm_fault (docs/analysis.md "Schedule
    checking").  Guarded lazy import so runtime modules (serving) never
    pay for — or cycle on — the analysis package."""
    try:
        from ..analysis.schedcheck import fault_armed
    except Exception:
        return False
    return fault_armed(name)
