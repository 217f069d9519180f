"""Signal-driven autoscaler for the serving fleet: the elastic runtime
meets the router (counterpart of paddle_tpu/cloud/autoscaler.py).

Membership has a TTL-lease registry, serving has a `ReplicaRouter`
front door, and the router keeps windowed p99/qps/backlog series
(`router.signals()`).  This module closes the
loop: a controller that watches those signals and grows or shrinks the
`cli serve` replica fleet itself —

* **scale-out** — sustained backlog (reserved-token queue) or p99 burn
  above target spawns one replica against the router's lease registry.
  The cold-start enabler is the WARM-START artifact
  (serving.save_generation_model(warm_start=True)): the new process
  points PADDLE_TPU_COMPILATION_CACHE_DIR at the model dir's
  ``kernel_cache`` and loads the CUDA kernels built there instead of
  running nvcc, so time-to-first-token is bounded by model load, not
  the kernels' build;
* **scale-in** — sustained idle retires one replica via graceful
  drain: mark it draining at the router (no new placements), send the
  replica `drain` verb (stop admission, finish every accepted stream —
  the router's one-at-a-time swap machinery), then release it (SIGTERM for
  replicas this process spawned — `cli serve` exits gracefully,
  releasing its lease first — or the wire `stop` op for adopted ones);
* **robustness is the headline, not the policy**:
  - hysteresis + sustain windows + cooldown: a noisy signal that
    oscillates across a threshold keeps resetting the sustain clock
    and can never flap the fleet (test-pinned);
  - a min/max replica band the fleet can never leave;
  - the at-least-one-replica invariant holds even when scale-in races
    a SIGKILL: survivors are re-counted AFTER the victim drained, and
    if the fleet shrank in the meantime the victim is resumed instead
    of retired;
  - a crash-looping replica (spawned process dies before it ever
    serves, `crash_loop_limit` times in a row) trips exponential
    backoff and the ``paddle_tpu_autoscaler_crashloops_total`` alert
    counter (tools/slo.json gates it);
  - chaos sites ``autoscaler.spawn`` / ``autoscaler.drain`` run
    through the FaultInjector: an injected error aborts that
    action cleanly (resumed victim, counted spawn failure), never the
    control loop.

Surfaces: embed ``Autoscaler(router, launcher)`` next to your
ReplicaRouter, or run ``python -m paddle_tpu_torch.cli autoscale MODEL_DIR``
as the operator front door.  docs/serving.md "Autoscaling" has the
runbook and knob table.
"""
from __future__ import annotations

import itertools
import logging
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional

from paddle_tpu_torch.core.resilience import fault_injector
from paddle_tpu_torch.observability import metrics as obs_metrics
from paddle_tpu_torch.serving.replica import replica_call

__all__ = ["AutoscalerPolicy", "Autoscaler",
           "SubprocessReplicaLauncher", "ReplicaProcess"]

_LOG = logging.getLogger("paddle_tpu_torch.autoscaler")

_SCALER_IDS = itertools.count()
_M_LIVE = obs_metrics.gauge(
    "paddle_tpu_autoscaler_replicas_live",
    "serving replicas live and routable (draining excluded)",
    ("scaler",), always=True)
_M_DESIRED = obs_metrics.gauge(
    "paddle_tpu_autoscaler_replicas_desired",
    "replica count the autoscaler is currently steering toward",
    ("scaler",), always=True)
_M_EVENTS = obs_metrics.counter(
    "paddle_tpu_autoscaler_scale_events_total",
    "completed scale actions by direction (out/in)",
    ("scaler", "direction"), always=True)
_M_ABORTS = obs_metrics.counter(
    "paddle_tpu_autoscaler_scale_aborts_total",
    "scale actions aborted mid-flight (invariant re-check, injected "
    "fault, victim death)", ("scaler",), always=True)
_M_CRASHLOOPS = obs_metrics.counter(
    "paddle_tpu_autoscaler_crashloops_total",
    "crash-loop detections: a spawned replica died before first "
    "serving, crash_loop_limit times in a row (backoff armed)",
    ("scaler",), always=True)
_M_SPAWN_FAILS = obs_metrics.counter(
    "paddle_tpu_autoscaler_spawn_failures_total",
    "replica spawns that never became live", ("scaler",), always=True)
_M_SPAWN_S = obs_metrics.histogram(
    "paddle_tpu_autoscaler_spawn_seconds",
    "spawn -> live-in-the-routing-table latency (the cold-start cost "
    "the warm-start artifact bounds)", ("scaler",), always=True)


# ---------------------------------------------------------------------------
# policy: pure decision logic (unit-testable with synthetic signals)
# ---------------------------------------------------------------------------


def _num(v, default=None):
    """None/NaN-tolerant float: windowed quantiles are NaN before
    traffic and gauges are None before their first sample."""
    if v is None:
        return default
    try:
        f = float(v)
    except (TypeError, ValueError):
        return default
    if f != f:  # NaN
        return default
    return f


class AutoscalerPolicy:
    """Hysteresis + sustain + cooldown over the router's windowed
    signals.  `observe(signals, live, now)` returns +1 (scale out),
    -1 (scale in) or 0; the caller reports back with
    `record_action(now)` when an action COMPLETES so the cooldown
    window starts from completion, not decision.

    Three signal zones make the hysteresis explicit:

    * HOT    — backlog > `backlog_high` or p99 > `p99_high_s`;
    * COLD   — backlog <= `backlog_low` and p99 <= `p99_low_s` (or no
               latency data at all: an idle fleet has no p99);
    * middle — the hysteresis band: both sustain clocks RESET, so a
      signal oscillating across either threshold can never accumulate
      the sustain a scale action requires (no flapping, test-pinned).

    HOT must hold continuously for `sustain_s` to scale out; COLD for
    `idle_sustain_s` (deliberately longer: growing late queues
    requests, shrinking early thrashes) to scale in; and any action
    starts a `cooldown_s` refractory window."""

    def __init__(self, min_replicas: int = 1, max_replicas: int = 4, *,
                 p99_high_s: float = 2.0,
                 p99_low_s: Optional[float] = None,
                 backlog_high: float = 512.0,
                 backlog_low: float = 32.0,
                 sustain_s: float = 3.0,
                 idle_sustain_s: float = 10.0,
                 cooldown_s: float = 15.0):
        if min_replicas < 1:
            raise ValueError("min_replicas must be >= 1 (the fleet "
                             "never scales to zero)")
        if max_replicas < min_replicas:
            raise ValueError("max_replicas < min_replicas")
        if backlog_low >= backlog_high:
            raise ValueError(
                "hysteresis needs backlog_low < backlog_high "
                f"(got {backlog_low} >= {backlog_high})")
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.p99_high_s = float(p99_high_s)
        self.p99_low_s = (float(p99_low_s) if p99_low_s is not None
                          else float(p99_high_s) / 4.0)
        if self.p99_low_s > self.p99_high_s:
            raise ValueError("p99_low_s > p99_high_s")
        self.backlog_high = float(backlog_high)
        self.backlog_low = float(backlog_low)
        self.sustain_s = float(sustain_s)
        self.idle_sustain_s = float(idle_sustain_s)
        self.cooldown_s = float(cooldown_s)
        self._hot_since: Optional[float] = None
        self._cold_since: Optional[float] = None
        self._cooldown_until = float("-inf")
        self.last_reason = "no signal yet"

    # -- zone classification ------------------------------------------------
    def is_hot(self, signals: Dict) -> bool:
        backlog = _num(signals.get("outstanding_tokens"), 0.0)
        p99 = _num(signals.get("p99"))
        return (backlog > self.backlog_high
                or (p99 is not None and p99 > self.p99_high_s))

    def is_cold(self, signals: Dict) -> bool:
        backlog = _num(signals.get("outstanding_tokens"), 0.0)
        p99 = _num(signals.get("p99"))
        return (backlog <= self.backlog_low
                and (p99 is None or p99 <= self.p99_low_s))

    # -- the decision -------------------------------------------------------
    def observe(self, signals: Dict, live: int, now: float) -> int:
        hot, cold = self.is_hot(signals), self.is_cold(signals)
        if hot:
            self._cold_since = None
            if self._hot_since is None:
                self._hot_since = now
        elif cold:
            self._hot_since = None
            if self._cold_since is None:
                self._cold_since = now
        else:
            # the hysteresis band: reset BOTH clocks — this is what
            # pins a noisy signal to zero scale events
            self._hot_since = None
            self._cold_since = None
            self.last_reason = "in hysteresis band"
            return 0
        if now < self._cooldown_until:
            self.last_reason = (f"cooldown "
                                f"({self._cooldown_until - now:.1f}s "
                                "left)")
            return 0
        if hot and now - self._hot_since >= self.sustain_s:
            if live >= self.max_replicas:
                self.last_reason = (f"hot but at max_replicas="
                                    f"{self.max_replicas}")
                return 0
            self.last_reason = (
                f"hot for {now - self._hot_since:.1f}s (backlog "
                f"{_num(signals.get('outstanding_tokens'), 0.0):.0f}"
                f" / p99 {_num(signals.get('p99'), float('nan')):.3g})")
            return +1
        if cold and now - self._cold_since >= self.idle_sustain_s:
            if live <= self.min_replicas:
                self.last_reason = (f"cold but at min_replicas="
                                    f"{self.min_replicas}")
                return 0
            self.last_reason = (
                f"cold for {now - self._cold_since:.1f}s")
            return -1
        self.last_reason = ("sustaining "
                            + ("hot" if hot else "cold"))
        return 0

    def record_action(self, now: float) -> None:
        """An action COMPLETED: arm the cooldown and reset the sustain
        clocks (the fleet changed, old evidence is stale)."""
        self._hot_since = None
        self._cold_since = None
        self._cooldown_until = now + self.cooldown_s


# ---------------------------------------------------------------------------
# replica process handles
# ---------------------------------------------------------------------------


class ReplicaProcess:
    """One spawned `cli serve` process: the Popen handle plus a stdout
    reader that learns the replica's address from its
    "serving <dir> on <addr>" banner.  Fake handles in tests implement
    the same alive()/terminate()/kill()/addr surface."""

    def __init__(self, proc: subprocess.Popen):
        self.proc = proc
        self.pid = proc.pid
        self.addr: Optional[str] = None
        if proc.stdout is not None:
            t = threading.Thread(target=self._read_banner, daemon=True)
            t.start()

    def _read_banner(self):
        try:
            for line in self.proc.stdout:
                # "serving MODEL_DIR on HOST:PORT[, ...]" — split on
                # the LAST " on " so a model dir containing spaces (or
                # even " on ") still yields the address, never a path
                # fragment that would make _check_pending kill a
                # healthy replica at spawn_timeout
                if line.startswith("serving ") and " on " in line:
                    tail = line.rsplit(" on ", 1)[1].split()
                    if tail:
                        self.addr = tail[0].rstrip(",")
                # keep draining so the child never blocks on a full
                # stdout pipe
        except (OSError, ValueError):
            pass

    def alive(self) -> bool:
        return self.proc.poll() is None

    def terminate(self) -> None:
        """SIGTERM: `cli serve` arms the graceful chain (drain ->
        release lease -> delist telemetry -> flight dump -> exit)."""
        if self.alive():
            self.proc.terminate()

    def kill(self) -> None:
        if self.alive():
            self.proc.kill()

    def wait(self, timeout: Optional[float] = None):
        return self.proc.wait(timeout=timeout)


class SubprocessReplicaLauncher:
    """Spawns `python -m paddle_tpu_torch.cli serve MODEL_DIR --registry
    ...` replicas.  The model dir's warm-start artifact (if shipped) is
    picked up by `cli serve` itself — nothing to configure here.
    `use_gpu=1` serves on CUDAPlace(0), 0 on the CPU."""

    def __init__(self, model_dir: str, registry_addr: str, *,
                 use_gpu: int = 1, ttl_s: float = 2.0,
                 drain_grace_s: float = 30.0,
                 extra_args: Optional[List[str]] = None,
                 env: Optional[Dict[str, str]] = None,
                 stderr=subprocess.DEVNULL):
        self.model_dir = model_dir
        self.registry_addr = registry_addr
        self.use_gpu = int(use_gpu)
        self.ttl_s = float(ttl_s)
        self.drain_grace_s = float(drain_grace_s)
        self.extra_args = list(extra_args or ())
        self.env = env
        self.stderr = stderr

    def spawn(self) -> ReplicaProcess:
        cmd = [sys.executable, "-m", "paddle_tpu_torch.cli", "serve",
               self.model_dir, "--registry", self.registry_addr,
               "--use_gpu", str(self.use_gpu),
               "--ttl", str(self.ttl_s),
               "--drain_grace", str(self.drain_grace_s)]
        cmd += self.extra_args
        proc = subprocess.Popen(
            cmd, env=self.env, text=True, stdout=subprocess.PIPE,
            stderr=self.stderr)
        return ReplicaProcess(proc)


# ---------------------------------------------------------------------------
# the controller
# ---------------------------------------------------------------------------


class Autoscaler:
    """The scaling control loop beside one ReplicaRouter.

    `poll()` runs one evaluation step (what tests drive directly);
    `start()` runs it on a daemon thread every `poll_s`.  Spawns are
    tracked asynchronously (the loop keeps evaluating while a replica
    boots); scale-ins run synchronously inside poll (a drain SHOULD
    pause further decisions).  `ensure_min()` brings a fresh fleet up
    to the policy's floor."""

    def __init__(self, router, launcher,
                 policy: Optional[AutoscalerPolicy] = None,
                 *, poll_s: float = 0.5, window_s: float = 15.0,
                 spawn_timeout_s: float = 300.0,
                 crash_loop_limit: int = 3,
                 crash_backoff_s: float = 30.0,
                 crash_backoff_max_s: float = 600.0,
                 drain_grace_s: float = 30.0):
        self.router = router
        self.launcher = launcher
        self.policy = policy or AutoscalerPolicy()
        self.poll_s = float(poll_s)
        self.window_s = float(window_s)
        self.spawn_timeout_s = float(spawn_timeout_s)
        self.crash_loop_limit = int(crash_loop_limit)
        self.crash_backoff_s = float(crash_backoff_s)
        self.crash_backoff_max_s = float(crash_backoff_max_s)
        self.drain_grace_s = float(drain_grace_s)
        self._pending: List[tuple] = []   # (handle, t0, live_before)
        self._owned: Dict[str, ReplicaProcess] = {}
        self._unplaced: List[ReplicaProcess] = []  # live, addr unknown
        self._crash_streak = 0
        self._crashloops = 0
        self._backoff_until = float("-inf")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.RLock()
        self.last_event = "idle"
        self.events: List[str] = []
        sid = self._sid = str(next(_SCALER_IDS))
        self._m_live = _M_LIVE.labels(scaler=sid)
        self._m_desired = _M_DESIRED.labels(scaler=sid)
        self._m_out = _M_EVENTS.labels(scaler=sid, direction="out")
        self._m_in = _M_EVENTS.labels(scaler=sid, direction="in")
        self._m_aborts = _M_ABORTS.labels(scaler=sid)
        self._m_crashloops = _M_CRASHLOOPS.labels(scaler=sid)
        self._m_spawn_fails = _M_SPAWN_FAILS.labels(scaler=sid)
        self._m_spawn_s = _M_SPAWN_S.labels(scaler=sid)
        # start the router's sampler now so windowed signals exist by
        # the first decision
        self.router.watch()

    # -- bookkeeping --------------------------------------------------------
    def _note(self, what: str) -> None:
        self.last_event = what
        self.events.append(what)
        del self.events[:-200]
        _LOG.info("autoscaler: %s", what)
        try:
            from paddle_tpu_torch.observability import flightrecorder

            flightrecorder.note("autoscaler", what=what)
        except Exception as e:  # the ring must never break scaling
            _LOG.debug("flight note failed: %r", e)

    def _live(self) -> List[str]:
        return self.router.live_replicas(include_draining=False)

    def _adopt_addrs(self) -> None:
        """Map spawned handles to their registry addresses once the
        banner (or membership) reveals them, so scale-in can SIGTERM a
        process it owns instead of using the wire stop."""
        with self._lock:
            for h in list(self._unplaced):
                if h.addr:
                    self._owned[h.addr] = h
                    self._unplaced.remove(h)
                elif not h.alive():
                    self._unplaced.remove(h)
            # reap owned replicas that died under us (SIGKILL chaos):
            # the process entry is collected and the address forgotten
            # so a later scale-in never tries to drain a corpse
            for addr, h in list(self._owned.items()):
                if not h.alive():
                    try:
                        h.wait(timeout=0)
                    except Exception:
                        pass
                    del self._owned[addr]

    def owned_pids(self) -> Dict[str, int]:
        """{addr: pid} of live replicas this autoscaler spawned — what
        a chaos drill SIGKILLs."""
        self._adopt_addrs()
        with self._lock:
            return {a: h.pid for a, h in self._owned.items()
                    if h.alive()}

    # -- the loop -----------------------------------------------------------
    def start(self) -> "Autoscaler":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(target=self._run,
                                            daemon=True,
                                            name="paddle-autoscaler")
            self._thread.start()
        return self

    def _run(self):
        while not self._stop.wait(self.poll_s):
            try:
                self.poll()
            except Exception as e:
                # one bad poll (registry hiccup, replica race) must
                # never kill the control loop
                _LOG.warning("autoscaler poll failed: %r", e)

    def poll(self, now: Optional[float] = None) -> int:
        """One control step; returns the direction acted on (+1/-1/0).
        Deterministic under an injected `now` for tests."""
        now = time.monotonic() if now is None else now
        self._adopt_addrs()
        # ONE forced registry re-list per step; every other view in
        # this poll reads the same listing (refresh=False) instead of
        # multiplying registry round-trips 4-8x per second
        listing = set(self.router.live_replicas())
        self._check_pending(now, listing)
        live = self.router.live_replicas(include_draining=False,
                                         refresh=False)
        self._m_live.set(len(live))
        with self._lock:
            pending = bool(self._pending)
        if pending:
            return 0  # a boot in flight: judge it before acting again
        if now < self._backoff_until:
            return 0  # crash-loop backoff window
        # the min-replica FLOOR is enforced here, not by the policy:
        # a replica dying outside a scale-in (OOM kill, hardware)
        # leaves a fleet whose signals look COLD (no traffic moves, so
        # no backlog and no p99), and the policy would idle at zero
        # forever.  Cooldown does not apply — restoring the floor is
        # repair, not scaling — but crash-loop backoff (above) does:
        # respawning a crash-looper in a tight loop is what the
        # detector exists to stop.
        if len(live) < self.policy.min_replicas:
            return (+1 if self._spawn(
                now, reason=f"below min_replicas="
                f"{self.policy.min_replicas} floor",
                live_before=listing) else 0)
        signals = self.router.signals(self.window_s)
        decision = self.policy.observe(signals, len(live), now)
        if decision > 0:
            return +1 if self._spawn(
                now, reason=self.policy.last_reason,
                live_before=listing) else 0
        if decision < 0:
            return -1 if self._scale_in(now, live) else 0
        return 0

    # -- spawn path ---------------------------------------------------------
    def ensure_min(self, timeout_s: Optional[float] = None) -> int:
        """Spawn until the fleet reaches the policy floor; with
        `timeout_s`, block until the spawned replicas are live (the
        cold-boot path of `cli autoscale`).  Returns how many were
        spawned."""
        n = 0
        live = self._live()
        while True:
            with self._lock:
                short = (len(live) + len(self._pending)
                         < self.policy.min_replicas)
            if not short:
                break
            if not self._spawn(time.monotonic(),
                               reason="ensure_min"):
                break
            n += 1
        if timeout_s is not None:
            deadline = time.monotonic() + timeout_s
            while time.monotonic() < deadline:
                with self._lock:
                    if not self._pending:
                        break
                time.sleep(min(self.poll_s, 0.1))
                self._adopt_addrs()
                self._check_pending(time.monotonic())
        return n

    def _spawn(self, now: float, reason: str,
               live_before: Optional[set] = None) -> bool:
        try:
            fault_injector().fire("autoscaler.spawn")
        except Exception as e:
            self._spawn_failed(now, f"injected fault: {e!r}")
            return False
        if live_before is None:
            live_before = set(self.router.live_replicas())
        try:
            handle = self.launcher.spawn()
        except Exception as e:
            self._spawn_failed(now, f"launcher failed: {e!r}")
            return False
        with self._lock:
            self._pending.append((handle, now, live_before))
            self._m_desired.set(len(live_before) + len(self._pending))
        self._note(f"scale-out: spawning replica ({reason})")
        return True

    def _check_pending(self, now: float,
                       live: Optional[set] = None) -> None:
        with self._lock:
            if not self._pending:
                return
        if live is None:
            live = set(self.router.live_replicas())  # outside the lock
        with self._lock:
            entries = list(self._pending)
        credited: set = set()  # new members already matched this pass
        # members claimed by a sibling's BANNER address are never up
        # for fuzzy grabs either, regardless of processing order
        known = {h.addr for h, _, _ in entries if h.addr}
        for entry in entries:
            handle, t0, before = entry
            if handle.addr:
                joined = handle.addr in live
                if joined:
                    credited.add(handle.addr)
            else:
                # fuzzy pre-banner match: only a LIVE process may claim
                # a new registry member, and each member is credited to
                # at most one pending — a sibling's join must not
                # absorb a dead or still-booting spawn (that would
                # reset the crash streak and hide a crash-looping
                # replica behind its healthy neighbour)
                fresh = live - before - credited - known
                joined = bool(fresh) and handle.alive()
                if joined:
                    credited.add(sorted(fresh)[0])
            with self._lock:
                if entry not in self._pending:
                    continue  # a concurrent check already judged it
                if joined or not handle.alive() \
                        or now - t0 > self.spawn_timeout_s:
                    self._pending.remove(entry)
                else:
                    continue
                if joined:
                    if handle.addr:
                        self._owned[handle.addr] = handle
                    else:
                        self._unplaced.append(handle)
                    self._crash_streak = 0
            if joined:
                self._m_spawn_s.observe(now - t0)
                self._m_out.inc()
                self.policy.record_action(now)
                self._note(f"scale-out complete: replica "
                           f"{handle.addr or '?'} live after "
                           f"{now - t0:.1f}s")
            elif not handle.alive():
                self._spawn_failed(
                    now, f"replica pid {handle.pid} exited before "
                    "first serving")
            else:
                handle.kill()
                self._spawn_failed(
                    now, f"replica pid {handle.pid} not live within "
                    f"{self.spawn_timeout_s:.0f}s")

    def _spawn_failed(self, now: float, why: str) -> None:
        self._m_spawn_fails.inc()
        self._crash_streak += 1
        self.policy.record_action(now)  # failed boots also cool down
        if self._crash_streak >= self.crash_loop_limit:
            # crash loop: exponential backoff, alertable counter
            k = self._crash_streak - self.crash_loop_limit
            backoff = min(self.crash_backoff_s * (2 ** k),
                          self.crash_backoff_max_s)
            self._backoff_until = now + backoff
            self._crashloops += 1
            self._m_crashloops.inc()
            self._note(f"CRASH LOOP: {self._crash_streak} consecutive "
                       f"spawn failures ({why}); backing off "
                       f"{backoff:.0f}s")
        else:
            self._note(f"spawn failed ({self._crash_streak}/"
                       f"{self.crash_loop_limit}): {why}")

    # -- retire path --------------------------------------------------------
    def _pick_victim(self, live: List[str]) -> Optional[str]:
        """Least-outstanding live replica; prefer one we own (clean
        SIGTERM + reaped process) over an adopted one."""
        outstanding = self.router.stats()["replicas"]
        with self._lock:
            owned = set(self._owned)
        ranked = sorted(
            live, key=lambda a: (outstanding.get(a, 0),
                                 a not in owned))
        return ranked[0] if ranked else None

    def _scale_in(self, now: float, live: List[str]) -> bool:
        try:
            fault_injector().fire("autoscaler.drain")
        except Exception as e:
            self._m_aborts.inc()
            self._note(f"scale-in aborted (injected fault: {e!r})")
            return False
        victim = self._pick_victim(live)
        if victim is None:
            return False
        self.router.set_draining(victim, True)
        self._m_desired.set(max(len(live) - 1,
                                self.policy.min_replicas))
        self._note(f"scale-in: draining {victim} "
                   f"({self.policy.last_reason})")
        try:
            reply = replica_call(victim, {"op": "drain",
                                          "timeout": self.drain_grace_s},
                                 timeout_s=self.drain_grace_s + 10)
        except (OSError, ValueError) as e:
            # the victim died mid-drain: nothing left to retire — the
            # registry TTL reclaims it, the router resumes its streams
            self.router.set_draining(victim, False)
            self._m_aborts.inc()
            self._note(f"scale-in victim {victim} died mid-drain "
                       f"({e!r})")
            return False
        if not reply.get("drained"):
            # grace expired with accepted streams still running (or an
            # error reply): retiring now would cut them off mid-flight
            # — resume and try again when the replica is actually idle
            try:
                replica_call(victim, {"op": "resume"}, timeout_s=10)
            except (OSError, ValueError) as e:
                _LOG.warning("resume of %s failed: %r", victim, e)
            self.router.set_draining(victim, False)
            self._m_aborts.inc()
            self.policy.record_action(now)
            self._note(f"scale-in aborted: {victim} not drained "
                       f"within {self.drain_grace_s:.0f}s "
                       f"({reply.get('err', 'streams still active')})")
            return False
        # THE INVARIANT RE-CHECK: between the decision and the drain a
        # SIGKILL may have taken another replica.  Count the survivors
        # NOW — by PINGING them, not by trusting the registry: a
        # SIGKILLed replica stays listed until its lease TTL expires,
        # and counting that corpse would retire the victim into a
        # zero-replica fleet (test-pinned).  If retiring the (already
        # drained, still resumable) victim would leave the fleet below
        # the floor, resume it instead.
        survivors = []
        for a in self._live():
            if a == victim:
                continue
            try:
                if replica_call(a, {"op": "ping"},
                                timeout_s=5).get("ok"):
                    survivors.append(a)
            except (OSError, ValueError):
                continue  # dead or dying: not a survivor
        if len(survivors) < self.policy.min_replicas:
            try:
                replica_call(victim, {"op": "resume"}, timeout_s=10)
            except (OSError, ValueError) as e:
                _LOG.warning("resume of %s failed: %r", victim, e)
            self.router.set_draining(victim, False)
            self._m_aborts.inc()
            self.policy.record_action(now)
            self._note(
                f"scale-in aborted: only {len(survivors)} survivor(s) "
                f"left for min_replicas={self.policy.min_replicas} "
                "(a concurrent death raced the drain) — victim "
                "resumed")
            return False
        with self._lock:
            handle = self._owned.pop(victim, None)
        if handle is not None:
            handle.terminate()  # graceful: cli serve drains + delists
            try:
                handle.wait(timeout=self.drain_grace_s + 10)
            except Exception:
                handle.kill()
        else:
            try:
                replica_call(victim, {"op": "stop"}, timeout_s=10)
            except (OSError, ValueError):
                pass  # it stopped before replying: same outcome
        self.router.set_draining(victim, False)
        self._m_in.inc()
        self.policy.record_action(now)
        self._note(f"scale-in complete: {victim} retired")
        return True

    # -- introspection / lifecycle ------------------------------------------
    def status(self) -> Dict:
        live = self.router.live_replicas(include_draining=False)
        with self._lock:
            owned = sorted(self._owned)
            pending = len(self._pending)
            crash_streak = self._crash_streak
        return {
            "live": live,
            "pending_spawns": pending,
            "owned": owned,
            "crash_streak": crash_streak,
            "crashloops": self._crashloops,
            "backoff_s": max(0.0,
                             self._backoff_until - time.monotonic()),
            "min_replicas": self.policy.min_replicas,
            "max_replicas": self.policy.max_replicas,
            "last_event": self.last_event,
        }

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None and t is not threading.current_thread():
            t.join(timeout=self.poll_s + 5)

    def close(self, retire_owned: bool = False) -> None:
        """Stop the loop; with `retire_owned`, SIGTERM every replica
        this autoscaler spawned (the `cli autoscale` exit path)."""
        self.stop()
        with self._lock:
            owned = list(self._owned.values()) + self._unplaced
            pending = [h for h, _, _ in self._pending]
            self._owned.clear()
            self._unplaced = []
            self._pending = []
        if retire_owned:
            for h in owned + pending:
                try:
                    h.terminate()
                except Exception as e:
                    _LOG.debug("terminate failed: %r", e)
            for h in owned + pending:
                try:
                    h.wait(timeout=self.drain_grace_s + 10)
                except Exception:
                    try:
                        h.kill()
                    except Exception as e:
                        _LOG.debug("kill failed: %r", e)
        for fam in (_M_LIVE, _M_DESIRED, _M_ABORTS, _M_CRASHLOOPS,
                    _M_SPAWN_FAILS, _M_SPAWN_S):
            fam.remove(scaler=self._sid)
        for direction in ("out", "in"):
            _M_EVENTS.remove(scaler=self._sid, direction=direction)
