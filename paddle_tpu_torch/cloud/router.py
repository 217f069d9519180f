"""Multi-replica generation front door: discovery, placement, retry,
hot swap.

The cluster runtime (cloud/cluster.py) made TRAINING membership a
runtime property; this module does the same for SERVING.  Replicas
(serving/replica.ReplicaServer around one GenerationServer each)
register in the front door's TTL-lease registry under kind
"generation" — the same liveness machinery pservers use — and the
router:

* **discovers** the live replica set from the registry (a SIGKILLed
  replica's lease expires within one TTL and it drops out of the
  routing table; an explicit connection failure demotes it immediately
  instead of waiting out the TTL);
* **places** each request on the live replica with the LEAST
  outstanding tokens (prompt+max_new reserved at dispatch, released as
  tokens stream back) — queue-depth-aware load balancing, the
  Triton/TF-Serving instance-group idea applied across processes;
* **retries on replica death** through a RetryPolicy: decode is
  deterministic per (prompt, seed), so the survivor regenerates the
  same stream and the router resumes it with `skip` = tokens already
  delivered — the client sees no duplicate and no gap, just latency;
  policy sheds (deadline/saturation) are answers, never retried;
* **hot-swaps checkpoints with zero downtime**: replicas are swapped
  ONE AT A TIME (drain -> swap -> resume, serving/generation.py), and
  while one drains the router routes around it, so capacity dips by a
  single replica but availability never does.

Run `python -m paddle_tpu_torch.cli serve MODEL_DIR --registry HOST:PORT`
per replica and point ReplicaRouter at the same registry (or let the
router host it: ``ReplicaRouter(desired=N)`` + pass
``router.registry_addr`` to the replicas).  docs/serving.md has the
runbook.
"""
from __future__ import annotations

import itertools
import logging
import threading
import time
from typing import Dict, List, Optional

from paddle_tpu_torch.core.resilience import RetryPolicy
from paddle_tpu_torch.observability import metrics as obs_metrics
from paddle_tpu_torch.observability import tracing as obs_tracing
from paddle_tpu_torch.serving.batching import (RequestDeadlineExceeded,
                                               ServerSaturated)
from paddle_tpu_torch.serving.generation import GenerationStream
from paddle_tpu_torch.serving.replica import (ReplicaError, ReplicaShed,
                                              replica_call, replica_stream)

__all__ = ["ReplicaRouter", "NoReplicasAvailable"]

_LOG = logging.getLogger("paddle_tpu_torch.router")

# one label per router instance (like GenerationServer's `server`):
# a process that churns routers must not mix their stats or grow dumps
_ROUTER_IDS = itertools.count()
_M_REQUESTS = obs_metrics.counter(
    "paddle_tpu_serving_router_requests_total",
    "front-door requests by outcome (ok/shed/failed)",
    ("router", "outcome"), always=True)
_M_RETRIES = obs_metrics.counter(
    "paddle_tpu_serving_router_retries_total",
    "request re-dispatches after a replica failure", ("router",),
    always=True)
_M_LIVE = obs_metrics.gauge(
    "paddle_tpu_serving_router_replicas_live",
    "replicas currently in the routing table", ("router",))
_M_SWAPS = obs_metrics.counter(
    "paddle_tpu_serving_router_swaps_total",
    "per-replica checkpoint hot swaps orchestrated", ("router",),
    always=True)
# always=True like the request counters: signals() (the autoscaler
# feed) is a stats()-style API whose contract must not depend on the
# metrics switch
_M_LATENCY = obs_metrics.histogram(
    "paddle_tpu_serving_router_request_seconds",
    "end-to-end front-door request latency (submit to last token, "
    "retries included)", ("router",), always=True)
_M_OUTSTANDING = obs_metrics.gauge(
    "paddle_tpu_serving_router_outstanding_tokens",
    "tokens reserved on replicas for in-flight requests", ("router",),
    always=True)


class NoReplicasAvailable(ConnectionError):
    """No live replica could serve the request within the retry
    budget (all dead, all demoted, or the registry lists none)."""


class _Replica:
    __slots__ = ("addr", "outstanding", "swapping")

    def __init__(self, addr: str):
        self.addr = addr
        self.outstanding = 0
        self.swapping = False


class ReplicaRouter:
    """The serving front door over a TTL-lease replica registry.

    Pass ``registry_addr`` to join an existing registry (e.g. a
    ClusterController's), or neither to let the router HOST one —
    ``router.registry_addr`` is then what each replica's
    ``cli serve --registry`` should point at.  ``desired`` caps the
    replica slots the hosted registry hands out."""

    def __init__(self, registry_addr: Optional[str] = None,
                 kind: str = "generation", desired: int = 16,
                 refresh_s: float = 0.2, demote_s: float = 3.0,
                 retry_policy: Optional[RetryPolicy] = None,
                 request_timeout_s: float = 120.0):
        from .registry import Registry, RegistryClient

        self._kind = kind
        self._owned_registry = None
        if registry_addr is None:
            self._owned_registry = Registry()
            self._owned_registry.set_desired(kind, desired)
            port = self._owned_registry.serve(0)
            registry_addr = f"127.0.0.1:{port}"
        self.registry_addr = registry_addr
        self._rc = RegistryClient(registry_addr)
        self._refresh_s = float(refresh_s)
        self._demote_s = float(demote_s)
        self._timeout_s = float(request_timeout_s)
        self.policy = retry_policy or RetryPolicy.from_env(
            "ROUTER_RETRY", max_attempts=8, base_delay=0.05,
            max_delay=0.5, deadline=30.0)
        self._lock = threading.Lock()
        self._replicas: Dict[str, _Replica] = {}
        self._demoted: Dict[str, float] = {}
        # addresses an operator/autoscaler marked as draining: still
        # live (their in-flight streams keep completing) but excluded
        # from placement so the drain converges.  Keyed by address, not
        # _Replica, so the mark survives table re-lists and applies to
        # replicas not yet discovered.
        self._draining: set = set()
        self._last_refresh = 0.0
        self._closed = False
        rid = self._rid = str(next(_ROUTER_IDS))
        self._m_ok = _M_REQUESTS.labels(router=rid, outcome="ok")
        self._m_shed = _M_REQUESTS.labels(router=rid, outcome="shed")
        self._m_failed = _M_REQUESTS.labels(router=rid, outcome="failed")
        self._m_retries = _M_RETRIES.labels(router=rid)
        self._m_live = _M_LIVE.labels(router=rid)
        self._m_swaps = _M_SWAPS.labels(router=rid)
        self._m_latency = _M_LATENCY.labels(router=rid)
        self._m_outstanding = _M_OUTSTANDING.labels(router=rid)
        # windowed self-observation (the autoscaler's substrate):
        # a TimeSeriesStore sampling this process's registry, started
        # lazily by watch()/signals() — the router then consumes
        # p99(window)/qps(window) instead of raw instantaneous gauges
        self._series = None

    # -- routing table ------------------------------------------------------
    def _refresh(self, force: bool = False):
        """Re-list the registry and merge into the routing table.  The
        NETWORK roundtrip runs outside the router lock: a slow registry
        (its client retries up to ~5s) must never stall the per-token
        accounting of every in-flight stream."""
        with self._lock:
            now = time.monotonic()
            if not force and now - self._last_refresh < self._refresh_s:
                return
            self._last_refresh = now  # claim the slot before the I/O
        try:
            listed = set(self._rc.list(self._kind).values())
        except OSError:
            return  # registry hiccup: keep routing on the last table
        with self._lock:
            now = time.monotonic()
            for addr in listed:
                if addr not in self._replicas:
                    self._replicas[addr] = _Replica(addr)
            for addr in list(self._replicas):
                if addr not in listed:
                    del self._replicas[addr]
                    # a retired replica's drain mark must not outlive
                    # it: the same host:port may serve a future replica
                    self._draining.discard(addr)
            # a demotion outlives the TTL only if the registry still
            # lists the member; expire stale demotions so a RESTARTED
            # replica on the same address gets traffic again
            for addr, until in list(self._demoted.items()):
                if now >= until:
                    del self._demoted[addr]
            if obs_metrics.enabled():
                self._m_live.set(len([a for a in self._replicas
                                      if a not in self._demoted]))

    def _pick_locked(self) -> Optional[_Replica]:
        live = [r for a, r in self._replicas.items()
                if a not in self._demoted and not r.swapping
                and a not in self._draining]
        if not live:
            return None
        return min(live, key=lambda r: r.outstanding)

    def _demote(self, addr: str):
        with self._lock:
            self._demoted[addr] = time.monotonic() + self._demote_s
            self._last_refresh = 0.0  # force a re-list on next pick

    def set_draining(self, addr: str, draining: bool = True) -> None:
        """Mark/unmark one replica as draining: it stays in the table
        (its in-flight streams keep their per-token accounting) but
        receives no new placements.  The autoscaler marks its scale-in
        victim before sending the replica `drain` verb so the router
        converges instead of racing fresh requests onto it."""
        with self._lock:
            if draining:
                self._draining.add(addr)
            else:
                self._draining.discard(addr)

    def live_replicas(self, include_draining: bool = True,
                      refresh: bool = True) -> List[str]:
        """Registry-live replica addresses (demotions excluded).  The
        autoscaler's capacity/invariant checks pass
        ``include_draining=False``: a draining replica still answers
        its accepted streams but is no longer serving capacity.
        ``refresh=False`` reads the table as of the last re-list — for
        a caller that just forced one and wants a second view of the
        SAME listing instead of another registry round-trip."""
        if refresh:
            self._refresh(force=True)
        with self._lock:
            return sorted(a for a in self._replicas
                          if a not in self._demoted
                          and (include_draining
                               or a not in self._draining))

    # -- request path -------------------------------------------------------
    def submit(self, prompt_ids, max_new_tokens: int, *,
               temperature: float = 0.0, seed: int = 0,
               eos_id: Optional[int] = None,
               deadline_ms: Optional[float] = None) -> GenerationStream:
        """Route one generation request; returns a streaming future
        (serving.GenerationStream).  Tokens stream as the replica
        produces them; a replica death mid-stream is retried on a
        survivor transparently (resumed, never duplicated)."""
        prompt = [int(t) for t in list(prompt_ids)]
        stream = GenerationStream(prompt, max_new_tokens)
        req = {"op": "generate", "prompt": prompt,
               "max_new": int(max_new_tokens),
               "temperature": float(temperature), "seed": int(seed),
               "eos_id": eos_id, "deadline_ms": deadline_ms}
        expires = (time.monotonic() + deadline_ms / 1000.0
                   if deadline_ms is not None else None)
        t = threading.Thread(target=self._run_request,
                             args=(stream, req, expires), daemon=True)
        t.start()
        return stream

    def generate(self, prompt_ids, max_new_tokens: int,
                 timeout: Optional[float] = None, **kw) -> List[int]:
        return self.submit(prompt_ids, max_new_tokens, **kw).result(
            timeout or self._timeout_s)

    def _run_request(self, stream: GenerationStream, req: dict,
                     expires: Optional[float]):
        # root span of the fleet-wide request trace: the replica and
        # its generation server's phases parent under it through the
        # wire-propagated context, and the latency observe below runs
        # with it active, so the histogram exemplar names this trace
        with obs_tracing.span("router.request",
                              max_new=req["max_new"]):
            inj = obs_tracing.inject()
            if inj:
                req = dict(req, trace=inj)
            self._run_request_traced(stream, req, expires)

    def _run_request_traced(self, stream: GenerationStream, req: dict,
                            expires: Optional[float]):
        delivered = 0
        t_start = time.monotonic()
        state = self.policy.begin()
        while True:
            if expires is not None and time.monotonic() >= expires:
                self._m_shed.inc()
                stream._fail(RequestDeadlineExceeded(
                    "request deadline expired at the router"))
                return
            self._refresh()
            with self._lock:
                replica = self._pick_locked()
                if replica is not None:
                    reserve = req["max_new"] - delivered
                    replica.outstanding += reserve
            if replica is not None:
                self._m_outstanding.inc(reserve)
            if replica is None:
                try:
                    state.record(NoReplicasAvailable(
                        f"no live {self._kind!r} replicas in "
                        f"{self.registry_addr}"),
                        what="router: no replicas")
                    state.sleep()
                    continue
                except OSError as e:
                    self._m_failed.inc()
                    stream._fail(e)
                    return
            addr = replica.addr
            try:
                attempt = dict(req, skip=delivered)
                if expires is not None:
                    attempt["deadline_ms"] = max(
                        0.0, (expires - time.monotonic()) * 1000.0)
                for tok in replica_stream(addr, attempt,
                                          timeout_s=self._timeout_s):
                    delivered += 1
                    with self._lock:
                        replica.outstanding -= 1
                        reserve -= 1
                    self._m_outstanding.dec()
                    stream._put(tok)
                self._m_ok.inc()
                self._m_latency.observe(time.monotonic() - t_start)
                stream._finish()
                return
            except (ReplicaShed, ServerSaturated) as e:
                # a policy answer: the replica chose to shed — honor it
                self._m_shed.inc()
                stream._fail(e)
                return
            except ReplicaError as e:
                if e.fatal:
                    self._m_failed.inc()
                    stream._fail(e)
                    return
                exc: Exception = e
            except (OSError, ValueError) as e:
                # died mid-stream / unreachable / garbled frame
                exc = e
            finally:
                with self._lock:
                    replica.outstanding -= max(reserve, 0)
                self._m_outstanding.dec(max(reserve, 0))
            self._demote(addr)
            self._m_retries.inc()
            _LOG.warning("router: replica %s failed (%r), retrying "
                         "with %d/%d tokens delivered", addr, exc,
                         delivered, req["max_new"])
            try:
                state.record(exc, what=f"replica {addr} failed")
                state.sleep()
            except OSError as e:
                self._m_failed.inc()
                stream._fail(e)
                return

    # -- control plane ------------------------------------------------------
    def ping(self, addr: str) -> dict:
        return replica_call(addr, {"op": "ping"}, timeout_s=5.0)

    def swap(self, model_dir: str, timeout_s: float = 120.0) -> int:
        """Zero-downtime checkpoint hot swap across the fleet: each
        replica drains and swaps ONE AT A TIME while the router routes
        around it.  Returns the number of replicas swapped; raises if
        no replica could be swapped."""
        swapped = 0
        errors = []
        for addr in self.live_replicas():
            with self._lock:
                rep = self._replicas.get(addr)
                if rep is None:
                    continue
                rep.swapping = True
            try:
                ans = replica_call(addr, {"op": "swap", "dir": model_dir,
                                          "timeout": timeout_s},
                                   timeout_s=timeout_s + 10)
                if ans.get("ok"):
                    swapped += 1
                    self._m_swaps.inc()
                else:
                    errors.append((addr, ans.get("err", "swap refused")))
                    self._demote(addr)
            except OSError as e:
                errors.append((addr, repr(e)))
                self._demote(addr)
            finally:
                with self._lock:
                    rep = self._replicas.get(addr)
                    if rep is not None:
                        rep.swapping = False
        if not swapped:
            raise RuntimeError(
                f"hot swap installed on 0 replicas: {errors}")
        if errors:
            _LOG.warning("router: hot swap skipped %d replica(s): %s",
                         len(errors), errors)
        return swapped

    # -- windowed self-observation (the autoscaler substrate) ---------------
    def watch(self, period_s: float = 0.5, capacity: int = 720):
        """Start (idempotently) the router's time-series sampler and
        return the TimeSeriesStore.  This is the watchable
        queue-depth/latency history the autoscaler scales
        on — windowed signals, not instantaneous gauge reads."""
        from paddle_tpu_torch.observability.timeseries import \
            TimeSeriesStore

        with self._lock:
            if self._closed:
                # a watch() racing close() must not resurrect a
                # sampler thread nobody will ever stop
                raise RuntimeError("router is closed")
            if self._series is None:
                self._series = TimeSeriesStore(period_s=period_s,
                                               capacity=capacity)
                self._series.start()
            return self._series

    def signals(self, window_s: float = 60.0) -> dict:
        """The scaling signals over one window: request rate, windowed
        p50/p99 latency (bucket-delta quantiles, NaN before traffic),
        reserved-token backlog, live replica count.  A scale-out
        policy reads `p99`/`qps`/`outstanding_tokens`; `replicas_live`
        closes its feedback loop."""
        series = self.watch()
        lbl = {"router": self._rid}
        return {
            "window_s": float(window_s),
            "qps": series.rate(
                "paddle_tpu_serving_router_requests_total", window_s,
                labels=lbl),
            "p50": series.p50(
                "paddle_tpu_serving_router_request_seconds", window_s,
                labels=lbl),
            "p99": series.p99(
                "paddle_tpu_serving_router_request_seconds", window_s,
                labels=lbl),
            "outstanding_tokens": series.latest(
                "paddle_tpu_serving_router_outstanding_tokens",
                labels=lbl),
            # as-of-last-re-list: a gauge in a SIGNAL summary must not
            # cost a forced registry round-trip per read (the autoscaler
            # polls signals() right after its own forced listing; the
            # request path re-lists on every pick anyway)
            "replicas_live": len(self.live_replicas(refresh=False)),
        }

    def stats(self) -> dict:
        with self._lock:
            return {
                "replicas": {a: r.outstanding
                             for a, r in self._replicas.items()},
                "demoted": sorted(self._demoted),
                "draining": sorted(self._draining),
                "requests_ok": int(self._m_ok.value),
                "requests_shed": int(self._m_shed.value),
                "requests_failed": int(self._m_failed.value),
                "retries": int(self._m_retries.value)}

    def close(self):
        if self._closed:
            return
        self._closed = True
        with self._lock:
            series, self._series = self._series, None
        if series is not None:
            series.stop()
        if self._owned_registry is not None:
            self._owned_registry.close()
        # reclaim this instance's registry series (router churn must
        # not grow dumps or bleed counts into later instances)
        for outcome in ("ok", "shed", "failed"):
            _M_REQUESTS.remove(router=self._rid, outcome=outcome)
        for fam in (_M_RETRIES, _M_LIVE, _M_SWAPS, _M_LATENCY,
                    _M_OUTSTANDING):
            fam.remove(router=self._rid)
