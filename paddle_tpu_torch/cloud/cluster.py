"""Elastic cluster runtime: membership-driven rebalancing + recovery
(counterpart of paddle_tpu/cloud/cluster.py, with its names, its view
JSON and its line protocol).

The Go cloud layer's fault-tolerant control plane (go/master/service.go
task re-dispatch, go/pserver/etcd_client.go TTL leases,
doc/design/cluster_train/README.md "trainers and pservers may join and
leave at any time") makes the CLUSTER SHAPE a runtime property:

* **ClusterController** — watches the TTL-lease registry
  (cloud/registry.py) for pserver/trainer join and lease-expiry events
  and publishes epoch-numbered **ClusterView**s (member list +
  parameter placement + sync fan-in).  On a pserver membership change
  it re-runs ``distributed_spliter.balanced_split`` over the surviving
  endpoints and migrates parameter shards over the batch wire
  (``PUT_BATCH``), sourcing a dead member's shards from its latest
  snapshot (parallel/checkpoint.latest_pserver_shard) or, failing
  that, from a trainer-held copy pushed during the transition.  Every
  transition is fenced: ``FENCE`` quiesces the optimize machinery on
  all live pservers, migration runs against frozen state, ``COMMIT``
  adopts the view — no optimize step mixes old and new placements.
* **ClusterClient** — the subscriber surface for trainers and tools:
  resolves/watches views, registers members (``join``), and answers
  the controller's trainer-held-recovery requests by pushing local
  parameter copies straight to the new owner pservers.

The trainer data path picks views up through ``parallel.comm``'s
process-global subscriber (``comm.set_cluster`` / the
``PADDLE_TPU_CONTROLLER`` env var): the fused send op re-derives each
round's endpoint map from the current view and, when a round dies
mid-flight (SIGKILLed pserver), waits for the next stable view and
retries against the new placement without a process restart.

Where the port departs from the JAX package (each a repair, ROADMAP
Queue C): a migrated parameter carries its optimizer state — the
companions its pserver names over ``STATE`` (an Adam parameter's
moments and its own beta powers) — from its live owner, its snapshot
or a stray copy, so an Adam step after a rebalance is the step the
serial Executor takes; and a bootstrap copy is dropped from a non-owner
on the first placement once its owner is confirmed to hold it, so a
stable cluster does not keep (and snapshot) the whole model on every
pserver.  A pserver that does not speak ``STATE`` (the JAX package's)
moves parameters alone, as the JAX package does.
"""
from __future__ import annotations

import json
import logging
import os
import socket
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

from ..core.resilience import RetryPolicy, fault_injector
from ..observability import metrics as obs_metrics

from .registry import Lease, Registry, RegistryClient

__all__ = ["ClusterView", "ClusterController", "ClusterClient"]

_LOG = logging.getLogger("paddle_tpu_torch.cluster")

_M_VIEW_EPOCH = obs_metrics.gauge(
    "paddle_tpu_cluster_view_epoch",
    "epoch of the controller's current published cluster view")
_M_MEMBERSHIP = obs_metrics.counter(
    "paddle_tpu_cluster_membership_changes_total",
    "membership events folded into a published view, by member kind",
    ("kind", "event"))
_M_REBALANCES = obs_metrics.counter(
    "paddle_tpu_cluster_rebalances_total",
    "completed fence->migrate->commit view changes")
_M_REBALANCE_SECONDS = obs_metrics.histogram(
    "paddle_tpu_cluster_rebalance_seconds",
    "wall time of one view change (fence + shard migration + commit)")
_M_MIGRATION_BYTES = obs_metrics.counter(
    "paddle_tpu_cluster_shard_migration_bytes_total",
    "serialized parameter bytes moved between pservers by rebalances")


class ClusterView:
    """One epoch-numbered snapshot of the cluster: who is in it, where
    every parameter lives, and how many trainers a sync round fans in.

    ``status``: "forming" (not enough members / no var defs yet),
    "rebalancing" (transition published so trainers can push
    trainer-held copies of ``needed`` shards), "stable"."""

    __slots__ = ("epoch", "status", "pservers", "trainers", "placement",
                 "fan_in", "needed", "registry")

    def __init__(self, epoch=0, status="forming", pservers=None,
                 trainers=None, placement=None, fan_in=None, needed=(),
                 registry=""):
        self.epoch = int(epoch)
        self.status = status
        self.pservers: Dict[int, str] = dict(pservers or {})
        self.trainers: Dict[int, str] = dict(trainers or {})
        self.placement: Dict[str, str] = dict(placement or {})
        self.fan_in = fan_in
        self.needed = list(needed)
        self.registry = registry

    @property
    def endpoints(self) -> List[str]:
        return [ep for _, ep in sorted(self.pservers.items())]

    def to_json(self) -> str:
        return json.dumps({
            "epoch": self.epoch, "status": self.status,
            "pservers": sorted(self.pservers.items()),
            "trainers": sorted(self.trainers.items()),
            "placement": self.placement, "fan_in": self.fan_in,
            "needed": self.needed, "registry": self.registry,
        }, separators=(",", ":"))

    @classmethod
    def from_json(cls, text: str) -> "ClusterView":
        d = json.loads(text)
        return cls(epoch=d["epoch"], status=d["status"],
                   pservers={int(i): ep for i, ep in d["pservers"]},
                   trainers={int(i): a for i, a in d["trainers"]},
                   placement=d["placement"], fan_in=d["fan_in"],
                   needed=d.get("needed", ()),
                   registry=d.get("registry", ""))

    def __repr__(self):
        return (f"ClusterView(epoch={self.epoch}, {self.status}, "
                f"pservers={self.endpoints}, "
                f"trainers={len(self.trainers)}, "
                f"vars={len(self.placement)})")


def _pserver_client(endpoint: str):
    """Controller-side pserver connection: short patience — a member
    that cannot answer within seconds is treated as dead and the
    rebalance recomputes without it (the TTL would evict it anyway)."""
    from ..parallel.pserver import VariableClient

    return VariableClient(
        endpoint, client_id=f"cluster-ctl-{os.getpid()}",
        connect_timeout=5.0, request_timeout=15.0,
        retry_policy=RetryPolicy(max_attempts=2, base_delay=0.1,
                                 max_delay=0.5, deadline=5.0))


class _MemberDied(Exception):
    def __init__(self, endpoint):
        super().__init__(endpoint)
        self.endpoint = endpoint


class ClusterController:
    """Watches membership, publishes views, orchestrates rebalances.

    ``var_descs``: the parameters under placement —
    ``distributed_spliter.VarDesc`` tuples (or anything with
    name/shape/dtype), settable at construction or later over the wire
    (``DEFINE`` — the first trainer to connect typically defines them
    from its transpiled program).  ``snapshot_dirs`` maps a pserver
    INDEX (the stable slot number) to that shard's snapshot directory,
    or is a callable ``index -> dir``; it is the recovery source for a
    member that died without a live copy.  ``master`` (optional
    cloud.Master) gets poked when a trainer lease expires so its
    lazy task-timeout reclaim runs promptly."""

    def __init__(self, registry: Optional[Registry] = None,
                 registry_addr: Optional[str] = None,
                 var_descs: Optional[Sequence] = None,
                 min_pservers: int = 1, split_method=None,
                 poll_s: float = 0.25, push_timeout_s: float = 10.0,
                 snapshot_dirs=None, master=None,
                 track_trainers: bool = True,
                 quarantine_s: float = 5.0):
        self._own_registry = None
        if registry is None and registry_addr is None:
            registry = Registry()
            registry.serve(0)
            self._own_registry = registry
        if registry is not None:
            self._reg = registry
            port = getattr(registry, "port", None)
            self.registry_addr = f"127.0.0.1:{port}" if port else ""
        else:
            self._reg = RegistryClient(registry_addr)
            self.registry_addr = registry_addr
        self.min_pservers = int(min_pservers)
        self.poll_s = float(poll_s)
        self.push_timeout_s = float(push_timeout_s)
        self.snapshot_dirs = snapshot_dirs or {}
        self.master = master
        self.track_trainers = track_trainers
        from ..parallel import distributed_spliter as spliter

        self._split = split_method or spliter.balanced_split
        self._vars = list(var_descs or [])
        self._lock = threading.Condition()
        self._view = ClusterView(registry=self.registry_addr)
        self._last_stable: Optional[ClusterView] = None
        self._needed: set = set()
        # (index, addr) pairs excluded mid-rebalance -> re-admit time.
        # A member that keeps its lease but cannot complete a
        # transition (a pre-elastic binary ERRing on FENCE, a wedged
        # process) would otherwise re-trigger a full fence+commit cycle
        # EVERY poll tick — each commit wiping in-flight grad slots on
        # the healthy members.  Quarantined pairs are filtered from the
        # registry listing for `quarantine_s`, bounding the churn to
        # one retry per window while still re-admitting a member that
        # recovers (or rejoins under a fresh lease).
        self.quarantine_s = float(quarantine_s)
        self._quarantine: Dict[tuple, float] = {}
        self._pclients: Dict[str, object] = {}
        # param -> the optimizer state that travels with it (the STATE
        # verb's answer; None until asked, {} from a pserver that does
        # not speak STATE)
        self._state: Optional[Dict[str, List[str]]] = None
        # one record a committed view: epoch, kind, seconds, the bytes
        # and vars migrated or restored, their seconds
        self.transitions: List[dict] = []
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._sock: Optional[socket.socket] = None
        self.port: Optional[int] = None

    # -- lifecycle ----------------------------------------------------------
    def serve(self, port: int = 0) -> int:
        """Start the view-protocol TCP server; returns the bound port."""
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(("127.0.0.1", port))
        self._sock.listen(16)
        self.port = self._sock.getsockname()[1]
        t = threading.Thread(target=self._accept_loop, daemon=True)
        t.start()
        self._threads.append(t)
        return self.port

    @property
    def addr(self) -> str:
        return f"127.0.0.1:{self.port}"

    def start(self):
        """Start the membership watch thread (serve() first if remote
        processes need the view protocol)."""
        t = threading.Thread(target=self._watch, daemon=True)
        t.start()
        self._threads.append(t)
        return self

    def define(self, var_descs: Sequence):
        """Set the placed-variable descs (idempotent: first definition
        wins — every process derives them from the same program)."""
        with self._lock:
            if not self._vars:
                self._vars = list(var_descs)

    def stop(self):
        self._stop.set()
        try:
            if self._sock is not None:
                # shutdown BEFORE close: close() alone does not wake an
                # accept() blocked in the serve thread, whose join below
                # would then wait out its timeout
                try:
                    self._sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                self._sock.close()
        except OSError:
            pass
        with self._lock:
            self._lock.notify_all()
        # join the watch/serve threads BEFORE draining clients: a tick
        # mid-rebalance would otherwise reconnect and re-insert fresh
        # pserver clients after the drain, leaking their sockets.  The
        # joins are bounded — a thread stuck in a slow network op is
        # drained under popitem below rather than waited out forever
        for t in self._threads:
            if t is not threading.current_thread():
                t.join(timeout=10.0)
        # popitem, not iteration: a straggler thread that outlived its
        # join timeout may still be inserting/popping clients —
        # mutating a dict being iterated raises and would abort
        # close() before the owned registry is torn down
        while True:
            try:
                _, c = self._pclients.popitem()
            except KeyError:
                break
            try:
                c.close()
            except Exception:
                pass

    def close(self):
        self.stop()
        if self._own_registry is not None:
            self._own_registry.close()
            self._own_registry = None

    # -- view access --------------------------------------------------------
    def view(self) -> ClusterView:
        with self._lock:
            return self._view

    def wait_view(self, min_epoch: int,
                  timeout_s: float = 30.0) -> Optional[ClusterView]:
        """Block until a STABLE view with epoch >= min_epoch is
        published (or timeout -> None)."""
        deadline = time.monotonic() + timeout_s
        with self._lock:
            while not (self._view.status == "stable"
                       and self._view.epoch >= min_epoch):
                left = deadline - time.monotonic()
                if left <= 0 or self._stop.is_set():
                    return None
                self._lock.wait(timeout=min(left, 0.1))
            return self._view

    def _publish(self, view: ClusterView):
        with self._lock:
            self._view = view
            if view.status == "stable":
                # migration sourcing reads THIS view, not whatever was
                # last published: an all-dead stall or an interrupted
                # transition publishes intermediate views whose
                # pserver->index map no longer says where shards live
                self._last_stable = view
            self._lock.notify_all()
        _M_VIEW_EPOCH.set(view.epoch)

    # -- membership watch ---------------------------------------------------
    def _list(self, kind: str) -> Dict[int, str]:
        return dict(self._reg.list(kind))

    def _watch(self):
        while not self._stop.is_set():
            try:
                self._tick()
            except Exception:
                # the watcher must survive anything — a transient
                # registry outage or an injected fault is a skipped
                # tick, not a dead control plane
                _LOG.warning("cluster watch tick failed", exc_info=True)
            self._stop.wait(self.poll_s)

    def _tick(self):
        ps = self._list("pserver")
        tr = self._list("trainer") if self.track_trainers else {}
        if self._quarantine:
            now = time.monotonic()
            self._quarantine = {k: t for k, t in
                                self._quarantine.items() if t > now}
            ps = {i: a for i, a in ps.items()
                  if (i, a) not in self._quarantine}
        with self._lock:
            view = self._view
            have_vars = bool(self._vars)
        if view.status == "forming":
            if len(ps) >= self.min_pservers and have_vars:
                self._rebalance(ps, tr)
            return
        if ps != view.pservers or tr != view.trainers:
            # ANY departed (index, addr) pair means a trainer is gone —
            # a bare subset check would miss a leave+join landing in
            # the same poll (or an expired slot re-registered)
            departed = set(view.trainers.items()) - set(tr.items())
            if self.master is not None and departed:
                # a trainer lease expired: poke the master so its lazy
                # task-timeout check runs now and orphaned task chunks
                # re-dispatch as soon as timeout_s allows
                try:
                    self.master.reclaim_expired()
                except Exception:
                    _LOG.warning("master reclaim poke failed",
                                 exc_info=True)
            self._rebalance(ps, tr)

    # -- rebalance (fence -> migrate -> commit) -----------------------------
    def _rebalance(self, ps: Dict[int, str], tr: Dict[int, str]):
        # a member that fails mid-rebalance is dropped from the target
        # membership and the whole transition recomputes — its shards
        # then source from snapshot/trainer copies like any dead member
        for _ in range(3):
            try:
                return self._rebalance_once(dict(ps), dict(tr))
            except _MemberDied as e:
                _LOG.warning(
                    "rebalance: pserver %s died mid-transition; "
                    "recomputing without it", e.endpoint)
                self._forget_client(e.endpoint)
                # quarantine the pair(s): a member that keeps
                # heartbeating but cannot transition must not re-enter
                # the target membership on the very next tick
                until = time.monotonic() + self.quarantine_s
                for i, ep in ps.items():
                    if ep == e.endpoint:
                        self._quarantine[(i, ep)] = until
                ps = {i: ep for i, ep in ps.items() if ep != e.endpoint}
        _LOG.error("rebalance: gave up after repeated member deaths")

    def _client(self, endpoint: str):
        c = self._pclients.get(endpoint)
        if c is None:
            c = self._pclients[endpoint] = _pserver_client(endpoint)
        return c

    def _forget_client(self, endpoint: str):
        c = self._pclients.pop(endpoint, None)
        if c is not None:
            try:
                c.close()
            except Exception:
                pass

    def _rebalance_once(self, ps: Dict[int, str], tr: Dict[int, str]):
        t0 = time.perf_counter()
        fault_injector().fire("cluster.rebalance")
        old = self.view()
        epoch = old.epoch + 1
        eps = [ep for _, ep in sorted(ps.items())]
        if not eps:
            # every pserver is gone: publish a non-stable view so
            # trainers BLOCK (and keep pushing nothing) until a
            # replacement registers, instead of erroring against
            # ghosts.  The LAST KNOWN placement rides along — it is
            # what the next rebalance reads to know which (dead)
            # endpoint owned each shard, so snapshot/trainer-held
            # recovery still runs when a replacement joins.
            _LOG.error("rebalance: no live pservers; cluster is stalled "
                       "until one joins")
            self._count_membership(old, ps, tr)
            self._publish(ClusterView(
                epoch=epoch, status="rebalancing", pservers={},
                trainers=tr, placement=old.placement,
                fan_in=len(tr) or None, registry=self.registry_addr))
            return
        fan_in = len(tr) if tr else None
        if old.status == "stable" and ps == old.pservers:
            # trainer-only churn: same endpoints + same vars means the
            # deterministic split cannot move a shard, so skip the
            # fence/migrate/drop machinery — one COMMIT per pserver
            # adopts the new fan-in (and releases any round stuck
            # behind a dead trainer's missing barrier)
            for ep in eps:
                try:
                    self._client(ep).commit(epoch, fan_in)
                except (OSError, ConnectionError, RuntimeError):
                    raise _MemberDied(ep)
            self._count_membership(old, ps, tr)
            self._publish(ClusterView(
                epoch=epoch, status="stable", pservers=ps, trainers=tr,
                placement=old.placement, fan_in=fan_in,
                registry=self.registry_addr))
            self._record(epoch, "trainer-only", t0, {})
            _LOG.info("cluster view %d committed (trainer-only): "
                      "%d pservers, %d trainers", epoch, len(ps),
                      len(tr))
            return
        from ..parallel.distributed_spliter import placement_map

        placement = placement_map(self._vars, eps, self._split)

        # phase 1: fence every live pserver (quiesce optimize rounds).
        # RuntimeError is a protocol-level ERR reply (e.g. a
        # pre-elastic server in the registry): treated like a death so
        # one incompatible member is excluded loudly instead of
        # wedging the watch loop in endless failed rebalances
        for ep in eps:
            try:
                self._client(ep).fence(epoch)
            except (OSError, ConnectionError, RuntimeError):
                raise _MemberDied(ep)
        t_fenced = time.perf_counter()
        moved = {"bytes": 0, "vars": 0, "state_vars": 0, "restored": 0}

        # migrate shards: group by source/destination so transfers ride
        # the bucketed batch wire.  Sourcing uses the last STABLE view —
        # `old` may be an all-dead stall or a half-done transition whose
        # placement/index map does not say where shards actually live.
        src = self._last_stable if self._last_stable is not None else old
        needed = set(self._migrate(src, placement, set(eps), moved))

        # verify REALITY before trusting src any further: a retried
        # transition may already have moved or dropped shards in ways
        # no published view records, and on the initial placement a
        # bootstrap copy may sit on a non-owner (transpile-time layout
        # vs registration-order skew).  Probe every live member (HAVE),
        # move stray copies onto their placed owners, and fold
        # lost-everywhere previously-placed vars into the trainer-held
        # recovery set.  `owner_ok` gates the drop phase below — a copy
        # is only ever dropped once its placed owner is CONFIRMED to
        # hold the var, so no sequence of failures can erase the last
        # copy.
        owner_ok = self._consolidate(placement, eps, src, needed, moved)

        if needed:
            # trainer-held recovery: publish the transition so
            # subscribers push their local copies of the lost shards to
            # the new owners (ClusterClient._push_needed), then wait
            with self._lock:
                self._needed = set(needed)
            self._publish(ClusterView(
                epoch=epoch, status="rebalancing", pservers=ps,
                trainers=tr, placement=placement, fan_in=fan_in,
                needed=sorted(needed), registry=self.registry_addr))
            deadline = time.monotonic() + self.push_timeout_s
            with self._lock:
                while self._needed and time.monotonic() < deadline \
                        and not self._stop.is_set():
                    self._lock.wait(timeout=0.1)
                left = sorted(self._needed)
                self._needed = set()
            owner_ok |= needed - set(left)  # pushed straight to owners
            # last resort for the un-pushed remainder: re-initialize to
            # zeros on the new owners — but ONLY names the owner holds
            # no copy of at all (owner_ok): a stale bootstrap copy that
            # no trainer refreshed still beats zeros, and a var the
            # owner never held would fail every GET and wedge the
            # cluster, which is strictly worse than zeros.
            truly_missing = [n for n in left if n not in owner_ok]
            if truly_missing:
                owner_ok |= self._zero_fill(truly_missing, placement)

        # drop non-owned copies so every param has ONE authoritative
        # home (and a later rebalance knows where to read it).  Only
        # copies whose placed owner is CONFIRMED to hold the var
        # (probe, migration, push, or zero-fill — `owner_ok`) are
        # dropped, so no sequence of interrupted transitions erases
        # the last copy.  The JAX package also waits until a var was
        # placed once, which keeps every bootstrap copy (the whole
        # model on every pserver, in every snapshot) until the first
        # membership change; the owner's confirmation is what makes
        # the drop safe, so the port drops them on the first placement.
        # An elastic pserver drops a parameter's optimizer state with
        # it.
        drops: Dict[str, list] = {}
        for name, owner in placement.items():
            if name not in owner_ok:
                continue
            for ep in eps:
                if ep != owner:
                    drops.setdefault(ep, []).append(name)
        for ep, names in drops.items():
            try:
                self._client(ep).drop_vars(names)
            except (OSError, ConnectionError, RuntimeError):
                raise _MemberDied(ep)

        # phase 2: commit everywhere, then publish the stable view.
        # Membership is counted HERE, once per committed transition — a
        # _MemberDied retry re-enters this method, and counting at the
        # top would tally the same join/leave two or three times.
        for ep in eps:
            try:
                self._client(ep).commit(epoch, fan_in)
            except (OSError, ConnectionError, RuntimeError):
                raise _MemberDied(ep)
        self._count_membership(old, ps, tr)
        self._publish(ClusterView(
            epoch=epoch, status="stable", pservers=ps, trainers=tr,
            placement=placement, fan_in=fan_in,
            registry=self.registry_addr))
        moved["fenced_s"] = time.perf_counter() - t_fenced
        self._record(epoch, "rebalance", t0, moved)
        _LOG.info("cluster view %d committed: %d pservers, %d trainers, "
                  "%d vars placed", epoch, len(ps), len(tr),
                  len(placement))

    def _record(self, epoch: int, kind: str, t0: float, moved: dict):
        dt = time.perf_counter() - t0
        _M_REBALANCES.inc()
        _M_REBALANCE_SECONDS.observe(dt)
        self.transitions.append({"epoch": epoch, "kind": kind,
                                 "seconds": dt,
                                 "at": time.perf_counter(), **moved})

    def _state_of(self, names, eps) -> Dict[str, List[str]]:
        """{param: the optimizer state that travels with it} from a live
        member's STATE answer (every elastic member holds the same
        optimize program, so one answer serves the cluster; asked once
        a controller).  A member that does not speak STATE (the JAX
        package's pserver) gives {}: parameters move alone."""
        if self._state is None:
            for ep in eps:
                try:
                    self._state = self._client(ep).state_of(names)
                    break
                except RuntimeError:
                    self._state = {}
                    break
                except (OSError, ConnectionError):
                    raise _MemberDied(ep)
        return self._state or {}

    def _copy(self, src_ep, dst_ep, names, moved) -> None:
        """GET `names` and the state held with them from `src_ep`, PUT
        them onto `dst_ep` (a RuntimeError from the source, an ERR
        reply, propagates to the caller)."""
        state = self._state_of(sorted(self._var_names()), [src_ep])
        extra = [c for n in names for c in state.get(n, ())]
        if extra:
            try:
                extra = sorted(self._client(src_ep).have_vars(extra))
            except (OSError, ConnectionError):
                raise _MemberDied(src_ep)
        try:
            vals = self._client(src_ep).get_vars(list(names) + extra)
        except (OSError, ConnectionError):
            raise _MemberDied(src_ep)
        try:
            moved["bytes"] += self._client(dst_ep).put_vars(
                list(zip(list(names) + extra, vals)))
        except (OSError, ConnectionError, RuntimeError):
            raise _MemberDied(dst_ep)
        moved["vars"] += len(names)
        moved["state_vars"] += len(extra)

    def _var_names(self):
        return [getattr(v, "name", None) for v in self._vars]

    def _zero_fill(self, names, placement: Dict[str, str]) -> set:
        """Install zeros on the placed owners.  Returns the names
        actually installed (unfillable ones — no known shape — are
        not)."""
        import numpy as np

        descs = {getattr(v, "name", None): v for v in self._vars}
        by_dst: Dict[str, list] = {}
        unfillable = []
        for name in names:
            d = descs.get(name)
            shape = tuple(getattr(d, "shape", ()) or ())
            if not shape or any(int(s) <= 0 for s in shape):
                unfillable.append(name)
                continue
            try:
                val = np.zeros(shape, dtype=str(getattr(
                    d, "dtype", "float32") or "float32"))
            except TypeError:
                val = np.zeros(shape, dtype="float32")
            by_dst.setdefault(placement[name], []).append((name, val))
        filled = sorted(set(names) - set(unfillable))
        if filled:
            _LOG.warning(
                "rebalance: no snapshot or trainer copy for %s — "
                "re-initialized to ZEROS on the new owners (learned "
                "values lost)", filled)
        if unfillable:
            _LOG.error(
                "rebalance: no recovery source AND no known shape for "
                "%s — reads of these will fail until some trainer "
                "pushes a copy", unfillable)
        for ep, pairs in by_dst.items():
            try:
                self._client(ep).put_vars(pairs)
            except (OSError, ConnectionError, RuntimeError):
                raise _MemberDied(ep)
        return set(filled)

    def _count_membership(self, old: ClusterView, ps, tr):
        for kind, before, now in (("pserver", old.pservers, ps),
                                  ("trainer", old.trainers, tr)):
            joined = set(now.items()) - set(before.items())
            left = set(before.items()) - set(now.items())
            if joined:
                _M_MEMBERSHIP.labels(kind=kind, event="join").inc(
                    len(joined))
            if left:
                _M_MEMBERSHIP.labels(kind=kind, event="leave").inc(
                    len(left))

    def _snapshot_dir(self, index: int):
        if callable(self.snapshot_dirs):
            return self.snapshot_dirs(index)
        return self.snapshot_dirs.get(index)

    def _consolidate(self, placement: Dict[str, str], eps,
                     src: ClusterView, needed: set, moved: dict) -> set:
        """Probe every live member (HAVE) and repair placement reality:
        stray copies move onto their placed owners (with the state held
        beside them), previously-placed vars held NOWHERE (an
        interrupted earlier transition) join `needed` for trainer-held
        recovery, and never-placed vars held nowhere are left alone
        (zeroing them could mask a pserver whose startup has not run
        yet).  Runs fenced, like _migrate.  Returns the names CONFIRMED
        present on their placed owner — the drop phase's license to
        erase copies elsewhere."""
        all_names = sorted(placement)
        held: Dict[str, set] = {}
        for ep in eps:
            try:
                held[ep] = self._client(ep).have_vars(all_names)
            except (OSError, ConnectionError, RuntimeError):
                raise _MemberDied(ep)
        moves: Dict[str, Dict[str, list]] = {}  # src_ep -> owner -> names
        owner_ok: set = set()
        missing = []
        for name in all_names:
            owner = placement[name]
            if name in held[owner]:
                # a copy is where it belongs.  It stays in `needed`
                # though: the held copy may be a stale bootstrap value
                # and a subscribed trainer's push is fresher — but the
                # zero-fill fallback skips owner_ok names, so an
                # un-pushed copy survives instead of being zeroed
                owner_ok.add(name)
                continue
            src_ep = next((ep for ep in eps if name in held[ep]), None)
            if src_ep is None:
                missing.append(name)
                continue
            moves.setdefault(src_ep, {}).setdefault(owner,
                                                    []).append(name)
        before = moved["bytes"]
        for src_ep, by_dst in moves.items():
            for owner, batch in by_dst.items():
                try:
                    self._copy(src_ep, owner, batch, moved)
                except RuntimeError:
                    raise _MemberDied(src_ep)
                owner_ok.update(batch)
        if moved["bytes"] > before:
            _M_MIGRATION_BYTES.inc(moved["bytes"] - before)
            _LOG.info(
                "consolidation: moved stray vars (%d bytes) onto their "
                "placed owners", moved["bytes"] - before)
        homeless = []
        for name in missing:
            if name in src.placement:
                needed.add(name)  # placed once, lost since: recover
            elif name not in needed:
                homeless.append(name)
        if homeless:
            _LOG.info(
                "bootstrap: no live member holds %s yet — reads fail "
                "until some member or trainer installs them",
                sorted(homeless))
        return owner_ok

    def _migrate(self, old: ClusterView, placement: Dict[str, str],
                 live: set, moved: dict) -> List[str]:
        """Move shards, with the optimizer state held beside them, to
        their new owners.  Returns names with no recoverable source
        (dead owner, no snapshot) for the trainer-held recovery
        phase."""
        moves: Dict[str, Dict[str, list]] = {}  # old_ep -> new_ep -> names
        lost: Dict[str, list] = {}              # dead old_ep -> names
        for name, new_ep in placement.items():
            old_ep = old.placement.get(name)
            if old_ep is None or old_ep == new_ep:
                continue  # initial placement or unchanged owner
            if old_ep in live:
                moves.setdefault(old_ep, {}).setdefault(new_ep,
                                                        []).append(name)
            else:
                lost.setdefault(old_ep, []).append(name)
        needed: List[str] = []
        before = moved["bytes"]
        for old_ep, by_dst in moves.items():
            fault_injector().fire("cluster.migrate")
            for new_ep, names in by_dst.items():
                try:
                    self._copy(old_ep, new_ep, names, moved)
                except RuntimeError:
                    # the source is alive but CANNOT serve (ERR reply:
                    # e.g. it restarted blank since the last view) —
                    # recover these names like a dead member's instead
                    # of evicting a healthy server
                    lost.setdefault(old_ep, []).extend(names)
        # dead members: latest shard snapshot, else trainer-held copy
        old_index = {ep: i for i, ep in old.pservers.items()}
        for old_ep, names in lost.items():
            fault_injector().fire("cluster.migrate")
            data = None
            snap_dir = self._snapshot_dir(old_index.get(old_ep, -1))
            if snap_dir:
                from ..parallel.checkpoint import latest_pserver_shard

                data, rnd, _ = latest_pserver_shard(snap_dir)
                if data is not None:
                    moved["restored_round"] = rnd
                    _LOG.info(
                        "rebalance: restoring %d vars of dead pserver "
                        "%s from its round-%d snapshot", len(names),
                        old_ep, rnd)
            state = (self._state_of(sorted(self._var_names()),
                                    sorted(live))
                     if data is not None else {})
            by_dst: Dict[str, list] = {}
            for name in names:
                if data is not None and name in data:
                    pairs = by_dst.setdefault(placement[name], [])
                    pairs.append((name, data[name]))
                    extra = [c for c in state.get(name, ()) if c in data]
                    pairs.extend((c, data[c]) for c in extra)
                    moved["restored"] += 1
                    moved["state_vars"] += len(extra)
                else:
                    needed.append(name)
            for new_ep, pairs in by_dst.items():
                try:
                    moved["bytes"] += self._client(new_ep).put_vars(pairs)
                except (OSError, ConnectionError, RuntimeError):
                    raise _MemberDied(new_ep)
        if moved["bytes"] > before:
            _M_MIGRATION_BYTES.inc(moved["bytes"] - before)
        return needed

    # -- view protocol server ----------------------------------------------
    # line-oriented, compact-JSON answers (RegistryClient idiom):
    #   VIEW\n                         -> OK <view json>\n
    #   WAIT <min_epoch> <timeout_ms>\n-> OK <view json>\n | TIMEOUT\n
    #   DEFINE <json var descs>\n      -> OK\n
    #   PUSHED <epoch> <json names>\n  -> OK\n
    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            # NOT retained in self._threads: every ClusterClient
            # roundtrip is one short-lived connection, so keeping a
            # Thread object per accept would grow without bound over a
            # long run; these are daemons that exit with their socket
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 daemon=True)
            t.start()

    def _serve_conn(self, conn: socket.socket):
        try:
            f = conn.makefile("rw", newline="\n")
            while not self._stop.is_set():
                line = f.readline()
                if not line:
                    return
                try:
                    reply = self._handle_line(line.strip())
                except Exception as e:
                    reply = f"ERR {type(e).__name__}: {e}"
                f.write(reply + "\n")
                f.flush()
        except (OSError, ValueError):
            pass
        finally:
            conn.close()

    def _handle_line(self, line: str) -> str:
        if not line:
            return "ERR empty request"
        cmd, _, rest = line.partition(" ")
        if cmd == "VIEW":
            return "OK " + self.view().to_json()
        if cmd == "WAIT":
            min_epoch, timeout_ms = rest.split()
            got = self.wait_view(int(min_epoch),
                                 timeout_s=int(timeout_ms) / 1000.0)
            return "OK " + got.to_json() if got is not None else "TIMEOUT"
        if cmd == "DEFINE":
            from ..parallel.distributed_spliter import VarDesc

            descs = [VarDesc(d["name"], tuple(d.get("shape") or ()),
                             d.get("dtype", "float32"))
                     for d in json.loads(rest)]
            self.define(descs)
            return "OK"
        if cmd == "PUSHED":
            epoch, _, names_json = rest.partition(" ")
            names = set(json.loads(names_json))
            with self._lock:
                if self._view.epoch == int(epoch):
                    self._needed -= names
                    self._lock.notify_all()
            return "OK"
        return f"ERR unknown command {cmd!r}"


class ClusterClient:
    """Subscriber surface over a remote (or in-process) controller.

    Trainers hand an instance to ``parallel.comm.set_cluster`` (or set
    ``PADDLE_TPU_CONTROLLER`` and let the comm layer build one); the
    fused send op then derives endpoint maps from the current view and
    retries failed rounds against fresh views.  ``set_param_provider``
    arms trainer-held recovery: during a rebalance that lost shards
    with no snapshot, the client pushes the provider's copies straight
    to the new owner pservers over PUT_BATCH."""

    def __init__(self, controller, timeout_s: float = 10.0,
                 poll_s: float = 0.5,
                 retry_policy: Optional[RetryPolicy] = None):
        # `controller` is an address string or an in-process
        # ClusterController (tests / single-process clusters)
        self._ctl = controller if not isinstance(controller, str) else None
        self._addr = None
        if isinstance(controller, str):
            host, port = controller.rsplit(":", 1)
            self._addr = (host, int(port))
        self._timeout = timeout_s
        self.poll_s = float(poll_s)
        self.policy = retry_policy or RetryPolicy.from_env(
            "CLUSTER_RETRY", max_attempts=3, base_delay=0.05,
            max_delay=0.5, deadline=5.0)
        self._provider: Optional[Callable[[str], object]] = None
        self._pushed: set = set()  # (epoch, name) already pushed
        self._cached: Optional[ClusterView] = None
        self._cached_at = 0.0
        self._lease: Optional[Lease] = None

    # -- wire ---------------------------------------------------------------
    def _roundtrip(self, line: str, timeout_s: Optional[float] = None) \
            -> str:
        if self._ctl is not None:
            return self._ctl._handle_line(line)

        def once():
            with socket.create_connection(
                    self._addr,
                    timeout=timeout_s or self._timeout) as s:
                s.sendall(line.encode() + b"\n")
                reply = s.makefile("r").readline()
                if not reply:
                    raise OSError("controller closed connection")
                return reply.strip()

        return self.policy.call(once, what=(
            f"cluster controller at "
            f"{self._addr[0]}:{self._addr[1]} unreachable"))

    @staticmethod
    def _parse(reply: str) -> ClusterView:
        if not reply.startswith("OK "):
            raise RuntimeError(f"cluster controller error: {reply}")
        return ClusterView.from_json(reply[3:])

    # -- views --------------------------------------------------------------
    def view(self) -> ClusterView:
        v = self._parse(self._roundtrip("VIEW"))
        self._cached, self._cached_at = v, time.monotonic()
        return v

    def wait_view(self, min_epoch: int,
                  timeout_s: float = 30.0) -> Optional[ClusterView]:
        """Next stable view with epoch >= min_epoch, or None."""
        deadline = time.monotonic() + timeout_s
        try:
            # a rebalance may ALREADY be waiting on our shard pushes —
            # check before blocking in WAIT, so trainer-held recovery
            # is prompt instead of deferred to the first WAIT timeout
            v = self.view()
            if v.status == "rebalancing":
                self._maybe_push_needed(v)
        except OSError:
            pass  # the WAIT loop below retries through the policy
        while True:
            left = deadline - time.monotonic()
            if left <= 0:
                return None
            # bounded server-side waits so a controller restart turns
            # into a retried request instead of a stuck socket; poll
            # fast when a rebalance is waiting on OUR shard pushes
            v = self._cached
            chunk = min(left, 5.0)
            if (self._provider is not None and v is not None
                    and v.status == "rebalancing" and v.needed):
                chunk = min(left, 0.5)
            reply = self._roundtrip(
                f"WAIT {int(min_epoch)} {int(chunk * 1000)}",
                timeout_s=chunk + self._timeout)
            if reply == "TIMEOUT":
                # refresh FIRST: a rebalance that started mid-WAIT is
                # only visible in a fresh view, and its `needed` list
                # is what trainer-held recovery pushes against
                v = self.view()
                if v.status == "rebalancing":
                    self._maybe_push_needed(v)
                continue
            v = self._parse(reply)
            self._cached, self._cached_at = v, time.monotonic()
            return v

    def ready_view(self, timeout_s: float = 60.0) -> ClusterView:
        """The current STABLE view with a placement, waiting out (and
        participating in) any rebalance in progress."""
        v = self._cached
        if (v is not None and v.status == "stable" and v.placement
                and time.monotonic() - self._cached_at < self.poll_s):
            return v
        deadline = time.monotonic() + timeout_s
        while True:
            v = self.view()
            if v.status == "stable" and v.placement:
                return v
            if v.status == "rebalancing" and v.needed:
                self._maybe_push_needed(v)
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"cluster: no stable view within {timeout_s}s "
                    f"(last: {v!r})")
            time.sleep(min(self.poll_s, 0.1))

    # -- membership ---------------------------------------------------------
    def join(self, kind: str, addr: Optional[str] = None,
             ttl_s: float = 2.0, on_lost=None) -> Lease:
        """Register this process as a cluster member (a trainer lease
        is what lets the controller adapt fan-in and the master reclaim
        task chunks when this process dies)."""
        reg_addr = self.view().registry
        if not reg_addr:
            raise RuntimeError("cluster view carries no registry address")
        addr = addr or f"{socket.gethostname()}:{os.getpid()}"
        self._lease = Lease(RegistryClient(reg_addr), kind, addr,
                            ttl_s=ttl_s, on_lost=on_lost)
        return self._lease

    def leave(self):
        if self._lease is not None:
            self._lease.release()
            self._lease = None

    # -- trainer-held shard recovery ----------------------------------------
    def set_param_provider(self, provider: Callable[[str], object]):
        """``provider(name) -> value or None``: the local parameter
        copies this process can contribute during a rebalance whose
        shards have no other source (typically the trainer scope —
        params there are refreshed by every round's pull)."""
        self._provider = provider

    def _maybe_push_needed(self, view: ClusterView):
        if self._provider is None or not view.needed:
            return
        # older epochs can never be pushed again — prune them so a
        # long-running job with periodic churn cannot grow this set
        # without bound
        self._pushed = {k for k in self._pushed if k[0] >= view.epoch}
        by_dst: Dict[str, list] = {}
        pushed = []
        for name in view.needed:
            key = (view.epoch, name)
            ep = view.placement.get(name)
            if key in self._pushed or ep is None:
                continue
            try:
                val = self._provider(name)
            except Exception:
                val = None
            if val is None:
                continue
            by_dst.setdefault(ep, []).append((name, val))
            pushed.append(name)
            self._pushed.add(key)
        if not by_dst:
            return
        from ..parallel.pserver import VariableClient

        for ep, pairs in by_dst.items():
            try:
                # a DEDICATED short-lived client, NOT the comm pool's:
                # pooled client sockets are only safe on their
                # endpoint's worker thread, and this runs on whatever
                # thread polled the view — possibly concurrent with a
                # round in flight on the same endpoint
                c = VariableClient(
                    ep, connect_timeout=2.0, request_timeout=15.0,
                    retry_policy=RetryPolicy.from_env(
                        "ELASTIC_RETRY", max_attempts=2,
                        base_delay=0.05, max_delay=0.25, deadline=2.0))
                try:
                    c.put_vars(pairs)
                finally:
                    c.close()
            except Exception as e:
                # a push is RECOVERY ASSIST: any failure (dead socket,
                # ERR reply like "batch too large") must not crash the
                # healthy trainer it runs on — un-mark so another
                # subscriber (or a later poll) can try
                _LOG.warning("trainer-held push to %s failed: %s", ep, e)
                for name, _ in pairs:
                    self._pushed.discard((view.epoch, name))
                    pushed.remove(name)
        if pushed:
            _LOG.info("pushed trainer-held copies of %s for view %d",
                      pushed, view.epoch)
            try:
                self._roundtrip(
                    f"PUSHED {view.epoch} {json.dumps(sorted(pushed))}")
            except OSError as e:
                # the values landed; a lost ack at worst lets the
                # controller fall back to its zero-fill degrade path —
                # strictly better than killing this trainer over it
                _LOG.warning("PUSHED ack for view %d failed: %s",
                             view.epoch, e)

    # -- var definitions ----------------------------------------------------
    def define(self, var_descs: Sequence):
        payload = json.dumps([
            {"name": v.name, "shape": list(v.shape or ()),
             "dtype": str(v.dtype)} for v in var_descs])
        reply = self._roundtrip("DEFINE " + payload)
        if not reply.startswith("OK"):
            raise RuntimeError(f"cluster controller error: {reply}")

    def close(self):
        self.leave()
