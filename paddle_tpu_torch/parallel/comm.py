"""Fused, pipelined parameter-server communication (client side;
counterpart of paddle_tpu/parallel/comm.py).

The naive wire path pushed one variable per frame, one endpoint at a
time, on a single thread — a sync round over many small grads was
dominated by per-frame overhead and serialized RTTs.  This module adds
the canonical fixes (PyTorch DDP's gradient buckets, Horovod's tensor
fusion) on top of the batch verbs in parallel/pserver.py:

* **arrival-order gradient buckets** — `VariableClient.send_vars`
  packs grads in the order they arrive into buckets capped by the
  ``comm_bucket_bytes`` flag (``PADDLE_TPU_COMM_BUCKET_BYTES``) and
  ships each bucket as one ``SEND_BATCH`` frame;
* **a per-endpoint connection/worker pool** (`CommPool`) — each
  pserver gets its own client + single-thread worker, so a round's
  per-endpoint chain (bucketed sends → barrier → one batched GET) runs
  concurrently across pservers while staying ordered within each;
* **round telemetry** on the observability registry — end-to-end round
  latency, bytes moved per round by direction, and (in pserver.py)
  bucket fill/size histograms — so a Prometheus dump shows whether
  buckets actually fill and rounds actually overlap.

Wire compatibility is the client's job: a `VariableClient` whose server
answers ERR to a batch verb falls back to per-var frames permanently
for that endpoint (see pserver.py), so one `CommPool` can serve mixed
old/new pserver fleets.

**Elastic clusters** (cloud/cluster.py): when a cluster subscription
is armed (`set_cluster` or the ``PADDLE_TPU_CONTROLLER`` env var),
`elastic_round` re-derives each round's endpoint map from the
controller's current epoch-numbered view instead of the transpile-time
epmap, and a round that dies mid-flight (SIGKILLed pserver, shard
migrated away between view fetch and GET) waits for the next stable
view and replays against the new placement — no process restart.  The
transpiled epmap stays as the static fallback for vars the view does
not place.

The replay is exactly once where the servers say what happened (the
port's pservers answer a BARRIER "applied" or "released"): a grad whose
endpoint applied its round is not sent again, and a pull is kept only
from an endpoint whose round is settled.  The JAX package replays the
whole round (at least once), so a survivor's shard there may take a
round's update twice; against a server that does not say, the port
keeps a completed endpoint's round as applied.
"""
from __future__ import annotations

import logging
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

from ..observability import attribution as obs_attr
from ..observability import metrics as obs_metrics
from ..observability import tracing as obs_tracing
from .pserver import VariableClient

__all__ = ["CommPool", "comm_pool", "reset_comm_pool", "set_cluster",
           "get_cluster", "reset_cluster", "elastic_round",
           "ensure_param_provider"]

_LOG = logging.getLogger("paddle_tpu_torch.comm")

# 64 B .. 1 GiB, x4 steps — grad rounds span tiny RNN cells to
# full embedding tables
_BYTE_BUCKETS = tuple(float(1 << i) for i in range(6, 31, 2))

_M_ROUND_SECONDS = obs_metrics.histogram(
    "paddle_tpu_comm_round_seconds",
    "end-to-end pserver round latency: bucketed sends + barrier + "
    "param pull across all endpoints (send/recv op)")
_M_ROUND_BYTES = obs_metrics.histogram(
    "paddle_tpu_comm_round_bytes",
    "serialized payload bytes moved per round, by direction (frame "
    "heads excluded so the directions are comparable)",
    ("direction",), buckets=_BYTE_BUCKETS)
_M_ROUND_RETRIES = obs_metrics.counter(
    "paddle_tpu_comm_round_retries_total",
    "elastic rounds retried against a fresh cluster view after a "
    "mid-round failure (dead pserver / migrated shard)")
# per-endpoint round attribution: the straggler detector
# (observability/attribution.py) compares endpoints' mean round time,
# so one slow pserver shows up as a z-score instead of hiding inside
# the all-endpoint round histogram
ENDPOINT_ROUND_METRIC = "paddle_tpu_comm_endpoint_round_seconds"
_M_EP_ROUND = obs_metrics.histogram(
    ENDPOINT_ROUND_METRIC,
    "per-endpoint slice of a fused round: sends + barrier + pull on "
    "that endpoint's worker (straggler attribution)",
    ("endpoint",))


def _default_client(endpoint: str) -> VariableClient:
    """Pool client factory.  Under an elastic cluster subscription the
    retry budget is deliberately SHORT (env-tunable via
    PADDLE_TPU_ELASTIC_RETRY_*): a dead pserver is not coming back on
    this endpoint — the recovery path is failing the round fast and
    replaying it against the controller's next view, not sitting in a
    multi-minute reconnect loop."""
    if get_cluster() is None:
        return VariableClient(endpoint)
    from ..core.resilience import RetryPolicy

    return VariableClient(
        endpoint, connect_timeout=2.0, request_timeout=15.0,
        barrier_timeout=15.0,
        retry_policy=RetryPolicy.from_env(
            "ELASTIC_RETRY", max_attempts=2, base_delay=0.05,
            max_delay=0.25, deadline=2.0))


class CommPool:
    """Per-endpoint connection + worker pool.

    One `VariableClient` and one single-thread executor per endpoint:
    within an endpoint requests stay ordered (sends must precede the
    barrier, the barrier must precede the pull), across endpoints they
    overlap — the serial `for ep in endpoints` loop the send op used to
    run paid one full round trip chain per pserver."""

    def __init__(self, client_factory=None):
        self._factory = client_factory or _default_client
        self._clients: Dict[str, VariableClient] = {}
        self._workers: Dict[str, ThreadPoolExecutor] = {}
        self._lock = threading.Lock()
        self._closed = False

    def client(self, endpoint: str) -> VariableClient:
        with self._lock:
            c = self._clients.get(endpoint)
            closed = self._closed
        if c is not None:
            # existing clients keep serving while close() drains the
            # workers — only NEW connections are refused, so an
            # in-flight round finishes instead of failing mid-round
            return c
        if closed:
            raise RuntimeError("CommPool is closed")
        # connect OUTSIDE the lock: a booting pserver can take
        # seconds, and other endpoints' clients must not wait on it
        c = self._factory(endpoint)
        with self._lock:
            if self._closed:
                extant = None
            else:
                extant = self._clients.setdefault(endpoint, c)
        if extant is None:
            c.close()
            raise RuntimeError("CommPool is closed")
        if extant is not c:
            c.close()
            c = extant
        return c

    def _worker(self, endpoint: str) -> ThreadPoolExecutor:
        with self._lock:
            if self._closed:
                raise RuntimeError("CommPool is closed")
            w = self._workers.get(endpoint)
            if w is None:
                w = ThreadPoolExecutor(
                    max_workers=1,
                    thread_name_prefix=f"comm-{endpoint}")
                self._workers[endpoint] = w
            return w

    def send_round(self, send_items: Sequence[Tuple[str, str, object]],
                   get_items: Sequence[Tuple[str, str]],
                   bucket_bytes: Optional[int] = None) -> List[object]:
        """One fused synchronous round.

        ``send_items``: [(endpoint, name, value)] grads in arrival
        order; ``get_items``: [(endpoint, name)] params to pull.  Per
        endpoint that received grads: bucketed sends, then the batch
        barrier, then one batched GET — chained on that endpoint's
        worker so endpoints overlap.  Endpoints appearing only in
        ``get_items`` are read without a barrier (recv-op semantics).
        Returns pulled values aligned with ``get_items``."""
        results, errors = self._run_round(send_items, get_items,
                                          bucket_bytes)
        if errors:
            raise next(iter(errors.values()))
        out, idx = [], {ep: 0 for ep, _ in get_items}
        for ep, name in get_items:
            out.append(results[ep][0][idx[ep]])
            idx[ep] += 1
        return out

    def _run_round(self, send_items, get_items, bucket_bytes=None):
        """send_round's body -> ({endpoint: (pulled values, bytes sent,
        bytes received, the barrier's word or None)} for the endpoints
        whose barrier came back, {endpoint: exception} for those that
        failed, in endpoint order; an endpoint whose pull failed after
        its barrier is in both, its values None).  Every submitted
        endpoint is drained before it returns."""
        t0 = time.perf_counter()
        sends: Dict[str, list] = {}
        for ep, name, value in send_items:
            sends.setdefault(ep, []).append((name, value))
        gets: Dict[str, list] = {}
        for ep, name in get_items:
            gets.setdefault(ep, []).append(name)
        ctx = obs_tracing.current_context()

        def run_ep(ep):
            c = self.client(ep)
            s0, r0 = c.bytes_sent, c.bytes_recv
            te0 = time.perf_counter()
            with obs_tracing.activate(ctx), \
                    obs_tracing.span("comm.endpoint_round", endpoint=ep):
                said = None
                if ep in sends:
                    c.send_vars(sends[ep], bucket_bytes)
                    with obs_attr.phase("trainer", "barrier_wait"):
                        said = c.send_batch_barrier()
                vals, failed = [], None
                if ep in gets:
                    try:
                        with obs_attr.phase("trainer", "get"):
                            vals = c.get_vars(gets[ep], bucket_bytes)
                    except Exception as e:
                        # the round itself is settled (the barrier
                        # said so); the caller learns the pull failed
                        vals, failed = None, e
            _M_EP_ROUND.labels(endpoint=ep).observe(
                time.perf_counter() - te0)
            return vals, c.bytes_sent - s0, c.bytes_recv - r0, said, failed

        eps = sorted(set(sends) | set(gets))
        results: Dict[str, tuple] = {}
        errors: Dict[str, BaseException] = {}
        if eps:
            # ALWAYS go through the per-endpoint worker — even for one
            # endpoint: two caller threads sharing the pool would
            # otherwise interleave frames on the same non-thread-safe
            # client socket; the worker is what serializes them
            futs = {}
            for ep in eps:
                try:
                    futs[ep] = self._worker(ep).submit(run_ep, ep)
                except BaseException as e:
                    # pool closed mid-loop: stop submitting, but still
                    # drain what IS in flight below
                    errors[ep] = e
                    break
            for ep, f in futs.items():
                # drain EVERY submitted future before raising: an
                # abandoned in-flight worker would race the caller's
                # error handling on the shared clients
                try:
                    *results[ep], failed = f.result()
                    if failed is not None:
                        errors[ep] = failed
                except BaseException as e:
                    errors[ep] = e
            if errors:
                errors = {ep: errors[ep] for ep in eps if ep in errors}
        dt = time.perf_counter() - t0
        _M_ROUND_SECONDS.observe(dt)
        obs_attr.observe_phase("trainer", "send_round", dt)
        _M_ROUND_BYTES.labels(direction="sent").observe(
            sum(r[1] for r in results.values()))
        _M_ROUND_BYTES.labels(direction="recv").observe(
            sum(r[2] for r in results.values()))
        return results, errors

    def forget(self, endpoint: str):
        """Drop the pooled client/worker for one endpoint so the next
        round reconnects fresh — the elastic retry path calls this for
        every endpoint a failed round touched (a dead pserver's socket
        must not be reused, and a survivor's batch-capability probe is
        cheap to redo)."""
        with self._lock:
            c = self._clients.pop(endpoint, None)
            w = self._workers.pop(endpoint, None)
        # a forgotten endpoint must not export a stale straggler
        # series forever (elastic churn)
        _M_EP_ROUND.remove(endpoint=endpoint)
        # the failed round drained every submitted future before
        # raising, so the worker is idle here
        if w is not None:
            w.shutdown(wait=False)
        if c is not None:
            try:
                c.close()
            except Exception:
                pass

    def close(self):
        # order matters: mark closed (new rounds and NEW connections
        # fail fast; existing clients keep serving), drain the workers
        # so in-flight rounds finish against those live clients, and
        # only then close the sockets — closing first would let a
        # draining round register a fresh connection into an
        # already-swept pool and leak it
        with self._lock:
            self._closed = True
            workers = list(self._workers.values())
            self._workers.clear()
        for w in workers:
            w.shutdown(wait=True)
        with self._lock:
            clients = list(self._clients.values())
            self._clients.clear()
        for c in clients:
            c.close()


_POOL: Optional[CommPool] = None
_POOL_LOCK = threading.Lock()


def comm_pool() -> CommPool:
    """The process-wide pool the send/recv ops route through."""
    global _POOL
    with _POOL_LOCK:
        if _POOL is None:
            _POOL = CommPool()
        return _POOL


def reset_comm_pool():
    """Close every pooled connection/worker (tests, cluster teardown)."""
    global _POOL
    with _POOL_LOCK:
        pool, _POOL = _POOL, None
    if pool is not None:
        pool.close()


# ---------------------------------------------------------------------------
# elastic cluster subscription (cloud/cluster.py views)
# ---------------------------------------------------------------------------

_CLUSTER = None
_CLUSTER_TRIED_ENV = False


def set_cluster(cluster):
    """Arm the process-wide cluster subscription: `cluster` is a
    cloud.cluster.ClusterClient, a ClusterController (in-process
    clusters/tests), or a controller address string.  The send/recv ops
    then route every round through `elastic_round`."""
    global _CLUSTER, _CLUSTER_TRIED_ENV
    from ..cloud.cluster import ClusterClient, ClusterController

    if cluster is None or isinstance(cluster, ClusterClient):
        pass
    elif isinstance(cluster, (str, ClusterController)):
        cluster = ClusterClient(cluster)
    else:
        raise TypeError(f"set_cluster: expected ClusterClient, "
                        f"ClusterController or address, got {cluster!r}")
    with _POOL_LOCK:
        _CLUSTER = cluster
        _CLUSTER_TRIED_ENV = True
    return cluster


def get_cluster():
    """The armed cluster subscription, building one from the
    ``PADDLE_TPU_CONTROLLER`` env var on first call; None when the
    process is not part of an elastic cluster."""
    global _CLUSTER, _CLUSTER_TRIED_ENV
    with _POOL_LOCK:
        if _CLUSTER is not None or _CLUSTER_TRIED_ENV:
            return _CLUSTER
    # build OUTSIDE the lock (imports + construction), publish under
    # it: TRIED_ENV flips only together with the client so a
    # concurrent first caller can never observe "tried, but None" and
    # silently fall back to the static epmap for its round
    client = None
    addr = os.environ.get("PADDLE_TPU_CONTROLLER", "").strip()
    if addr:
        from ..cloud.cluster import ClusterClient

        client = ClusterClient(addr)
    with _POOL_LOCK:
        if _CLUSTER is None and not _CLUSTER_TRIED_ENV:
            _CLUSTER_TRIED_ENV = True
            _CLUSTER = client
        return _CLUSTER


def reset_cluster():
    """Drop the cluster subscription (tests, teardown).  The env var is
    re-read on the next get_cluster()."""
    global _CLUSTER, _CLUSTER_TRIED_ENV
    with _POOL_LOCK:
        c, _CLUSTER = _CLUSTER, None
        _CLUSTER_TRIED_ENV = False
    if c is not None:
        try:
            c.close()
        except Exception:
            pass


def _elastic_wait_s() -> float:
    try:
        return float(os.environ.get("PADDLE_TPU_ELASTIC_WAIT_S", "60"))
    except ValueError:
        return 60.0


def ensure_param_provider(scope):
    """Arm trainer-held shard recovery on the cluster subscription: the
    data-path scope's parameter copies (refreshed by every round's
    pull), read as numpy on the host, become a recovery source when a
    pserver dies snapshotless.  First scope wins; later calls are
    no-ops."""
    import numpy as np
    import torch

    cluster = get_cluster()
    if cluster is None or getattr(cluster, "_provider", None) is not None:
        return

    def provider(name):
        v = scope.find_var(name) if scope.has_var(name) else None
        if v is None:
            return None
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu()
            if v.dtype == torch.bfloat16:
                return v    # the wire carries bf16 as its bits
            return v.numpy()
        try:
            return np.asarray(v)
        except Exception:
            return v  # LoDTensor/SelectedRows ship as-is

    cluster.set_param_provider(provider)


def elastic_round(sends, gets, bucket_bytes: Optional[int] = None,
                  scope=None) -> List[object]:
    """One send/recv round that survives membership changes.

    ``sends``: [(placement_key, wire_name, value, fallback_ep)] — the
    placement key is the PARAM name (cluster views place params; grads
    ride to their param's owner), the wire name is what the pserver
    stores (the grad name).  ``gets``: [(placement_key, wire_name,
    fallback_ep)].  Without a cluster subscription this is exactly
    CommPool.send_round over the fallback endpoints.

    With one, each attempt maps keys through the CURRENT stable view's
    placement.  An attempt that fails somewhere (dead pserver: retries
    exhausted; stale placement: the server's ERR for an unknown var;
    a barrier a view change released without the round) forgets the
    failed connections, waits for a FRESH stable view (the controller
    publishes one once the dead member's TTL lease expires and shards
    have migrated), and replays what is left against the new
    placement: the grads of endpoints whose round was not applied, and
    the pulls not yet settled.  An endpoint that applied the round keeps
    it — its grads are not sent twice — and its parameters are pulled
    from wherever the new view places them."""
    from .pserver import BarrierTimeoutError

    pool = comm_pool()
    cluster = get_cluster()
    if cluster is None:
        return pool.send_round(
            [(ep, n, v) for _, n, v, ep in sends],
            [(ep, n) for _, n, ep in gets], bucket_bytes)
    if scope is not None:
        ensure_param_provider(scope)
    wait_s = _elastic_wait_s()
    todo_s = list(range(len(sends)))
    todo_g = list(range(len(gets)))
    pulled: Dict[int, object] = {}
    last_exc = None
    for attempt in range(8):
        view = cluster.ready_view(timeout_s=wait_s)
        place = view.placement
        s_eps = [place.get(sends[i][0], sends[i][3]) for i in todo_s]
        g_eps = [place.get(gets[i][0], gets[i][2]) for i in todo_g]
        results, errors = pool._run_round(
            [(ep, sends[i][1], sends[i][2])
             for i, ep in zip(todo_s, s_eps)],
            [(ep, gets[i][1]) for i, ep in zip(todo_g, g_eps)],
            bucket_bytes)
        sent_to = set(s_eps)
        # an endpoint's round is settled when its barrier came back and,
        # if it took grads, it applied them (a JAX server does not say:
        # its barrier's return counts as applied); its pull counts when
        # the round is settled and the pull itself succeeded
        settled = {ep for ep, r in results.items()
                   if ep not in sent_to or r[3] != "released"}
        idx: Dict[str, int] = {}
        left_g = []
        for i, ep in zip(todo_g, g_eps):
            k = idx.get(ep, 0)
            idx[ep] = k + 1
            if ep in settled and ep not in errors:
                pulled[i] = results[ep][0][k]
            else:
                left_g.append(i)
        todo_s = [i for i, ep in zip(todo_s, s_eps) if ep not in settled]
        todo_g = left_g
        if not todo_s and not todo_g:
            return [pulled[i] for i in range(len(gets))]
        for ep in errors:
            pool.forget(ep)
        failed = [e for e in errors.values()
                  if not isinstance(e, (OSError, ConnectionError,
                                        RuntimeError, BarrierTimeoutError))]
        if failed:
            raise failed[0]
        last_exc = (next(iter(errors.values())) if errors else
                    RuntimeError("elastic round: a view change released "
                                 "the round's barrier"))
        _M_ROUND_RETRIES.inc()
        _LOG.warning(
            "elastic round failed under view %d (%s); waiting for a "
            "fresh cluster view", view.epoch, last_exc)
        # wait briefly for a NEWER view (the usual cause: a member
        # died and the controller is rebalancing).  If none comes, the
        # failure was transient — a barrier timed out on round-skew, a
        # peer was mid-replay — so replay against the CURRENT view;
        # the attempt cap bounds the total spin.
        nxt = cluster.wait_view(view.epoch + 1,
                                timeout_s=min(wait_s, 5.0))
        if nxt is None:
            _LOG.warning(
                "elastic round: no newer view than %d; replaying "
                "against the current placement", view.epoch)
    raise last_exc
