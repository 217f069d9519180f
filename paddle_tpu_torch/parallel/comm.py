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

**Elastic clusters** (the JAX package's cloud/cluster.py) are ROADMAP
A11's second slice: `set_cluster`, and a ``PADDLE_TPU_CONTROLLER``
environment variable, raise naming it.  Until then `elastic_round` is
exactly `CommPool.send_round` over the transpile-time endpoint map.
"""
from __future__ import annotations

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
    """Pool client factory (the elastic cluster's short retry budget
    comes with A11's second slice)."""
    return VariableClient(endpoint)


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
                if ep in sends:
                    c.send_vars(sends[ep], bucket_bytes)
                    with obs_attr.phase("trainer", "barrier_wait"):
                        c.send_batch_barrier()
                if ep in gets:
                    with obs_attr.phase("trainer", "get"):
                        vals = c.get_vars(gets[ep], bucket_bytes)
                else:
                    vals = []
            _M_EP_ROUND.labels(endpoint=ep).observe(
                time.perf_counter() - te0)
            return vals, c.bytes_sent - s0, c.bytes_recv - r0

        eps = sorted(set(sends) | set(gets))
        results: Dict[str, tuple] = {}
        if eps:
            # ALWAYS go through the per-endpoint worker — even for one
            # endpoint: two caller threads sharing the pool would
            # otherwise interleave frames on the same non-thread-safe
            # client socket; the worker is what serializes them
            futs = {}
            submit_exc = None
            for ep in eps:
                try:
                    futs[ep] = self._worker(ep).submit(run_ep, ep)
                except BaseException as e:
                    # pool closed mid-loop: stop submitting, but still
                    # drain what IS in flight below
                    submit_exc = e
                    break
            first_exc = None
            for ep, f in futs.items():
                # drain EVERY submitted future before raising: an
                # abandoned in-flight worker would race the caller's
                # error handling on the shared clients
                try:
                    results[ep] = f.result()
                except BaseException as e:
                    if first_exc is None:
                        first_exc = e
            if first_exc is None:
                first_exc = submit_exc
            if first_exc is not None:
                raise first_exc
        out, idx = [], {ep: 0 for ep in gets}
        for ep, name in get_items:
            out.append(results[ep][0][idx[ep]])
            idx[ep] += 1
        dt = time.perf_counter() - t0
        _M_ROUND_SECONDS.observe(dt)
        obs_attr.observe_phase("trainer", "send_round", dt)
        _M_ROUND_BYTES.labels(direction="sent").observe(
            sum(r[1] for r in results.values()))
        _M_ROUND_BYTES.labels(direction="recv").observe(
            sum(r[2] for r in results.values()))
        return out

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


_SECOND_SLICE = ("the elastic cluster (cloud/cluster.py: membership "
                 "views, shard migration) is not ported yet (ROADMAP "
                 "A11's second slice)")


def set_cluster(cluster):
    """Arm the process-wide cluster subscription (the JAX package's
    ClusterClient, ClusterController or controller address): raises
    naming A11's second slice, unless `cluster` is None (no
    subscription, the state this port is always in)."""
    global _CLUSTER, _CLUSTER_TRIED_ENV
    if cluster is not None:
        raise NotImplementedError(f"comm.set_cluster: {_SECOND_SLICE}")
    with _POOL_LOCK:
        _CLUSTER = None
        _CLUSTER_TRIED_ENV = True
    return None


def get_cluster():
    """The armed cluster subscription: None.  A
    ``PADDLE_TPU_CONTROLLER`` environment variable asks for one, which
    raises naming A11's second slice rather than training against the
    static endpoint map in its place."""
    global _CLUSTER_TRIED_ENV
    with _POOL_LOCK:
        if _CLUSTER is not None or _CLUSTER_TRIED_ENV:
            return _CLUSTER
    if os.environ.get("PADDLE_TPU_CONTROLLER", "").strip():
        raise NotImplementedError(
            f"PADDLE_TPU_CONTROLLER is set: {_SECOND_SLICE}")
    with _POOL_LOCK:
        _CLUSTER_TRIED_ENV = True
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
    pull) become a recovery source when a pserver dies snapshotless.
    The subscription comes with A11's second slice; until then there is
    none to arm (get_cluster() is None, or raises where one is asked
    for)."""
    del scope
    get_cluster()


def elastic_round(sends, gets, bucket_bytes: Optional[int] = None,
                  scope=None) -> List[object]:
    """One send/recv round.

    ``sends``: [(placement_key, wire_name, value, fallback_ep)] — the
    placement key is the PARAM name (cluster views place params; grads
    ride to their param's owner), the wire name is what the pserver
    stores (the grad name).  ``gets``: [(placement_key, wire_name,
    fallback_ep)].  Without a cluster subscription (the only state
    until A11's second slice) this is exactly CommPool.send_round over
    the fallback endpoints; the JAX package's replay of a failed round
    against the controller's next view comes with that slice."""
    if scope is not None:
        ensure_param_provider(scope)
    else:
        get_cluster()   # None, or raises where a cluster is asked for
    return comm_pool().send_round(
        [(ep, n, v) for _, n, v, ep in sends],
        [(ep, n) for _, n, ep in gets], bucket_bytes)
