"""Task-dispatch master: Python surface over the native implementation
(counterpart of paddle_tpu/cloud/master.py; the native master is the
same source, native/src/master.cc).

Reference: Paddle's go/master/service.go (task queues, timeout
re-dispatch, failureMax discard, snapshot/recover) and
python/paddle/v2/master/client.py:29-117 (the trainer-side client:
set_dataset / next record paradigm).
"""
from __future__ import annotations

import ctypes
import socket
import time
from typing import List, Optional, Sequence

from .. import native
from ..core.resilience import RetryPolicy, fault_injector
from ..observability import metrics as obs_metrics
from ..observability import tracing as obs_tracing

# task-dispatch telemetry (gated by PADDLE_TPU_METRICS).  The master
# protocol itself is owned by the native server, so trace context is not
# carried on this wire; instead each client roundtrip gets a span and
# the whole chunk-processing window of a task records as `master.task` —
# reader work done while a task is held nests under it.
_M_REQUESTS = obs_metrics.counter(
    "paddle_tpu_master_requests_total",
    "master-client roundtrips, by verb", ("verb",))
_M_TASKS = obs_metrics.counter(
    "paddle_tpu_master_tasks_total",
    "task lifecycle acks sent to the master", ("result",))


def _declare(l):
    if getattr(l, "_master_declared", False):
        return l
    p, sz, i = ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int
    i64 = ctypes.c_int64
    l.pt_master_create.restype = p
    l.pt_master_create.argtypes = [i, ctypes.c_double, ctypes.c_char_p]
    l.pt_master_set_dataset.restype = i
    l.pt_master_set_dataset.argtypes = [
        p, ctypes.POINTER(ctypes.c_char_p), sz, sz,
    ]
    l.pt_master_has_dataset.restype = i
    l.pt_master_has_dataset.argtypes = [p]
    l.pt_master_get_task.restype = i
    l.pt_master_get_task.argtypes = [
        p, ctypes.POINTER(i64), ctypes.c_char_p, sz,
    ]
    l.pt_master_task_finished.restype = i
    l.pt_master_task_finished.argtypes = [p, i64]
    l.pt_master_task_failed.restype = i
    l.pt_master_task_failed.argtypes = [p, i64]
    l.pt_master_counts.argtypes = [p, ctypes.POINTER(i64)]
    l.pt_master_serve.restype = i
    l.pt_master_serve.argtypes = [p, i]
    l.pt_master_stop.argtypes = [p]
    l.pt_master_destroy.argtypes = [p]
    l._master_declared = True
    return l


class Master:
    """In-process master; optionally served over TCP for remote trainers.

    failure_max / timeout_s mirror the reference's task re-dispatch policy
    (service.go checkTimeoutFunc/processFailedTask); snapshot_path enables
    crash recovery (service.go snapshot/recover — a file here, etcd there).
    """

    def __init__(self, failure_max: int = 3, timeout_s: float = 60.0,
                 snapshot_path: Optional[str] = None):
        self._l = _declare(native.lib())
        self._h = self._l.pt_master_create(
            failure_max, timeout_s,
            snapshot_path.encode() if snapshot_path else None,
        )
        self.port = None

    def set_dataset(self, chunks: Sequence[str], chunks_per_task: int = 1):
        arr = (ctypes.c_char_p * len(chunks))(
            *[c.encode() for c in chunks]
        )
        self._l.pt_master_set_dataset(
            self._h, arr, len(chunks), chunks_per_task
        )

    @property
    def has_dataset(self) -> bool:
        return bool(self._l.pt_master_has_dataset(self._h))

    def get_task(self):
        """-> (task_id, [chunks]) or None if nothing available right now."""
        tid = ctypes.c_int64()
        buf = ctypes.create_string_buffer(1 << 20)
        st = self._l.pt_master_get_task(
            self._h, ctypes.byref(tid), buf, len(buf)
        )
        if st == 0:
            return None
        chunks = buf.value.decode().split("\n") if buf.value else []
        return tid.value, chunks

    def task_finished(self, task_id: int) -> bool:
        return bool(self._l.pt_master_task_finished(self._h, task_id))

    def task_failed(self, task_id: int) -> bool:
        return bool(self._l.pt_master_task_failed(self._h, task_id))

    def counts(self) -> dict:
        out = (ctypes.c_int64 * 5)()
        self._l.pt_master_counts(self._h, out)
        return {
            "todo": out[0], "pending": out[1], "done": out[2],
            "discarded": out[3], "pass": out[4],
        }

    # same surface as MasterClient so readers work against either
    info = counts

    def reclaim_expired(self) -> dict:
        """Run the lazy task-timeout check NOW and return the
        post-reclaim counts.

        The native master reclaims expired leases inside get_task /
        counts (service.go checkTimeoutFunc is a ticker there; here the
        check is amortized onto trainer roundtrips).  That is correct
        but LAZY: a task leased to a SIGKILLed trainer re-dispatches
        only when some surviving trainer next polls.  The elastic
        ClusterController pokes this on every trainer-lease expiry so
        orphaned chunks requeue as soon as ``timeout_s`` allows.

        Reclamation is exactly-once per expiry: the timeout sweep moves
        the task out of `pending` under the master lock, so a second
        sweep (or the vanished trainer's late FIN/FAIL ack) finds
        nothing — the late ack is rejected as stale and does NOT bump
        the task's `failure_max` accounting a second time
        (the JAX package's tests/test_elastic.py pins this)."""
        return self.counts()

    def serve(self, port: int = 0) -> int:
        """Start the TCP server; returns the bound port."""
        self.port = self._l.pt_master_serve(self._h, port)
        if self.port < 0:
            raise OSError("master: failed to bind server socket")
        return self.port

    def stop(self):
        self._l.pt_master_stop(self._h)

    def __del__(self):
        # interpreter shutdown may have torn down ctypes/native state in
        # any order; destroying twice or raising from __del__ would turn
        # a clean exit into "Exception ignored in" noise
        try:
            h = getattr(self, "_h", None)
            if h:
                self._h = None
                self._l.pt_master_destroy(h)
        except Exception:
            pass


class MasterClient:
    """TCP client for a remote Master (the cgo client.py analogue).

    Reconnects on socket failure — a trainer may outlive a restarted master
    (whose state comes back from its snapshot)."""

    def __init__(self, addr: str, retry_interval: float = 0.2,
                 timeout: float = 30.0,
                 retry_policy: Optional[RetryPolicy] = None):
        self.host, port = addr.rsplit(":", 1)
        self.port = int(port)
        self.retry_interval = retry_interval
        self.timeout = timeout
        # legacy kwargs map onto the policy: retry_interval seeds the
        # backoff, timeout bounds the whole retry sequence (the old flat
        # 50 x retry_interval loop is the from_env default's ancestor)
        self.policy = retry_policy or RetryPolicy.from_env(
            "MASTER_RETRY", max_attempts=50, base_delay=retry_interval,
            max_delay=max(retry_interval, 2.0), deadline=timeout)
        self._sock = None
        self._f = None

    def _connect(self):
        if self._sock is not None:
            return
        fault_injector().fire("master.connect")
        self._sock = socket.create_connection(
            (self.host, self.port), timeout=self.timeout
        )
        self._f = self._sock.makefile("rw", newline="\n")

    def _reset(self):
        # close the buffered file FIRST (with its flush suppressed):
        # closing only the socket leaves _f to flush buffered bytes at GC
        # time, which raises into "Exception ignored" noise during
        # interpreter shutdown when the server died mid-roundtrip
        f, s = self._f, self._sock
        self._sock = self._f = None
        for obj in (f, s):
            try:
                if obj is not None:
                    obj.close()
            except (OSError, ValueError):
                pass

    def _roundtrip(self, req: str, read_payload=False):
        verb = req.split(None, 1)[0] if req.strip() else "?"
        _M_REQUESTS.labels(verb=verb).inc()
        with obs_tracing.span("master.client." + verb.lower(),
                              endpoint=f"{self.host}:{self.port}"):
            return self._roundtrip_attempts(req, read_payload)

    def _roundtrip_attempts(self, req: str, read_payload=False):
        state = self.policy.begin()
        while True:
            try:
                self._connect()
                raw = req.encode()
                data = fault_injector().mangle("master.send", raw)
                if data != raw:
                    # injected mid-write crash / wire corruption: ship
                    # the mangled frame so the server sees it, then fail
                    # our side like the sender died
                    self._sock.sendall(data)
                    raise OSError("fault injection: mangled frame")
                self._f.write(req)
                self._f.flush()
                line = self._f.readline()
                if not line:
                    raise OSError("master connection closed")
                payload = None
                if read_payload and line.startswith("OK"):
                    payload = []
                    while True:
                        ln = self._f.readline()
                        if not ln:
                            raise OSError("master connection closed")
                        if ln.rstrip("\n") == ".":
                            break
                        payload.append(ln.rstrip("\n"))
                return line.rstrip("\n"), payload
            except OSError as e:
                self._reset()
                state.record(e, what=(f"master at {self.host}:{self.port} "
                                      "unreachable"))
                state.sleep()

    def set_dataset(self, chunks: Sequence[str], chunks_per_task: int = 1):
        req = f"SET {chunks_per_task} {len(chunks)}\n" + "".join(
            c + "\n" for c in chunks
        )
        line, _ = self._roundtrip(req)
        return line == "OK"

    def get_task(self):
        line, payload = self._roundtrip("GET\n", read_payload=True)
        if line == "NONE":
            return None
        _, _st, tid = line.split()
        return int(tid), payload

    def task_finished(self, task_id: int) -> bool:
        ok = self._roundtrip(f"FIN {task_id}\n")[0] == "OK"
        if ok:  # a rejected stale ack must not count as a completion
            _M_TASKS.labels(result="finished").inc()
        return ok

    def task_failed(self, task_id: int) -> bool:
        ok = self._roundtrip(f"FAIL {task_id}\n")[0] == "OK"
        if ok:
            _M_TASKS.labels(result="failed").inc()
        return ok

    def info(self) -> dict:
        line, _ = self._roundtrip("INFO\n")
        parts = line.split()
        return dict(
            zip(
                ("todo", "pending", "done", "discarded", "pass"),
                map(int, parts[1:]),
            )
        )

    # INFO runs the server's lazy timeout sweep, so poking a REMOTE
    # master is the same roundtrip (Master.reclaim_expired docs)
    reclaim_expired = info

    def close(self):
        self._reset()

    def __del__(self):
        try:
            self._reset()
        except Exception:
            pass


def task_record_reader(client, chunk_reader, poll_interval: float = 0.05,
                       stop_after_pass: bool = True,
                       on_chunk_error: str = "raise"):
    """Elastic reader: pull tasks from the master, yield records from each
    chunk via `chunk_reader(chunk) -> iterable`, ack on success, nack on
    error (reference v2/reader/creator.py:60-117 cloud_reader +
    master client NextRecord).

    One call iterates one dataset pass: it stops when the master rolls over
    to a new pass (status 2 on a later get_task) — so a fresh call starts
    the next pass, matching the epoch-per-call reader convention.

    `on_chunk_error` decides what happens after a failing chunk_reader is
    nacked (`task_failed`, so the master re-dispatches the task and
    discards it after failure_max nacks — service.go processFailedTask):
    "raise" propagates and kills this reader (a second reader picks the
    task up); "skip" moves on to the next task, so one surviving reader
    can drive a poisoned task to discard and still finish the pass.
    """
    if on_chunk_error not in ("raise", "skip"):
        raise ValueError(f"on_chunk_error={on_chunk_error!r}: "
                         "expected 'raise' or 'skip'")

    def reader():
        while True:
            got = client.get_task()
            if got is None:
                info = client.info()
                if info["todo"] == 0 and info["pending"] == 0:
                    return  # nothing left this pass
                time.sleep(poll_interval)  # others hold pending tasks
                continue
            tid, chunks = got
            # the task's processing window spans many yields, so a
            # context-managed span would stay pushed on the consumer's
            # stack between resumes (and forever, if the reader is
            # abandoned) — record it detached at the end instead
            task_parent = obs_tracing.current_context()
            t_wall, t0 = time.time(), time.perf_counter()

            def _record_task(ok):
                obs_tracing.record_span(
                    "master.task", t_wall, time.perf_counter() - t0,
                    parent=task_parent, task_id=tid,
                    chunks=len(chunks), ok=ok)

            try:
                for chunk in chunks:
                    yield from chunk_reader(chunk)
            except Exception:
                _record_task(False)
                client.task_failed(tid)
                if on_chunk_error == "raise":
                    raise
                # a nack that DISCARDED the task may have drained the
                # pass (todo and pending both empty); without this check
                # the next get_task would roll into a new pass and this
                # reader would re-yield chunks it already served
                if stop_after_pass:
                    info = client.info()
                    if info["todo"] == 0 and info["pending"] == 0:
                        return
                continue
            _record_task(True)
            client.task_finished(tid)
            if stop_after_pass:
                info = client.info()
                if info["todo"] == 0 and info["pending"] == 0:
                    return

    return reader
