"""Resident inference serving: captured forwards + dynamic batching
(counterpart of paddle_tpu/serving/batching.py).

  * the model's forward is a `program_to_fn` function made ONCE, and on
    a CUDA place every batch-size bucket is captured into its CUDA graph
    at construction, so no request ever pays a capture: a dispatch is a
    replay;
  * a worker thread coalesces concurrently submitted requests into one
    dispatch (dynamic batching), padded up to the smallest bucket that
    fits with rows repeating the last request.  Inference has no
    cross-sample coupling (batch norm runs is_test), so K aggregated
    requests compute the same per-request results as K separate calls;
  * the coalesced batch is staged to the device through pinned memory
    (`stage_to_device`), and each dispatch's outputs come back to the
    host once, sliced per request.

Deadlines (`RequestDeadlineExceeded`), backpressure on a full queue
(`ServerSaturated`), `stats()`, the seven serving metrics and the
`serving.dispatch` fault point are the JAX package's.
"""
from __future__ import annotations

import itertools
import queue
import threading
import time
from concurrent.futures import Future, InvalidStateError
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..core.executor import program_to_fn, resolve_place
from ..core.resilience import fault_injector
from ..core.types import torch_dtype
from ..observability import metrics as obs_metrics
from ..observability import tracing as obs_tracing

__all__ = ["InferenceServer", "ServerSaturated", "RequestDeadlineExceeded"]

# serving telemetry, one label per server instance.  The counters that
# back stats() are always=True; the latency/batch/queue series are gated
_SERVER_IDS = itertools.count()
_M_REQUESTS = obs_metrics.counter(
    "paddle_tpu_serving_requests_total",
    "requests dispatched to the device", ("server",), always=True)
_M_DISPATCHES = obs_metrics.counter(
    "paddle_tpu_serving_dispatches_total",
    "coalesced device dispatches (dispatches << requests shows "
    "aggregation)", ("server",), always=True)
_M_SHED = obs_metrics.counter(
    "paddle_tpu_serving_shed_total",
    "submits rejected with ServerSaturated (queue full)",
    ("server",), always=True)
_M_DEADLINE = obs_metrics.counter(
    "paddle_tpu_serving_deadline_expired_total",
    "requests dropped because their deadline expired while queued",
    ("server",), always=True)
_M_LATENCY = obs_metrics.histogram(
    "paddle_tpu_serving_request_seconds",
    "submit -> result-delivered wall latency", ("server",))
_M_BATCH = obs_metrics.histogram(
    "paddle_tpu_serving_batch_size",
    "requests coalesced per dispatch", ("server",),
    buckets=(1, 2, 4, 8, 16, 32, 64, 128))
_M_QDEPTH = obs_metrics.gauge(
    "paddle_tpu_serving_queue_depth",
    "requests waiting in the batching queue", ("server",))


class ServerSaturated(RuntimeError):
    """The admission queue is full — graceful backpressure: the caller
    should shed load or retry later, instead of blocking unboundedly
    behind a stalled worker."""


class RequestDeadlineExceeded(TimeoutError):
    """A request's deadline expired while it sat in the queue; the
    server drops it without spending device time on it."""


def stage_to_device(value: torch.Tensor, device) -> torch.Tensor:
    """A host tensor on `device`: through pinned memory and an
    asynchronous copy for a CUDA device (the host allocator keeps the
    pinned block until the copy ran), as it is for the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return value.to(device)
    return value.pin_memory().to(device, non_blocking=True)


class InferenceServer:
    """Resident server over one feed / one fetch inference program.

    server = InferenceServer(infer_prog, "img", predict, scope)
    fut = server.submit(img)          # [C,H,W] or [1,C,H,W]
    out = fut.result()                # [1, ...] numpy, blocks this caller
    server.close()

    `place` defaults to CUDAPlace(0).  `buckets` are the batch sizes
    captured at construction; a coalesced batch pads up to the smallest
    bucket that fits (padding rows repeat the last request and are
    sliced away before delivery).  `graph_stats()` counts the captures
    and replays (no capture after construction)."""

    def __init__(self, program, feed_name: str, fetch_var, scope,
                 place=None, buckets: Sequence[int] = (1, 2, 4, 8, 16),
                 window_ms: float = 0.3, max_queue: int = 1024):
        self._feed_name = feed_name
        self._fetch_name = getattr(fetch_var, "name", str(fetch_var))
        self._buckets = sorted(set(int(b) for b in buckets))
        self._window_s = window_ms / 1000.0
        self._device = resolve_place(place)
        self._fn = program_to_fn(program, [feed_name], [self._fetch_name],
                                 place=self._device)
        self._states = {n: scope.find_var(n).to(self._device)
                        for n in self._fn.state_in_names}
        var = program.global_block().vars.get(feed_name)
        if var is None:
            raise ValueError(f"no feed var {feed_name!r} in program")
        sample = tuple(int(d) for d in var.shape)
        if sample and sample[0] == -1:  # data vars carry the batch dim
            sample = sample[1:]
        self._item_shape = sample
        self._dtype = torch_dtype(var.dtype)
        # every bucket up front: its eager first run, then its capture
        # (one run on the CPU), so serving never pays either
        for b in self._buckets:
            x = torch.zeros((b,) + sample, dtype=self._dtype,
                            device=self._device)
            for _ in range(2 if self._device.type == "cuda" else 1):
                self._fn({feed_name: x}, self._states)
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)
        self._q: "queue.Queue" = queue.Queue(maxsize=max_queue)
        self._stop = False
        # serializes submit vs close: without it a submit that passed
        # the stop check could enqueue AFTER close() drained the queue,
        # leaving its Future unresolved forever
        self._submit_lock = threading.Lock()
        sid = self._sid = str(next(_SERVER_IDS))
        self._m_requests = _M_REQUESTS.labels(server=sid)
        self._m_dispatches = _M_DISPATCHES.labels(server=sid)
        self._m_shed = _M_SHED.labels(server=sid)
        self._m_deadline = _M_DEADLINE.labels(server=sid)
        self._m_latency = _M_LATENCY.labels(server=sid)
        self._m_batch = _M_BATCH.labels(server=sid)
        self._m_qdepth = _M_QDEPTH.labels(server=sid)
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    # -- client side --------------------------------------------------------
    def _request(self, x) -> torch.Tensor:
        """A request as a [1, ...] host tensor of the feed's dtype."""
        t = x if isinstance(x, torch.Tensor) else torch.as_tensor(
            np.asarray(x))
        t = t.detach().to(device="cpu", dtype=self._dtype)
        if tuple(t.shape) == self._item_shape:
            t = t[None]
        if tuple(t.shape) != (1,) + self._item_shape:
            raise ValueError(f"request shape {tuple(t.shape)} != "
                             f"(1,)+{self._item_shape}")
        return t

    def submit(self, x, deadline_ms: Optional[float] = None) -> Future:
        """Enqueue one request ([C,H,W] or [1,C,H,W], numpy or a tensor);
        returns a Future resolving to the [1, ...] fetch for this
        request.  With `deadline_ms`, a request still queued when the
        deadline passes is failed with RequestDeadlineExceeded instead of
        occupying a batch slot; a saturated queue raises ServerSaturated
        immediately."""
        x = self._request(x)
        fut: Future = Future()
        expires = (time.monotonic() + deadline_ms / 1000.0
                   if deadline_ms is not None else None)
        item = (x, fut, expires, time.perf_counter(),
                obs_tracing.current_context())
        with self._submit_lock:
            if self._stop:
                raise RuntimeError("InferenceServer is closed")
            try:
                # non-blocking while holding the lock: a blocking put on
                # a full queue would wedge every submitter on the lock and
                # deadlock close()
                self._q.put_nowait(item)
            except queue.Full:
                self._m_shed.inc()
                raise ServerSaturated(
                    "InferenceServer queue full "
                    f"({self._q.maxsize} pending) — backpressure: retry "
                    "later or raise max_queue") from None
        if obs_metrics.enabled():
            self._m_qdepth.set(self._q.qsize())
        return fut

    def infer(self, x, timeout: Optional[float] = None):
        """Synchronous single request (`timeout` in seconds bounds the
        wait for the result)."""
        return np.asarray(self.submit(x).result(timeout))

    def stats(self) -> Dict[str, int]:
        """`requests`/`dispatches` (dispatches << requests shows
        aggregation), `shed` (ServerSaturated rejections),
        `deadline_expired` (queued requests dropped at their deadline)
        and the instantaneous `queue_depth`."""
        return {"requests": int(self._m_requests.value),
                "dispatches": int(self._m_dispatches.value),
                "shed": int(self._m_shed.value),
                "deadline_expired": int(self._m_deadline.value),
                "queue_depth": self._q.qsize()}

    def graph_stats(self) -> Dict[str, int]:
        """The forward's `eager_runs`, `captures` and `replays`."""
        return dict(self._fn.stats)

    def close(self):
        with self._submit_lock:
            self._stop = True
        self._worker.join(timeout=5)
        # reclaim this instance's registry series (stats() keeps working
        # off the held child objects)
        for fam in (_M_REQUESTS, _M_DISPATCHES, _M_SHED, _M_DEADLINE,
                    _M_LATENCY, _M_BATCH, _M_QDEPTH):
            fam.remove(server=self._sid)
        # fail any requests still queued — abandoning them would hang
        # callers blocked in fut.result() forever
        while True:
            try:
                _, fut, _, _, _ = self._q.get_nowait()
            except queue.Empty:
                break
            fut.set_exception(RuntimeError("InferenceServer closed"))
        self._fn.close()

    # -- worker -------------------------------------------------------------
    def _expired(self, item) -> bool:
        """Shed a dead request at dequeue time, updating the queue-depth
        gauge (a deadline storm drains the queue here, not through a
        dispatch)."""
        _, fut, expires, _, _ = item
        if expires is None or time.monotonic() < expires:
            return False
        self._m_deadline.inc()
        if obs_metrics.enabled():
            self._m_qdepth.set(self._q.qsize())
        _deliver(fut, exception=RequestDeadlineExceeded(
            "request deadline expired while queued"))
        return True

    def _take_batch(self):
        """Block for the first request, then coalesce whatever arrives
        within the window, capped at the largest bucket."""
        try:
            first = self._q.get(timeout=0.05)
        except queue.Empty:
            return []
        if self._expired(first):
            return []
        batch = [first]
        cap = self._buckets[-1]
        deadline = time.perf_counter() + self._window_s
        while len(batch) < cap:
            remain = deadline - time.perf_counter()
            if remain <= 0 and self._q.empty():
                break
            try:
                item = self._q.get(timeout=max(remain, 0))
            except queue.Empty:
                break
            if not self._expired(item):
                batch.append(item)
        return batch

    def _dispatch(self, xs):
        """One bucket's forward -> its outputs on the host."""
        staged = stage_to_device(torch.cat(xs), self._device)
        with torch.no_grad():
            out = self._fn({self._feed_name: staged},
                           self._states)[0][self._fetch_name]
            if out.dtype == torch.bfloat16:
                out = out.float()
            # read before the next replay overwrites the graph's output
            return out.cpu().numpy()

    def _loop(self):
        if self._device.type == "cuda":
            torch.cuda.set_device(self._device)
        while not self._stop:
            batch = self._take_batch()
            if not batch:
                continue
            # chaos hook: delay rules back the queue up; an error rule
            # fails this batch but must not kill the worker
            try:
                fault_injector().fire("serving.dispatch")
            except Exception as e:
                for _, fut, _, _, _ in batch:
                    _deliver(fut, exception=e)
                continue
            n = len(batch)
            bucket = next(b for b in self._buckets if b >= n)
            xs = [item[0] for item in batch]
            if bucket > n:  # pad with the last request, sliced away below
                xs += [xs[-1]] * (bucket - n)
            # the dispatch span parents under the FIRST request's
            # submitter context: its latency is the one the dispatch
            # bounds
            with obs_tracing.activate(batch[0][4]), \
                    obs_tracing.span("serving.dispatch", batch=n,
                                     bucket=bucket):
                try:
                    out = self._dispatch(xs)
                except Exception as e:  # deliver, don't kill the loop
                    for _, fut, _, _, _ in batch:
                        _deliver(fut, exception=e)
                    continue
            self._m_dispatches.inc()
            self._m_requests.inc(n)
            metrics_on = obs_metrics.enabled()
            if metrics_on:
                self._m_batch.observe(n)
                self._m_qdepth.set(self._q.qsize())
            for i, (_, fut, _, t0, _) in enumerate(batch):
                _deliver(fut, result=out[i:i + 1])
                if metrics_on:
                    self._m_latency.observe(time.perf_counter() - t0)


def _deliver(fut: Future, result=None, exception=None):
    """Resolve a future, tolerating client-side cancellation (a
    set_result on a cancelled Future raises InvalidStateError, which
    must not kill the worker loop) — only that."""
    try:
        if exception is not None:
            fut.set_exception(exception)
        else:
            fut.set_result(result)
    except InvalidStateError:
        pass  # cancelled by the client; nothing to deliver
