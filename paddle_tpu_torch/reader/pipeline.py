"""Async input pipeline: the reader, the feed packing and the
host-to-device copy run on a worker thread, ahead of the training loop
(counterpart of paddle_tpu/reader/pipeline.py).

`prefetch_feeder(reader, feeder, place)` takes any batch reader and
returns another zero-argument reader whose iterator is a
`PrefetchIterator`: a bounded queue (backpressure), exceptions
re-raised in the consumer after the good batches before them, and a
clean shutdown (`close()`).

On a CUDA place the worker copies each feed from pinned host memory on
a CUDA stream of its own and records an event after the copy; the
consumer's current stream waits on that event before it is handed the
batch, and each tensor is recorded on the consumer's stream, so the
caching allocator does not reuse its memory while the consumer's work
may still read it.  So the consumer never reads a batch before its copy
has finished, and the copy overlaps the consumer's compute.  On the CPU
the staging is a plain `.to`.

The staging stage (`stage_to_device`) emits the `pipeline.h2d` profiler
event; the consumer's blocking on an empty queue is `pipeline.wait`.
"""
from __future__ import annotations

import itertools
import queue
import threading
import time

import torch

from . import _Error
from ..observability import attribution as obs_attr
from ..observability import metrics as obs_metrics
from ..observability import tracing as obs_tracing

__all__ = ["prefetch_feeder", "PrefetchIterator", "PrefetchReader",
           "stage_to_device"]

# queue occupancy per iterator (near `depth` = the reader keeps up, near
# 0 with long waits = the reader is the bottleneck); close() reclaims the
# series
_PIPE_IDS = itertools.count()
_M_QUEUE_DEPTH = obs_metrics.gauge(
    "paddle_tpu_pipeline_queue_depth",
    "prefetch queue occupancy (packed device-resident batches ready)",
    ("pipe",))
_M_WAIT_SECONDS = obs_metrics.histogram(
    "paddle_tpu_pipeline_wait_seconds",
    "consumer blocked on an empty prefetch queue per batch")


class _End:
    pass


def _staged(v, device, stream):
    from ..core.executor import _feed_tensor
    from ..core.lod import LoDTensor

    v = _feed_tensor(v)
    if isinstance(v, LoDTensor):
        return v.map(lambda d: _staged(d, device, stream))
    if not isinstance(v, torch.Tensor):
        return v
    if stream is None or v.device.type != "cpu":
        return v.to(device)
    with torch.cuda.stream(stream):
        return v.pin_memory().to(device, non_blocking=True)


def stage_to_device(value, device, stream=None):
    """One feed value on `device` (a LoDTensor's LoD kept), in a
    `pipeline.h2d` profiler event.  With a CUDA `stream`, a host tensor
    is copied from pinned memory on that stream, asynchronously: the
    caller records an event on the stream and makes the consumer wait
    on it."""
    from .. import profiler

    with profiler.record_event("pipeline.h2d"):
        return _staged(value, device, stream)


def _tensors_of(feed):
    from ..core.lod import LoDTensor

    vals = feed.values() if isinstance(feed, dict) else [feed]
    for v in vals:
        if isinstance(v, LoDTensor):
            v = v.data
        if isinstance(v, torch.Tensor):
            yield v


class PrefetchIterator:
    """One epoch of prefetched feeds: a daemon thread runs `reader() ->
    feeder.feed -> the copy to the device` into a queue of at most
    `depth` batches.  Errors in the worker re-raise at the consumer's
    next `__next__`; `close()` (idempotent, also at exhaustion) stops
    and joins the worker.  A live worker holds this iterator, so an
    abandoned one is not collected: hold the `PrefetchReader` that
    `prefetch_feeder` returns, whose `__del__` closes it."""

    def __init__(self, reader, feeder=None, place=None, depth=2,
                 device_put=True):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._done = False
        # the consumer's cumulative blocked seconds (queue empty)
        self.wait_s = 0.0
        self._feeder = feeder
        self._device_put = device_put
        # batches prepared on the worker record under the span that made
        # the iterator
        self._trace_ctx = obs_tracing.current_context()
        self._pipe_id = str(next(_PIPE_IDS))
        self._m_depth = _M_QUEUE_DEPTH.labels(pipe=self._pipe_id)
        self._device = self._stream = None
        if device_put:
            from ..core.executor import resolve_place

            self._device = resolve_place(
                place if place is not None else getattr(feeder, "place",
                                                        None))
            if self._device.type == "cuda":
                self._stream = torch.cuda.Stream(self._device)
        self.thread = threading.Thread(
            target=self._work, args=(reader,), daemon=True,
            name="paddle-tpu-prefetch")
        self.thread.start()

    # -- worker -------------------------------------------------------------
    def _put(self, item) -> bool:
        """A blocking put that gives up when the consumer closes."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _prepare(self, batch):
        """-> (feed, the event its copy recorded, or None)."""
        if self._feeder is not None:
            with obs_attr.phase("trainer", "feed_pack"):
                feed = self._feeder.feed(batch)
        else:
            feed = batch  # the reader yields feed dicts already
        if not self._device_put:
            return feed, None
        with obs_attr.phase("trainer", "h2d"):
            if isinstance(feed, dict):
                feed = {k: stage_to_device(v, self._device, self._stream)
                        for k, v in feed.items()}
            else:
                feed = stage_to_device(feed, self._device, self._stream)
        event = None
        if self._stream is not None:
            event = torch.cuda.Event()
            event.record(self._stream)
        return feed, event

    def _work(self, reader):
        try:
            with obs_tracing.activate(self._trace_ctx):
                for batch in reader():
                    if self._stop.is_set():
                        return
                    with obs_tracing.span("pipeline.prepare"):
                        item = self._prepare(batch)
                    if not self._put(item):
                        return
                    if obs_metrics.enabled():
                        self._m_depth.set(self._q.qsize())
                self._put(_End)
        except BaseException as e:  # re-raised in the consumer
            self._put(_Error(e))

    # -- consumer -----------------------------------------------------------
    def __iter__(self):
        return self

    def __next__(self):
        from .. import profiler

        if self._done:
            raise StopIteration
        with profiler.record_event("pipeline.wait"):
            t0 = time.perf_counter()
            item = self._q.get()
            dt = time.perf_counter() - t0
            self.wait_s += dt
        if obs_metrics.enabled():
            _M_WAIT_SECONDS.observe(dt)
            self._m_depth.set(self._q.qsize())
        if item is _End:
            self._done = True
            self.thread.join(timeout=5)
            raise StopIteration
        if isinstance(item, _Error):
            self._done = True
            self._stop.set()
            raise item.exc
        feed, event = item
        if event is not None:
            consumer = torch.cuda.current_stream(self._device)
            consumer.wait_event(event)
            for t in _tensors_of(feed):
                if t.is_cuda:
                    t.record_stream(consumer)
        return feed

    def close(self):
        """Stop the worker and join it (safe to call more than once)."""
        self._done = True
        self._stop.set()
        _M_QUEUE_DEPTH.remove(pipe=self._pipe_id)
        while True:  # drain, so a blocked put wakes at once
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        if self.thread.is_alive():
            self.thread.join(timeout=5)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class PrefetchReader:
    """A lazy one-epoch handle: the PrefetchIterator (and its thread)
    starts at the first `next()`, not at construction (the reader
    contract: `compose` calls every reader before reading any).  The
    worker references only the inner iterator, so dropping this handle
    is collectable, and `__del__` closes the iterator."""

    def __init__(self, reader, feeder=None, place=None, depth=2,
                 device_put=True):
        self._args = (reader, feeder, place, depth, device_put)
        self._it: "PrefetchIterator | None" = None
        self._closed = False

    def __iter__(self):
        return self

    def __next__(self):
        if self._closed:
            raise StopIteration
        if self._it is None:
            reader, feeder, place, depth, device_put = self._args
            self._it = PrefetchIterator(reader, feeder=feeder,
                                        place=place, depth=depth,
                                        device_put=device_put)
        return next(self._it)

    @property
    def wait_s(self) -> float:
        """The consumer's blocked seconds (PrefetchIterator.wait_s)."""
        return self._it.wait_s if self._it is not None else 0.0

    def close(self):
        self._closed = True
        if self._it is not None:
            self._it.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def prefetch_feeder(reader, feeder=None, place=None, depth=2,
                    device_put=True):
    """Batch reader -> reader of feed dicts already on `place` (the
    feeder's place when None, else CUDAPlace(0)), prepared `depth`
    batches ahead on a worker thread:

        feeds = prefetch_feeder(train_reader, feeder, place, depth=2)
        for feed in feeds():
            exe.run(main, feed=feed, fetch_list=[loss])

    `feeder=None`: the reader yields feed dicts and only the copy is
    staged; `device_put=False` keeps the values on the host.  Each call
    of the returned reader gives a fresh `PrefetchReader`."""

    def feed_reader():
        return PrefetchReader(reader, feeder=feeder, place=place,
                              depth=depth, device_put=device_put)

    return feed_reader
