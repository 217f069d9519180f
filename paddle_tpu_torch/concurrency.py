"""CSP concurrency surface: make_channel / channel_send / channel_recv /
channel_close / go (counterpart of paddle_tpu/concurrency.py).

Paddle's doc/design/csp.md and framework/channel.h (the C++ Go-style
channels) describe the surface its Python DSL declared but never
implemented (tests/notest_csp.py:19-33).  Here the surface works:
channels are the port's native C++ buffered/unbuffered channels
(native/src/channel.cc) carrying pickled Python values, and `go()` runs
each registered callable on a thread of its own.

This is host-side orchestration (reader pipelines, daisy-chained
producers, actor-ish plumbing), not traced program state; device compute
launched inside a goroutine goes through the normal Executor or a loaded
artifact (io.load_aot_model) on the caller's device.  A tensor sent
through a channel is pickled with its device: a CUDA tensor arrives on
the same card.
"""
from __future__ import annotations

import contextlib
import pickle
import struct
import threading

from . import native

__all__ = ["make_channel", "channel_send", "channel_recv", "channel_close",
           "go", "Go"]

_PTR = struct.Struct("<Q")


class _PyChannel:
    """Typed channel of Python objects over a native bytes channel.

    The native channel moves fixed-size elements; it moves an 8-byte
    index into a side table holding the pickled payloads (arbitrary-size
    objects, while the blocking/closing semantics stay native)."""

    def __init__(self, dtype=None, capacity: int = 0):
        self.dtype = dtype
        self._ch = native.Channel(elem_size=_PTR.size, capacity=capacity)
        self._table = {}
        self._next = 0
        self._mu = threading.Lock()

    def send(self, value) -> bool:
        if self.dtype is not None and value is not None \
                and not isinstance(value, self.dtype):
            raise TypeError(
                f"channel of {self.dtype.__name__} got "
                f"{type(value).__name__}")
        with self._mu:
            idx = self._next
            self._next += 1
            self._table[idx] = pickle.dumps(value)
        ok = self._ch.send(_PTR.pack(idx))
        if not ok:
            with self._mu:
                self._table.pop(idx, None)
        return ok

    def recv(self):
        raw = self._ch.recv()
        if raw is None:
            return None  # closed and drained (Go zero-value convention)
        (idx,) = _PTR.unpack(raw)
        with self._mu:
            payload = self._table.pop(idx)
        return pickle.loads(payload)

    def close(self):
        self._ch.close()

    def __len__(self):
        return len(self._ch)


def make_channel(dtype=None, capacity: int = 0) -> _PyChannel:
    """Unbuffered (capacity=0, rendezvous) or buffered channel
    (Paddle's MakeChannel, channel.h:42)."""
    return _PyChannel(dtype, capacity)


def channel_send(channel: _PyChannel, value) -> bool:
    """Blocking send; False if the channel closed (channel.h Send)."""
    return channel.send(value)


def channel_recv(channel: _PyChannel):
    """Blocking recv; None once closed and drained (channel.h Receive)."""
    return channel.recv()


def channel_close(channel: _PyChannel):
    channel.close()


class Go:
    """A goroutine-style task: `spawn(fn)` runs fn on a daemon thread;
    an exception it raises is re-raised by `wait()` (the go op's
    semantics in doc/design/csp.md)."""

    def __init__(self):
        self._thread = None
        self._exc = None

    def _run(self, fn):
        try:
            fn()
        except BaseException as e:  # surfaced on wait()
            self._exc = e

    def spawn(self, fn):
        self._thread = threading.Thread(target=self._run, args=(fn,),
                                        daemon=True)
        self._thread.start()
        return self

    def wait(self, timeout=None):
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise TimeoutError("goroutine still running after timeout")
        if self._exc is not None:
            raise self._exc


@contextlib.contextmanager
def go():
    """Collect the block body and run it asynchronously.

    Python `with` blocks can't defer their own body, so the block
    registers callables:

        with fluid.go() as g:
            g(lambda: fluid.channel_send(ch, compute()))

    Every registered callable runs concurrently; `g.wait()` joins."""
    tasks = []

    class _Spawner:
        _handles = None  # set when the with-block exits

        def __call__(self, fn):
            tasks.append(fn)
            return fn

        def wait(self, timeout=None):
            if self._handles is None:
                raise RuntimeError(
                    "g.wait() called inside the `with go()` block — tasks "
                    "only spawn when the block exits")
            for h in self._handles:
                h.wait(timeout)

    sp = _Spawner()
    yield sp
    sp._handles = [Go().spawn(fn) for fn in tasks]
