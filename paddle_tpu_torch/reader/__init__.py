"""Reader composition: a reader is a zero-argument callable returning
an iterable of samples (counterpart of paddle_tpu/reader/).

Reference: python/paddle/v2/reader/decorator.py (map_readers, shuffle,
chain, compose, buffered, firstn, xmap_readers, PipeReader) and
minibatch.py (batch).  Pure Python: the same decorators give the same
samples in the same order as the JAX package's for the same seeds.
`native_pipeline` runs the port's C++ loader (native/src/loader.cc,
the JAX package's source), so it yields the same batches for the same
seed.
"""
from __future__ import annotations

import itertools
import queue
import random
import threading

__all__ = [
    "map_readers",
    "buffered",
    "compose",
    "chain",
    "shuffle",
    "firstn",
    "xmap_readers",
    "cache",
    "batch",
    "bucket_by_length",
    "native_pipeline",
    "prefetch_feeder",
    "PrefetchIterator",
    "PrefetchReader",
    "stage_to_device",
    "PipeReader",
    "ComposeNotAligned",
]


from . import creator  # noqa: E402,F401


class ComposeNotAligned(ValueError):
    pass


class _Error:
    """Exception carrier for worker->consumer queues: background reader
    failures re-raise in the consumer instead of truncating the stream."""

    def __init__(self, exc):
        self.exc = exc


def map_readers(func, *readers):
    """Reader applying `func` across the outputs of several readers
    (decorator.py map_readers)."""

    def reader():
        rs = [r() for r in readers]
        for args in zip(*rs):
            yield func(*args)

    return reader


def shuffle(reader, buf_size):
    """Buffered shuffle (decorator.py shuffle)."""

    def data_reader():
        buf = []
        for e in reader():
            buf.append(e)
            if len(buf) >= buf_size:
                random.shuffle(buf)
                for b in buf:
                    yield b
                buf = []
        if buf:
            random.shuffle(buf)
            for b in buf:
                yield b

    return data_reader


def chain(*readers):
    """Concatenate readers (decorator.py chain)."""

    def reader():
        return itertools.chain(*[r() for r in readers])

    return reader


def compose(*readers, **kwargs):
    """Zip readers into flattened tuples (decorator.py compose)."""
    check_alignment = kwargs.pop("check_alignment", True)

    def make_tuple(x):
        if isinstance(x, tuple):
            return x
        return (x,)

    def reader():
        rs = [r() for r in readers]
        if check_alignment:
            for outputs in itertools.zip_longest(*rs):
                if any(o is None for o in outputs):
                    raise ComposeNotAligned(
                        "outputs of readers are not aligned")
                yield sum((make_tuple(o) for o in outputs), ())
        else:
            for outputs in zip(*rs):
                yield sum((make_tuple(o) for o in outputs), ())

    return reader


def buffered(reader, size):
    """Prefetch into a bounded buffer on a worker thread
    (decorator.py buffered) — a host-side PrefetchIterator (no feed
    packing, no device transfer), which also gives abandoned streams a
    clean worker shutdown instead of a thread blocked on a full queue.
    `size <= 0` means unbounded, as before.  The generator wrapper keeps
    the original laziness: nothing is consumed from the source until the
    first next() (side-effecting sources like cloud_reader must not
    drain tasks at construction time)."""

    def data_reader():
        from .pipeline import PrefetchIterator

        it = PrefetchIterator(reader, feeder=None, device_put=False,
                              depth=size if size > 0 else 2 ** 30)
        try:
            yield from it
        finally:
            it.close()

    return data_reader


def firstn(reader, n):
    def data_reader():
        for i, item in enumerate(reader()):
            if i >= n:
                break
            yield item

    return data_reader


def xmap_readers(mapper, reader, process_num, buffer_size, order=False):
    """Parallel map over a reader with worker threads
    (decorator.py xmap_readers).  `order=True` preserves input order."""

    class _End:
        pass

    def data_reader():
        in_q = queue.Queue(buffer_size)
        out_q = queue.Queue(buffer_size)

        def feed():
            try:
                for i, d in enumerate(reader()):
                    in_q.put((i, d))
                for _ in range(process_num):
                    in_q.put(_End)
            except BaseException as e:
                # wake every worker with the error so each forwards one
                # _Error/_End downstream and the consumer can't deadlock
                for _ in range(process_num):
                    in_q.put(_Error(e))

        def work():
            item = in_q.get()
            try:
                while item is not _End:
                    if isinstance(item, _Error):
                        out_q.put(item)
                        return
                    i, d = item
                    out_q.put((i, mapper(d)))
                    item = in_q.get()
                out_q.put(_End)
            except BaseException as e:  # mapper raised
                out_q.put(_Error(e))

        threading.Thread(target=feed, daemon=True).start()
        workers = [threading.Thread(target=work, daemon=True)
                   for _ in range(process_num)]
        for w in workers:
            w.start()
        finished = 0
        if order:
            pending = {}
            want = 0
            while finished < process_num:
                item = out_q.get()
                if item is _End:
                    finished += 1
                    continue
                if isinstance(item, _Error):
                    raise item.exc
                i, d = item
                pending[i] = d
                while want in pending:
                    yield pending.pop(want)
                    want += 1
            for i in sorted(pending):
                yield pending[i]
        else:
            while finished < process_num:
                item = out_q.get()
                if item is _End:
                    finished += 1
                    continue
                if isinstance(item, _Error):
                    raise item.exc
                yield item[1]

    return data_reader


def cache(reader):
    """Materialize once, replay from memory."""
    all_data = []
    filled = []

    def data_reader():
        if not filled:
            all_data.extend(reader())
            filled.append(True)
        return iter(all_data)

    return data_reader


def batch(reader, batch_size, drop_last=False):
    """Group samples into lists of batch_size (reference minibatch.py)."""

    def batch_reader():
        b = []
        for item in reader():
            b.append(item)
            if len(b) == batch_size:
                yield b
                b = []
        if b and not drop_last:
            yield b

    return batch_reader


def bucket_by_length(reader, batch_size, boundaries, seq_slots=(0,),
                     key_slot=None, pad_value=0, drop_last=False):
    """Bucketed batching for variable-length samples: bounds the cache
    entries (and CUDA graphs) a program needs to len(boundaries) with
    `drop_last` (up to 2*len(boundaries) without it — each bucket's
    final partial batch adds at most one extra shape).

    The LoD offset table is part of the Executor's cache key
    (core/executor.py), so feeding raw per-batch length multisets
    misses the cache every batch; static length buckets bound that.  Samples are pooled by the bucket of ``len(sample[key_slot])``
    (default: the first seq slot); when a pool reaches `batch_size` a batch
    is yielded in which every slot in `seq_slots` is right-padded with
    `pad_value` to the bucket boundary, so every batch from a bucket has
    the SAME shapes + LoD and hits the same executable.

    Sequences longer than the last boundary are truncated to it.  Padding
    rows are real rows at the LoD level — models that must ignore them
    should mask (or choose a benign pad token, e.g. an embedding id whose
    vector is zero).  Partial pools are flushed at exhaustion unless
    `drop_last` (each flush costs at most one extra compile per bucket).
    """
    bounds = sorted({int(b) for b in boundaries})
    if not bounds:
        raise ValueError("boundaries must be non-empty")
    key = seq_slots[0] if key_slot is None else key_slot

    def bucket_of(n):
        for b in bounds:
            if n <= b:
                return b
        return bounds[-1]

    def pad(sample, bound):
        row = list(sample)
        for s in seq_slots:
            seq = list(row[s])[:bound]
            fill = bound - len(seq)
            if fill:
                seq = seq + [pad_value] * fill
            row[s] = seq
        return tuple(row)

    def bucket_reader():
        pools = {b: [] for b in bounds}
        for sample in reader():
            b = bucket_of(len(sample[key]))
            pool = pools[b]
            pool.append(pad(sample, b))
            if len(pool) == batch_size:
                yield pool[:]
                pool.clear()
        if not drop_last:
            for b in bounds:
                if pools[b]:
                    yield pools[b]

    return bucket_reader


def native_pipeline(reader, slots, batch_size, shuffle_buf=0, seed=0,
                    prefetch_depth=2, drop_last=False):
    """Fused shuffle+batch+double_buffer on native threads: yields tuples of
    stacked numpy arrays, one per slot.

    The native replacement for `shuffle(...) |> batch(...) |> buffered(...)`
    when samples are fixed-shape: shuffling, the stacking memcpy and prefetch
    all run off the GIL in C++ (native/src/loader.cc), overlapping the input
    pipeline with device compute — the role Paddle's double_buffer reader
    (framework/reader.h) and PyDataProvider2's async pool play.

    slots: [(shape, dtype), ...] of one sample's components.
    """
    from ..native import NativeLoader

    loader = NativeLoader(slots, batch_size, shuffle_buf=shuffle_buf,
                          seed=seed, prefetch_depth=prefetch_depth,
                          drop_last=drop_last)

    def batch_reader():
        return loader.run(reader)

    batch_reader.loader = loader
    return batch_reader


class PipeReader:
    """Stream records from a shell command's stdout (reference
    decorator.py:337 PipeReader) — `cat file`, `curl url`,
    `hadoop fs -cat ...`; file_type="gzip" decompresses inline."""

    def __init__(self, command, bufsize=8192, file_type="plain"):
        import codecs
        import shlex
        import subprocess
        import zlib

        if not isinstance(command, str):
            raise TypeError("command must be a string")
        if file_type not in ("plain", "gzip"):
            raise TypeError(f"file_type must be plain/gzip, got {file_type}")
        self.file_type = file_type
        if file_type == "gzip":
            self.dec = zlib.decompressobj(32 + zlib.MAX_WBITS)
        self.bufsize = bufsize
        # incremental decoder: a multibyte char split across read chunks
        # must not raise
        self._decoder = codecs.getincrementaldecoder("utf-8")()
        self.process = subprocess.Popen(
            shlex.split(command), bufsize=bufsize, stdout=subprocess.PIPE)

    def close(self):
        """Terminate the child (early-stopping consumers must call this,
        or the child blocks forever on a full pipe)."""
        if self.process.poll() is None:
            self.process.terminate()
        self.process.wait()

    def _gunzip(self, buff):
        """Decompress, restarting the decompressor at gzip member
        boundaries — concatenated .gz parts (`cat a.gz b.gz`) must not
        silently truncate after the first member."""
        import zlib

        out = b""
        while buff:
            out += self.dec.decompress(buff)
            if not self.dec.eof:
                break
            buff = self.dec.unused_data
            self.dec = zlib.decompressobj(32 + zlib.MAX_WBITS)
        return out

    def get_line(self, cut_lines=True, line_break="\n"):
        remained = ""
        while True:
            buff = self.process.stdout.read(self.bufsize)
            if not buff:
                break
            if self.file_type == "gzip":
                buff = self._gunzip(buff)
            decomp_buff = self._decoder.decode(buff)
            if cut_lines:
                lines = (remained + decomp_buff).split(line_break)
                remained = lines.pop(-1)
                yield from lines
            else:
                yield decomp_buff
        remained += self._decoder.decode(b"", final=True)
        if remained:
            yield remained
        rc = self.process.wait()
        if rc != 0:
            raise RuntimeError(f"PipeReader command failed with exit {rc}")


# imported last: pipeline reuses this module's _Error carrier
from .pipeline import (  # noqa: E402,F401
    PrefetchIterator,
    PrefetchReader,
    prefetch_feeder,
    stage_to_device,
)
