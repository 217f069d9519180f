"""The reader ops: create_random_data_generator, create_shuffle_reader,
create_batch_reader and read (counterparts of the reader part of
paddle_tpu/ops/io_ops.py).

Reference: PaddlePaddle's framework/reader.h (ReaderBase and the
DecoratedReader chain), operators/create_reader_op.cc and read_op.cc.

A reader is a host object held in a scope variable; each decorator
wraps the reader under it.  All four ops are host ops: the Executor runs
them eagerly between its device segments, passes the reader objects
through and never captures one.  The readers draw from
`np.random.RandomState`, as the JAX package's, so both give the same
values from the same seeds; `read` moves each array onto the op's
device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.execution import one
from ..core.registry import register_op


class RandomDataReader:
    """Uniform random samples of the given shapes
    (create_random_data_generator_op.cc)."""

    def __init__(self, shapes, low, high, seed=0):
        self.shapes = shapes
        self.low, self.high = low, high
        self.rng = np.random.RandomState(seed)

    def read_next(self):
        return [self.rng.uniform(self.low, self.high, s).astype(np.float32)
                for s in self.shapes]

    def reset(self):
        pass


class ShuffleReader:
    """Fills a buffer of `buffer_size` items from the reader under it,
    permutes it, and hands the items out from its end; None when the
    reader under it is exhausted."""

    def __init__(self, reader, buffer_size, seed=0):
        self.reader = reader
        self.buffer_size = buffer_size
        self.rng = np.random.RandomState(seed)
        self._buf = []

    def read_next(self):
        if not self._buf:
            for _ in range(self.buffer_size):
                item = self.reader.read_next()
                if item is None:
                    break
                self._buf.append(item)
            order = self.rng.permutation(len(self._buf))
            self._buf = [self._buf[i] for i in order]
        return self._buf.pop() if self._buf else None

    def reset(self):
        self._buf = []
        self.reader.reset()


class BatchReader:
    """Stacks up to `batch_size` items of the reader under it, slot by
    slot; None when it gives none."""

    def __init__(self, reader, batch_size):
        self.reader = reader
        self.batch_size = batch_size

    def read_next(self):
        rows = []
        for _ in range(self.batch_size):
            item = self.reader.read_next()
            if item is None:
                break
            rows.append(item)
        if not rows:
            return None
        return [np.stack([r[i] for r in rows]) for i in range(len(rows[0]))]

    def reset(self):
        self.reader.reset()


def _split_shapes(attrs):
    concat, shapes, off = list(attrs["shape_concat"]), [], 0
    for r in attrs["ranks"]:
        shapes.append(tuple(int(d) for d in concat[off:off + r]))
        off += r
    return shapes


@register_op("create_random_data_generator", inputs=(), outputs=("Out",),
             attrs={"shape_concat": [], "ranks": [], "lod_levels": [],
                    "min": 0.0, "max": 1.0, "seed": 0},
             not_differentiable=True, host=True)
def create_random_data_generator(ctx, ins, attrs):
    return {"Out": RandomDataReader(_split_shapes(attrs), attrs["min"],
                                    attrs["max"], attrs.get("seed", 0))}


@register_op("create_shuffle_reader", inputs=("UnderlyingReader",),
             outputs=("Out",), attrs={"buffer_size": 64},
             not_differentiable=True, host=True)
def create_shuffle_reader(ctx, ins, attrs):
    return {"Out": ShuffleReader(one(ins, "UnderlyingReader"),
                                 attrs["buffer_size"])}


@register_op("create_batch_reader", inputs=("UnderlyingReader",),
             outputs=("Out",), attrs={"batch_size": 1},
             not_differentiable=True, host=True)
def create_batch_reader(ctx, ins, attrs):
    return {"Out": BatchReader(one(ins, "UnderlyingReader"),
                               attrs["batch_size"])}


@register_op("read", inputs=("Reader",), outputs=("Out",),
             dup_outputs=("Out",), not_differentiable=True, host=True)
def read(ctx, ins, attrs):
    """The reader's next item, one tensor a slot on the op's device;
    EOFError when the reader is exhausted (read_op.cc)."""
    item = one(ins, "Reader").read_next()
    if item is None:
        raise EOFError("reader exhausted")
    return {"Out": [torch.from_numpy(np.ascontiguousarray(x)).to(ctx.device)
                    for x in item]}
