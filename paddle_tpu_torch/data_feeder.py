"""DataFeeder: a Python minibatch -> a feed dict of arrays and LoDTensors
(counterpart of paddle_tpu/data_feeder.py; the reference's
python/paddle/v2/fluid/data_feeder.py DataToLoDTensorConverter).

The JAX package wraps the packing in a `feed.pack` profiler event; this
one does not yet, as the port's profiler (ROADMAP A10) is still to
come.  The arrays stay on the host: the Executor places them."""
from __future__ import annotations

import numpy as np

from .core.framework import Variable
from .core.lod import LoDTensor, lod_from_seq_lens
from .core.types import np_dtype

__all__ = ["DataFeeder"]


def _packed(parts, dtype):
    """Sequences concatenated along the row axis, as [rows, 1] when they
    hold scalars."""
    flat = (np.concatenate(parts, axis=0) if parts
            else np.zeros((0,), dtype=dtype))
    return flat.reshape(-1, 1) if flat.ndim == 1 else flat


class DataFeeder:
    def __init__(self, feed_list, place=None, program=None):
        self.feed_list = feed_list
        self.place = place

    def feed(self, iterable):
        """`iterable` of rows, each with one value per feed var:
        lod_level 0 slots are stacked dense; lod_level 1 slots are lists
        of variable-length sequences, packed flat with an offset table;
        deeper slots are lists of lists of sequences (two LoD levels)."""
        rows = list(iterable)
        out = {}
        for i, var in enumerate(self.feed_list):
            name = var.name if isinstance(var, Variable) else str(var)
            dtype = np_dtype(var.dtype if isinstance(var, Variable)
                             else "float32")
            lod_level = getattr(var, "lod_level", 0)
            col = [r[i] for r in rows]
            if lod_level == 0:
                arr = np.asarray(col, dtype=dtype)
                shape = getattr(var, "shape", None)
                if shape is not None and len(shape) > arr.ndim:
                    # rows carried flat features: the declared shape
                    arr = arr.reshape((len(rows),) + tuple(
                        d if d > 0 else -1 for d in shape[1:]))
                out[name] = arr
            elif lod_level == 1:
                seqs = [np.asarray(s, dtype=dtype) for s in col]
                out[name] = LoDTensor(
                    _packed(seqs, dtype),
                    [lod_from_seq_lens([len(s) for s in seqs])])
            else:
                # Paddle's convention: level-k offsets index level k+1's
                # entries (rows for the last level)
                outer_lens, inner, parts = [], [], []
                for doc in col:
                    outer_lens.append(len(doc))
                    for s in doc:
                        s = np.asarray(s, dtype=dtype)
                        inner.append(len(s))
                        parts.append(s)
                out[name] = LoDTensor(
                    _packed(parts, dtype),
                    [lod_from_seq_lens(outer_lens),
                     lod_from_seq_lens(inner)])
        return out
