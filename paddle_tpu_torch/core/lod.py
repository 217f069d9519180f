"""LoDTensor, SelectedRows, TensorArray and Tensor runtime values
(counterpart of paddle_tpu/core/lod.py).

A `LoDTensor` is a dense tensor whose rows pack variable-length,
possibly nested sequences (PaddlePaddle's framework/lod_tensor.h): its
`data` is a torch tensor (or a numpy array in a feed or a fetch), and
its `lod` the offset tables, outermost level first, as a tuple of int
tuples.  The LoD is host metadata: it is part of the Executor's cache
key, so each distinct LoD is one cache entry (one CUDA graph on a card),
and the sequence ops build their index tables from it on the host
(ops/sequence.py).

A `SelectedRows` is the sparse row-slice gradient of an embedding table
built with `is_sparse=True` (PaddlePaddle's framework/selected_rows.h):
`value[i]` belongs to row `rows[i]` of a dense table of `height` rows,
and a row may appear more than once.  Ops that take one (sum, the
optimizer updates, split_selected_rows) say so; any other lowering that
meets one raises, naming itself (core/execution.py).

`rows` are int64 tensors here (the JAX package's are int32, as it never
enables x64): compare them by value.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

__all__ = ["LoDTensor", "SelectedRows", "Tensor", "TensorArray",
           "create_lod_tensor", "lod_from_seq_lens"]


class LoDTensor:
    """`data`: a tensor (or array) whose dim 0 is the packed row axis;
    `lod`: nested offset tables, outermost level first, e.g. [[0, 2, 5]]
    packs two sequences of lengths 2 and 3."""

    __slots__ = ("data", "lod")

    def __init__(self, data, lod: Sequence[Sequence[int]] = ()):
        self.data = data
        self.lod: Tuple[Tuple[int, ...], ...] = tuple(
            tuple(int(x) for x in level) for level in lod)

    @property
    def shape(self):
        return tuple(self.data.shape)

    @property
    def dtype(self):
        return self.data.dtype

    def seq_lens(self, level: int = 0) -> List[int]:
        offs = self.lod[level]
        return [offs[i + 1] - offs[i] for i in range(len(offs) - 1)]

    def num_sequences(self, level: int = 0) -> int:
        return len(self.lod[level]) - 1 if self.lod else self.data.shape[0]

    def recursive_seq_lens(self):
        return [self.seq_lens(i) for i in range(len(self.lod))]

    def segment_ids(self, level: int = 0) -> np.ndarray:
        """Row -> sequence index map."""
        offs = self.lod[level]
        return np.repeat(np.arange(len(offs) - 1, dtype=np.int64),
                         np.diff(np.asarray(offs, np.int64)))

    def map(self, fn):
        """The same LoD with `fn(data)` (a copy, a move, a conversion to
        numpy)."""
        return LoDTensor(fn(self.data), self.lod)

    def __repr__(self):
        return f"LoDTensor(shape={self.shape}, lod={self.lod})"


def lod_from_seq_lens(seq_lens: Sequence[int]) -> Tuple[int, ...]:
    offs = [0]
    for n in seq_lens:
        offs.append(offs[-1] + int(n))
    return tuple(offs)


def create_lod_tensor(data, recursive_seq_lens=(), place=None) -> LoDTensor:
    """A LoDTensor from flat data and per-level sequence lengths (the
    reference's fluid.create_lod_tensor); the data stays on the host
    until a feed places it."""
    del place
    lod = [lod_from_seq_lens(lv) for lv in recursive_seq_lens]
    return LoDTensor(np.asarray(data), lod)


class SelectedRows:
    """Sparse row slices: `rows` [n] int64, `value` [n, ...], the dense
    shape (height,) + value.shape[1:].  Duplicate rows are summed when
    the value is made dense, in the order they occur."""

    __slots__ = ("rows", "value", "height")

    def __init__(self, rows, value, height: int):
        self.rows = rows
        self.value = value
        self.height = int(height)

    @property
    def dense_shape(self):
        return (self.height,) + tuple(self.value.shape[1:])

    def to_dense(self):
        """The dense table: each row the sum of its values, in the order
        they occur — `index_add_` on the CPU; on a card
        `sorted_segment_sum`, which gives the CPU's bits without atomics
        (ops/embedding.py)."""
        if self.value.device.type == "cuda":
            from ..ops.embedding import sorted_segment_sum

            return sorted_segment_sum(self.rows, self.value, self.height)
        out = torch.zeros(self.dense_shape, dtype=self.value.dtype,
                          device=self.value.device)
        return out.index_add_(0, self.rows, self.value)

    def map(self, fn):
        """The same rows with `fn(rows)` and `fn(value)` (a copy, a move, a
        conversion to numpy)."""
        return SelectedRows(fn(self.rows), fn(self.value), self.height)

    def __repr__(self):
        return (f"SelectedRows(height={self.height}, n={len(self.rows)}, "
                f"row_dim={tuple(self.value.shape[1:])})")


class TensorArray:
    """LoDTensorArray: an ordered list of values (tensors or LoDTensors;
    None at an index not written yet) — the While loop's per-iteration
    states and beam search's per-step ids and scores.  A host value:
    only host ops (ops/control_flow.py) read or write one, and a write
    makes a new array, so an array read earlier keeps its values."""

    __slots__ = ("tensors",)

    def __init__(self, tensors=None):
        self.tensors: List = list(tensors or [])

    def append(self, t):
        self.tensors.append(t)

    def __len__(self):
        return len(self.tensors)

    def __getitem__(self, i):
        return self.tensors[i]

    def __repr__(self):
        return f"TensorArray(len={len(self.tensors)})"


class Tensor:
    """Host-side tensor container with the pybind Tensor surface
    (`t = fluid.Tensor(); t.set(arr, place)`), for feed construction."""

    def __init__(self):
        self._value = None

    def set(self, array, place=None):
        del place
        self._value = np.asarray(array)

    def shape(self):
        return list(self._value.shape) if self._value is not None else []

    def __array__(self, dtype=None, copy=None):
        return np.asarray(self._value, dtype)
