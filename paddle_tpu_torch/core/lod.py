"""SelectedRows and Tensor runtime values (counterpart of
paddle_tpu/core/lod.py).

A `SelectedRows` is the sparse row-slice gradient of an embedding table
built with `is_sparse=True` (PaddlePaddle's framework/selected_rows.h):
`value[i]` belongs to row `rows[i]` of a dense table of `height` rows,
and a row may appear more than once.  Ops that take one (sum, the
optimizer updates, split_selected_rows) say so; any other lowering that
meets one raises, naming itself (core/execution.py).

`rows` are int64 tensors here (the JAX package's are int32, as it never
enables x64): compare them by value.  LoDTensor and TensorArray wait for
the sequence ops that read LoD (ROADMAP A7).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["SelectedRows", "Tensor"]


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
