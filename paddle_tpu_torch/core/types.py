"""Core dtype / variable-type vocabulary.

Counterpart of paddle_tpu/core/types.py.  Dtypes stay the Paddle
strings the Program IR serializes ("float32", "int64", ...); this module
maps them onto ``torch.dtype`` (and numpy, for the host-side formats).
"""
from __future__ import annotations

import numpy as np
import torch

# ---------------------------------------------------------------------------
# dtypes
# ---------------------------------------------------------------------------

_TORCH = {
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float64": torch.float64,
    "int8": torch.int8,
    "uint8": torch.uint8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "bool": torch.bool,
}
_FROM_TORCH = {v: k for k, v in _TORCH.items()}

FLOAT_DTYPES = ("float16", "bfloat16", "float32", "float64")


def canonical_dtype(d) -> str:
    """Accept strings / numpy dtypes / torch dtypes -> canonical name."""
    if isinstance(d, torch.dtype):
        if d not in _FROM_TORCH:
            raise ValueError(f"unsupported dtype {d!r}")
        return _FROM_TORCH[d]
    if isinstance(d, str):
        if d in _TORCH:
            return d
        # allow numpy-style names like '<f4'
        return np.dtype(d).name
    name = np.dtype(d).name
    if name not in _TORCH:
        raise ValueError(f"unsupported dtype {d!r}")
    return name


def torch_dtype(name) -> torch.dtype:
    """Canonical name (or anything canonical_dtype takes) -> torch dtype."""
    return _TORCH[canonical_dtype(name)]


def np_dtype(name):
    """Canonical name -> numpy dtype (bfloat16 via ml_dtypes)."""
    name = canonical_dtype(name)
    if name == "bfloat16":
        import ml_dtypes

        return np.dtype(ml_dtypes.bfloat16)
    return np.dtype(name)


def is_float_dtype(d) -> bool:
    return canonical_dtype(d) in FLOAT_DTYPES


# ---------------------------------------------------------------------------
# variable types (what a Variable holds)
# ---------------------------------------------------------------------------


class VarType:
    LOD_TENSOR = "lod_tensor"          # dense tensor (+ optional LoD)
    SELECTED_ROWS = "selected_rows"    # sparse row-slices (embedding grads)
    LOD_TENSOR_ARRAY = "tensor_array"  # list of tensors (dynamic RNN states)
    LOD_RANK_TABLE = "lod_rank_table"  # sequence-length sort table
    STEP_SCOPES = "step_scopes"        # control-flow local scopes
    READER = "reader"                  # data pipeline handle
    RAW = "raw"                        # opaque python object
    FEED_MINIBATCH = "feed_minibatch"
    FETCH_LIST = "fetch_list"
