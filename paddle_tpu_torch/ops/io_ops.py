"""The io ops: save, load, save_combine, load_combine, feed and fetch
(counterparts of paddle_tpu/ops/io_ops.py:28-183, :303-319).

Reference: PaddlePaddle's operators/save_op.cc, load_op.cc,
save_combine_op.cc, load_combine_op.cc, feed_op.cc and fetch_op.cc.

The tensor file is the JAX package's, byte for byte: the magic `PTP0`,
then per tensor `<I` version 0, `<I` header length, the JSON header
(`dtype`, `shape`, `lod` and, in a combined file, `name`, in that order,
`json.dumps`' default separators), `<Q` raw length and the raw
little-endian bytes.  So either package reads what the other writes.
bfloat16 goes through the tensor's raw 2-byte storage (numpy has no
such type without `ml_dtypes`, which the port does not need).

All six are host ops: the Executor runs them eagerly, outside every
device segment and CUDA graph.  `save` copies a card tensor to the
host; `load` puts the value on the Executor's device with its LoD and
keeps the dtype the file holds (a file the JAX package wrote holds its
int64 variables as int32: it never enables x64).
"""
from __future__ import annotations

import json
import os
import struct

import numpy as np
import torch

from ..core.execution import many, one
from ..core.lod import LoDTensor
from ..core.registry import register_op

__all__ = ["save_tensor_to_file", "load_tensor_from_file"]

MAGIC = b"PTP0"
VERSION = 0


def _host_array(t) -> np.ndarray:
    """A tensor's values as a contiguous numpy array on the host,
    bfloat16 as its raw uint16 storage; a 0-d value as shape [1], as
    the JAX package's `np.ascontiguousarray` writes it."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().contiguous()
        t = (t.view(torch.int16).numpy().view(np.uint16)
             if t.dtype == torch.bfloat16 else t.numpy())
    return np.ascontiguousarray(t)


def _payload(value):
    """-> (header dict, raw bytes) of one tensor value."""
    lod = ()
    if isinstance(value, LoDTensor):
        value, lod = value.data, value.lod
    arr = _host_array(value)
    dtype = ("bfloat16" if isinstance(value, torch.Tensor)
             and value.dtype == torch.bfloat16 else str(arr.dtype))
    header = {"dtype": dtype, "shape": [int(d) for d in arr.shape],
              "lod": [[int(o) for o in level] for level in lod]}
    return header, arr.tobytes()


def _write_tensor(f, value, name=None):
    header, raw = _payload(value)
    if name is not None:
        header["name"] = name
    hb = json.dumps(header).encode("utf-8")
    f.write(struct.pack("<I", VERSION))
    f.write(struct.pack("<I", len(hb)))
    f.write(hb)
    f.write(struct.pack("<Q", len(raw)))
    f.write(raw)


def _from_raw(raw, header, device):
    """The header's tensor from its raw bytes, on `device`."""
    shape = header["shape"]
    if header["dtype"] == "bfloat16":
        t = torch.from_numpy(np.frombuffer(raw, np.uint16).reshape(shape)
                             .copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.frombuffer(
            raw, np.dtype(header["dtype"])).reshape(shape).copy())
    t = t.to(device)
    if header.get("lod"):
        return LoDTensor(t, header["lod"])
    return t


def _read_tensor(f, device):
    """-> (header, value) of the next tensor, or None at the end."""
    ver_bytes = f.read(4)
    if len(ver_bytes) < 4:
        return None
    (ver,) = struct.unpack("<I", ver_bytes)
    if ver != VERSION:
        raise ValueError(f"unsupported tensor file version {ver}")
    (hlen,) = struct.unpack("<I", f.read(4))
    header = json.loads(f.read(hlen).decode("utf-8"))
    (rlen,) = struct.unpack("<Q", f.read(8))
    return header, _from_raw(f.read(rlen), header, device)


def save_tensor_to_file(path, value):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(MAGIC)
        _write_tensor(f, value)


def _open_checked(path):
    f = open(path, "rb")
    if f.read(4) != MAGIC:
        f.close()
        raise ValueError(f"{path} is not a paddle_tpu tensor file")
    return f


def load_tensor_from_file(path, device="cpu"):
    with _open_checked(path) as f:
        return _read_tensor(f, torch.device(device))[1]


def _check_overwrite(path, attrs):
    if os.path.exists(path) and not attrs.get("overwrite", True):
        raise IOError(f"{path} exists; overwrite=False (save_op.cc:45)")


@register_op("save", inputs=("X",), outputs=(),
             attrs={"file_path": "", "overwrite": True},
             not_differentiable=True, host=True, lod=True)
def save_lower(ctx, ins, attrs):
    path = attrs["file_path"]
    _check_overwrite(path, attrs)
    value = one(ins, "X")
    if value is None:
        raise ValueError(f"save: variable {ctx.op.input('X')} is not "
                         "initialized (reference save_op.cc enforce)")
    save_tensor_to_file(path, value)
    return {}


@register_op("load", inputs=(), outputs=("Out",),
             attrs={"file_path": ""}, not_differentiable=True, host=True)
def load_lower(ctx, ins, attrs):
    return {"Out": load_tensor_from_file(attrs["file_path"], ctx.device)}


@register_op("save_combine", inputs=("X",), outputs=(),
             attrs={"file_path": "", "overwrite": True}, dup_inputs=("X",),
             not_differentiable=True, host=True, lod=True)
def save_combine_lower(ctx, ins, attrs):
    path = attrs["file_path"]
    _check_overwrite(path, attrs)
    names = ctx.op.input("X")
    values = many(ins, "X")
    missing = [n for n, v in zip(names, values) if v is None]
    if missing:
        raise ValueError(
            f"save_combine: variables {missing} are not initialized")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(MAGIC)
        for name, v in zip(names, values):
            _write_tensor(f, v, name=name)
    return {}


@register_op("load_combine", inputs=(), outputs=("Out",),
             attrs={"file_path": ""}, dup_outputs=("Out",),
             not_differentiable=True, host=True)
def load_combine_lower(ctx, ins, attrs):
    """Each output by its name in the file when every name is there,
    else by position (the reference's load_combine)."""
    path = attrs["file_path"]
    out_names = ctx.op.output("Out")
    by_name, order = {}, []
    with _open_checked(path) as f:
        while True:
            rec = _read_tensor(f, ctx.device)
            if rec is None:
                break
            header, value = rec
            by_name[header.get("name")] = value
            order.append(value)
    if all(n in by_name for n in out_names):
        return {"Out": [by_name[n] for n in out_names]}
    if len(order) < len(out_names):
        raise ValueError(f"{path} holds {len(order)} tensors; program "
                         f"expects {len(out_names)}")
    return {"Out": order[:len(out_names)]}


@register_op("feed", inputs=("X",), outputs=("Out",), attrs={"col": 0},
             not_differentiable=True, host=True, lod=True)
def feed(ctx, ins, attrs):
    """Column `col` of a feed list into the output (reference
    feed_op.cc; the Executor's direct feeds normally replace it)."""
    item = one(ins, "X")
    if isinstance(item, (list, tuple)):
        item = item[attrs.get("col", 0)]
    return {"Out": item}


@register_op("fetch", inputs=("X",), outputs=("Out",), attrs={"col": 0},
             not_differentiable=True, host=True, lod=True)
def fetch(ctx, ins, attrs):
    """A variable into the fetch list, LoD intact (reference
    fetch_op.cc)."""
    return {"Out": one(ins, "X")}
