"""v2-style ``Parameters``: name-addressed access to a Program's
parameters and a one-file tar round trip (counterpart of
paddle_tpu/parameters.py).

Reference: python/paddle/v2/parameters.py (keys :116, get/set :200-239,
to_tar :242, from_tar :274, init_from_tar :300).  Each tar member is a
``.npy`` file named after its parameter, with a ``meta.json`` manifest
of shapes and dtypes, as the JAX package writes them: the two packages'
tars of the same values are the same bytes.  numpy has no bfloat16
without ``ml_dtypes``; the JAX package's ``np.save`` of a bfloat16
array records it as the 2-byte void type ``<V2`` (its raw bits), and
the manifest says ``bfloat16``.  The port writes that header itself
from the tensor's raw storage and reads such a member back as
bfloat16.
"""
from __future__ import annotations

import io as _io
import json
import tarfile
from typing import Dict, List, Optional

import numpy as np
import torch

from .core.executor import global_scope
from .core.framework import Parameter, Program, default_main_program
from .core.scope import Scope, tensor_from_numpy
from .core.types import canonical_dtype, torch_dtype

__all__ = ["Parameters"]


def _npy_bytes(t: torch.Tensor) -> bytes:
    """The .npy file numpy's `np.save` writes for the tensor's values
    (for bfloat16: what it writes for an ml_dtypes bfloat16 array)."""
    t = t.detach().cpu().contiguous()
    buf = _io.BytesIO()
    if t.dtype == torch.bfloat16:
        np.lib.format.write_array_header_1_0(buf, {
            "descr": "<V2", "fortran_order": False,
            "shape": tuple(t.shape)})
        buf.write(t.view(torch.int16).numpy().tobytes())
    else:
        np.save(buf, t.numpy())
    return buf.getvalue()


def _tensor_of(arr: np.ndarray, dtype: Optional[str]) -> torch.Tensor:
    """A loaded member as a CPU tensor: 2-byte void data that the
    manifest (or the caller) calls bfloat16 keeps its bits."""
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        if dtype not in (None, "bfloat16"):
            raise ValueError(f"a 2-byte void array recorded as {dtype}")
        return torch.from_numpy(np.ascontiguousarray(arr).view(
            np.uint16).copy()).view(torch.bfloat16)
    return tensor_from_numpy(arr).clone()


class Parameters:
    """A live, dict-like view of a Program's parameters in a Scope:
    training's updates show through `get`, and `set` writes what later
    runs read."""

    def __init__(self, program: Optional[Program] = None,
                 scope: Optional[Scope] = None):
        self._program = program or default_main_program()
        self._scope = scope or global_scope()

    # -- introspection ----------------------------------------------------
    def _param_vars(self) -> Dict[str, object]:
        out = {}
        for block in self._program.blocks:
            for var in block.vars.values():
                if isinstance(var, Parameter):
                    out.setdefault(var.name, var)
        return out

    def names(self) -> List[str]:
        return sorted(self._param_vars())

    keys = names

    def has_key(self, name: str) -> bool:
        return name in self._param_vars()

    def __contains__(self, name: str) -> bool:
        return self.has_key(name)

    def __iter__(self):
        return iter(self.names())

    def __len__(self):
        return len(self._param_vars())

    def get_shape(self, name: str):
        return tuple(int(d) for d in self._param_vars()[name].shape)

    # -- value access -----------------------------------------------------
    def _tensor(self, name: str) -> torch.Tensor:
        var = (self._scope.find_var(name) if self._scope.has_var(name)
               else None)
        if var is None:
            raise KeyError(f"parameter '{name}' has no value in scope "
                           "(run the startup program first)")
        return var

    def get(self, name: str) -> np.ndarray:
        """The value as a numpy array (bfloat16 read as float32, which
        numpy has no type below)."""
        t = self._tensor(name).detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()

    __getitem__ = get

    def set(self, name: str, value) -> None:
        """Write `value` (numpy or a tensor), in the dtype and on the
        device of the value it replaces (else the parameter's declared
        dtype, on the CPU)."""
        if name not in self._param_vars():
            raise KeyError(f"'{name}' is not a parameter of the program")
        t = value if isinstance(value, torch.Tensor) else _tensor_of(
            np.asarray(value), None)
        if tuple(t.shape) != self.get_shape(name):
            raise ValueError(
                f"shape mismatch for '{name}': got {tuple(t.shape)}, "
                f"parameter is {self.get_shape(name)}")
        old = (self._scope.find_var(name) if self._scope.has_var(name)
               else None)
        if old is not None:
            t = t.to(old.device, old.dtype)
        else:
            t = t.to(torch_dtype(self._param_vars()[name].dtype))
        self._scope.set_var(name, t.clone() if t is value else t)

    __setitem__ = set

    # -- serialization ----------------------------------------------------
    def to_tar(self, f) -> None:
        """Every parameter into one tar stream (v2 to_tar)."""
        with tarfile.open(fileobj=f, mode="w") as tar:
            meta = {}
            for name in self.names():
                t = self._tensor(name)
                meta[name] = {"shape": list(t.shape),
                              "dtype": canonical_dtype(t.dtype)}
                data = _npy_bytes(t)
                ti = tarfile.TarInfo(name=name + ".npy")
                ti.size = len(data)
                tar.addfile(ti, _io.BytesIO(data))
            mbytes = json.dumps(meta, indent=1, sort_keys=True).encode()
            ti = tarfile.TarInfo(name="meta.json")
            ti.size = len(mbytes)
            tar.addfile(ti, _io.BytesIO(mbytes))

    @staticmethod
    def _iter_tar_tensors(f):
        """(name, CPU tensor) for every .npy member of a params tar."""
        with tarfile.open(fileobj=f, mode="r") as tar:
            members = tar.getmembers()
            meta = {}
            for m in members:
                if m.name == "meta.json":
                    meta = json.loads(tar.extractfile(m).read())
            for m in members:
                if not m.name.endswith(".npy"):
                    continue
                name = m.name[:-len(".npy")]
                arr = np.load(_io.BytesIO(tar.extractfile(m).read()),
                              allow_pickle=False)
                yield name, _tensor_of(arr, meta.get(name, {}).get("dtype"))

    def init_from_tar(self, f) -> None:
        """Load the parameters the tar and the program both hold (extra
        tar entries are ignored, v2 init_from_tar)."""
        own = self._param_vars()
        for name, t in self._iter_tar_tensors(f):
            if name in own:
                self.set(name, t)

    @staticmethod
    def from_tar(f) -> "Parameters":
        """A NEW Parameters from a tar alone: a detached Program with one
        Parameter a member and a private Scope holding the values on the
        CPU (v2 `from_tar`); `init_from_tar` loads into an existing
        program's parameters instead."""
        prog = Program()
        scope = Scope()
        blk = prog.global_block()
        for name, t in Parameters._iter_tar_tensors(f):
            blk.create_parameter(name, list(t.shape),
                                 canonical_dtype(t.dtype))
            scope.set_var(name, t)
        return Parameters(prog, scope)
