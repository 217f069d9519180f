"""Scope: hierarchical name -> runtime value map.

Counterpart of paddle_tpu/core/scope.py.  Values are torch tensors (or
opaque Python objects).  `scope_from_numpy` / `scope_to_numpy` carry
weights between host arrays — the JAX package's parameters as
{name: np.ndarray}, a saved model's npz — and a scope on a device.
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional

import numpy as np
import torch

__all__ = ["Scope", "scope_from_numpy", "scope_to_numpy",
           "tensor_from_numpy"]


class Scope:
    def __init__(self, parent: Optional["Scope"] = None):
        self.parent = parent
        self._vars: Dict[str, object] = {}
        self.kids = []

    def var(self, name: str):
        """Get-or-create (returns None placeholder if new)."""
        if name not in self._vars:
            s = self._find_scope(name)
            if s is not None:
                return s._vars[name]
            self._vars[name] = None
        return self._vars[name]

    def new_scope(self) -> "Scope":
        s = Scope(self)
        self.kids.append(s)
        return s

    def drop_kids(self):
        self.kids.clear()

    def _find_scope(self, name) -> Optional["Scope"]:
        s = self
        while s is not None:
            if name in s._vars:
                return s
            s = s.parent
        return None

    def find_var(self, name: str):
        s = self._find_scope(name)
        if s is None:
            raise KeyError(f"variable '{name}' not found in scope")
        return s._vars[name]

    def has_var(self, name: str) -> bool:
        return self._find_scope(name) is not None

    def set_var(self, name: str, value, local: bool = False):
        """Write `value`.  Non-local writes update the owning scope if the
        name already exists somewhere up the chain (matches executor
        semantics where persistables live in the global scope)."""
        if not local:
            s = self._find_scope(name)
            if s is not None:
                s._vars[name] = value
                return
        self._vars[name] = value

    def local_names(self):
        return list(self._vars.keys())

    def erase(self, name: str):
        self._vars.pop(name, None)


def tensor_from_numpy(arr) -> torch.Tensor:
    """A host array as a CPU tensor sharing its memory where numpy
    allows.  numpy's extension dtype named "bfloat16" (what JAX hands
    over for a bf16 value; torch cannot read it) keeps its bits: viewed
    as uint16, then as torch.bfloat16."""
    a = np.asarray(arr)
    if not (a.flags.c_contiguous and a.flags.writeable):
        a = np.array(a, order="C")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def scope_from_numpy(arrays, place=None, scope: Optional[Scope] = None
                     ) -> Scope:
    """{name: array} -> `scope` (a new Scope when None) holding each
    value as a tensor on `place` (None = CUDAPlace(0); a place or a
    torch.device).  Integer arrays become int64, Paddle's id type: the
    JAX package runs its int64 as int32, so values, not dtypes, match.
    A bf16 array keeps its bits (`tensor_from_numpy`)."""
    from .executor import resolve_place

    device = resolve_place(place)
    scope = Scope() if scope is None else scope
    for name, arr in arrays.items():
        t = tensor_from_numpy(arr).clone()
        if not (t.is_floating_point() or t.dtype == torch.bool):
            t = t.long()
        scope.set_var(name, t.to(device))
    return scope


def scope_to_numpy(scope: Scope, names: Iterable[str]
                   ) -> Dict[str, np.ndarray]:
    """{name: np.ndarray} of `names` read from `scope` (bfloat16 values
    come back as float32, which numpy has no type below)."""
    out = {}
    for name in names:
        t = scope.find_var(name)
        if t is None:
            raise KeyError(f"variable '{name}' has no value in scope")
        if t.dtype == torch.bfloat16:
            t = t.float()
        out[name] = t.detach().cpu().numpy()
    return out
