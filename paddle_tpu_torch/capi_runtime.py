"""Python side of the C inference ABI (native/src/capi.cc), counterpart
of paddle_tpu/capi_runtime.py.

Paddle ships a pure-C inference ABI (paddle/capi/gradient_machine.h:
paddle_gradient_machine_create_for_inference_with_parameters + forward)
so C/C++/mobile hosts can embed trained models.  The port keeps that ABI,
with the JAX package's six function names and signatures, so a C host
links either library; the engine behind it is this module: `_capi`
embeds CPython, loads the saved inference model
(`io.load_inference_model`) and runs it through the port's Executor, on
CUDAPlace(0) unless PADDLE_TPU_CAPI_PLACE=cpu (the JAX package's runs on
the CPU unless told otherwise; the port's entry points run on the card).

A float32 feed is cast to the dtype the program declares for it (a bf16
model takes float32 from C, as C has no bf16); a fetch is handed back as
float32.  Handles are tracked in a registry keyed by integer id so the C
side never owns Python object lifetimes.
"""
from __future__ import annotations

import os
import threading
from typing import Dict

import numpy as np
import torch

__all__ = ["create", "feed", "run", "fetch", "destroy", "capi_place"]

_sessions: Dict[int, "InferenceSession"] = {}
_next_id = 1
_lock = threading.Lock()

_DTYPES = {0: np.float32, 1: np.int64, 2: np.int32}


def capi_place():
    """The place a session runs on: CPUPlace() when
    PADDLE_TPU_CAPI_PLACE is "cpu", else CUDAPlace(0)."""
    from .core.executor import CPUPlace, CUDAPlace

    mode = os.environ.get("PADDLE_TPU_CAPI_PLACE", "cuda").lower()
    if mode not in ("cpu", "cuda", "gpu"):
        raise ValueError(f"PADDLE_TPU_CAPI_PLACE must be cpu or cuda, got "
                         f"{mode!r}")
    return CPUPlace() if mode == "cpu" else CUDAPlace(0)


class InferenceSession:
    def __init__(self, model_dir: str):
        from . import io
        from .core.executor import Executor
        from .core.scope import Scope

        self.exe = Executor(capi_place())
        self.scope = Scope()
        (self.program, self.feed_names,
         self.fetch_vars) = io.load_inference_model(
            model_dir, self.exe, scope=self.scope)
        self.feeds: Dict[str, torch.Tensor] = {}
        self.results = []

    def feed(self, name: str, payload: bytes, dtype_code: int, dims):
        from .core.types import torch_dtype

        arr = np.frombuffer(payload, dtype=_DTYPES[dtype_code])
        t = torch.from_numpy(arr.reshape([int(d) for d in dims]).copy())
        var = self.program.global_block().vars.get(name)
        if var is not None and t.is_floating_point():
            t = t.to(torch_dtype(var.dtype))
        self.feeds[name] = t

    def run(self) -> int:
        missing = [n for n in self.feed_names if n not in self.feeds]
        if missing:
            raise ValueError(f"missing feeds: {missing}")
        self.results = self.exe.run(
            self.program, feed=dict(self.feeds),
            fetch_list=self.fetch_vars, scope=self.scope)
        return len(self.results)

    def fetch(self, idx: int):
        r = np.ascontiguousarray(self.results[idx], dtype=np.float32)
        return r.tobytes(), list(r.shape)


def create(model_dir: str) -> int:
    global _next_id
    s = InferenceSession(model_dir)
    with _lock:
        sid = _next_id
        _next_id += 1
        _sessions[sid] = s
    return sid


def feed(sid: int, name: str, payload: bytes, dtype_code: int,
         dims) -> None:
    _sessions[sid].feed(name, payload, dtype_code, dims)


def run(sid: int) -> int:
    return _sessions[sid].run()


def fetch(sid: int, idx: int):
    return _sessions[sid].fetch(idx)


def destroy(sid: int) -> None:
    with _lock:
        s = _sessions.pop(sid, None)
    if s is not None:
        s.exe.close()
