"""Fused per-bucket SGD update: the CUDA kernel's wrapper and its plain
version.

Replaces the TPU kernel paddle_tpu/kernels/fused_update.py
`_sgd_kernel`.  ParallelExecutor's overlap step reduces gradients in
same-dtype buckets (one flat all-reduce per bucket); when the update
section is a chain of plain dense `sgd` ops sharing one learning rate
per bucket, the executor keeps each bucket's parameters as views of one
flat buffer and this kernel applies the whole bucket in ONE launch, in
place (csrc/fused_update.cu):

    flat_params -= lr * flat_grads

It is bit-identical to the per-parameter `sgd` chain by construction:
the same product and difference, each rounded once, in float32.

`fused_bucket_sgd_` launches the kernel for CUDA tensors and runs the
same two roundings in place with PyTorch for CPU tensors; a CUDA call
the kernel does not take raises.  `fused_bucket_sgd_reference` is the
plain version, into a new tensor.  Selection goes through
kernels/registry.py ("fused_bucket_update"); whether the update chain
has the shape the kernel replaces is the executor's verdict, not this
module's.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from .registry import register_kernel

__all__ = ["fused_update_supports", "build_fused_bucket_update",
           "fused_bucket_sgd_", "fused_bucket_sgd_reference", "build",
           "SOURCE"]

SOURCE = "fused_update.cu"

_count_lock = threading.Lock()
_lib = None


def fused_update_supports(*, numel: int, dtype: str = "float32",
                          platform: str = "cpu", **_) -> Optional[str]:
    if dtype != "float32":
        return "dtype"
    if int(numel) < 1:
        return "empty_bucket"
    return None


def _step(flat_g, lr, dtype):
    return lr.reshape(()).float().to(dtype) * flat_g


def fused_bucket_sgd_reference(flat_p, flat_g, lr):
    """The plain version: the `sgd` op's arithmetic on the flat views
    (lr a one-element float32 tensor), into a new tensor."""
    return flat_p - _step(flat_g, lr, flat_p.dtype)


def _library():
    global _lib
    if _lib is None:
        from . import cuda_build

        lib = cuda_build.load_library(SOURCE)
        fn = lib.fused_sgd_update_
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def build():
    """Build (or load) the kernel library; the first CUDA call builds it
    anyway — this lets a caller pay the build up front."""
    _library()


def fused_bucket_sgd_(flat_p, flat_g, lr):
    """flat_p, flat_g [numel] float32, lr a one-element float32 tensor
    on the same device: flat_p -= lr * flat_g in place; returns flat_p.
    CPU tensors run the plain arithmetic in place; CUDA tensors launch
    the kernel (one launch per call) or raise."""
    if flat_p.device.type != "cuda":
        return flat_p.sub_(_step(flat_g, lr, flat_p.dtype))
    dtypes = {str(t.dtype).replace("torch.", "") for t in (flat_p, flat_g,
                                                           lr)}
    reason = fused_update_supports(
        numel=flat_p.numel(),
        dtype=dtypes.pop() if len(dtypes) == 1 else "mixed")
    if reason is not None:
        raise ValueError(f"fused_bucket_sgd_: the kernel does not take "
                         f"this call ({reason}): params, grads and lr "
                         f"{flat_p.dtype}/{flat_g.dtype}/{lr.dtype}, numel "
                         f"{flat_p.numel()} (float32 and non-empty)")
    for name, t in (("grads", flat_g), ("lr", lr)):
        if t.device != flat_p.device:
            raise ValueError(f"fused_bucket_sgd_: {name} on {t.device}, "
                             f"params on {flat_p.device}")
    if not (flat_p.is_contiguous() and flat_g.is_contiguous()):
        raise ValueError("fused_bucket_sgd_: params and grads must be "
                         "contiguous")
    if flat_p.dim() != 1 or flat_g.shape != flat_p.shape:
        raise ValueError(f"fused_bucket_sgd_: flat params "
                         f"{tuple(flat_p.shape)} and grads "
                         f"{tuple(flat_g.shape)} must be one 1-D shape")
    if lr.numel() != 1:
        raise ValueError(f"fused_bucket_sgd_: lr must hold one value, got "
                         f"{tuple(lr.shape)}")
    lib = _library()
    with torch.cuda.device(flat_p.device):
        rc = lib.fused_sgd_update_(
            flat_p.data_ptr(), flat_g.data_ptr(), lr.data_ptr(),
            flat_p.numel(),
            torch.cuda.current_stream(flat_p.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_sgd_update_ launch failed: CUDA error "
                           f"{rc}")
    with _count_lock:
        fused_bucket_sgd_.launches += 1
    return flat_p


fused_bucket_sgd_.launches = 0


@register_kernel("fused_bucket_update", fused_update_supports)
def build_fused_bucket_update(*, numel: int, **_):
    """-> update_(flat_params [numel] f32, flat_grads [numel] f32,
    lr one-element f32 tensor): flat_params -= lr * flat_grads in
    place; returns flat_params."""
    n = int(numel)

    def update_(flat_p, flat_g, lr):
        if flat_p.numel() != n:
            raise ValueError(f"fused bucket update built for {n} elements, "
                             f"got {flat_p.numel()}")
        return fused_bucket_sgd_(flat_p, flat_g, lr)

    return update_
