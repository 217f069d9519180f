"""Mixed-precision (bfloat16) training (counterpart of paddle_tpu/amp.py).

With the `amp_bf16` flag on, the op lowerings cast at the same edges as
the JAX package's, and nowhere else (not PyTorch's automatic mixed
precision, which casts by its own op lists and would give another dtype
map):

  * `mul` casts float32 operands to bfloat16 at its input edge, so its
    product runs on the tensor cores in bf16 and its output is bf16;
  * an elementwise op meeting a bf16 side and an f32 side (a bias, a
    residual) computes in bf16, keeping the activation chain in bf16;
  * softmax and the cross-entropy losses upcast bf16 inputs to f32;
  * parameters stay float32 ("master weights"): `LayerHelper` makes a
    parameter f32 where a layer asks for bf16, and each gradient comes
    back in its parameter's dtype, so the optimizer ops see f32 only.
    bf16 keeps f32's exponent range, so no loss scaling is needed.

Usage:
    with fluid.amp.bf16_guard():
        ...build the Program...
        exe.run(main, feed=..., fetch_list=[loss])
or process-wide: fluid.amp.enable_bf16() / PADDLE_TPU_AMP_BF16=1.

The flag is read when a Program is built (build-time shape inference
types its vars) and when its ops run: keep it fixed between the two.
"""
from __future__ import annotations

import contextlib

import torch

from .core.flags import get_flag, set_flags

__all__ = ["enable_bf16", "disable_bf16", "bf16_guard", "amp_cast",
           "amp_upcast", "is_bf16_enabled"]


def is_bf16_enabled() -> bool:
    return bool(get_flag("amp_bf16"))


def enable_bf16():
    set_flags({"amp_bf16": True})


def disable_bf16():
    set_flags({"amp_bf16": False})


@contextlib.contextmanager
def bf16_guard():
    prev = is_bf16_enabled()
    set_flags({"amp_bf16": True})
    try:
        yield
    finally:
        set_flags({"amp_bf16": prev})


def amp_cast(*tensors):
    """Input-edge cast: float32 -> bfloat16 when amp is on (other dtypes
    pass through untouched).  One tensor in, one out; several in, a
    tuple out."""
    if is_bf16_enabled():
        tensors = tuple(
            t.to(torch.bfloat16)
            if isinstance(t, torch.Tensor) and t.dtype == torch.float32
            else t for t in tensors)
    return tensors if len(tensors) > 1 else tensors[0]


def amp_upcast(t):
    """Output-edge cast for numerically sensitive ops (softmax,
    cross-entropy): bfloat16 -> float32 while amp is on.  Programs that
    are deliberately bf16 without amp keep their dtypes."""
    if is_bf16_enabled() and isinstance(t, torch.Tensor) \
            and t.dtype == torch.bfloat16:
        return t.float()
    return t
