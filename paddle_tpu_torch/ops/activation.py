"""relu, square, sqrt and softmax (counterpart of
paddle_tpu/ops/activation.py)."""
from __future__ import annotations

import torch

from ..amp import amp_upcast
from ..core.execution import one
from ..core.registry import register_op


@register_op("relu", inputs=("X",), outputs=("Out",))
def relu(ctx, ins, attrs):
    return {"Out": torch.relu(one(ins, "X"))}


@register_op("square", inputs=("X",), outputs=("Out",))
def square(ctx, ins, attrs):
    return {"Out": torch.square(one(ins, "X"))}


@register_op("sqrt", inputs=("X",), outputs=("Out",))
def sqrt(ctx, ins, attrs):
    return {"Out": torch.sqrt(one(ins, "X"))}


@register_op("softmax", inputs=("X",), outputs=("Out",))
def softmax(ctx, ins, attrs):
    """Reference softmax_op.cc: softmax over the last dim.  Under amp a
    bf16 input is upcast to f32 (numerically sensitive)."""
    return {"Out": torch.softmax(amp_upcast(one(ins, "X")), dim=-1)}
