"""Reductions: mean and reduce_sum (counterpart of
paddle_tpu/ops/reduce.py).  Reference mean_op.cc outputs a {1}-shaped
tensor; reduce ops take dim / keep_dim / reduce_all attrs."""
from __future__ import annotations

import torch

from ..core.execution import one
from ..core.registry import register_op


@register_op("mean", inputs=("X",), outputs=("Out",))
def mean(ctx, ins, attrs):
    return {"Out": torch.mean(one(ins, "X")).reshape(1)}


@register_op("reduce_sum", inputs=("X",), outputs=("Out",),
             attrs={"dim": [0], "keep_dim": False, "reduce_all": False})
def reduce_sum(ctx, ins, attrs):
    x = one(ins, "X")
    keep = bool(attrs["keep_dim"])
    if attrs.get("reduce_all"):
        axes = tuple(range(x.dim()))
    else:
        dim = attrs["dim"]
        axes = tuple(dim) if isinstance(dim, (list, tuple)) else (int(dim),)
        axes = tuple(a if a >= 0 else a + x.dim() for a in axes)
    out = torch.sum(x, dim=axes, keepdim=keep)
    if out.dim() == 0:
        out = out.reshape(1)
    return {"Out": out}
