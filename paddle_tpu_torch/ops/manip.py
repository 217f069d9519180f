"""Tensor manipulation ops: reshape, slice, top_k (counterpart of
paddle_tpu/ops/manip.py)."""
from __future__ import annotations

import torch

from ..core.execution import one
from ..core.registry import register_op


@register_op("reshape", inputs=("X",), outputs=("Out",),
             attrs={"shape": []})
def reshape(ctx, ins, attrs):
    x = one(ins, "X")
    shape = list(attrs["shape"])
    # reference reshape_op: 0 keeps the original dim, -1 infers
    for i, s in enumerate(shape):
        if s == 0:
            shape[i] = x.shape[i]
    return {"Out": x.reshape(shape)}


@register_op("slice", inputs=("Input",), outputs=("Out",),
             attrs={"axes": [], "starts": [], "ends": []})
def slice_op(ctx, ins, attrs):
    x = one(ins, "Input")
    idx = [slice(None)] * x.dim()
    for a, s, e in zip(attrs["axes"], attrs["starts"], attrs["ends"]):
        idx[a] = slice(s, e)
    return {"Out": x[tuple(idx)]}


@register_op("top_k", inputs=("X",), outputs=("Out", "Indices"),
             attrs={"k": 1}, diff_outputs=())
def top_k(ctx, ins, attrs):
    """The k largest along the last dim, largest first, equal values in
    index order (as `lax.top_k`): a stable descending sort, cut to k."""
    vals, idx = torch.sort(one(ins, "X"), dim=-1, descending=True,
                           stable=True)
    k = int(attrs["k"])
    return {"Out": vals[..., :k], "Indices": idx[..., :k]}
