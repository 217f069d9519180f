"""Elementwise binary ops with the reference's axis-broadcast semantics,
plus scale / sum / clip (counterpart of paddle_tpu/ops/elementwise.py):
Y's shape must be a contiguous sub-sequence of X's shape starting at
`axis` (axis == -1 means trailing alignment)."""
from __future__ import annotations

import torch

from ..core.execution import many, one
from ..core.registry import register_op


def _broadcast_y(x, y, axis):
    if x.shape == y.shape:
        return y
    axis = int(axis)
    if axis == -1:
        axis = x.dim() - y.dim()
    # trim trailing 1s of y (reference allows y shape (n,1) against axis dim n)
    yshape = list(y.shape)
    while yshape and yshape[-1] == 1 and len(yshape) > 1:
        yshape = yshape[:-1]
    target = [1] * axis + yshape + [1] * (x.dim() - axis - len(yshape))
    return y.reshape(target)


def _make_elementwise(name, fn):
    @register_op(name, inputs=("X", "Y"), outputs=("Out",),
                 attrs={"axis": -1})
    def lower(ctx, ins, attrs, _fn=fn):
        x, y = one(ins, "X"), one(ins, "Y")
        return {"Out": _fn(x, _broadcast_y(x, y, attrs.get("axis", -1)))}

    return lower


elementwise_add = _make_elementwise("elementwise_add", torch.add)
_make_elementwise("elementwise_sub", torch.sub)
_make_elementwise("elementwise_mul", torch.mul)
_make_elementwise("elementwise_div", torch.div)
_make_elementwise("elementwise_max", torch.maximum)


@register_op("scale", inputs=("X",), outputs=("Out",),
             attrs={"scale": 1.0, "bias": 0.0, "bias_after_scale": True})
def scale(ctx, ins, attrs):
    x = one(ins, "X")
    s = torch.tensor(attrs["scale"], dtype=x.dtype, device=x.device)
    b = torch.tensor(attrs.get("bias", 0.0), dtype=x.dtype, device=x.device)
    if attrs.get("bias_after_scale", True):
        return {"Out": x * s + b}
    return {"Out": (x + b) * s}


@register_op("clip", inputs=("X",), outputs=("Out",),
             attrs={"min": -1.0, "max": 1.0},
             inplace={"Out": "X"})
def clip(ctx, ins, attrs):
    return {"Out": torch.clamp(one(ins, "X"), attrs["min"], attrs["max"])}


@register_op("clip_by_norm", inputs=("X",), outputs=("Out",),
             attrs={"max_norm": 1.0})
def clip_by_norm(ctx, ins, attrs):
    x = one(ins, "X")
    norm = torch.sqrt(torch.sum(torch.square(x)))
    factor = torch.where(norm > attrs["max_norm"],
                         attrs["max_norm"] / torch.clamp(norm, min=1e-12),
                         torch.ones_like(norm))
    return {"Out": x * factor.to(x.dtype)}


@register_op("sum", inputs=("X",), outputs=("Out",),
             dup_inputs=("X",))
def sum_op(ctx, ins, attrs):
    """Fan-in accumulator over dense tensors (the sparse SelectedRows
    branch of the JAX op is queue A1)."""
    xs = [v for v in many(ins, "X") if v is not None]
    if not xs:
        return {"Out": None}
    acc = xs[0]
    for v in xs[1:]:
        acc = acc + v
    return {"Out": acc}
