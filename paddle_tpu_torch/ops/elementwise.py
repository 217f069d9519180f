"""Elementwise binary ops with the reference's axis-broadcast semantics,
the comparisons and logicals, plus scale / sum / clip (counterpart of
paddle_tpu/ops/elementwise.py): Y's shape must be a contiguous
sub-sequence of X's shape starting at `axis` (axis == -1 means trailing
alignment).  The logicals broadcast as numpy does, as the JAX
package's."""
from __future__ import annotations

import torch

from ..amp import is_bf16_enabled
from ..core.execution import (data_of, dense_of, many, one, scalar_like,
                              with_lod_of)
from ..core.lod import SelectedRows
from ..core.registry import register_op
from .activation import clip as _clip


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
                 attrs={"axis": -1}, lod=True)
    def lower(ctx, ins, attrs, _fn=fn):
        xv = one(ins, "X")
        x, y = data_of(xv), data_of(one(ins, "Y"))
        if _amp_mixed(x, y):
            # under amp, a bf16 activation meeting an f32 side (bias,
            # residual) computes in bf16: the activation chain stays bf16
            # instead of promoting back to f32
            x, y = x.to(torch.bfloat16), y.to(torch.bfloat16)
        out = _fn(x, _broadcast_y(x, y, attrs.get("axis", -1)))
        return {"Out": with_lod_of(xv, out)}

    return lower


def _amp_mixed(x, y) -> bool:
    return is_bf16_enabled() and {x.dtype, y.dtype} == {torch.bfloat16,
                                                        torch.float32}


elementwise_add = _make_elementwise("elementwise_add", torch.add)
_make_elementwise("elementwise_sub", torch.sub)
_make_elementwise("elementwise_mul", torch.mul)
_make_elementwise("elementwise_div", torch.div)
_make_elementwise("elementwise_max", torch.maximum)
_make_elementwise("elementwise_min", torch.minimum)
_make_elementwise("elementwise_pow", torch.pow)


@register_op("scale", inputs=("X",), outputs=("Out",),
             attrs={"scale": 1.0, "bias": 0.0, "bias_after_scale": True},
             lod=True)
def scale(ctx, ins, attrs):
    xv = one(ins, "X")
    x = data_of(xv)
    s = scalar_like(x, attrs["scale"])
    b = scalar_like(x, attrs.get("bias", 0.0))
    if attrs.get("bias_after_scale", True):
        return {"Out": with_lod_of(xv, x * s + b)}
    return {"Out": with_lod_of(xv, (x + b) * s)}


@register_op("clip", inputs=("X",), outputs=("Out",),
             attrs={"min": -1.0, "max": 1.0},
             inplace={"Out": "X"}, lod=True)
def clip(ctx, ins, attrs):
    """A maximum then a minimum, as `jnp.clip`: at a bound the gradient
    is 1/2 (`torch.clamp`'s is 1)."""
    xv = one(ins, "X")
    return {"Out": with_lod_of(xv, _clip(data_of(xv), attrs["min"],
                                         attrs["max"]))}


@register_op("clip_by_norm", inputs=("X",), outputs=("Out",),
             attrs={"max_norm": 1.0}, lod=True)
def clip_by_norm(ctx, ins, attrs):
    xv = one(ins, "X")
    x = data_of(xv)
    norm = torch.sqrt(torch.sum(torch.square(x)))
    factor = torch.where(norm > attrs["max_norm"],
                         attrs["max_norm"] / torch.clamp(norm, min=1e-12),
                         torch.ones_like(norm))
    return {"Out": with_lod_of(xv, x * factor.to(x.dtype))}


@register_op("sum", inputs=("X",), outputs=("Out",),
             dup_inputs=("X",), sparse=True, lod=True)
def sum_op(ctx, ins, attrs):
    """Fan-in accumulator, over dense and SelectedRows values as the JAX
    package's: all sparse in, a SelectedRows out (rows and values
    concatenated in input order: a shared table's partial gradients);
    any dense in, the dense sum in input order, each SelectedRows made
    dense where it stands (a regularized sparse gradient), with the
    first dense input's LoD."""
    xs = [v for v in many(ins, "X") if v is not None]
    if not xs:
        return {"Out": None}
    if all(isinstance(v, SelectedRows) for v in xs):
        return {"Out": SelectedRows(torch.cat([v.rows for v in xs]),
                                    torch.cat([v.value for v in xs]),
                                    xs[0].height)}
    acc = data_of(dense_of(xs[0]))
    for v in xs[1:]:
        acc = acc + data_of(dense_of(v))
    first = next(v for v in xs if not isinstance(v, SelectedRows))
    return {"Out": with_lod_of(first, acc)}


def _make_compare(name, fn):
    @register_op(name, inputs=("X", "Y"), outputs=("Out",),
                 attrs={"axis": -1}, not_differentiable=True)
    def lower(ctx, ins, attrs, _fn=fn):
        x, y = one(ins, "X"), one(ins, "Y")
        return {"Out": _fn(x, _broadcast_y(x, y, attrs.get("axis", -1)))}

    return lower


_make_compare("less_than", torch.lt)
_make_compare("less_equal", torch.le)
_make_compare("greater_than", torch.gt)
_make_compare("greater_equal", torch.ge)
_make_compare("equal", torch.eq)
_make_compare("not_equal", torch.ne)


def _make_logical(name, fn, unary=False):
    @register_op(name, inputs=("X",) if unary else ("X", "Y"),
                 outputs=("Out",), not_differentiable=True)
    def lower(ctx, ins, attrs, _fn=fn, _unary=unary):
        x = one(ins, "X")
        if _unary:
            return {"Out": _fn(x)}
        return {"Out": _fn(x, one(ins, "Y"))}

    return lower


_make_logical("logical_and", torch.logical_and)
_make_logical("logical_or", torch.logical_or)
_make_logical("logical_xor", torch.logical_xor)
_make_logical("logical_not", torch.logical_not, unary=True)
