"""Reductions: mean, reduce_{sum,mean,max,min,prod}, cumsum, the norms,
argmax and maxout (counterpart of paddle_tpu/ops/reduce.py).  Reference
mean_op.cc outputs a {1}-shaped tensor; reduce ops take dim / keep_dim /
reduce_all attrs, and a full reduction without keep_dim has shape [1]."""
from __future__ import annotations

import torch

from ..core.execution import one
from ..core.registry import register_op
from .activation import abs_


def _axes(x, axis):
    """Sorted non-negative axes; None = all."""
    if axis is None:
        return tuple(range(x.dim()))
    return tuple(sorted(a if a >= 0 else a + x.dim() for a in axis))


def _index_routed(arg_fn):
    """Max/min reduction whose gradient goes to ONE index per reduced
    group — the first arg-extreme, as the JAX package's custom VJP routes
    it (paddle_tpu/ops/reduce.py `_index_routed_extreme`) — not spread
    over ties as `torch.amax`'s: the reduced axes move last, flatten,
    and the value is gathered at the arg index, whose autograd scatters
    to that index alone.  -> fn(x, axis, keepdims)."""

    def reduce(x, axis=None, keepdims=False):
        axes = _axes(x, axis)
        keep = tuple(a for a in range(x.dim()) if a not in axes)
        xt = x.permute(keep + axes)
        xf = xt.reshape(xt.shape[:len(keep)] + (-1,))
        i = arg_fn(xf, dim=-1, keepdim=True)
        out = torch.take_along_dim(xf, i, dim=-1)[..., 0]
        if keepdims:
            for a in axes:
                out = out.unsqueeze(a)
        return out

    return reduce


_max_by_index = _index_routed(torch.argmax)
_min_by_index = _index_routed(torch.argmin)


def _sum(x, axis=None, keepdims=False):
    return torch.sum(x, dim=_axes(x, axis), keepdim=keepdims)


def _mean(x, axis=None, keepdims=False):
    return torch.mean(x, dim=_axes(x, axis), keepdim=keepdims)


def _prod(x, axis=None, keepdims=False):
    # torch.prod takes one dim at a time: highest first, so the others
    # keep their positions
    for a in reversed(_axes(x, axis)):
        x = torch.prod(x, dim=a, keepdim=keepdims)
    return x


@register_op("mean", inputs=("X",), outputs=("Out",))
def mean(ctx, ins, attrs):
    return {"Out": torch.mean(one(ins, "X")).reshape(1)}


def _make_reduce(name, fn):
    @register_op(name, inputs=("X",), outputs=("Out",),
                 attrs={"dim": [0], "keep_dim": False, "reduce_all": False})
    def lower(ctx, ins, attrs, _fn=fn):
        x = one(ins, "X")
        keep = bool(attrs["keep_dim"])
        if attrs.get("reduce_all"):
            out = _fn(x, None, keep)
        else:
            dim = attrs["dim"]
            out = _fn(x, tuple(dim) if isinstance(dim, (list, tuple))
                      else (int(dim),), keep)
        if out.dim() == 0:
            out = out.reshape(1)
        return {"Out": out}

    return lower


_make_reduce("reduce_sum", _sum)
_make_reduce("reduce_mean", _mean)
_make_reduce("reduce_max", _max_by_index)
_make_reduce("reduce_min", _min_by_index)
_make_reduce("reduce_prod", _prod)


@register_op("cumsum", inputs=("X",), outputs=("Out",),
             attrs={"axis": -1, "exclusive": False, "reverse": False})
def cumsum(ctx, ins, attrs):
    x = one(ins, "X")
    axis = int(attrs["axis"])
    if attrs.get("reverse"):
        x = torch.flip(x, (axis,))
    out = torch.cumsum(x, dim=axis, dtype=x.dtype)
    if attrs.get("exclusive"):
        out = out - x
    if attrs.get("reverse"):
        out = torch.flip(out, (axis,))
    return {"Out": out}


@register_op("l1_norm", inputs=("X",), outputs=("Out",))
def l1_norm(ctx, ins, attrs):
    return {"Out": torch.sum(abs_(one(ins, "X"))).reshape(1)}


@register_op("squared_l2_norm", inputs=("X",), outputs=("Out",))
def squared_l2_norm(ctx, ins, attrs):
    return {"Out": torch.sum(torch.square(one(ins, "X"))).reshape(1)}


@register_op("squared_l2_distance", inputs=("X", "Y"),
             outputs=("Out", "sub_result"))
def squared_l2_distance(ctx, ins, attrs):
    """Row-wise squared distance; a one-row Y broadcasts over X's rows."""
    x, y = one(ins, "X"), one(ins, "Y")
    sub = x - y
    return {"sub_result": sub,
            "Out": torch.sum(torch.square(sub),
                             dim=tuple(range(1, sub.dim()))).reshape(-1, 1)}


@register_op("norm", inputs=("X", "Scale"), outputs=("Out",),
             attrs={"epsilon": 1e-10})
def norm(ctx, ins, attrs):
    """Cross-channel L2 norm scaling of NCHW (reference norm_op.cc)."""
    x, scale = one(ins, "X"), one(ins, "Scale")
    l2 = torch.sqrt(torch.sum(torch.square(x), dim=1, keepdim=True)
                    + attrs["epsilon"])
    return {"Out": x / l2 * scale.reshape(1, -1, 1, 1)}


@register_op("argmax", inputs=("X",), outputs=("Out",),
             attrs={"axis": -1}, not_differentiable=True)
def argmax(ctx, ins, attrs):
    """The first maximal index, int64."""
    return {"Out": torch.argmax(one(ins, "X"), dim=int(attrs["axis"]))}


@register_op("maxout", inputs=("X",), outputs=("Out",),
             attrs={"groups": 1})
def maxout(ctx, ins, attrs):
    """Channel maxout over NCHW: C splits into C / groups groups of
    `groups` channels; index-routed max, as reduce_max."""
    x = one(ins, "X")
    n, c, h, w = x.shape
    g = int(attrs["groups"])
    return {"Out": _max_by_index(x.reshape(n, c // g, g, h, w), (2,))}
