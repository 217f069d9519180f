"""Tensor manipulation ops: reshape, transpose, concat, split, expand,
pad, crop, gather, scatter, top_k, unsqueeze, squeeze, stack, slice,
flatten and reverse (counterpart of paddle_tpu/ops/manip.py)."""
from __future__ import annotations

import math

import torch

from ..core.execution import data_of, many, one, with_lod_of
from ..core.lod import LoDTensor
from ..core.registry import register_op


@register_op("reshape", inputs=("X",), outputs=("Out",),
             attrs={"shape": []}, lod=True)
def reshape(ctx, ins, attrs):
    xv = one(ins, "X")
    x = data_of(xv)
    shape = list(attrs["shape"])
    # reference reshape_op: 0 keeps the original dim, -1 infers
    for i, s in enumerate(shape):
        if s == 0:
            shape[i] = x.shape[i]
    return {"Out": with_lod_of(xv, x.reshape(shape))}


@register_op("slice", inputs=("Input",), outputs=("Out",),
             attrs={"axes": [], "starts": [], "ends": []})
def slice_op(ctx, ins, attrs):
    x = one(ins, "Input")
    idx = [slice(None)] * x.dim()
    for a, s, e in zip(attrs["axes"], attrs["starts"], attrs["ends"]):
        idx[a] = slice(s, e)
    return {"Out": x[tuple(idx)]}


@register_op("concat", inputs=("X",), outputs=("Out",),
             dup_inputs=("X",), attrs={"axis": 0}, lod=True)
def concat(ctx, ins, attrs):
    """The inputs joined along `axis` in slot order.  A concat along
    another axis than the rows keeps the first input's LoD (the seq2seq
    decoder's [target embedding, expanded context])."""
    vs = many(ins, "X")
    out = torch.cat([data_of(v) for v in vs], dim=int(attrs["axis"]))
    if attrs["axis"] != 0 and isinstance(vs[0], LoDTensor):
        return {"Out": LoDTensor(out, vs[0].lod)}
    return {"Out": out}


@register_op("top_k", inputs=("X",), outputs=("Out", "Indices"),
             attrs={"k": 1}, diff_outputs=(), lod=True)
def top_k(ctx, ins, attrs):
    """The k largest along the last dim, largest first, equal values in
    index order (as `lax.top_k`): a stable descending sort, cut to k."""
    xv = one(ins, "X")
    vals, idx = torch.sort(data_of(xv), dim=-1, descending=True,
                           stable=True)
    k = int(attrs["k"])
    return {"Out": with_lod_of(xv, vals[..., :k]),
            "Indices": with_lod_of(xv, idx[..., :k])}


@register_op("transpose", inputs=("X",), outputs=("Out",),
             attrs={"axis": []})
def transpose(ctx, ins, attrs):
    """Permute by `axis`; an empty `axis` reverses the dims."""
    x = one(ins, "X")
    axis = list(attrs["axis"]) or list(range(x.dim()))[::-1]
    return {"Out": x.permute(axis)}


@register_op("split", inputs=("X",), outputs=("Out",),
             dup_outputs=("Out",),
             attrs={"axis": 0, "num": 0, "sections": []})
def split(ctx, ins, attrs):
    """`sections` sizes, or `num` equal parts, along `axis`."""
    x = one(ins, "X")
    axis = int(attrs["axis"])
    if attrs.get("sections"):
        sizes = [int(s) for s in attrs["sections"]]
    else:
        num = int(attrs["num"])
        if x.shape[axis] % num:
            raise ValueError(f"split: dim {x.shape[axis]} does not divide "
                             f"into {num} equal parts")
        sizes = [x.shape[axis] // num] * num
    return {"Out": list(torch.split(x, sizes, dim=axis))}


@register_op("expand", inputs=("X",), outputs=("Out",),
             attrs={"expand_times": []})
def expand(ctx, ins, attrs):
    """Tile X `expand_times` times along each dim (np.tile)."""
    x = one(ins, "X")
    times = [int(t) for t in attrs["expand_times"]]
    times = [1] * (x.dim() - len(times)) + times
    return {"Out": x.repeat(times)}


@register_op("pad", inputs=("X",), outputs=("Out",),
             attrs={"paddings": [], "pad_value": 0.0})
def pad(ctx, ins, attrs):
    """`paddings` = [before_0, after_0, before_1, ...], constant fill."""
    x = one(ins, "X")
    p = [int(v) for v in attrs["paddings"]]
    # F.pad takes (before, after) pairs from the last dim backwards
    flat = []
    for i in reversed(range(x.dim())):
        flat += [p[2 * i], p[2 * i + 1]]
    return {"Out": torch.nn.functional.pad(x, flat, value=attrs["pad_value"])}


@register_op("crop", inputs=("X", "Y"), outputs=("Out",),
             attrs={"offsets": [], "shape": []})
def crop(ctx, ins, attrs):
    """The window of Y's shape (or `shape`) at `offsets`, each offset
    clamped so the window stays inside X (lax.dynamic_slice)."""
    x, y = one(ins, "X"), one(ins, "Y")
    shape = tuple(y.shape) if y is not None else tuple(attrs["shape"])
    offsets = attrs.get("offsets") or [0] * x.dim()
    idx = []
    for d, (o, n) in enumerate(zip(offsets, shape)):
        o = min(max(int(o), 0), x.shape[d] - int(n))
        idx.append(slice(o, o + int(n)))
    return {"Out": x[tuple(idx)]}


@register_op("gather", inputs=("X", "Index"), outputs=("Out",),
             diff_inputs=("X",))
def gather(ctx, ins, attrs):
    """Rows of X at Index (flattened)."""
    idx = one(ins, "Index").reshape(-1).long()
    return {"Out": torch.index_select(one(ins, "X"), 0, idx)}


@register_op("scatter", inputs=("X", "Ids", "Updates"), outputs=("Out",),
             diff_inputs=("X", "Updates"))
def scatter(ctx, ins, attrs):
    """Reference scatter_op: Out = X; Out[Ids] = Updates (overwrite)."""
    ids = one(ins, "Ids").reshape(-1).long()
    return {"Out": one(ins, "X").index_put((ids,), one(ins, "Updates"))}


@register_op("unsqueeze", inputs=("X",), outputs=("Out",),
             attrs={"axes": []})
def unsqueeze(ctx, ins, attrs):
    x = one(ins, "X")
    for a in sorted(attrs["axes"]):
        x = x.unsqueeze(a)
    return {"Out": x}


@register_op("squeeze", inputs=("X",), outputs=("Out",),
             attrs={"axes": []})
def squeeze(ctx, ins, attrs):
    """Drop the size-1 dims in `axes` (all of them when empty)."""
    x = one(ins, "X")
    axes = attrs.get("axes")
    if not axes:
        return {"Out": x.squeeze()}
    for a in axes:
        if x.shape[a] != 1:
            raise ValueError(f"squeeze: dim {a} of shape {tuple(x.shape)} "
                             "is not 1")
    return {"Out": x.squeeze(tuple(axes))}


@register_op("stack", inputs=("X",), outputs=("Out",), attrs={"axis": 0},
             dup_inputs=("X",))
def stack(ctx, ins, attrs):
    return {"Out": torch.stack(many(ins, "X"), dim=int(attrs["axis"]))}


@register_op("flatten", inputs=("X",), outputs=("Out",), attrs={"axis": 1})
def flatten(ctx, ins, attrs):
    """2-D: the dims before `axis` as rows, the rest as columns."""
    x = one(ins, "X")
    a = int(attrs["axis"])
    return {"Out": x.reshape(math.prod(x.shape[:a]) if a else 1, -1)}


@register_op("reverse", inputs=("X",), outputs=("Out",), attrs={"axis": [0]})
def reverse(ctx, ins, attrs):
    ax = attrs["axis"]
    ax = ax if isinstance(ax, (list, tuple)) else [ax]
    return {"Out": torch.flip(one(ins, "X"), tuple(ax))}
