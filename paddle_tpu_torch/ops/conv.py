"""Convolution and pooling ops (counterpart of paddle_tpu/ops/conv.py):
conv2d, depthwise_conv2d, conv3d and the two transposed convolutions,
pool2d, pool3d, the max pools with their index, spp, unpool, row_conv
and conv_shift, with explicit gradients for the convolutions.

The convolutions run through `aten.convolution`, as the JAX package
runs them through `lax.conv_general_dilated`, outside any kernel of its
own.  Inside every conv lowering the backend is pinned (`conv_pinned`):
bf16 convolutions on a card run in cuDNN with no benchmark search (the
algorithm is the heuristics' choice, fixed before a CUDA graph captures
it) and deterministic algorithms only (a replayed step must give the
interpreter's bits); float32 ones in PyTorch's own convolution with
TF32 off (float32 is float32, whatever the caller's global flags say).
Autograd through a conv lowering (a `recompute` segment's gradient, a
generic gradient) takes the same pinned backend (`_PinnedConv`), so it
runs the explicit gradient's `convolution_backward`, not the caller's
global cuDNN flags (TF32 and non-deterministic algorithms by default).
The transposed convolutions keep Paddle's filter layout [C, M, k...]
(torch's own) and its output size (in - 1) * s - 2p + (k - 1) * d + 1:
no output padding, no groups.

Layouts: "NHWC" activations keep channels last at the IR level; the
filter is OIHW either way.  The `conv_layout` flag ("NHWC") runs an
NCHW-declared conv channels-last inside the lowering: its output stays
in torch's channels_last memory format, so the next conv of a trunk
takes it without a transpose (what XLA's cancelled transpose pairs do
in the JAX package).  Neither changes a value.

pool3d and the max pools with index read each window from a padded,
unfolded copy of the input (`_windows`): max pooling pads with -inf and
takes the first maximum in window order (the JAX selector takes a later
element only if it is strictly greater), average pooling divides by the
count of unpadded elements.  Their gradients and unpool's scatter run
with no float atomics (`_MaxPool`: a sorted segment sum, or a copy where
windows do not overlap; `_Unpool`: gathers), so a replayed step equals
the interpreter bit for bit; PyTorch's own CUDA max_pool3d and
avg_pool3d backwards and max_unpool add with atomics.
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..amp import amp_cast
from ..core.execution import one
from ..core.flags import get_flag
from ..core.lod import LoDTensor
from ..core.registry import register_grad_lower, register_op
from .embedding import sorted_segment_sum


def _pair(v, n=2):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return (int(v),) * n


@contextlib.contextmanager
def conv_pinned(dtype):
    """The convolution backend for a conv of `dtype`, for the calls
    inside; the caller's flags come back after.  bf16/f16: cuDNN, no
    benchmark search, deterministic algorithms.  float32/float64:
    cuDNN off, so PyTorch's own convolution (im2col and a cuBLAS GEMM,
    TF32 off) runs it.  On an H100, cuDNN's deterministic float32
    algorithms put a 3x3 conv's weight gradient up to 7e-6 (relative to
    its largest element) off float64, against 2.5e-7 for PyTorch's, and
    batch norm's backward amplifies that: after two float32 ResNet-18
    steps a velocity sat 0.021 off float64 (its largest element 0.53)
    with cuDNN, 1.6e-6 with PyTorch's convolution, as on the CPU
    (`tools/torch_tree_probe.py conv-fp32`).  PyTorch's convolution is
    the slower: 6x on the float32 VGG-16 step."""
    c, m = torch.backends.cudnn, torch.backends.cuda.matmul
    old = (c.enabled, c.benchmark, c.deterministic, c.allow_tf32,
           m.allow_tf32)
    c.enabled = dtype not in (torch.float32, torch.float64)
    c.benchmark, c.deterministic, c.allow_tf32 = False, True, False
    m.allow_tf32 = False
    try:
        yield
    finally:
        (c.enabled, c.benchmark, c.deterministic, c.allow_tf32,
         m.allow_tf32) = old


def _channels_last_flag(attrs, x) -> bool:
    return (attrs.get("data_format", "NCHW") == "NCHW" and x.dim() == 4
            and str(get_flag("conv_layout")).upper() == "NHWC")


def _as_nchw(t, attrs):
    """An activation as the NCHW tensor torch's conv takes: an NHWC one
    as a permuted view (channels_last strides), an NCHW one in the
    memory format the `conv_layout` flag asks for."""
    if attrs.get("data_format", "NCHW") == "NHWC":
        return t.permute(0, 3, 1, 2)
    if _channels_last_flag(attrs, t):
        return t.contiguous(memory_format=torch.channels_last)
    return t


def _from_nchw(t, attrs):
    if attrs.get("data_format", "NCHW") == "NHWC":
        return t.permute(0, 2, 3, 1).contiguous()
    return t


def _conv_args(attrs, n=2, groups=True):
    """(strides, paddings, dilations, groups) over `n` spatial dims; a
    transposed convolution has no groups."""
    return (_pair(attrs["strides"], n), _pair(attrs["paddings"], n),
            _pair(attrs.get("dilations", [1] * n), n),
            int(attrs.get("groups") or 1) if groups else 1)


def _conv_backward(dy, x, w, s, p, d, g, transposed=False,
                   mask=(True, True)):
    """(dx, dw) of the convolution the forward ran, by
    `convolution_backward` on the pinned backend (no forward re-run)."""
    with conv_pinned(x.dtype):
        dx, dw, _ = torch.ops.aten.convolution_backward(
            dy, x, w, None, list(s), list(p), list(d), transposed,
            [0] * len(s), g, [mask[0], mask[1], False])
    return dx, dw


class _PinnedConv(torch.autograd.Function):
    """`aten.convolution` (transposed or not, 2 or 3 spatial dims) with
    the backend pinned (`conv_pinned`) in its forward and in its
    backward, which is the explicit gradients' `convolution_backward`."""

    @staticmethod
    def forward(ctx, x, w, s, p, d, g, transposed=False):
        ctx.save_for_backward(x, w)
        ctx.args = (s, p, d, g, transposed)
        with conv_pinned(x.dtype):
            return torch.ops.aten.convolution(
                x, w, None, list(s), list(p), list(d), transposed,
                [0] * len(s), g)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw = _conv_backward(dy, x, w, *ctx.args,
                                mask=ctx.needs_input_grad[:2])
        return dx, dw, None, None, None, None, None


@register_op("conv2d", inputs=("Input", "Filter"), outputs=("Output",),
             attrs={"strides": [1, 1], "paddings": [0, 0],
                    "dilations": [1, 1], "groups": 1, "use_cudnn": True,
                    "data_format": "NCHW"})
def conv2d(ctx, ins, attrs):
    """Output in the (amp-cast) input's dtype, float32 accumulated."""
    x, w = amp_cast(one(ins, "Input"), one(ins, "Filter"))
    s, p, d, g = _conv_args(attrs)
    xt = _as_nchw(x, attrs)
    if _channels_last_flag(attrs, x):
        w = w.contiguous(memory_format=torch.channels_last)
    out = _PinnedConv.apply(xt, w, s, p, d, g)
    return {"Output": _from_nchw(out, attrs)}


@register_op("depthwise_conv2d", inputs=("Input", "Filter"),
             outputs=("Output",),
             attrs={"strides": [1, 1], "paddings": [0, 0],
                    "dilations": [1, 1], "groups": 1})
def depthwise_conv2d(ctx, ins, attrs):
    """conv2d with `groups` (the input's channels when 0 or None)."""
    groups = attrs.get("groups") or one(ins, "Input").shape[1]
    return conv2d(ctx, ins, {**attrs, "groups": groups})


def _conv2d_grad(ctx, ins, attrs):
    """dInput and dFilter from `convolution_backward` of the product
    the forward ran (the amp-cast operands, the same layout and backend),
    without re-running the forward; each cast back to its input's
    dtype."""
    x, w = one(ins, "Input"), one(ins, "Filter")
    xc, wc = amp_cast(x, w)
    dy = one(ins, "Output@GRAD").to(xc.dtype)
    s, p, d, g = _conv_args(attrs)
    if _channels_last_flag(attrs, x):
        wc = wc.contiguous(memory_format=torch.channels_last)
    dx, dw = _conv_backward(_as_nchw(dy, attrs), _as_nchw(xc, attrs), wc,
                            s, p, d, g)
    return {"Input@GRAD": [_from_nchw(dx, attrs).to(x.dtype)],
            "Filter@GRAD": [dw.contiguous().to(w.dtype)]}


register_grad_lower("conv2d")(_conv2d_grad)


@register_grad_lower("depthwise_conv2d")
def _depthwise_conv2d_grad(ctx, ins, attrs):
    groups = attrs.get("groups") or one(ins, "Input").shape[1]
    return _conv2d_grad(ctx, ins, {**attrs, "groups": groups})


def _pool2d(x, attrs):
    """Max pooling pads with -inf; average pooling divides each window's
    sum by its count of unpadded elements (the JAX lowering reduces a
    ones tensor alike); `global_pooling` takes the whole spatial
    extent.  A padding wider than half the window, which torch's
    pooling refuses, is padded explicitly."""
    nhwc = attrs.get("data_format", "NCHW") == "NHWC"
    xt = x.permute(0, 3, 1, 2) if nhwc else x
    k = _pair(attrs.get("ksize", [2, 2]))
    s = _pair(attrs.get("strides", [1, 1]))
    p = _pair(attrs.get("paddings", [0, 0]))
    if attrs.get("global_pooling"):
        k, s, p = tuple(xt.shape[2:]), (1, 1), (0, 0)
    is_max = attrs.get("pooling_type", "max") == "max"
    if all(pi <= ki // 2 for pi, ki in zip(p, k)):
        out = (F.max_pool2d(xt, k, s, p) if is_max else
               F.avg_pool2d(xt, k, s, p, count_include_pad=False))
    else:
        pad = (p[1], p[1], p[0], p[0])
        if is_max:
            out = F.max_pool2d(F.pad(xt, pad, value=float("-inf")), k, s)
        else:
            sums = F.avg_pool2d(F.pad(xt, pad), k, s, divisor_override=1)
            cnt = F.avg_pool2d(F.pad(torch.ones_like(xt), pad), k, s,
                               divisor_override=1)
            out = sums / cnt
    return out.permute(0, 2, 3, 1) if nhwc else out


@register_op("pool2d", inputs=("X",), outputs=("Out",),
             attrs={"pooling_type": "max", "ksize": [2, 2],
                    "strides": [1, 1], "paddings": [0, 0],
                    "global_pooling": False, "use_cudnn": True,
                    "data_format": "NCHW"})
def pool2d(ctx, ins, attrs):
    return {"Out": _pool2d(one(ins, "X"), attrs)}


# ---------------------------------------------------------------------------
# conv3d and the transposed convolutions (paddle_tpu/ops/conv.py:82-122,
# :315-336), behind the same pinned Function and explicit gradients
# ---------------------------------------------------------------------------


def _conv_nd(ins, attrs, n, transposed):
    """conv3d (filter [M, C/g, k...]) or a transposed convolution
    (filter [C, M, k...]) of the amp-cast operands."""
    x, w = amp_cast(one(ins, "Input"), one(ins, "Filter"))
    s, p, d, g = _conv_args(attrs, n, groups=not transposed)
    return {"Output": _PinnedConv.apply(x, w, s, p, d, g, transposed)}


def _conv_nd_grad(ins, attrs, n, transposed):
    """dInput and dFilter from `convolution_backward` of the amp-cast
    operands (no forward re-run), each in its input's dtype."""
    x, w = one(ins, "Input"), one(ins, "Filter")
    xc, wc = amp_cast(x, w)
    dy = one(ins, "Output@GRAD").to(xc.dtype)
    dx, dw = _conv_backward(dy, xc, wc, *_conv_args(
        attrs, n, groups=not transposed), transposed)
    return {"Input@GRAD": [dx.to(x.dtype)],
            "Filter@GRAD": [dw.contiguous().to(w.dtype)]}


@register_op("conv3d", inputs=("Input", "Filter"), outputs=("Output",),
             attrs={"strides": [1, 1, 1], "paddings": [0, 0, 0],
                    "dilations": [1, 1, 1], "groups": 1})
def conv3d(ctx, ins, attrs):
    """[N, C, D, H, W] by [M, C/g, kd, kh, kw]."""
    return _conv_nd(ins, attrs, 3, False)


@register_op("conv2d_transpose", inputs=("Input", "Filter"),
             outputs=("Output",),
             attrs={"strides": [1, 1], "paddings": [0, 0],
                    "dilations": [1, 1]})
def conv2d_transpose(ctx, ins, attrs):
    """[N, C, H, W] by [C, M, kh, kw] -> [N, M, (H - 1)s - 2p +
    (kh - 1)d + 1, ...]."""
    return _conv_nd(ins, attrs, 2, True)


@register_op("conv3d_transpose", inputs=("Input", "Filter"),
             outputs=("Output",),
             attrs={"strides": [1, 1, 1], "paddings": [0, 0, 0],
                    "dilations": [1, 1, 1]})
def conv3d_transpose(ctx, ins, attrs):
    """[N, C, D, H, W] by [C, M, kd, kh, kw]."""
    return _conv_nd(ins, attrs, 3, True)


register_grad_lower("conv3d")(
    lambda ctx, ins, attrs: _conv_nd_grad(ins, attrs, 3, False))
register_grad_lower("conv2d_transpose")(
    lambda ctx, ins, attrs: _conv_nd_grad(ins, attrs, 2, True))
register_grad_lower("conv3d_transpose")(
    lambda ctx, ins, attrs: _conv_nd_grad(ins, attrs, 3, True))


# ---------------------------------------------------------------------------
# windowed pools: pool3d, max_pool{2,3}d_with_index, spp, unpool
# (paddle_tpu/ops/conv.py:125-233, :279-312)
# ---------------------------------------------------------------------------


def _pool_geometry(x, attrs, rank):
    """(ksize, strides, paddings) over the last `rank` dims;
    `global_pooling` takes the whole extent."""
    k = _pair(attrs.get("ksize", [2] * rank), rank)
    s = _pair(attrs.get("strides", [1] * rank), rank)
    p = _pair(attrs.get("paddings", [0] * rank), rank)
    if attrs.get("global_pooling"):
        k, s, p = tuple(x.shape[2:]), (1,) * rank, (0,) * rank
    return k, s, p


def _windows(x, k, s, p, value):
    """x [N, C, *sp] padded by `p` with `value` and cut into its windows:
    [N, C, *out, prod(k)], each window's elements in row-major order."""
    rank = len(k)
    pad = []
    for pi in reversed(p):
        pad += [pi, pi]
    xp = F.pad(x, pad, value=value) if any(p) else x
    for i in range(rank):
        xp = xp.unfold(2 + i, k[i], s[i])
    return xp.reshape(xp.shape[:2 + rank] + (-1,))


def _plane_index(x, k, s, p):
    """[1, 1, *out, prod(k)]: each window element's flat index in its
    input plane, -1 where it is padding (built on x's device)."""
    sp = tuple(x.shape[2:])
    plane = torch.arange(math.prod(sp), device=x.device).reshape(
        (1, 1) + sp)
    return _windows(plane, k, s, p, -1)


class _MaxPool(torch.autograd.Function):
    """Max over each window -> (values, the flat plane index of the first
    maximum in window order: -1 where no element beats -inf).  The
    backward hands each window's cotangent to that element: a copy when
    no two windows overlap, else a sorted segment sum in window order;
    no float atomics either way."""

    @staticmethod
    def forward(ctx, x, k, s, p):
        vals, arg = _windows(x, k, s, p, float("-inf")).max(-1)
        idx = _plane_index(x, k, s, p).expand(
            vals.shape + (math.prod(k),)).gather(-1, arg.unsqueeze(-1))
        idx = torch.where(vals == float("-inf"), -1, idx.squeeze(-1))
        ctx.save_for_backward(idx)
        ctx.mark_non_differentiable(idx)
        ctx.shape, ctx.disjoint = tuple(x.shape), all(
            si >= ki for si, ki in zip(s, k))
        return vals, idx

    @staticmethod
    def backward(ctx, g, _):
        idx, = ctx.saved_tensors
        n, c = ctx.shape[:2]
        plane = math.prod(ctx.shape[2:])
        total = n * c * plane
        base = (torch.arange(n * c, device=idx.device) * plane).reshape(
            (n, c) + (1,) * (idx.dim() - 2))
        ids = torch.where(idx >= 0, idx + base, total).reshape(-1)
        g = g.reshape(-1)
        if ctx.disjoint:
            # every element is some window's at most once; the dump slot
            # `total` takes the no-element windows and is cut off
            dx = g.new_zeros(total + 1).index_copy_(0, ids, g)
        else:
            dx = sorted_segment_sum(ids, g.unsqueeze(1), total + 1)[:, 0]
        return dx[:total].reshape(ctx.shape), None, None, None


def _pool_nd(x, attrs, rank):
    """pool2d's rule in `rank` dims: max pads with -inf; avg divides each
    window's sum by its count of unpadded elements."""
    k, s, p = _pool_geometry(x, attrs, rank)
    if attrs.get("pooling_type", "max") == "max":
        return _MaxPool.apply(x, k, s, p)[0]
    sums = _windows(x, k, s, p, 0.0).sum(-1)
    cnt = _windows(torch.ones_like(x[:1, :1]), k, s, p, 0.0).sum(-1)
    return sums / cnt


@register_op("pool3d", inputs=("X",), outputs=("Out",),
             attrs={"pooling_type": "max", "ksize": [2, 2, 2],
                    "strides": [1, 1, 1], "paddings": [0, 0, 0],
                    "global_pooling": False})
def pool3d(ctx, ins, attrs):
    return {"Out": _pool_nd(one(ins, "X"), attrs, 3)}


def _max_pool_with_index(ins, attrs, rank):
    """Out and Mask: the window maxima and their flat plane indices
    (-1 where a window holds no element above -inf), int64 in the port
    (the JAX package gives int64 for 2-D and int32 for 3-D)."""
    x = one(ins, "X")
    k, s, p = _pool_geometry(x, attrs, rank)
    vals, idx = _MaxPool.apply(x, k, s, p)
    return {"Out": vals, "Mask": idx}


@register_op("max_pool2d_with_index", inputs=("X",),
             outputs=("Out", "Mask"),
             attrs={"ksize": [2, 2], "strides": [1, 1], "paddings": [0, 0],
                    "global_pooling": False},
             diff_outputs=("Out",))
def max_pool2d_with_index(ctx, ins, attrs):
    return _max_pool_with_index(ins, attrs, 2)


@register_op("max_pool3d_with_index", inputs=("X",),
             outputs=("Out", "Mask"),
             attrs={"ksize": [2, 2, 2], "strides": [1, 1, 1],
                    "paddings": [0, 0, 0], "global_pooling": False},
             diff_outputs=("Out",))
def max_pool3d_with_index(ctx, ins, attrs):
    return _max_pool_with_index(ins, attrs, 3)


@register_op("spp", inputs=("X",), outputs=("Out",),
             attrs={"pyramid_height": 2, "pooling_type": "max"})
def spp(ctx, ins, attrs):
    """Spatial pyramid pooling: level l pools 2^l x 2^l bins of
    ceil(h / 2^l) x ceil(w / 2^l), centred by padding; a bin wholly in
    the padding is -inf (max) or NaN (avg), as in the JAX package."""
    x = one(ins, "X")
    n, c, h, w = x.shape
    outs = []
    for level in range(attrs["pyramid_height"]):
        bins = 2 ** level
        kh, kw = -(-h // bins), -(-w // bins)
        ph, pw = (kh * bins - h + 1) // 2, (kw * bins - w + 1) // 2
        pooled = _pool2d(x, {"pooling_type": attrs["pooling_type"],
                             "ksize": [kh, kw], "strides": [kh, kw],
                             "paddings": [ph, pw]})
        outs.append(pooled.reshape(n, -1))
    return {"Out": torch.cat(outs, dim=1)}


def _unpool_winners(idx, plane):
    """[N, C, plane]: the position j of the LAST input element writing
    each output element (the JAX scatter's write order), -1 where none
    does.  Negative indices count from the end and out-of-range ones
    are dropped, as the JAX `.at[].set` does; an integer max is exact
    in any order."""
    idx = torch.where(idx < 0, idx + plane, idx)
    ok = (idx >= 0) & (idx < plane)
    j = torch.arange(idx.shape[-1], device=idx.device).expand_as(idx)
    win = torch.full(idx.shape[:2] + (plane + 1,), -1, dtype=torch.long,
                     device=idx.device)
    win.scatter_reduce_(-1, torch.where(ok, idx, plane),
                        torch.where(ok, j, -1), "amax")
    return win[..., :plane], torch.where(ok, idx, plane)


class _Unpool(torch.autograd.Function):
    """out[n, c, idx[n, c, j]] = x[n, c, j], the last write winning, by
    gathers: the output gathers each element's winner, and dX gathers
    dOut where the element won."""

    @staticmethod
    def forward(ctx, x, idx, plane):
        win, where = _unpool_winners(idx, plane)
        out = torch.where(win >= 0, x.gather(-1, win.clamp(min=0)),
                          x.new_zeros(()))
        won = torch.cat([win, win.new_full(win.shape[:2] + (1,), -1)],
                        -1).gather(-1, where) == torch.arange(
            idx.shape[-1], device=idx.device)
        ctx.save_for_backward(where, won)
        return out

    @staticmethod
    def backward(ctx, g):
        where, won = ctx.saved_tensors
        g = torch.cat([g, g.new_zeros(g.shape[:2] + (1,))], -1)
        return torch.where(won, g.gather(-1, where),
                           g.new_zeros(())), None, None


@register_op("unpool", inputs=("X", "Indices"), outputs=("Out",),
             attrs={"ksize": [2, 2], "strides": [2, 2], "paddings": [0, 0],
                    "unpooling_type": "max"},
             diff_inputs=("X",))
def unpool(ctx, ins, attrs):
    """Max-unpool through the saved flat indices into an output of
    (h - 1) s - 2p + k rows and columns."""
    x, idx = one(ins, "X"), one(ins, "Indices")
    n, c, h, w = x.shape
    k, s, p = attrs["ksize"], attrs["strides"], attrs["paddings"]
    oh = (h - 1) * s[0] - 2 * p[0] + k[0]
    ow = (w - 1) * s[1] - 2 * p[1] + k[1]
    xf = x.reshape(n, c, -1)
    out = _Unpool.apply(xf, idx.reshape(n, c, -1).long(), oh * ow)
    return {"Out": out.reshape(n, c, oh, ow)}


# ---------------------------------------------------------------------------
# conv_shift and row_conv (paddle_tpu/ops/conv.py:236-269)
# ---------------------------------------------------------------------------


@register_op("conv_shift", inputs=("X", "Y"), outputs=("Out",))
def conv_shift(ctx, ins, attrs):
    """Circular correlation: out[i, j] = sum_k x[i, (j + k - M//2) mod N]
    * y[i, k], the JAX package's rolls and contraction (whose gradients
    are rolls and products: no scatter)."""
    x, y = one(ins, "X"), one(ins, "Y")
    m = y.shape[1]
    half = m // 2
    shifted = torch.stack([torch.roll(x, shifts=half - k, dims=1)
                           for k in range(m)], dim=2)
    return {"Out": torch.einsum("bnm,bm->bn", shifted, y)}


def _row_conv_masks(ctx, lod, k, rows, device):
    """[k, rows, 1] bool: whether row t + i lies in row t's sequence
    (built on the host once per LoD, `ctx.tables`)."""
    from .sequence import _table

    def build():
        offs = np.asarray(lod[-1], np.int64)
        end = np.repeat(offs[1:], np.diff(offs))
        t = np.arange(rows)
        return (np.stack([t + i < end for i in range(k)])[..., None],)

    return _table(ctx, ("row_conv", tuple(map(tuple, lod)), k, rows),
                  device, build)[0]


@register_op("row_conv", inputs=("X", "Filter"), outputs=("Out",), lod=True)
def row_conv(ctx, ins, attrs):
    """Lookahead row convolution: out[t] = sum_i x[t + i] * w[i] over the
    filter's k = future_context + 1 rows, on dense [B, T, D] or on a
    LoD input's packed [T, D] rows.  On a LoD input each sequence's
    window stops at that sequence's end, as Paddle's row_conv_op does
    (the JAX package reads on into the next sequence's rows); with one
    sequence the two agree."""
    xv = one(ins, "X")
    lod = xv.lod if isinstance(xv, LoDTensor) else None
    x = xv.data if lod is not None else xv
    w = one(ins, "Filter")
    k = w.shape[0]
    x3 = x if x.dim() == 3 else x[None]
    t = x3.shape[1]
    pad = F.pad(x3, (0, 0, 0, k - 1))
    masks = (_row_conv_masks(ctx, lod, k, t, x.device)
             if lod is not None and len(lod[-1]) > 2 else None)
    out = 0
    for i in range(k):
        term = pad[:, i:i + t, :] * w[i]
        if masks is not None:
            term = torch.where(masks[i], term, term.new_zeros(()))
        out = out + term
    out = out if x.dim() == 3 else out[0]
    return {"Out": LoDTensor(out, lod) if lod is not None else out}
