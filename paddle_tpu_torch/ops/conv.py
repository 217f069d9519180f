"""Convolution and pooling ops: conv2d, depthwise_conv2d and pool2d
(counterpart of paddle_tpu/ops/conv.py:32-170), with an explicit
conv2d gradient.

conv2d runs through `torch.nn.functional.conv2d`, as the JAX package
runs it through `lax.conv_general_dilated`, outside any kernel of its
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

Layouts: "NHWC" activations keep channels last at the IR level; the
filter is OIHW either way.  The `conv_layout` flag ("NHWC") runs an
NCHW-declared conv channels-last inside the lowering: its output stays
in torch's channels_last memory format, so the next conv of a trunk
takes it without a transpose (what XLA's cancelled transpose pairs do
in the JAX package).  Neither changes a value.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from ..amp import amp_cast
from ..core.execution import one
from ..core.flags import get_flag
from ..core.registry import register_grad_lower, register_op


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


def _conv_args(attrs):
    return (_pair(attrs["strides"]), _pair(attrs["paddings"]),
            _pair(attrs["dilations"]), int(attrs.get("groups") or 1))


class _PinnedConv(torch.autograd.Function):
    """`F.conv2d` with the backend pinned (`conv_pinned`) in its forward
    and in its backward, which is `_conv2d_grad`'s
    `convolution_backward`."""

    @staticmethod
    def forward(ctx, x, w, s, p, d, g):
        ctx.save_for_backward(x, w)
        ctx.args = (s, p, d, g)
        with conv_pinned(x.dtype):
            return F.conv2d(x, w, None, s, p, d, g)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        s, p, d, g = ctx.args
        with conv_pinned(x.dtype):
            dx, dw, _ = torch.ops.aten.convolution_backward(
                dy, x, w, None, list(s), list(p), list(d), False, [0, 0],
                g, [ctx.needs_input_grad[0], ctx.needs_input_grad[1],
                    False])
        return dx, dw, None, None, None, None


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
    with conv_pinned(xc.dtype):
        dx, dw, _ = torch.ops.aten.convolution_backward(
            _as_nchw(dy, attrs), _as_nchw(xc, attrs), wc, None, list(s),
            list(p), list(d), False, [0, 0], g, [True, True, False])
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
