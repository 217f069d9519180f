"""batch_norm, layer_norm and lrn (counterpart of
paddle_tpu/ops/norm.py), with an explicit batch_norm gradient."""
from __future__ import annotations

import math

import torch

from ..core.execution import one
from ..core.registry import register_grad_lower, register_op

_F32 = torch.float32


def _acc(x):
    """batch_norm's accumulation dtype: float64 for float64 input, else
    float32."""
    return torch.float64 if x.dtype == torch.float64 else _F32


def _bn_axes(x, attrs):
    """-> (the reduced axes, the per-channel broadcast shape)."""
    layout = attrs.get("data_layout", "NCHW")
    c_axis = 1 if (layout == "NCHW" and x.dim() > 1) else x.dim() - 1
    bshape = [1] * x.dim()
    bshape[c_axis] = x.shape[c_axis]
    return tuple(i for i in range(x.dim()) if i != c_axis), bshape


def _affine(x, inv, mean, scale, bias, bshape):
    """y = x * a + b in x's dtype, a = inv * scale and b = bias - mean * a
    per channel in inv's dtype."""
    a = inv * scale.to(inv.dtype)
    b = bias.to(inv.dtype) - mean * a
    return x * a.to(x.dtype).reshape(bshape) + \
        b.to(x.dtype).reshape(bshape)


def _synced_stats(x, axes, bshape, group):
    """The batch mean and biased variance over every rank's rows, in
    `_acc(x)` with the global element count: float32/float64 input sums x
    first, then the centred sum of (x - mean)^2 (two all-reduces, the
    serial two-pass variance); bf16/f16 input sums x and x^2 in one
    all-reduce (E[x^2] - mean^2, clamped at 0, as the serial one-pass
    variance).  `group.all_reduce(t)` sums t in place over the ranks,
    `group.size` is their count; every rank holds as many rows."""
    n = x.numel() // math.prod(bshape) * group.size
    if x.dtype in (torch.float32, torch.float64):
        total = group.all_reduce(torch.sum(x, dim=axes, dtype=_acc(x)))
        mean = total / n
        centred = x - mean.to(x.dtype).reshape(bshape)
        sq = group.all_reduce(torch.sum(torch.square(centred), dim=axes,
                                        dtype=_acc(x)))
        return mean, sq / n
    xf = x.to(_F32)
    sums = group.all_reduce(torch.cat([torch.sum(xf, dim=axes),
                                       torch.sum(torch.square(xf),
                                                 dim=axes)]))
    mean, ex2 = torch.chunk(sums / n, 2)
    return mean, torch.clamp_min(ex2 - torch.square(mean), 0.0)


@register_op("batch_norm",
             inputs=("X", "Scale", "Bias", "Mean", "Variance"),
             outputs=("Y", "MeanOut", "VarianceOut", "SavedMean",
                      "SavedVariance"),
             attrs={"momentum": 0.9, "epsilon": 1e-5, "is_test": False,
                    "data_layout": "NCHW"},
             diff_inputs=("X", "Scale", "Bias"), diff_outputs=("Y",),
             inplace={"MeanOut": "Mean", "VarianceOut": "Variance"})
def batch_norm(ctx, ins, attrs):
    """Paddle's batch norm, as the JAX package computes it (not
    `F.batch_norm`): statistics accumulated in float32 (float64 for
    float64 input, which the JAX package never sees); the variance
    two-pass (centred) for float32/float64 input and E[x^2] - m^2 in one
    pass for bf16/f16; the running update mom * old + (1 - mom) * batch
    with the biased batch variance, kept in the state's dtype;
    `SavedVariance` is rsqrt(var + eps).  In test mode the running
    statistics normalize and pass through.

    The lowering is pure: MeanOut/VarianceOut are new tensors written
    under the Mean/Variance names (an in-place update would run twice,
    since the generic gradient re-runs forward lowerings).

    With `ctx.sync_group` (ParallelExecutor's sync-BN form: each rank
    holds its rows of the global batch) a training-mode call
    all-reduces its statistics over the group, so SavedMean,
    SavedVariance, MeanOut and VarianceOut are the serial values on
    every rank (`_synced_stats`).  The generic gradient never re-runs
    this lowering, which would run the all-reduces again: batch_norm
    has its explicit gradient (`batch_norm_grad`)."""
    x = one(ins, "X")
    scale, bias = one(ins, "Scale"), one(ins, "Bias")
    mean, var = one(ins, "Mean"), one(ins, "Variance")
    eps, mom = attrs["epsilon"], attrs["momentum"]
    axes, bshape = _bn_axes(x, attrs)
    acc = _acc(x)
    if attrs.get("is_test"):
        inv = torch.rsqrt(var.to(acc) + eps)
        y = _affine(x, inv, mean.to(acc), scale, bias, bshape)
        return {"Y": y, "MeanOut": mean, "VarianceOut": var,
                "SavedMean": mean, "SavedVariance": var}
    group = ctx.sync_group
    if group is not None:
        use_mean, use_var = _synced_stats(x, axes, bshape, group)
    else:
        use_mean = torch.mean(x, dim=axes, dtype=acc)
        if x.dtype in (torch.float32, torch.float64):
            centred = x - use_mean.to(x.dtype).reshape(bshape)
            use_var = torch.mean(torch.square(centred), dim=axes,
                                 dtype=acc)
        else:
            ex2 = torch.mean(torch.square(x.to(_F32)), dim=axes)
            use_var = torch.clamp_min(ex2 - torch.square(use_mean), 0.0)
    inv = torch.rsqrt(use_var + eps)
    y = _affine(x, inv, use_mean, scale, bias, bshape)
    mean_out = mom * mean.to(acc) + (1.0 - mom) * use_mean
    var_out = mom * var.to(acc) + (1.0 - mom) * use_var
    return {"Y": y, "MeanOut": mean_out.to(mean.dtype),
            "VarianceOut": var_out.to(var.dtype),
            "SavedMean": use_mean, "SavedVariance": inv}


@register_grad_lower("batch_norm")
def batch_norm_grad(ctx, ins, attrs):
    """The VJP of the lowering above from the forward's SavedMean and
    SavedVariance (in test mode, the running statistics), without
    re-running it.  With dA = sum(dY * X) and dB = sum(dY) per channel
    (in X's dtype, as the forward's a and b were cast to it):

        dBias = dB,  dScale = (dA - m dB) * inv,
        dvar = -0.5 inv^3 scale (dA - m dB)      (training only),
        dX = dY * a + (2 dvar / N) X + (-a dB - 2 m dvar) / N

    (the last two terms training only); dX is the sum of the `_acc(X)`
    terms cast to X's dtype and dY * a in X's dtype.  The variance's
    clamp at 0 (bf16) is taken as inactive.  Under `ctx.sync_group`
    (training mode) dX takes dA, dB and N over every rank's rows, one
    all-reduce of [dA, dB]; dScale and dBias stay this rank's."""
    x = one(ins, "X")
    dy = one(ins, "Y@GRAD").to(x.dtype)
    scale, bias = one(ins, "Scale"), one(ins, "Bias")
    axes, bshape = _bn_axes(x, attrs)
    test = bool(attrs.get("is_test"))
    acc = _acc(x)
    if test:
        m = one(ins, "Mean").to(acc)
        inv = torch.rsqrt(one(ins, "Variance").to(acc) + attrs["epsilon"])
    else:
        m, inv = one(ins, "SavedMean"), one(ins, "SavedVariance")
    a = inv * scale.to(acc)
    d_a = torch.sum(dy * x, dim=axes, dtype=acc)
    d_b = torch.sum(dy, dim=axes, dtype=acc)
    n = x.numel() // a.numel()     # elements a channel
    # Scale@GRAD and Bias@GRAD stay this rank's sums: the data-parallel
    # step's gradient all-reduce sums them over the ranks (and divides
    # by their count, as it does every gradient)
    d_scale = (d_a.to(x.dtype).to(acc) - m * d_b.to(x.dtype).to(acc)) * inv
    d_bias = d_b.to(x.dtype).to(acc)
    group = None if test else ctx.sync_group
    if group is not None:
        # dX reads the sums over every rank's rows and the global count
        sums = group.all_reduce(torch.cat([d_a, d_b]))
        d_a, d_b = torch.chunk(sums, 2)
        n *= group.size
    d_b = d_b.to(x.dtype).to(acc)
    d_a = d_a.to(x.dtype).to(acc) - m * d_b
    dx = dy * a.to(x.dtype).reshape(bshape)
    if not test:
        dvar = -0.5 * inv * inv * inv * scale.to(acc) * d_a
        c1 = 2.0 * dvar / n
        c0 = (-a * d_b - 2.0 * m * dvar) / n
        t = x * c1.reshape(bshape)
        dx = dx + t.add_(c0.reshape(bshape)).to(x.dtype)
    return {"X@GRAD": [dx],
            "Scale@GRAD": [d_scale.to(scale.dtype)],
            "Bias@GRAD": [d_bias.to(bias.dtype)]}


@register_op("layer_norm", inputs=("X", "Scale", "Bias"),
             outputs=("Y", "Mean", "Variance"),
             attrs={"epsilon": 1e-5, "begin_norm_axis": 1},
             diff_inputs=("X", "Scale", "Bias"), diff_outputs=("Y",))
def layer_norm(ctx, ins, attrs):
    x = one(ins, "X")
    a = attrs["begin_norm_axis"]
    axes = tuple(range(a, x.dim()))
    mean = x.mean(dim=axes, keepdim=True)
    var = torch.square(x - mean).mean(dim=axes, keepdim=True)
    y = (x - mean) / torch.sqrt(var + attrs["epsilon"])
    scale = one(ins, "Scale")
    bias = one(ins, "Bias")
    norm_shape = [1] * a + list(x.shape[a:])
    if scale is not None:
        y = y * scale.reshape(norm_shape)
    if bias is not None:
        y = y + bias.reshape(norm_shape)
    return {"Y": y, "Mean": mean.reshape(x.shape[:a]),
            "Variance": var.reshape(x.shape[:a])}


@register_op("lrn", inputs=("X",), outputs=("Out", "MidOut"),
             attrs={"n": 5, "k": 2.0, "alpha": 1e-4, "beta": 0.75},
             diff_outputs=("Out",))
def lrn(ctx, ins, attrs):
    """Cross-channel local response normalization (reference lrn_op.cc)
    on NCHW: MidOut = k + alpha * (the sum of x^2 over a window of n
    channels centred on each, zero-padded), Out = x / MidOut^beta, in
    x's dtype; the window is summed channel-slice by channel-slice in
    the JAX lowering's order."""
    x = one(ins, "X")
    n = int(attrs["n"])
    half = n // 2
    sq = torch.nn.functional.pad(torch.square(x),
                                 (0, 0, 0, 0, half, half))
    c = x.shape[1]
    window = sum(sq[:, i:i + c] for i in range(n))
    mid = attrs["k"] + attrs["alpha"] * window
    return {"Out": x / torch.pow(mid, attrs["beta"]), "MidOut": mid}
