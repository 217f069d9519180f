"""batch_norm and layer_norm (counterpart of paddle_tpu/ops/norm.py:15-92
and its layer_norm), with an explicit batch_norm gradient."""
from __future__ import annotations

import torch

from ..core.execution import one
from ..core.registry import register_grad_lower, register_op

_F32 = torch.float32


def _bn_axes(x, attrs):
    """-> (the reduced axes, the per-channel broadcast shape)."""
    layout = attrs.get("data_layout", "NCHW")
    c_axis = 1 if (layout == "NCHW" and x.dim() > 1) else x.dim() - 1
    bshape = [1] * x.dim()
    bshape[c_axis] = x.shape[c_axis]
    return tuple(i for i in range(x.dim()) if i != c_axis), bshape


def _affine(x, inv, mean, scale, bias, bshape):
    """y = x * a + b in x's dtype, a = inv * scale and b = bias - mean * a
    per channel in float32."""
    a = inv * scale.to(_F32)
    b = bias.to(_F32) - mean * a
    return x * a.to(x.dtype).reshape(bshape) + \
        b.to(x.dtype).reshape(bshape)


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
    `F.batch_norm`): statistics accumulated in float32; the variance
    two-pass (centred) for float32/float64 input and E[x^2] - m^2 in one
    pass for bf16/f16; the running update mom * old + (1 - mom) * batch
    with the biased batch variance, kept in the state's dtype;
    `SavedVariance` is rsqrt(var + eps).  In test mode the running
    statistics normalize and pass through.

    The lowering is pure: MeanOut/VarianceOut are new tensors written
    under the Mean/Variance names (an in-place update would run twice,
    since the generic gradient re-runs forward lowerings)."""
    x = one(ins, "X")
    scale, bias = one(ins, "Scale"), one(ins, "Bias")
    mean, var = one(ins, "Mean"), one(ins, "Variance")
    eps, mom = attrs["epsilon"], attrs["momentum"]
    axes, bshape = _bn_axes(x, attrs)
    if attrs.get("is_test"):
        inv = torch.rsqrt(var.to(_F32) + eps)
        y = _affine(x, inv, mean.to(_F32), scale, bias, bshape)
        return {"Y": y, "MeanOut": mean, "VarianceOut": var,
                "SavedMean": mean, "SavedVariance": var}
    use_mean = torch.mean(x, dim=axes, dtype=_F32)
    if x.dtype in (torch.float32, torch.float64):
        centred = x - use_mean.to(x.dtype).reshape(bshape)
        use_var = torch.mean(torch.square(centred), dim=axes, dtype=_F32)
    else:
        ex2 = torch.mean(torch.square(x.to(_F32)), dim=axes)
        use_var = torch.clamp_min(ex2 - torch.square(use_mean), 0.0)
    inv = torch.rsqrt(use_var + eps)
    y = _affine(x, inv, use_mean, scale, bias, bshape)
    mean_out = mom * mean.to(_F32) + (1.0 - mom) * use_mean
    var_out = mom * var.to(_F32) + (1.0 - mom) * use_var
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

    (the last two terms training only); dX is the sum of the float32
    terms cast to X's dtype and dY * a in X's dtype.  The variance's
    clamp at 0 (bf16) is taken as inactive."""
    x = one(ins, "X")
    dy = one(ins, "Y@GRAD").to(x.dtype)
    scale, bias = one(ins, "Scale"), one(ins, "Bias")
    axes, bshape = _bn_axes(x, attrs)
    test = bool(attrs.get("is_test"))
    if test:
        m = one(ins, "Mean").to(_F32)
        inv = torch.rsqrt(one(ins, "Variance").to(_F32) + attrs["epsilon"])
    else:
        m, inv = one(ins, "SavedMean"), one(ins, "SavedVariance")
    a = inv * scale.to(_F32)
    d_a = torch.sum(dy * x, dim=axes, dtype=_F32).to(x.dtype).to(_F32)
    d_b = torch.sum(dy, dim=axes, dtype=_F32).to(x.dtype).to(_F32)
    d_a = d_a - m * d_b
    dx = dy * a.to(x.dtype).reshape(bshape)
    if not test:
        n = x.numel() // a.numel()     # elements a channel
        dvar = -0.5 * inv * inv * inv * scale.to(_F32) * d_a
        c1 = 2.0 * dvar / n
        c0 = (-a * d_b - 2.0 * m * dvar) / n
        t = x * c1.reshape(bshape)
        dx = dx + t.add_(c0.reshape(bshape)).to(x.dtype)
    return {"X@GRAD": [dx],
            "Scale@GRAD": [(d_a * inv).to(scale.dtype)],
            "Bias@GRAD": [d_b.to(bias.dtype)]}


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
