"""Optimizer update ops: sgd, momentum, adam (counterpart of
paddle_tpu/ops/optimizer_ops.py).

Each writes ParamOut (and its accumulators) under the input's name, as
in the reference, but computes a NEW tensor: values in the scope may
alias a parameter (the `reshape` lowering returns views), so an
in-place update would change them too.  Dense gradients only; the
SelectedRows scatter branch is queue A1.

As in the JAX package, every update computes in float32 and casts each
state it writes back to the dtype it was stored in: half-precision
optimizer arithmetic is unsound (bf16 rounds Adam's beta2 = 0.999 to
1.0, so the second moment never grows and the step divides by eps).
Under amp the states are f32 already and nothing is cast.
"""
from __future__ import annotations

import functools

import torch

from ..core.execution import one, scalar_like
from ..core.registry import get_op_info, register_op


def _lr(ins, p):
    return one(ins, "LearningRate").reshape(()).float().to(p.dtype)


@register_op("sgd", inputs=("Param", "Grad", "LearningRate"),
             outputs=("ParamOut",), inplace={"ParamOut": "Param"},
             not_differentiable=True)
def sgd(ctx, ins, attrs):
    p = one(ins, "Param")
    return {"ParamOut": p - _lr(ins, p) * one(ins, "Grad")}


@register_op("momentum",
             inputs=("Param", "Grad", "Velocity", "LearningRate"),
             outputs=("ParamOut", "VelocityOut"),
             attrs={"mu": 0.9, "use_nesterov": False},
             inplace={"ParamOut": "Param", "VelocityOut": "Velocity"},
             not_differentiable=True)
def momentum(ctx, ins, attrs):
    p = one(ins, "Param")
    g = one(ins, "Grad")
    v = one(ins, "Velocity")
    lr = _lr(ins, p)
    mu = scalar_like(p, attrs["mu"])
    v_out = mu * v + g
    if attrs.get("use_nesterov"):
        p_out = p - (g + mu * v_out) * lr
    else:
        p_out = p - lr * v_out
    return {"ParamOut": p_out, "VelocityOut": v_out}


@register_op("adam",
             inputs=("Param", "Grad", "Moment1", "Moment2", "LearningRate",
                     "Beta1Pow", "Beta2Pow"),
             outputs=("ParamOut", "Moment1Out", "Moment2Out"),
             attrs={"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8},
             inplace={"ParamOut": "Param", "Moment1Out": "Moment1",
                      "Moment2Out": "Moment2"},
             not_differentiable=True)
def adam(ctx, ins, attrs):
    p = one(ins, "Param")
    g = one(ins, "Grad")
    m1 = one(ins, "Moment1")
    m2 = one(ins, "Moment2")
    b1p = one(ins, "Beta1Pow").reshape(()).to(p.dtype)
    b2p = one(ins, "Beta2Pow").reshape(()).to(p.dtype)
    lr = _lr(ins, p)
    b1, b2 = scalar_like(p, attrs["beta1"]), scalar_like(p, attrs["beta2"])
    eps = scalar_like(p, attrs["epsilon"])
    lr_t = lr * torch.sqrt(1 - b2p) / (1 - b1p)
    m1_out = b1 * m1 + (1 - b1) * g
    m2_out = b2 * m2 + (1 - b2) * torch.square(g)
    p_out = p - lr_t * m1_out / (torch.sqrt(m2_out) + eps)
    return {"ParamOut": p_out, "Moment1Out": m1_out, "Moment2Out": m2_out}


def _in_f32(info):
    """Wrap `info.lower`: float inputs to float32, each in-place output
    back to its input's dtype."""
    lower = info.lower

    @functools.wraps(lower)
    def f32_lower(ctx, ins, attrs):
        ins32 = {s: [v.float() if isinstance(v, torch.Tensor)
                     and v.is_floating_point() else v for v in vals]
                 for s, vals in ins.items()}
        outs = lower(ctx, ins32, attrs)
        for o, i in info.inplace.items():
            v = one(ins, i)
            if o in outs and isinstance(v, torch.Tensor) \
                    and v.is_floating_point():
                outs[o] = outs[o].to(v.dtype)
        return outs

    info.lower = f32_lower


for _name in ("sgd", "momentum", "adam"):
    _in_f32(get_op_info(_name))
