"""Optimizer update ops: sgd, momentum, adam (counterpart of
paddle_tpu/ops/optimizer_ops.py).

Each writes ParamOut (and its accumulators) under the input's name, as
in the reference, but computes a NEW tensor: values in the scope may
alias a parameter (the `reshape` lowering returns views), so an
in-place update would change them too.  Dense gradients only; the
SelectedRows scatter branch is queue A1.
"""
from __future__ import annotations

import torch

from ..core.execution import one
from ..core.registry import register_op


def _lr(ins, p):
    return one(ins, "LearningRate").reshape(()).float().to(p.dtype)


def _const(v, p):
    return torch.tensor(v, dtype=p.dtype, device=p.device)


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
    mu = _const(attrs["mu"], p)
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
    b1, b2 = _const(attrs["beta1"], p), _const(attrs["beta2"], p)
    eps = _const(attrs["epsilon"], p)
    lr_t = lr * torch.sqrt(1 - b2p) / (1 - b1p)
    m1_out = b1 * m1 + (1 - b1) * g
    m2_out = b2 * m2 + (1 - b2) * torch.square(g)
    p_out = p - lr_t * m1_out / (torch.sqrt(m2_out) + eps)
    return {"ParamOut": p_out, "Moment1Out": m1_out, "Moment2Out": m2_out}
