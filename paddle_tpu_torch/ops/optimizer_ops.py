"""Optimizer update ops (counterpart of paddle_tpu/ops/optimizer_ops.py):
sgd, momentum, adam, adamax, adagrad, adadelta, decayed_adagrad,
rmsprop, ftrl, proximal_gd, proximal_adagrad and average_accumulates.

Each writes ParamOut (and its accumulators) under the input's name, as
in the reference, but computes a NEW tensor: values in the scope may
alias a parameter (the `reshape` lowering returns views), so an
in-place update would change them too.

A SelectedRows gradient (an `is_sparse` embedding's, core/lod.py) takes
sgd's scatter branch: only the rows it names move, each by its values
added in the order they occur.  Every other update makes it dense first
(`dense_of`), as the JAX package's `_dense_grad` does.

As in the JAX package, every update computes in float32 and casts each
state it writes back to the dtype it was stored in (a SelectedRows'
values too): half-precision optimizer arithmetic is unsound (bf16
rounds Adam's beta2 = 0.999 to 1.0, so the second moment never grows
and the step divides by eps).  Under amp the states are f32 already and
nothing is cast.
"""
from __future__ import annotations

import functools

import torch

from ..core.execution import dense_of, one, scalar_like
from ..core.lod import SelectedRows
from ..core.registry import get_op_info, register_op
from .embedding import sorted_segment_sum

UPDATE_OPS = ("sgd", "momentum", "adam", "adamax", "adagrad", "adadelta",
              "decayed_adagrad", "rmsprop", "ftrl", "proximal_gd",
              "proximal_adagrad", "average_accumulates")


def _lr(ins, p):
    return one(ins, "LearningRate").reshape(()).float().to(p.dtype)


def _grad(ins):
    return dense_of(one(ins, "Grad"))


def scatter_add_rows(p, rows, upd):
    """p with upd[k] added to row rows[k], for k in increasing order: a
    row named twice takes (p + upd[i]) + upd[j].  On the CPU that is
    `index_add`; on a card `ordered_scatter_add_rows`, whose CUDA
    index_add_ would add duplicates with atomics in a changing order."""
    if p.device.type != "cuda":
        return p.index_add(0, rows, upd)
    return ordered_scatter_add_rows(p, rows, upd)


def ordered_scatter_add_rows(p, rows, upd):
    """`scatter_add_rows` without atomics: each touched row's run — its
    old value first, then its updates in order — is summed front to back
    by `sorted_segment_sum`, so the same bits on every call and
    index_add's; the rows no id names keep their values untouched."""
    h = p.shape[0]
    ids = torch.cat([torch.arange(h, dtype=rows.dtype, device=p.device),
                     rows])
    summed = sorted_segment_sum(ids, torch.cat([p, upd.to(p.dtype)]), h)
    touched = torch.zeros(h, dtype=torch.bool, device=p.device)
    touched.index_fill_(0, rows, True)
    return torch.where(touched.view((h,) + (1,) * (p.dim() - 1)), summed, p)


@register_op("sgd", inputs=("Param", "Grad", "LearningRate"),
             outputs=("ParamOut",), inplace={"ParamOut": "Param"},
             not_differentiable=True, sparse=True)
def sgd(ctx, ins, attrs):
    p = one(ins, "Param")
    g = one(ins, "Grad")
    lr = _lr(ins, p)
    if isinstance(g, SelectedRows):
        return {"ParamOut": scatter_add_rows(p, g.rows, -lr * g.value)}
    return {"ParamOut": p - lr * g}


@register_op("momentum",
             inputs=("Param", "Grad", "Velocity", "LearningRate"),
             outputs=("ParamOut", "VelocityOut"),
             attrs={"mu": 0.9, "use_nesterov": False},
             inplace={"ParamOut": "Param", "VelocityOut": "Velocity"},
             not_differentiable=True, sparse=True)
def momentum(ctx, ins, attrs):
    p = one(ins, "Param")
    g = _grad(ins)
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
             not_differentiable=True, sparse=True)
def adam(ctx, ins, attrs):
    p = one(ins, "Param")
    g = _grad(ins)
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


@register_op("adamax",
             inputs=("Param", "Grad", "Moment", "InfNorm", "LearningRate",
                     "Beta1Pow"),
             outputs=("ParamOut", "MomentOut", "InfNormOut"),
             attrs={"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8},
             inplace={"ParamOut": "Param", "MomentOut": "Moment",
                      "InfNormOut": "InfNorm"},
             not_differentiable=True, sparse=True)
def adamax(ctx, ins, attrs):
    p = one(ins, "Param")
    g = _grad(ins)
    m = one(ins, "Moment")
    inf = one(ins, "InfNorm")
    b1p = one(ins, "Beta1Pow").reshape(()).to(p.dtype)
    lr = _lr(ins, p)
    b1, b2 = scalar_like(p, attrs["beta1"]), scalar_like(p, attrs["beta2"])
    eps = scalar_like(p, attrs["epsilon"])
    m_out = b1 * m + (1 - b1) * g
    inf_out = torch.maximum(b2 * inf, torch.abs(g) + eps)
    p_out = p - (lr / (1 - b1p)) * (m_out / inf_out)
    return {"ParamOut": p_out, "MomentOut": m_out, "InfNormOut": inf_out}


@register_op("adagrad",
             inputs=("Param", "Grad", "Moment", "LearningRate"),
             outputs=("ParamOut", "MomentOut"),
             attrs={"epsilon": 1e-6},
             inplace={"ParamOut": "Param", "MomentOut": "Moment"},
             not_differentiable=True, sparse=True)
def adagrad(ctx, ins, attrs):
    p = one(ins, "Param")
    m = one(ins, "Moment")
    lr = _lr(ins, p)
    eps = scalar_like(p, attrs["epsilon"])
    g = _grad(ins)
    m_out = m + torch.square(g)
    p_out = p - lr * g / (torch.sqrt(m_out) + eps)
    return {"ParamOut": p_out, "MomentOut": m_out}


@register_op("adadelta",
             inputs=("Param", "Grad", "AvgSquaredGrad", "AvgSquaredUpdate"),
             outputs=("ParamOut", "AvgSquaredGradOut", "AvgSquaredUpdateOut"),
             attrs={"rho": 0.95, "epsilon": 1e-6},
             inplace={"ParamOut": "Param",
                      "AvgSquaredGradOut": "AvgSquaredGrad",
                      "AvgSquaredUpdateOut": "AvgSquaredUpdate"},
             not_differentiable=True, sparse=True)
def adadelta(ctx, ins, attrs):
    p = one(ins, "Param")
    g = _grad(ins)
    asg = one(ins, "AvgSquaredGrad")
    asu = one(ins, "AvgSquaredUpdate")
    rho = scalar_like(p, attrs["rho"])
    eps = scalar_like(p, attrs["epsilon"])
    asg_out = rho * asg + (1 - rho) * torch.square(g)
    update = -torch.sqrt((asu + eps) / (asg_out + eps)) * g
    asu_out = rho * asu + (1 - rho) * torch.square(update)
    return {"ParamOut": p + update, "AvgSquaredGradOut": asg_out,
            "AvgSquaredUpdateOut": asu_out}


@register_op("decayed_adagrad",
             inputs=("Param", "Grad", "Moment", "LearningRate"),
             outputs=("ParamOut", "MomentOut"),
             attrs={"decay": 0.95, "epsilon": 1e-6},
             inplace={"ParamOut": "Param", "MomentOut": "Moment"},
             not_differentiable=True, sparse=True)
def decayed_adagrad(ctx, ins, attrs):
    p = one(ins, "Param")
    g = _grad(ins)
    m = one(ins, "Moment")
    lr = _lr(ins, p)
    decay = scalar_like(p, attrs["decay"])
    eps = scalar_like(p, attrs["epsilon"])
    m_out = decay * m + (1 - decay) * torch.square(g)
    return {"ParamOut": p - lr * g / (torch.sqrt(m_out) + eps),
            "MomentOut": m_out}


@register_op("rmsprop",
             inputs=("Param", "Grad", "MeanSquare", "Moment", "LearningRate"),
             outputs=("ParamOut", "MeanSquareOut", "MomentOut"),
             attrs={"decay": 0.9, "momentum": 0.0, "epsilon": 1e-10},
             inplace={"ParamOut": "Param", "MeanSquareOut": "MeanSquare",
                      "MomentOut": "Moment"},
             not_differentiable=True, sparse=True)
def rmsprop(ctx, ins, attrs):
    p = one(ins, "Param")
    g = _grad(ins)
    ms = one(ins, "MeanSquare")
    mom = one(ins, "Moment")
    lr = _lr(ins, p)
    decay = scalar_like(p, attrs["decay"])
    mu = scalar_like(p, attrs["momentum"])
    eps = scalar_like(p, attrs["epsilon"])
    ms_out = decay * ms + (1 - decay) * torch.square(g)
    mom_out = mu * mom + lr * g / torch.sqrt(ms_out + eps)
    return {"ParamOut": p - mom_out, "MeanSquareOut": ms_out,
            "MomentOut": mom_out}


@register_op("ftrl",
             inputs=("Param", "SquaredAccumulator", "LinearAccumulator",
                     "Grad", "LearningRate"),
             outputs=("ParamOut", "SquaredAccumOut", "LinearAccumOut"),
             attrs={"l1": 0.0, "l2": 0.0, "lr_power": -0.5},
             inplace={"ParamOut": "Param",
                      "SquaredAccumOut": "SquaredAccumulator",
                      "LinearAccumOut": "LinearAccumulator"},
             not_differentiable=True, sparse=True)
def ftrl(ctx, ins, attrs):
    p = one(ins, "Param")
    sq = one(ins, "SquaredAccumulator")
    lin = one(ins, "LinearAccumulator")
    g = _grad(ins)
    lr = _lr(ins, p)
    l1, l2 = scalar_like(p, attrs["l1"]), scalar_like(p, attrs["l2"])
    power = -float(attrs["lr_power"])
    sq_out = sq + torch.square(g)
    sigma = (torch.pow(sq_out, power) - torch.pow(sq, power)) / lr
    lin_out = lin + g - sigma * p
    x = l1 * torch.sign(lin_out) - lin_out
    y = torch.pow(sq_out, power) / lr + 2 * l2
    p_out = torch.where(torch.abs(lin_out) > l1, x / y, torch.zeros_like(p))
    return {"ParamOut": p_out, "SquaredAccumOut": sq_out,
            "LinearAccumOut": lin_out}


def _proximal(prox, lr_t, l1, l2):
    return (torch.sign(prox) * torch.clamp_min(torch.abs(prox) - lr_t * l1,
                                               0.0)
            / (1.0 + lr_t * l2))


@register_op("proximal_gd", inputs=("Param", "Grad", "LearningRate"),
             outputs=("ParamOut",), attrs={"l1": 0.0, "l2": 0.0},
             inplace={"ParamOut": "Param"}, not_differentiable=True,
             sparse=True)
def proximal_gd(ctx, ins, attrs):
    p = one(ins, "Param")
    g = _grad(ins)
    lr = _lr(ins, p)
    l1, l2 = scalar_like(p, attrs["l1"]), scalar_like(p, attrs["l2"])
    return {"ParamOut": _proximal(p - lr * g, lr, l1, l2)}


@register_op("proximal_adagrad",
             inputs=("Param", "Moment", "Grad", "LearningRate"),
             outputs=("ParamOut", "MomentOut"),
             attrs={"l1": 0.0, "l2": 0.0},
             inplace={"ParamOut": "Param", "MomentOut": "Moment"},
             not_differentiable=True, sparse=True)
def proximal_adagrad(ctx, ins, attrs):
    p = one(ins, "Param")
    m = one(ins, "Moment")
    g = _grad(ins)
    lr = _lr(ins, p)
    l1, l2 = scalar_like(p, attrs["l1"]), scalar_like(p, attrs["l2"])
    m_out = m + torch.square(g)
    lr_t = lr / torch.sqrt(m_out)
    return {"ParamOut": _proximal(p - lr_t * g, lr_t, l1, l2),
            "MomentOut": m_out}


# one chunk of step sums is folded into sum_2 every this many updates
_K_MAX_CHUNK = 16384


@register_op("average_accumulates",
             inputs=("Param", "InSum1", "InSum2", "InSum3",
                     "InNumAccumulates", "InOldNumAccumulates",
                     "InNumUpdates"),
             outputs=("OutSum1", "OutSum2", "OutSum3",
                      "OutNumAccumulates", "OutOldNumAccumulates",
                      "OutNumUpdates"),
             attrs={"average_window": 0.15, "min_average_window": 10000,
                    "max_average_window": 10000},
             inplace={"OutSum1": "InSum1", "OutSum2": "InSum2",
                      "OutSum3": "InSum3",
                      "OutNumAccumulates": "InNumAccumulates",
                      "OutOldNumAccumulates": "InOldNumAccumulates",
                      "OutNumUpdates": "InNumUpdates"},
             not_differentiable=True)
def average_accumulates(ctx, ins, attrs):
    """Windowed parameter sums for ModelAverage (Polyak averaging), the
    JAX package's legacy AverageOptimizer windowing: sum_1 gains the
    parameter each update; every 16384 updates it folds into sum_2; once
    past min_average_window updates in a window of
    min(max_average_window, updates x average_window), sum_1 + sum_2
    roll into sum_3 and the window restarts.  Every branch is a select
    on device scalars, so the op runs inside a CUDA graph."""
    p = one(ins, "Param")
    s1, s2, s3 = (one(ins, k) for k in ("InSum1", "InSum2", "InSum3"))
    num_acc = one(ins, "InNumAccumulates").reshape(())
    old_num = one(ins, "InOldNumAccumulates").reshape(())
    num_upd = one(ins, "InNumUpdates").reshape(()) + 1
    num_acc = num_acc + 1
    s1 = s1 + p
    fold = (num_upd % _K_MAX_CHUNK) == 0
    s2 = torch.where(fold, s2 + s1, s2)
    s1 = torch.where(fold, torch.zeros_like(s1), s1)
    window = torch.minimum(
        torch.full((), float(attrs["max_average_window"]),
                   dtype=torch.float32, device=p.device),
        num_upd.float() * float(attrs["average_window"]))
    roll = ((num_acc >= int(attrs["min_average_window"]))
            & (num_acc.float() >= window))
    s3 = torch.where(roll, s1 + s2, s3)
    s1 = torch.where(roll, torch.zeros_like(s1), s1)
    s2 = torch.where(roll, torch.zeros_like(s2), s2)
    old_num = torch.where(roll, num_acc, old_num)
    num_acc = torch.where(roll, torch.zeros_like(num_acc), num_acc)
    return {"OutSum1": s1, "OutSum2": s2, "OutSum3": s3,
            "OutNumAccumulates": num_acc.reshape(1),
            "OutOldNumAccumulates": old_num.reshape(1),
            "OutNumUpdates": num_upd.reshape(1)}


def _f32(v):
    if isinstance(v, SelectedRows):
        return SelectedRows(v.rows, _f32(v.value), v.height)
    if isinstance(v, torch.Tensor) and v.is_floating_point():
        return v.float()
    return v


def _in_f32(info):
    """Wrap `info.lower`: float inputs (a SelectedRows' values too) to
    float32, each in-place output back to its input's dtype."""
    lower = info.lower

    @functools.wraps(lower)
    def f32_lower(ctx, ins, attrs):
        outs = lower(ctx, {s: [_f32(v) for v in vals]
                           for s, vals in ins.items()}, attrs)
        for o, i in info.inplace.items():
            v = one(ins, i)
            if o in outs and isinstance(v, torch.Tensor) \
                    and v.is_floating_point():
                outs[o] = outs[o].to(v.dtype)
        return outs

    info.lower = f32_lower


for _name in UPDATE_OPS:
    _in_f32(get_op_info(_name))
