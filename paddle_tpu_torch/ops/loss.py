"""Loss ops: cross_entropy, softmax_with_cross_entropy, the sigmoid,
hinge, huber, log, margin-rank, modified-huber, rank and smooth-L1
losses (counterpart of paddle_tpu/ops/loss.py).  Kinks are written as
the JAX package's: a maximum against 0 splits a tie's gradient, |x| has
derivative 1 at 0."""
from __future__ import annotations

import torch

from ..amp import amp_upcast
from ..core.execution import data_of, one, scalar_like, with_lod_of
from ..core.registry import register_infer_shape, register_op
from ..core.shape_inference import input_var, set_output_shape
from .activation import abs_


def _take_label(x, label):
    """x: [N, D]; label: [N] or [N, 1] int -> x[i, label[i]] as [N, 1]."""
    if label.dim() == 2 and label.shape[-1] == 1:
        label = label.squeeze(-1)
    return torch.gather(x, 1, label[:, None].long())


@register_op("cross_entropy", inputs=("X", "Label"), outputs=("Y",),
             attrs={"soft_label": False}, diff_inputs=("X",), lod=True)
def cross_entropy(ctx, ins, attrs):
    xv = one(ins, "X")
    # numerically sensitive tail: bf16 probabilities upcast to f32
    x = amp_upcast(data_of(xv))
    # additive eps (not clamp): keeps a finite, recovery-capable gradient
    # -1/(p+eps) when the softmax saturates to p≈0 on the true class
    eps = scalar_like(x, 1e-10 if x.dtype == torch.float32 else 1e-20)
    if attrs.get("soft_label"):
        lbl = data_of(one(ins, "Label"))
        y = -torch.sum(lbl * torch.log(x + eps), dim=-1, keepdim=True)
    else:
        y = -torch.log(_take_label(x, data_of(one(ins, "Label"))) + eps)
    return {"Y": with_lod_of(xv, y)}


@register_op("softmax_with_cross_entropy", inputs=("Logits", "Label"),
             outputs=("Softmax", "Loss"),
             attrs={"soft_label": False},
             diff_inputs=("Logits",), diff_outputs=("Loss",))
def softmax_with_cross_entropy(ctx, ins, attrs):
    log_p = torch.log_softmax(amp_upcast(one(ins, "Logits")), dim=-1)
    if attrs.get("soft_label"):
        loss = -torch.sum(one(ins, "Label") * log_p, dim=-1, keepdim=True)
    else:
        loss = -_take_label(log_p, one(ins, "Label"))
    return {"Softmax": torch.exp(log_p), "Loss": loss}


def _relu0(x):
    """max(x, 0) with a tie's gradient split, as jnp.maximum's."""
    return torch.maximum(x, torch.zeros_like(x))


@register_op("sigmoid_cross_entropy_with_logits", inputs=("X", "Label"),
             outputs=("Out",), diff_inputs=("X",))
def sigmoid_cross_entropy_with_logits(ctx, ins, attrs):
    x = one(ins, "X")
    lbl = one(ins, "Label").to(x.dtype)
    return {"Out": _relu0(x) - x * lbl
            + torch.log1p(torch.exp(-abs_(x)))}


@register_op("hinge_loss", inputs=("Logits", "Labels"), outputs=("Loss",),
             diff_inputs=("Logits",))
def hinge_loss(ctx, ins, attrs):
    x = one(ins, "Logits")
    y = one(ins, "Labels").to(x.dtype)
    return {"Loss": _relu0(1.0 - (2.0 * y - 1.0) * x)}


@register_op("huber_loss", inputs=("X", "Y"), outputs=("Residual", "Out"),
             attrs={"delta": 1.0}, diff_outputs=("Out",))
def huber_loss(ctx, ins, attrs):
    x, y = one(ins, "X"), one(ins, "Y")
    d = scalar_like(x, attrs["delta"])
    r = y - x
    out = torch.where(abs_(r) <= d, 0.5 * torch.square(r),
                      d * (abs_(r) - 0.5 * d))
    return {"Residual": r, "Out": out}


@register_op("log_loss", inputs=("Predicted", "Labels"), outputs=("Loss",),
             attrs={"epsilon": 1e-4}, diff_inputs=("Predicted",))
def log_loss(ctx, ins, attrs):
    p = one(ins, "Predicted")
    y = one(ins, "Labels").to(p.dtype)
    eps = scalar_like(p, attrs["epsilon"])
    return {"Loss": -y * torch.log(p + eps)
            - (1 - y) * torch.log(1 - p + eps)}


@register_op("margin_rank_loss", inputs=("X1", "X2", "Label"),
             outputs=("Out", "Activated"),
             attrs={"margin": 0.0},
             diff_inputs=("X1", "X2"), diff_outputs=("Out",))
def margin_rank_loss(ctx, ins, attrs):
    x1, x2 = one(ins, "X1"), one(ins, "X2")
    lbl = one(ins, "Label").to(x1.dtype)
    out = _relu0(-lbl * (x1 - x2) + scalar_like(x1, attrs["margin"]))
    return {"Out": out, "Activated": (out > 0).to(x1.dtype)}


@register_op("modified_huber_loss", inputs=("X", "Y"),
             outputs=("IntermediateVal", "Out"),
             diff_inputs=("X",), diff_outputs=("Out",))
def modified_huber_loss(ctx, ins, attrs):
    x = one(ins, "X")
    y = one(ins, "Y").to(x.dtype)
    z = (2.0 * y - 1.0) * x
    out = torch.where(z < -1.0, -4.0 * z,
                      torch.where(z < 1.0, torch.square(1.0 - z),
                                  torch.zeros_like(z)))
    return {"IntermediateVal": z, "Out": out}


@register_op("rank_loss", inputs=("Label", "Left", "Right"), outputs=("Out",),
             diff_inputs=("Left", "Right"))
def rank_loss(ctx, ins, attrs):
    d = one(ins, "Left") - one(ins, "Right")
    return {"Out": torch.log1p(torch.exp(d))
            - one(ins, "Label").to(d.dtype) * d}


@register_op("smooth_l1_loss", inputs=("X", "Y", "InsideWeight",
                                       "OutsideWeight"),
             outputs=("Diff", "Out"),
             attrs={"sigma": 1.0},
             diff_inputs=("X",), diff_outputs=("Out",))
def smooth_l1_loss(ctx, ins, attrs):
    """Per-row sum of the smooth L1 of (X - Y) * InsideWeight, each term
    times OutsideWeight -> [N, 1]."""
    iw, ow = one(ins, "InsideWeight"), one(ins, "OutsideWeight")
    sigma2 = attrs["sigma"] ** 2
    diff = one(ins, "X") - one(ins, "Y")
    if iw is not None:
        diff = diff * iw
    ad = abs_(diff)
    val = torch.where(ad < 1.0 / sigma2, 0.5 * sigma2 * torch.square(diff),
                      ad - 0.5 / sigma2)
    if ow is not None:
        val = val * ow
    return {"Diff": diff,
            "Out": torch.sum(val, dim=tuple(range(1, val.dim())))
            .reshape(-1, 1)}


@register_infer_shape("cross_entropy")
def _infer_cross_entropy(op, block):
    """One loss value per row: [..., C] -> [..., 1]."""
    x = input_var(op, block, "X")
    if x is None or x.shape is None:
        return
    set_output_shape(op, block, "Y", tuple(x.shape[:-1]) + (1,), x.dtype)
