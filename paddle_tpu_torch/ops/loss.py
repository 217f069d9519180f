"""Loss ops: cross_entropy and softmax_with_cross_entropy (counterpart
of paddle_tpu/ops/loss.py)."""
from __future__ import annotations

import torch

from ..core.execution import one
from ..core.registry import register_infer_shape, register_op
from ..core.shape_inference import input_var, set_output_shape


def _take_label(x, label):
    """x: [N, D]; label: [N] or [N, 1] int -> x[i, label[i]] as [N, 1]."""
    if label.dim() == 2 and label.shape[-1] == 1:
        label = label.squeeze(-1)
    return torch.gather(x, 1, label[:, None].long())


@register_op("cross_entropy", inputs=("X", "Label"), outputs=("Y",),
             attrs={"soft_label": False}, diff_inputs=("X",))
def cross_entropy(ctx, ins, attrs):
    x = one(ins, "X")
    # additive eps (not clamp): keeps a finite, recovery-capable gradient
    # -1/(p+eps) when the softmax saturates to p≈0 on the true class
    eps = torch.tensor(1e-10 if x.dtype == torch.float32 else 1e-20,
                       dtype=x.dtype, device=x.device)
    if attrs.get("soft_label"):
        lbl = one(ins, "Label")
        y = -torch.sum(lbl * torch.log(x + eps), dim=-1, keepdim=True)
    else:
        y = -torch.log(_take_label(x, one(ins, "Label")) + eps)
    return {"Y": y}


@register_op("softmax_with_cross_entropy", inputs=("Logits", "Label"),
             outputs=("Softmax", "Loss"),
             attrs={"soft_label": False},
             diff_inputs=("Logits",), diff_outputs=("Loss",))
def softmax_with_cross_entropy(ctx, ins, attrs):
    log_p = torch.log_softmax(one(ins, "Logits"), dim=-1)
    if attrs.get("soft_label"):
        loss = -torch.sum(one(ins, "Label") * log_p, dim=-1, keepdim=True)
    else:
        loss = -_take_label(log_p, one(ins, "Label"))
    return {"Softmax": torch.exp(log_p), "Loss": loss}


@register_infer_shape("cross_entropy")
def _infer_cross_entropy(op, block):
    """One loss value per row: [..., C] -> [..., 1]."""
    x = input_var(op, block, "X")
    if x is None or x.shape is None:
        return
    set_output_shape(op, block, "Y", tuple(x.shape[:-1]) + (1,), x.dtype)
