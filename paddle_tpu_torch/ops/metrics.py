"""The accuracy metric op (counterpart of paddle_tpu/ops/metrics.py:14)."""
from __future__ import annotations

import torch

from ..core.execution import one
from ..core.registry import register_op


@register_op("accuracy", inputs=("Out", "Indices", "Label"),
             outputs=("Accuracy", "Correct", "Total"),
             not_differentiable=True)
def accuracy(ctx, ins, attrs):
    """Top-k accuracy from top_k's indices: a row is correct when its
    label is among them.  Accuracy float32, Correct and Total int32,
    each of shape [1]."""
    idx = one(ins, "Indices")                  # [N, k]
    label = one(ins, "Label")
    if label.dim() == 2 and label.shape[-1] == 1:
        label = label.squeeze(-1)
    hit = torch.any(idx == label[:, None].to(idx.dtype), dim=1)
    correct = torch.sum(hit, dtype=torch.int32).reshape(1)
    total = torch.full((1,), idx.shape[0], dtype=torch.int32,
                       device=idx.device)
    return {"Accuracy": correct.to(torch.float32) / total.to(torch.float32),
            "Correct": correct, "Total": total}
