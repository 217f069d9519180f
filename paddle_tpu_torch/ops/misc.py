"""pruning_mask (counterpart of the op in paddle_tpu/ops/misc.py): the
static-pruning parameter update hook's mask."""
from __future__ import annotations

import torch

from ..core.execution import one
from ..core.registry import register_op


@register_op("pruning_mask", inputs=("Param",), outputs=("Mask",),
             attrs={"sparsity_ratio": 0.6}, not_differentiable=True)
def pruning_mask(ctx, ins, attrs):
    """0/1 mask keeping the largest-magnitude (1-ratio) fraction of the
    parameter: |p| >= the ratio quantile of |p| (linear interpolation,
    as numpy's and jnp's default)."""
    p = one(ins, "Param")
    a = torch.abs(p.float()).reshape(-1)
    srt = torch.sort(a).values
    pos = min(max(float(attrs["sparsity_ratio"]), 0.0), 1.0) * (a.numel() - 1)
    lo = int(pos)
    hi = min(lo + 1, a.numel() - 1)
    thr = srt[lo] + (srt[hi] - srt[lo]) * (pos - lo)
    return {"Mask": (torch.abs(p.float()) >= thr).to(p.dtype)}
