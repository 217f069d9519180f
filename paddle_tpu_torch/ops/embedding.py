"""Embedding lookup and its dense gradient (counterpart of
paddle_tpu/ops/embedding.py).  The `is_sparse` gradient needs the
SelectedRows type (ROADMAP A1) and raises."""
from __future__ import annotations

import torch

from ..core.execution import one
from ..core.registry import register_op


@register_op("lookup_table", inputs=("Ids", "W"), outputs=("Out",),
             attrs={"is_sparse": False, "padding_idx": -1},
             diff_inputs=("W",))
def lookup_table(ctx, ins, attrs):
    ids = one(ins, "Ids")
    w = one(ins, "W")
    flat = ids.reshape(-1).long()
    out = w.index_select(0, flat)
    pad = attrs.get("padding_idx", -1)
    if pad is not None and pad >= 0:
        out = torch.where((flat == pad)[:, None], torch.zeros_like(out), out)
    if ids.dim() >= 2 and ids.shape[-1] == 1:
        out_shape = tuple(ids.shape[:-1]) + (w.shape[1],)
    else:
        out_shape = tuple(ids.shape) + (w.shape[1],)
    return {"Out": out.reshape(out_shape)}


@register_op("lookup_table_grad", inputs=("Ids", "W", "Out@GRAD"),
             outputs=("W@GRAD",))
def lookup_table_grad(ctx, ins, attrs):
    """Dense W@GRAD: the output rows scatter-added into a zero table
    (index_add_: duplicate ids accumulate)."""
    if attrs.get("is_sparse"):
        raise NotImplementedError(
            "lookup_table with is_sparse=True needs the SelectedRows "
            "gradient type, which is not ported yet (ROADMAP A1); build "
            "the embedding with is_sparse=False")
    ids = one(ins, "Ids")
    w = one(ins, "W")
    flat = ids.reshape(-1).long()
    og2 = one(ins, "Out@GRAD").reshape(-1, w.shape[1]).to(w.dtype)
    pad = attrs.get("padding_idx", -1)
    if pad is not None and pad >= 0:
        og2 = torch.where((flat == pad)[:, None], torch.zeros_like(og2), og2)
    return {"W@GRAD": torch.zeros_like(w).index_add_(0, flat, og2)}
