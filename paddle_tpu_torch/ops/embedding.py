"""Embedding lookup and its gradient (counterpart of
paddle_tpu/ops/embedding.py): dense, or with `is_sparse` a SelectedRows
of the looked-up rows (core/lod.py), which the optimizer updates and
`sum` take.

On a CUDA device the dense gradient is a segment sum with a fixed
order (`sorted_segment_sum`) instead of `index_add_`, whose CUDA kernel
accumulates duplicate ids with atomics in an order that changes from
call to call."""
from __future__ import annotations

import torch

from ..core.execution import data_of, one, with_lod_of
from ..core.lod import SelectedRows
from ..core.registry import register_op


@register_op("lookup_table", inputs=("Ids", "W"), outputs=("Out",),
             attrs={"is_sparse": False, "padding_idx": -1},
             diff_inputs=("W",), lod=True)
def lookup_table(ctx, ins, attrs):
    ids_v = one(ins, "Ids")
    ids = data_of(ids_v)
    w = data_of(one(ins, "W"))
    flat = ids.reshape(-1).long()
    out = w.index_select(0, flat)
    pad = attrs.get("padding_idx", -1)
    if pad is not None and pad >= 0:
        out = torch.where((flat == pad)[:, None], torch.zeros_like(out), out)
    if ids.dim() >= 2 and ids.shape[-1] == 1:
        out_shape = tuple(ids.shape[:-1]) + (w.shape[1],)
    else:
        out_shape = tuple(ids.shape) + (w.shape[1],)
    return {"Out": with_lod_of(ids_v, out.reshape(out_shape))}


@register_op("lookup_table_grad", inputs=("Ids", "W", "Out@GRAD"),
             outputs=("W@GRAD",))
def lookup_table_grad(ctx, ins, attrs):
    """W@GRAD.  With `is_sparse`: SelectedRows(the flat ids, the output
    rows with padding_idx's zeroed, W's height), duplicates kept.
    Otherwise dense: the output rows scatter-added into a zero table,
    duplicate ids accumulating in the order they occur (index_add_ on
    the CPU, `sorted_segment_sum` on a card) — the bits the sparse
    gradient gives when it is made dense."""
    ids = one(ins, "Ids")
    w = one(ins, "W")
    flat = ids.reshape(-1).long()
    og2 = one(ins, "Out@GRAD").reshape(-1, w.shape[1])
    pad = attrs.get("padding_idx", -1)
    if pad is not None and pad >= 0:
        og2 = torch.where((flat == pad)[:, None], torch.zeros_like(og2), og2)
    if attrs.get("is_sparse"):
        return {"W@GRAD": SelectedRows(flat, og2, w.shape[0])}
    og2 = og2.to(w.dtype)
    if og2.device.type == "cuda":
        return {"W@GRAD": sorted_segment_sum(flat, og2, w.shape[0])}
    return {"W@GRAD": torch.zeros_like(w).index_add_(0, flat, og2)}


def sorted_segment_sum(flat, rows, n_rows):
    """[n_rows, D] table whose row i is the sum of rows[k] over the k with
    flat[k] == i, in increasing k: the ids are sorted stably, the rows
    gathered in that order, and each id's run summed front to back by
    `segment_reduce` (one sequential sum per output element, no
    atomics).  So the same inputs give the same bits on every call, and
    the same bits as `index_add_` on the CPU.  The run lengths are
    counted for every table row by an integer scatter-add (exact in any
    order); rows no id names are empty runs and stay zero.  Nothing
    here reads a value back to the host."""
    order = torch.sort(flat, stable=True)
    counts = torch.zeros(n_rows, dtype=torch.long, device=flat.device)
    counts.index_add_(0, flat, torch.ones_like(flat))
    return torch.segment_reduce(rows.index_select(0, order.indices), "sum",
                                lengths=counts, axis=0, unsafe=True)
