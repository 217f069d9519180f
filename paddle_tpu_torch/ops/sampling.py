"""Sampled-softmax family: hsigmoid (the hierarchical sigmoid) and nce
(noise-contrastive estimation), counterparts of
paddle_tpu/ops/sampling.py.

Reference: PaddlePaddle's gserver/layers/HierarchicalSigmoidLayer.cpp
with math/MatrixBitCode.cpp, and operators/nce_op.{cc,h}.

Both ops gather a few rows of a large weight table for every input row
(a tree path's nodes, or the true class and the drawn negatives), so
their weight and bias gradients scatter-add rows that repeat across the
batch.  The gather here is `_gather_rows`, whose backward is
ops/embedding.py's `sorted_segment_sum` (a stable sort of the ids, then
one sequential sum a table row): the same bits on every call on a card,
where autograd through `w[idx]` would sum the repeats with atomics.

nce draws its negatives from a counter-based hash of (the op's seed, the
global row `ctx.row_offset + i`, the sample index), as dropout draws its
masks (ops/activation.py `keyed_randint`): the generic gradient's
recompute, which runs with the forward's seed, redraws the forward's
negatives, and a data-parallel rank draws its own rows' negatives of the
serial batch.  The JAX package draws from threefry keys, which are not
matched bit for bit: the two agree in distribution.
"""
from __future__ import annotations

import torch

from ..core.execution import data_of, one
from ..core.registry import register_op
from .activation import clip, keyed_randint
from .embedding import sorted_segment_sum


class _GatherRows(torch.autograd.Function):
    """table[ids] along dim 0, with a fixed-order backward."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.n = table.shape[0]
        return table.index_select(0, ids)

    @staticmethod
    def backward(ctx, g):
        ids, = ctx.saved_tensors
        return sorted_segment_sum(ids, g.contiguous(), ctx.n), None


def _gather_rows(table, ids):
    """table[ids] for a 1-D int64 `ids`: rows of a 2-D table, or
    elements of a 1-D one."""
    flat = table.reshape(table.shape[0], -1)
    if table.device.type == "meta":
        out = flat.index_select(0, ids)
    else:
        out = _GatherRows.apply(flat, ids)
    return out.reshape((ids.shape[0],) + tuple(table.shape[1:]))


@register_op("hsigmoid",
             inputs=("X", "W", "Label", "Bias"),
             outputs=("Out", "PreOut"),
             attrs={"num_classes": 2},
             diff_inputs=("X", "W", "Bias"),
             diff_outputs=("Out",))
def hsigmoid(ctx, ins, attrs):
    """The hierarchical sigmoid's cost [B, 1] over a complete binary
    tree of `num_classes` leaves (MatrixBitCode's SimpleCode: c = label
    + K; the node at bit j is (c >> (j + 1)) - 1, its branch bit
    (c >> j) & 1; the path is bit_length(c) - 1 long): the sum of the
    sigmoid cross-entropies along the label's path, softplus(pre) -
    bit * pre, with pre clipped to +-40.  Padding lanes are masked out,
    as the JAX package's (the reference adds log 2 for each)."""
    x = one(ins, "X")                            # [B, D]
    w = one(ins, "W")                            # [K-1, D]
    label = one(ins, "Label").reshape(-1)
    bias = one(ins, "Bias")
    k = int(attrs["num_classes"])
    max_len = max((k - 1).bit_length(), 1)
    dev = x.device

    c = label.to(torch.int64) + k                # codes in [K, 2K)
    j = torch.arange(max_len, dtype=torch.int64, device=dev)
    idx = (c[:, None] >> (j + 1)) - 1            # [B, L] node ids
    bit = ((c[:, None] >> j) & 1).to(x.dtype)
    # the path's length, bit_length(c) - 1, without a float log2
    length = torch.zeros_like(c)
    for s in range(1, (2 * k).bit_length() + 1):
        length = length + (c >= (1 << s)).to(c.dtype)
    valid = j[None, :] < length[:, None]
    idx = torch.clamp(idx, 0, k - 2).reshape(-1)

    b_n, l_n = valid.shape
    w_path = _gather_rows(w, idx).reshape(b_n, l_n, -1)
    pre = torch.matmul(w_path, x[:, :, None])[..., 0]       # [B, L]
    if bias is not None:
        pre = pre + _gather_rows(bias.reshape(-1), idx).reshape(b_n, l_n)
    pre = clip(pre, -40.0, 40.0)
    zero = torch.zeros((), dtype=pre.dtype, device=dev)
    pre = torch.where(valid, pre, zero)
    cost = torch.sum(torch.where(
        valid, torch.logaddexp(pre, torch.zeros_like(pre)) - bit * pre,
        zero), dim=1)
    return {"Out": cost[:, None], "PreOut": pre}


@register_op("nce",
             inputs=("Input", "Label", "Weight", "Bias", "SampleWeight"),
             outputs=("Cost", "SampleLogits", "SampleLabels"),
             attrs={"num_total_classes": 2, "num_neg_samples": 10},
             diff_inputs=("Input", "Weight", "Bias"),
             diff_outputs=("Cost",), random=True)
def nce(ctx, ins, attrs):
    """NCE cost [B, 1] (nce_op.h): SampleLabels = [the true labels | the
    negatives, drawn uniformly from [0, num_total_classes) with
    replacement, the true class not excluded]; o = sigmoid(x . w_s +
    b_s) for each sampled class (SampleLogits, as the JAX package
    outputs it); with b = num_neg / num_total, cost = sum over the
    true of -log(o / (o + b)) + sum over the negatives of
    -log(b / (o + b)), times SampleWeight when given."""
    x = one(ins, "Input")                        # [B, D]
    label = one(ins, "Label")                    # [B, num_true] ints
    w = one(ins, "Weight")                       # [num_total, D]
    bias = one(ins, "Bias")                      # [num_total] or None
    sw = one(ins, "SampleWeight")
    num_total = int(attrs["num_total_classes"])
    num_neg = int(attrs["num_neg_samples"])
    b_n = x.shape[0]
    num_true = label.shape[1] if label.dim() == 2 else 1
    label = label.reshape(b_n, num_true).to(torch.int64)

    if x.device.type == "meta":
        negs = torch.empty((b_n, num_neg), dtype=torch.int64,
                           device=x.device)
    else:
        negs = keyed_randint(b_n, num_neg, num_total, ctx.seed or 0,
                             ctx.row_offset, x.device)
    sample_labels = torch.cat([label, negs], dim=1)          # [B, S]
    flat = sample_labels.reshape(-1)
    w_s = _gather_rows(w, flat).reshape(b_n, num_true + num_neg, -1)
    logits = torch.matmul(w_s, x[:, :, None])[..., 0]
    if bias is not None:
        logits = logits + _gather_rows(bias.reshape(-1), flat).reshape(
            logits.shape)
    o = torch.sigmoid(logits)
    b = float(num_neg) / float(num_total)
    o_true, o_neg = o[:, :num_true], o[:, num_true:]
    cost = (torch.sum(-torch.log(o_true / (o_true + b)), dim=1)
            + torch.sum(-torch.log(b / (o_neg + b)), dim=1))
    if sw is not None:
        cost = cost * data_of(sw).reshape(-1)
    return {"Cost": cost[:, None], "SampleLogits": o,
            "SampleLabels": sample_labels}
