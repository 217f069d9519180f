"""CTC ops: warpctc (the CTC loss) and ctc_align (the greedy decode's
collapse), counterparts of paddle_tpu/ops/ctc.py.

Reference: PaddlePaddle's operators/warpctc_op.{cc,h} (a wrapper around
Baidu's warp-ctc) and ctc_align_op.{cc,h}.

The JAX package computes CTC natively, as the log-space alpha recursion
over the blank-extended labels, one `lax.scan` over the padded time
axis.  Here the recursion is a plain PyTorch loop over that axis, as
ops/crf.py runs the CRF's: the padded gather of the logits, the label
pad table, each sequence's extended length and the start mask are
host-built tables in `ctx.tables` (ops/sequence.py `_table`), so a
CUDA-graph capture reads them without a host-to-device copy.  The
blank-extended labels and the skip mask are built on the device from
the label values.  Each step's log-probabilities at the extended labels
are one contraction of the padded log-softmax with the labels' one-hot
rows ([B, T, C] x [B, S, C]), not an indexed gather: the blank repeats
in every row, and a gather's backward would sum those repeats with
atomics on a card.  The gradient is autograd's through the loop (the
generic gradient, as the JAX package's is `jax.vjp` of its scan).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.execution import data_of, one
from ..core.lod import LoDTensor, lod_from_seq_lens
from ..core.registry import register_infer_shape, register_op
from ..core.shape_inference import input_var, set_output_shape
from .activation import clip
from .sequence import (_lod_key, _RowSpec, _seq_lens, _table, gather_rows,
                       lod_to_padded_index, padded_rows)

NEG_INF = -1e30


def _logsumexp2(a, b):
    """log(e^a + e^b) for values that may be NEG_INF, as the JAX
    package's: the differences clipped to [-80, 0], so no exp(-inf) or
    log(0) appears on the untaken branch of the `where`, whose NaNs
    would reach the gradient.  `clip` is the JAX package's (a maximum
    then a minimum): where a equals b its gradient splits as
    `jnp.clip`'s."""
    m = torch.maximum(a, b)
    dead = m <= NEG_INF / 2
    m_safe = torch.where(dead, torch.zeros_like(m), m)
    da = clip(a - m_safe, -80.0, 0.0)
    db = clip(b - m_safe, -80.0, 0.0)
    out = m_safe + torch.log(torch.exp(da) + torch.exp(db))
    return torch.where(dead, torch.full_like(out, NEG_INF), out)


def _logsumexp3(a, b, c):
    return _logsumexp2(_logsumexp2(a, b), c)


def _shift(alpha, k):
    """alpha moved k places right along dim 1, NEG_INF coming in."""
    s = alpha.shape[1]
    if k >= s:
        return torch.full_like(alpha, NEG_INF)
    pad = torch.full_like(alpha[:, :k], NEG_INF)
    return torch.cat([pad, alpha[:, :s - k]], dim=1)


def _label_tables(ctx, logits_lod, label_lod, device):
    """(the label gather [B*L] with its mask [B, L], each sequence's
    extended length [B] and the start mask [B, S], each sequence's
    frame count [B] as float64, L, S)."""
    def build():
        lab_idx, lab_mask = lod_to_padded_index(label_lod)
        lens = np.asarray(_seq_lens(label_lod), np.int64)
        lmax = int(lens.max()) if lens.size else 0
        s = 2 * lmax + 1
        start = np.full((len(lens), s), NEG_INF, np.float32)
        start[:, 0] = 0.0
        if s > 1:
            start[lens > 0, 1] = 0.0
        return (_RowSpec(lab_idx, label_lod[-1], lab_mask > 0), lab_mask > 0,
                2 * lens + 1, start,
                np.asarray(_seq_lens(logits_lod), np.float64), lmax, s)

    return _table(ctx, ("warpctc", _lod_key(logits_lod),
                        _lod_key(label_lod)), device, build)


@register_op("warpctc", inputs=("Logits", "Label"),
             outputs=("Loss", "WarpCTCGrad"),
             attrs={"blank": 0, "norm_by_times": False},
             diff_inputs=("Logits",), diff_outputs=("Loss",), lod=True)
def warpctc(ctx, ins, attrs):
    """CTC negative log-likelihood [B, 1] of each sequence's labels.
    Logits: LoD rows [sum T_i, C] of unnormalised activations (softmax
    inside, as warp-ctc's); Label: LoD rows [sum L_i, 1] of ints; the
    blank index is `blank`.  WarpCTCGrad is zeros with the logits'
    LoD (the gradient is the generic one)."""
    lv, labv = one(ins, "Logits"), one(ins, "Label")
    blank = int(attrs.get("blank", 0))
    logits = lv.data
    dev = logits.device
    logits_lod, label_lod = lv.lod[-1], labv.lod[-1]
    rows, tmask, tmax = padded_rows(ctx, logits_lod, dev)
    bsz = tmask.shape[0]
    c = logits.shape[-1]
    lab_rows, lab_mask, ext_len, start, frames, lmax, s = _label_tables(
        ctx, logits_lod, label_lod, dev)

    logp = gather_rows(torch.log_softmax(logits, dim=-1), rows)
    logp = logp.reshape(bsz, tmax, c)
    # the blank-extended labels [B, S] (blank l1 blank l2 ... blank) and
    # the skip s-2 -> s where ext[s] is no blank and differs from ext[s-2]
    labels = data_of(labv).reshape(-1).to(torch.int64)
    ext = torch.full((bsz, s), blank, dtype=torch.int64, device=dev)
    if lmax:
        lab_pad = torch.where(
            lab_mask, labels.index_select(0, lab_rows.idx).reshape(bsz, lmax),
            torch.full((), blank, dtype=torch.int64, device=dev))
        ext[:, 1::2] = lab_pad
    skip = torch.zeros((bsz, s), dtype=torch.bool, device=dev)
    if s > 2:
        skip[:, 2:] = (ext[:, 2:] != blank) & (ext[:, 2:] != ext[:, :-2])
    one_hot = (ext[..., None] == torch.arange(c, device=dev)).to(
        logits.dtype)                                      # [B, S, C]
    # every step's log-probabilities at the extended labels: [B, T, S]
    lp = torch.matmul(logp, one_hot.transpose(1, 2))

    neg = torch.full((), NEG_INF, dtype=logits.dtype, device=dev)
    alpha = lp[:, 0] + start.to(logits.dtype)
    for t in range(1, tmax):
        a_skip = torch.where(skip, _shift(alpha, 2), neg)
        nxt = _logsumexp3(alpha, _shift(alpha, 1), a_skip) + lp[:, t]
        alpha = torch.where(tmask[:, t, None] > 0, nxt, alpha)
    # p = alpha[ext_len - 1] + alpha[ext_len - 2]
    last1 = torch.gather(alpha, 1, (ext_len - 1)[:, None])[:, 0]
    last2 = torch.gather(alpha, 1, torch.clamp(ext_len - 2, min=0)[:, None])
    last2 = torch.where(ext_len >= 2, last2[:, 0], neg)
    loss = -_logsumexp2(last1, last2)
    if attrs.get("norm_by_times"):
        loss = loss / frames.to(loss.dtype)
    return {"Loss": loss[:, None],
            "WarpCTCGrad": LoDTensor(torch.zeros_like(logits), lv.lod)}


@register_op("ctc_align", inputs=("Input",), outputs=("Output",),
             attrs={"blank": 0, "merge_repeated": True},
             not_differentiable=True, host=True, lod=True)
def ctc_align(ctx, ins, attrs):
    """Greedy CTC decode's collapse: repeats merged, then blanks dropped
    (ctc_align_op.h), on the host -> int64 [n, 1] with the collapsed
    LoD (a (0, 1) tensor when nothing is kept), on the input's device."""
    xv = one(ins, "Input")
    x = data_of(xv).detach().cpu().numpy().reshape(-1)
    lod = xv.lod[-1]
    blank = int(attrs["blank"])
    merge = bool(attrs.get("merge_repeated", True))
    out_rows, out_lens = [], []
    for i in range(len(lod) - 1):
        seq = x[lod[i]:lod[i + 1]]
        if merge and len(seq):
            seq = seq[np.concatenate([[True], seq[1:] != seq[:-1]])]
        kept = seq[seq != blank]
        out_rows.append(kept)
        out_lens.append(len(kept))
    data = np.concatenate(out_rows).astype(np.int64).reshape(-1, 1) \
        if out_rows else np.zeros((0, 1), np.int64)
    return {"Output": LoDTensor(
        torch.from_numpy(data).to(data_of(xv).device),
        [lod_from_seq_lens(out_lens)])}


# -- build-time shape inference (LoD-dependent) -------------------------------

@register_infer_shape("warpctc")
def _infer_warpctc(op, block):
    logits = input_var(op, block, "Logits")
    if logits is None or logits.shape is None:
        return
    # one loss row a sequence (their count is in the LoD)
    set_output_shape(op, block, "Loss", (-1, 1), logits.dtype)
    set_output_shape(op, block, "WarpCTCGrad", logits.shape, logits.dtype)
