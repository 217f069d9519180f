"""Metric ops: accuracy, auc, precision_recall and the host ops
edit_distance and positive_negative_pair (counterpart of
paddle_tpu/ops/metrics.py)."""
from __future__ import annotations

import numpy as np
import torch

from ..core.execution import data_of, many, one
from ..core.lod import LoDTensor
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


@register_op("auc", inputs=("Out", "Indices", "Label"), outputs=("AUC",),
             attrs={"curve": "ROC", "num_thresholds": 200},
             not_differentiable=True)
def auc(ctx, ins, attrs):
    """Single-batch ROC AUC by a sweep over num_thresholds thresholds in
    [0, 1], the trapezoid rule over decreasing FPR (reference
    auc_op.cc); the positive score is the last column."""
    probs = one(ins, "Out")
    if probs.dim() == 2:
        pos = probs[:, -1] if probs.shape[1] > 1 else probs[:, 0]
    else:
        pos = probs
    is_pos = one(ins, "Label").reshape(-1) > 0
    thr = torch.linspace(0.0, 1.0, int(attrs["num_thresholds"]),
                         dtype=torch.float32, device=pos.device)
    pred = pos[None, :] > thr[:, None]                 # [T, N]
    tp = torch.sum(pred & is_pos[None, :], dim=1).float()
    fp = torch.sum(pred & ~is_pos[None, :], dim=1).float()
    p = torch.clamp(torch.sum(is_pos).float(), min=1.0)
    n = torch.clamp(torch.sum(~is_pos).float(), min=1.0)
    tpr, fpr = tp / p, fp / n
    area = torch.sum((fpr[:-1] - fpr[1:]) * (tpr[:-1] + tpr[1:]) / 2.0)
    return {"AUC": area.reshape(1)}


def _pr_metrics(s):
    """[C, 4] (TP, FP, TN, FN) -> macro P, R, F1 then micro P, R, F1."""
    tp, fp, fn = s[:, 0], s[:, 1], s[:, 3]
    zero = torch.zeros((), dtype=s.dtype, device=s.device)

    def ratio(a, b):
        return torch.where(b > 0, a / torch.clamp(b, min=1e-9), zero)

    prec, rec = ratio(tp, tp + fp), ratio(tp, tp + fn)
    f1 = ratio(2 * prec * rec, prec + rec)
    micro_p = torch.sum(tp) / torch.clamp(torch.sum(tp + fp), min=1e-9)
    micro_r = torch.sum(tp) / torch.clamp(torch.sum(tp + fn), min=1e-9)
    micro_f = ratio(2 * micro_p * micro_r, micro_p + micro_r)
    return torch.stack([prec.mean(), rec.mean(), f1.mean(),
                        micro_p, micro_r, micro_f])


@register_op("precision_recall",
             inputs=("MaxProbs", "Indices", "Labels", "Weights",
                     "StatesInfo"),
             outputs=("BatchMetrics", "AccumMetrics", "AccumStatesInfo"),
             attrs={"class_number": 2},
             not_differentiable=True)
def precision_recall(ctx, ins, attrs):
    """Per-class weighted TP/FP/TN/FN of this batch (TN: the weight of
    the rows that neither predicted nor carried the class), plus the
    StatesInfo carried in; the metrics of both."""
    c = int(attrs["class_number"])
    idx = one(ins, "Indices").reshape(-1).long()
    labels = one(ins, "Labels").reshape(-1).long()
    wv = one(ins, "Weights")
    w = (torch.ones(idx.shape[0], dtype=torch.float32, device=idx.device)
         if wv is None else wv.reshape(-1).float())
    eye = torch.eye(c, dtype=torch.float32, device=idx.device)
    pred, lbl = eye[idx], eye[labels]
    tp = torch.sum(w[:, None] * pred * lbl, dim=0)
    fp = torch.sum(w[:, None] * pred * (1 - lbl), dim=0)
    fn = torch.sum(w[:, None] * (1 - pred) * lbl, dim=0)
    tn = torch.sum(w) - tp - fp - fn
    states = torch.stack([tp, fp, tn, fn], dim=1)
    prev = one(ins, "StatesInfo")
    acc = states if prev is None else states + prev
    return {"BatchMetrics": _pr_metrics(states),
            "AccumMetrics": _pr_metrics(acc), "AccumStatesInfo": acc}


@register_op("edit_distance", inputs=("Hyps", "Refs"),
             outputs=("Out", "SequenceNum"),
             attrs={"normalized": False}, not_differentiable=True, host=True,
             lod=True)
def edit_distance(ctx, ins, attrs):
    """Levenshtein distance between each hypothesis and reference
    sequence (first LoD level; a value with no LoD is one sequence), on
    the host.  Out [n, 1] float32 (divided by the reference's length
    when `normalized`), SequenceNum [1] int64, on the inputs' device."""
    hyps, refs = one(ins, "Hyps"), one(ins, "Refs")

    def seqs(t):
        d = data_of(t).reshape(-1).tolist()
        if isinstance(t, LoDTensor) and t.lod:
            offs = t.lod[0]
            return [d[offs[i]:offs[i + 1]] for i in range(len(offs) - 1)]
        return [d]

    outs = []
    for h, r in zip(seqs(hyps), seqs(refs)):
        n = len(r)
        dp = np.arange(n + 1, dtype=np.float32)
        for i in range(1, len(h) + 1):
            prev = dp.copy()
            dp[0] = i
            for j in range(1, n + 1):
                cost = 0 if h[i - 1] == r[j - 1] else 1
                dp[j] = min(prev[j] + 1, dp[j - 1] + 1, prev[j - 1] + cost)
        d = dp[n]
        if attrs.get("normalized") and n > 0:
            d /= n
        outs.append(d)
    dev = data_of(hyps).device
    return {"Out": torch.tensor(np.asarray(outs, np.float32).reshape(-1, 1),
                                device=dev),
            "SequenceNum": torch.tensor([len(outs)], dtype=torch.int64,
                                        device=dev)}


@register_op("positive_negative_pair",
             inputs=("Score", "Label", "QueryID", "Weight",
                     "AccumulatePositivePair", "AccumulateNegativePair",
                     "AccumulateNeutralPair"),
             outputs=("PositivePair", "NegativePair", "NeutralPair"),
             attrs={"column": -1},
             not_differentiable=True, host=True)
def positive_negative_pair(ctx, ins, attrs):
    """Per-query correctly / incorrectly ordered pair counts (reference
    positive_negative_pair_op.h), on the host: rows group by QueryID and
    pairs are formed within each query.  A pair with equal scores adds
    its weight to NeutralPair and to NegativePair, as the reference's.
    The accumulators apply only when all three are wired."""
    def host(v):
        return v.detach().cpu().numpy()

    score = host(one(ins, "Score"))
    label = host(one(ins, "Label")).reshape(-1)
    query = host(one(ins, "QueryID")).reshape(-1)
    col = attrs.get("column", -1)
    s = (score[:, col] if score.ndim == 2 else score.reshape(-1)
         ).astype(np.float64)
    wv = many(ins, "Weight")
    w = (host(wv[0]).reshape(-1).astype(np.float64) if wv
         else np.ones_like(s))
    pos = neg = neu = 0.0
    for q in np.unique(query):
        idx = np.flatnonzero(query == q)
        if len(idx) < 2:
            continue
        sq, lq, wq = s[idx], label[idx].astype(np.float64), w[idx]
        iu = np.triu(np.ones((len(idx), len(idx)), bool), k=1)
        ldiff = lq[:, None] - lq[None, :]
        sdiff = sq[:, None] - sq[None, :]
        vw = np.where(iu & (ldiff != 0), (wq[:, None] + wq[None, :]) * 0.5,
                      0.0)
        correct = sdiff * ldiff > 0
        pos += float(np.sum(np.where(correct, vw, 0.0)))
        neg += float(np.sum(np.where(correct, 0.0, vw)))
        neu += float(np.sum(np.where(sdiff == 0, vw, 0.0)))
    accs = [many(ins, k) for k in ("AccumulatePositivePair",
                                   "AccumulateNegativePair",
                                   "AccumulateNeutralPair")]
    if all(accs):
        pos += float(host(accs[0][0]).reshape(-1)[0])
        neg += float(host(accs[1][0]).reshape(-1)[0])
        neu += float(host(accs[2][0]).reshape(-1)[0])
    dev = one(ins, "Score").device
    return {k: torch.tensor([v], dtype=torch.float32, device=dev)
            for k, v in (("PositivePair", pos), ("NegativePair", neg),
                         ("NeutralPair", neu))}
