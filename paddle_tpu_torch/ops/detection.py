"""Detection ops: prior_box, box_coder, iou_similarity, target_assign
and roi_pool on the device; bipartite_match, mine_hard_examples,
multiclass_nms and detection_map on the host (counterparts of
paddle_tpu/ops/detection.py).

Reference: PaddlePaddle's operators/{prior_box_op.h, box_coder_op.h,
iou_similarity_op.h, bipartite_match_op.cc, target_assign_op.h,
mine_hard_examples_op.cc, multiclass_nms_op.cc, roi_pool_op.h,
detection_map_op.h}.

The dense geometry runs on the device.  prior_box's boxes depend only on
shapes and attributes: they are built once a shape with numpy, in the
JAX package's float32 arithmetic, into `ctx.tables`.  roi_pool takes
each bin's first maximum in row-major (h, w) order in two passes (the
first maximum over w in each bin row, then the first over h), a chunk
of ROIs at a time, and routes the gradient to that element with a
fixed-order sum (ops/embedding.py `sorted_segment_sum`: overlapping bins
and ROIs hit one element).

The sequential algorithms with outputs whose size the data decides
(greedy matching, hard-example mining, NMS, mAP) are host ops, as in the
reference and the JAX package: they read their inputs back, keep its
selection order and tie rules, and are vectorised with numpy where the
JAX package loops over every prior in Python.

One difference from the JAX package, intended: box_coder's encoding
carries TargetBox's LoD, so target_assign reads each image's own
ground-truth rows in ssd_loss.  The JAX package's encoding has no LoD,
and target_assign then reads image n's targets at row n + match, which
is another image's box wherever an earlier image holds more than one.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core.execution import data_of, one
from ..core.lod import LoDTensor, lod_from_seq_lens
from ..core.registry import register_op
from .activation import abs_
from .embedding import sorted_segment_sum
from .sequence import _lod_key, _table


def _host(v):
    return data_of(v).detach().cpu().numpy()


def _rows_of(v, n_rows):
    """A value's last LoD level, or one sequence of all its rows."""
    if isinstance(v, LoDTensor) and v.lod:
        return v.lod[-1]
    return (0, n_rows)


# a comparison of a numpy float32 scalar with a Python float, as the JAX
# package's host loops make it: in float64 under numpy 1's value-based
# casting, in float32 under numpy 2's rules
_SCALAR = (np.float32(0) + 0.0).dtype.type


def _gt(a, thr):
    """`a > thr` elementwise for a float32 array `a`, as the scalar
    comparison `np.float32 > float` decides it."""
    return a.astype(_SCALAR) > _SCALAR(thr)


# ---------------------------------------------------------------------------
# prior_box
# ---------------------------------------------------------------------------


def _expand_aspect_ratios(aspect_ratios, flip):
    """prior_box_op.h ExpandAspectRatios: 1.0 first, duplicates dropped,
    1/ar added when flipping."""
    out = [1.0]
    for ar in aspect_ratios:
        if any(abs(ar - o) < 1e-6 for o in out):
            continue
        out.append(float(ar))
        if flip:
            out.append(1.0 / float(ar))
    return out


def _prior_boxes(fh, fw, ih, iw, attrs):
    """The JAX package's boxes [fh, fw, num_priors, 4] and variances,
    float32, in its arithmetic (each box's corners in Python floats,
    then stored)."""
    min_sizes = [float(s) for s in attrs["min_sizes"]]
    max_sizes = [float(s) for s in attrs["max_sizes"]]
    ars = _expand_aspect_ratios(attrs["aspect_ratios"], attrs["flip"])
    offset = float(attrs["offset"])
    step_w = float(attrs["step_w"]) or iw / fw
    step_h = float(attrs["step_h"]) or ih / fh
    sizes = []
    for s, ms in enumerate(min_sizes):
        sizes.append((ms, ms))
        if max_sizes:
            sz = math.sqrt(ms * max_sizes[s])
            sizes.append((sz, sz))
        for ar in ars:
            if abs(ar - 1.0) < 1e-6:
                continue
            sizes.append((ms * math.sqrt(ar), ms / math.sqrt(ar)))
    boxes = np.zeros((fh, fw, len(sizes), 4), np.float32)
    for h in range(fh):
        cy = (h + offset) * step_h
        for w in range(fw):
            cx = (w + offset) * step_w
            boxes[h, w] = [[(cx - bw / 2) / iw, (cy - bh / 2) / ih,
                            (cx + bw / 2) / iw, (cy + bh / 2) / ih]
                           for bw, bh in sizes]
    if attrs["clip"]:
        boxes = np.clip(boxes, 0.0, 1.0)
    var = np.tile(np.asarray([float(v) for v in attrs["variances"]],
                             np.float32), (fh, fw, len(sizes), 1))
    return boxes, var


@register_op("prior_box", inputs=("Input", "Image"),
             outputs=("Boxes", "Variances"),
             attrs={"min_sizes": [], "max_sizes": [], "aspect_ratios": [],
                    "variances": [0.1, 0.1, 0.2, 0.2], "flip": True,
                    "clip": True, "step_w": 0.0, "step_h": 0.0,
                    "offset": 0.5},
             not_differentiable=True)
def prior_box(ctx, ins, attrs):
    """SSD prior boxes [H, W, num_priors, 4] and their variances
    (prior_box_op.h), from the feature map's and the image's shapes."""
    x, img = one(ins, "Input"), one(ins, "Image")
    fh, fw = int(x.shape[2]), int(x.shape[3])
    ih, iw = int(img.shape[2]), int(img.shape[3])
    key = ("prior_box", fh, fw, ih, iw,
           tuple(sorted((k, str(v)) for k, v in attrs.items())))
    if x.device.type == "meta":
        boxes, var = _prior_boxes(fh, fw, ih, iw, attrs)
        return {"Boxes": torch.empty(boxes.shape, device="meta"),
                "Variances": torch.empty(var.shape, device="meta")}
    boxes, var = _table(ctx, key, x.device,
                        lambda: _prior_boxes(fh, fw, ih, iw, attrs))
    # copies: the table outlives this run's values
    return {"Boxes": boxes.clone(), "Variances": var.clone()}


# ---------------------------------------------------------------------------
# box_coder / iou_similarity
# ---------------------------------------------------------------------------


def _center_size(box):
    """[..., 4] corners -> (cx, cy, w, h)."""
    w = box[..., 2] - box[..., 0]
    h = box[..., 3] - box[..., 1]
    cx = (box[..., 2] + box[..., 0]) / 2
    cy = (box[..., 3] + box[..., 1]) / 2
    return cx, cy, w, h


@register_op("box_coder", inputs=("PriorBox", "PriorBoxVar", "TargetBox"),
             outputs=("OutputBox",),
             attrs={"code_type": "encode_center_size"},
             diff_inputs=("TargetBox",), lod=True)
def box_coder(ctx, ins, attrs):
    """Boxes encoded against the priors, or deltas decoded
    (box_coder_op.h).  Encode: TargetBox [row, 4] -> [row, col, 4],
    with TargetBox's LoD; decode: deltas [row, col, 4] -> corners
    [row, col, 4], no LoD."""
    prior = data_of(one(ins, "PriorBox"))           # [col, 4]
    pvar = data_of(one(ins, "PriorBoxVar"))         # [col, 4]
    tb_v = one(ins, "TargetBox")
    target = data_of(tb_v)
    pcx, pcy, pw, ph = _center_size(prior)
    if attrs["code_type"] == "encode_center_size":
        tcx, tcy, tw, th = _center_size(target)
        ox = (tcx[:, None] - pcx[None, :]) / pw[None, :] / pvar[None, :, 0]
        oy = (tcy[:, None] - pcy[None, :]) / ph[None, :] / pvar[None, :, 1]
        ow = torch.log(abs_(tw[:, None] / pw[None, :])) / pvar[None, :, 2]
        oh = torch.log(abs_(th[:, None] / ph[None, :])) / pvar[None, :, 3]
        out = torch.stack([ox, oy, ow, oh], dim=-1)
        if isinstance(tb_v, LoDTensor) and tb_v.lod:
            out = LoDTensor(out, tb_v.lod)
        return {"OutputBox": out}
    dcx = pvar[None, :, 0] * target[..., 0] * pw[None, :] + pcx[None, :]
    dcy = pvar[None, :, 1] * target[..., 1] * ph[None, :] + pcy[None, :]
    dw = torch.exp(pvar[None, :, 2] * target[..., 2]) * pw[None, :]
    dh = torch.exp(pvar[None, :, 3] * target[..., 3]) * ph[None, :]
    return {"OutputBox": torch.stack([dcx - dw / 2, dcy - dh / 2,
                                      dcx + dw / 2, dcy + dh / 2], dim=-1)}


@register_op("iou_similarity", inputs=("X", "Y"), outputs=("Out",),
             diff_inputs=(), lod=True)
def iou_similarity(ctx, ins, attrs):
    """The IoU matrix [N, M] of X's and Y's boxes (iou_similarity_op.h),
    0 where the union is not positive; it keeps X's LoD."""
    xv = one(ins, "X")
    x, y = data_of(xv), data_of(one(ins, "Y"))
    ix1 = torch.maximum(x[:, None, 0], y[None, :, 0])
    iy1 = torch.maximum(x[:, None, 1], y[None, :, 1])
    ix2 = torch.minimum(x[:, None, 2], y[None, :, 2])
    iy2 = torch.minimum(x[:, None, 3], y[None, :, 3])
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    inter = torch.maximum(ix2 - ix1, zero) * torch.maximum(iy2 - iy1, zero)
    ax = (x[:, 2] - x[:, 0]) * (x[:, 3] - x[:, 1])
    ay = (y[:, 2] - y[:, 0]) * (y[:, 3] - y[:, 1])
    union = ax[:, None] + ay[None, :] - inter
    out = torch.where(union > 0,
                      inter / torch.clamp(union, min=1e-10), zero)
    if isinstance(xv, LoDTensor) and xv.lod:
        return {"Out": LoDTensor(out, xv.lod)}
    return {"Out": out}


# ---------------------------------------------------------------------------
# bipartite_match (host: bipartite_match_op.cc's greedy matching)
# ---------------------------------------------------------------------------


def bipartite_match_np(dist, eps=1e-6):
    """The greedy bipartite match of one image's [rows, cols] distances
    -> (the matched row of each column or -1, its distance).  Each round
    takes the strictly largest distance of at least `eps` among the
    unmatched rows and columns, the first in (column, row) order on a
    tie, as the JAX package's loops scan."""
    rows, cols = dist.shape
    idx = -np.ones(cols, np.int32)
    mdist = np.zeros(cols, np.float32)
    if rows == 0 or cols == 0:
        return idx, mdist
    cand = np.where(dist.T >= eps, dist.T, -np.inf).astype(np.float32)
    for _ in range(rows):
        flat = int(np.argmax(cand))
        j, m = divmod(flat, rows)
        if cand[j, m] == -np.inf:
            break
        idx[j], mdist[j] = m, cand[j, m]
        cand[j, :] = -np.inf
        cand[:, m] = -np.inf
    return idx, mdist


@register_op("bipartite_match", inputs=("DistMat",),
             outputs=("ColToRowMatchIndices", "ColToRowMatchDist"),
             not_differentiable=True, host=True, lod=True)
def bipartite_match(ctx, ins, attrs):
    """Each LoD sequence of DistMat's rows matched to its columns ->
    int32 [N, cols] indices (-1 unmatched) and float32 distances."""
    dv = one(ins, "DistMat")
    dist = _host(dv)
    offs = _rows_of(dv, dist.shape[0])
    n = len(offs) - 1
    idx = np.empty((n, dist.shape[1]), np.int32)
    mdist = np.empty((n, dist.shape[1]), np.float32)
    for b in range(n):
        idx[b], mdist[b] = bipartite_match_np(dist[offs[b]:offs[b + 1]])
    dev = data_of(dv).device
    return {"ColToRowMatchIndices": torch.from_numpy(idx).to(dev),
            "ColToRowMatchDist": torch.from_numpy(mdist).to(dev)}


# ---------------------------------------------------------------------------
# target_assign (device gather, target_assign_op.h)
# ---------------------------------------------------------------------------


@register_op("target_assign",
             inputs=("X", "MatchIndices", "NegIndices"),
             outputs=("Out", "OutWeight"),
             attrs={"mismatch_value": 0}, not_differentiable=True,
             lod=True)
def target_assign(ctx, ins, attrs):
    """Out[n, m] = X[lod[n] + match[n, m], m % P] where matched, else
    mismatch_value, with weight 1 (0 unmatched); each image's NegIndices
    rows get mismatch_value and weight 1.  A gather and two value sets
    (the negative indices are unique within an image): no atomics.
    Out [N, M, K]; OutWeight [N, M, 1] float32."""
    xv = one(ins, "X")
    x = data_of(xv)
    if x.dim() == 2:
        x = x[:, None, :]
    match = data_of(one(ins, "MatchIndices")).to(torch.int64)   # [N, M]
    n, m = match.shape
    p, k = x.shape[1], x.shape[2]
    lod = xv.lod[-1] if isinstance(xv, LoDTensor) and xv.lod \
        else tuple(range(n + 1))
    dev = x.device
    off, cols = _table(ctx, ("target_assign", _lod_key(lod), n, m, p), dev,
                       lambda: (np.asarray(lod[:-1], np.int64)[:, None] * p,
                                np.arange(m, dtype=np.int64)[None, :] % p))
    flat = off + torch.clamp(match, min=0) * p + cols            # [N, M]
    gathered = x.reshape(-1, k).index_select(0, flat.reshape(-1))
    matched = (match > -1).reshape(-1, 1)
    mismatch = torch.full((), float(attrs["mismatch_value"]),
                          device=dev).to(x.dtype)
    out = torch.where(matched, gathered, mismatch)               # [N*M, K]
    wt = matched.to(torch.float32)
    neg = one(ins, "NegIndices")
    if neg is not None:
        neg_rows = data_of(neg).reshape(-1).to(torch.int64)
        neg_lod = _rows_of(neg, neg_rows.shape[0])
        img, = _table(ctx, ("target_assign_neg", _lod_key(neg_lod), m), dev,
                      lambda: (np.repeat(np.arange(len(neg_lod) - 1) * m,
                                         np.diff(neg_lod)).astype(np.int64),))
        at = img + neg_rows
        # Python fill values: a tensor value is read back to the host
        wt = wt.index_fill(0, at, 1.0)
        out = out.index_fill(0, at, attrs["mismatch_value"])
    return {"Out": out.reshape(n, m, k), "OutWeight": wt.reshape(n, m, 1)}


# ---------------------------------------------------------------------------
# mine_hard_examples (host, mine_hard_examples_op.cc)
# ---------------------------------------------------------------------------


@register_op("mine_hard_examples",
             inputs=("ClsLoss", "LocLoss", "MatchIndices", "MatchDist"),
             outputs=("NegIndices", "UpdatedMatchIndices"),
             attrs={"neg_pos_ratio": 3.0, "neg_dist_threshold": 0.5,
                    "mining_type": "max_negative", "sample_size": 0},
             not_differentiable=True, host=True)
def mine_hard_examples(ctx, ins, attrs):
    """Each image's hardest negatives, in increasing prior order: with
    `max_negative` the unmatched priors whose match distance is under
    the threshold, num_pos * neg_pos_ratio of them; with `hard_example`
    any prior, `sample_size` of them, by class plus location loss, and
    the matched priors not chosen are unmatched.  The candidates are
    ranked by a stable sort on -loss -> NegIndices int32 [n, 1] with a
    LoD an image, and the match indices updated."""
    cls_loss = _host(one(ins, "ClsLoss"))
    loc = one(ins, "LocLoss")
    loc_loss = _host(loc) if loc is not None else None
    mv = one(ins, "MatchIndices")
    match = _host(mv).copy()
    mdist = _host(one(ins, "MatchDist"))
    ratio = float(attrs["neg_pos_ratio"])
    thresh = float(attrs["neg_dist_threshold"])
    mtype = attrs["mining_type"]
    sample_size = int(attrs.get("sample_size") or 0)
    neg_rows, neg_lens = [], []
    for n in range(match.shape[0]):
        loss = cls_loss[n]
        if mtype == "max_negative":
            cands = np.flatnonzero((match[n] == -1) & (
                mdist[n].astype(_SCALAR) < _SCALAR(thresh)))
            num_pos = int((match[n] != -1).sum())
            neg_sel = min(int(num_pos * ratio), len(cands))
        else:
            cands = np.arange(match.shape[1])
            if loc_loss is not None:
                loss = loss + loc_loss[n]
            neg_sel = min(sample_size, len(cands))
        order = np.argsort(-loss[cands], kind="stable")
        chosen = cands[order[:neg_sel]]
        if mtype == "hard_example":
            drop = np.ones(match.shape[1], bool)
            drop[chosen] = False
            match[n][(match[n] > -1) & drop] = -1
        neg_rows.append(np.sort(chosen))
        neg_lens.append(len(chosen))
    neg = np.concatenate(neg_rows).astype(np.int32).reshape(-1, 1) \
        if neg_rows else np.zeros((0, 1), np.int32)
    dev = data_of(mv).device
    return {"NegIndices": LoDTensor(torch.from_numpy(neg).to(dev),
                                    [lod_from_seq_lens(neg_lens)]),
            "UpdatedMatchIndices": torch.from_numpy(match).to(dev)}


# ---------------------------------------------------------------------------
# multiclass_nms (host, multiclass_nms_op.cc)
# ---------------------------------------------------------------------------


def iou_matrix_np(a, b):
    """[len(a), len(b)] IoUs of float32 corner boxes in the JAX package's
    `_iou_np` arithmetic (float32, its order of operations; 0 where the
    union is not positive)."""
    ix1 = np.maximum(a[:, None, 0], b[None, :, 0])
    iy1 = np.maximum(a[:, None, 1], b[None, :, 1])
    ix2 = np.minimum(a[:, None, 2], b[None, :, 2])
    iy2 = np.minimum(a[:, None, 3], b[None, :, 3])
    zero = np.float32(0.0)
    inter = np.maximum(ix2 - ix1, zero) * np.maximum(iy2 - iy1, zero)
    ua = (((a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1]))[:, None]
          + ((b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1]))[None, :] - inter)
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(ua > 0, inter / ua, zero).astype(np.float32)


def _iou_t(b):
    """[..., K, K] float32 IoUs of corner boxes b [..., K, 4] (a tensor
    on any device) in `iou_matrix_np`'s arithmetic: the same IEEE
    operations in its order and dtype, one at a time, so equal element
    for element."""
    a, c = b[..., :, None, :], b[..., None, :, :]
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    inter = (torch.maximum(torch.minimum(a[..., 2], c[..., 2])
                           - torch.maximum(a[..., 0], c[..., 0]), zero)
             * torch.maximum(torch.minimum(a[..., 3], c[..., 3])
                             - torch.maximum(a[..., 1], c[..., 1]), zero))
    area = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    ua = area[..., :, None] + area[..., None, :] - inter
    return torch.where(ua > 0, inter / ua, zero).to(torch.float32)


def _gt_t(a, thr):
    """`_gt` for a float32 tensor."""
    dt = torch.float64 if _SCALAR is np.float64 else torch.float32
    return a.to(dt) > torch.tensor(thr, dtype=dt, device=a.device)


def _suppressed(over):
    """NMSFast's greedy pass with one threshold (eta >= 1), every row of
    candidates at once: [..., K, K] bool (IoU over the threshold, the
    candidates in score order) -> [..., K] bool suppressed.  Position i
    is decided once every position before it is; if it is kept, it
    suppresses the later positions it overlaps."""
    sup = torch.zeros(over.shape[:-1], dtype=torch.bool, device=over.device)
    for i in range(over.shape[-1] - 1):
        sup[..., i + 1:] |= over[..., i, i + 1:] & ~sup[..., i:i + 1]
    return sup


def _adaptive_keep(iou, nms_threshold, eta):
    """NMSFast's greedy pass with an adaptive threshold (eta < 1) over
    one class's [K, K] candidate IoUs -> the positions kept: a box is
    kept unless its IoU with a kept one exceeds the threshold, which
    shrinks by `eta` after each keep while it is above 0.5."""
    kept, threshold = [], nms_threshold
    for i in range(len(iou)):
        if not _gt(iou[i, kept], threshold).any():
            kept.append(i)
            if threshold > 0.5:
                threshold *= eta
    return kept


def _nms_batch(boxes, scores, attrs):
    """multiclass_nms_op.cc NMSFast for every image and class: boxes
    [N, M, 4] and scores [N, C, M] (tensors on one device) -> kept
    [N][C] prior indices in score order.  A class's candidates are its
    scores above the threshold in a stable sort by score, the first
    `nms_top_k`; a candidate is dropped where its IoU (`_iou_t`) with a
    kept, higher-scored one exceeds the threshold.  The sort, the IoUs
    and the greedy pass with one threshold run on the scores' device,
    every class at once and the IoUs an image at a time; an adaptive
    threshold's passes run on the host."""
    n, c, m = scores.shape
    count = _gt_t(scores, attrs["score_threshold"]).sum(-1)
    if int(attrs["nms_top_k"]) > -1:
        count = count.clamp(max=int(attrs["nms_top_k"]))
    counts = count.cpu().numpy()
    k = int(counts.max()) if counts.size else 0
    if not k:
        return [[np.zeros(0, np.int64)] * c for _ in range(n)]
    order = torch.sort(-scores, dim=-1, stable=True).indices[..., :k]
    idx = order.cpu().numpy()
    ious = (_iou_t(boxes[b][order[b]]) for b in range(n))   # [C, k, k]
    thr, eta = attrs["nms_threshold"], float(attrs["nms_eta"])
    if eta >= 1:
        keep = ~_suppressed(torch.stack([_gt_t(v, thr) for v in ious]))
        keep = keep.cpu().numpy()
        return [[idx[b, j, :counts[b, j]][keep[b, j, :counts[b, j]]]
                 for j in range(c)] for b in range(n)]
    out = []
    for b, iou in enumerate(ious):
        iou = iou.cpu().numpy()
        out.append([idx[b, j, :counts[b, j]][_adaptive_keep(
            iou[j, :counts[b, j], :counts[b, j]], thr, eta)]
            for j in range(c)])
    return out


@register_op("multiclass_nms", inputs=("BBoxes", "Scores"),
             outputs=("Out",),
             attrs={"background_label": 0, "score_threshold": 0.01,
                    "nms_top_k": 400, "nms_threshold": 0.3, "nms_eta": 1.0,
                    "keep_top_k": 200},
             not_differentiable=True, host=True)
def multiclass_nms(ctx, ins, attrs):
    """BBoxes [N, M, 4] (shared by the classes), Scores [N, C, M] ->
    [kept, 6] float32 rows (label, score, x1, y1, x2, y2) with a LoD an
    image: each class but the background's NMS (`_nms_batch`), in class
    order, then, past `keep_top_k` detections, the `keep_top_k` best by
    a stable sort on score."""
    boxes_t, scores_t = data_of(one(ins, "BBoxes")), data_of(one(ins,
                                                                 "Scores"))
    if boxes_t.dim() == 2:
        boxes_t, scores_t = boxes_t[None], scores_t[None]
    bg = int(attrs["background_label"])
    keep_top_k = int(attrs["keep_top_k"])
    classes = [c for c in range(scores_t.shape[1]) if c != bg]
    kept = _nms_batch(boxes_t, scores_t[:, classes], attrs)
    bboxes = boxes_t.detach().cpu().numpy()
    scores = scores_t.detach().cpu().numpy()
    rows, lens = [], []
    for n, per_class in enumerate(kept):
        dets = []
        for c, keep in zip(classes, per_class):
            det = np.empty((len(keep), 6), np.float32)
            det[:, 0] = c
            det[:, 1] = scores[n, c, keep]
            det[:, 2:] = bboxes[n, keep]
            dets.append(det)
        dets = np.concatenate(dets) if dets else np.zeros((0, 6), np.float32)
        if keep_top_k > -1 and len(dets) > keep_top_k:
            dets = dets[np.argsort(-dets[:, 1], kind="stable")[:keep_top_k]]
        rows.append(dets)
        lens.append(len(dets))
    data = np.concatenate(rows) if rows else np.zeros((0, 6), np.float32)
    return {"Out": LoDTensor(torch.from_numpy(data).to(boxes_t.device),
                             [lod_from_seq_lens(lens)])}


# ---------------------------------------------------------------------------
# roi_pool (device: a separable first-maximum, roi_pool_op.h)
# ---------------------------------------------------------------------------

# elements of roi_pool's [ROIs, C, H, pooled_w, W] pass at a time
_ROI_CHUNK = 1 << 26


class _PickElements(torch.autograd.Function):
    """x.reshape(-1)[at] with a fixed-order backward: the cotangents of
    the elements several picks read summed in increasing position
    (`sorted_segment_sum`); `keep` zeroes the picks of empty bins."""

    @staticmethod
    def forward(ctx, x, at, keep):
        ctx.save_for_backward(at, keep)
        ctx.shape = x.shape
        return torch.where(keep, x.reshape(-1)[at], torch.zeros(
            (), dtype=x.dtype, device=x.device))

    @staticmethod
    def backward(ctx, g):
        at, keep = ctx.saved_tensors
        g = torch.where(keep, g, torch.zeros((), dtype=g.dtype,
                                             device=g.device))
        d = sorted_segment_sum(at.reshape(-1), g.reshape(-1, 1),
                               math.prod(ctx.shape))
        return d.reshape(ctx.shape), None, None


def _bin_masks(start, end, n, dtype):
    """[R, bins, n]: whether position p of each bin lies in [start,
    end)."""
    pos = torch.arange(n, dtype=dtype, device=start.device)
    return (pos >= start[:, :, None]) & (pos < end[:, :, None])


@register_op("roi_pool", inputs=("X", "ROIs"), outputs=("Out", "Argmax"),
             attrs={"spatial_scale": 1.0, "pooled_height": 1,
                    "pooled_width": 1},
             diff_inputs=("X",), diff_outputs=("Out",), lod=True)
def roi_pool(ctx, ins, attrs):
    """Each ROI max-pooled into a pooled_height x pooled_width grid
    (roi_pool_op.h): the ROI's corners scaled and rounded, bin i of a
    side spanning [floor(i * bin) + start, ceil((i + 1) * bin) + start)
    of the feature map.  Out [R, C, ph, pw] is each bin's first maximum
    in row-major (h, w) order, Argmax its h * W + w; an empty bin gives
    0 and Argmax 0.  The gradient goes to the argmax element alone."""
    x = data_of(one(ins, "X"))                     # [N, C, H, W]
    roi_v = one(ins, "ROIs")
    rois = data_of(roi_v)                          # [R, 4]
    scale = float(attrs["spatial_scale"])
    ph, pw = int(attrs["pooled_height"]), int(attrs["pooled_width"])
    n_img, c, h, w = x.shape
    r_n = rois.shape[0]
    dev, dt = x.device, x.dtype
    lod = _rows_of(roi_v, r_n)
    batch_of, = _table(ctx, ("roi_batch", _lod_key(lod)), dev, lambda: (
        np.repeat(np.arange(len(lod) - 1), np.diff(lod)).astype(np.int64),))
    if dev.type == "meta":
        return {"Out": torch.empty((r_n, c, ph, pw), dtype=dt, device=dev),
                "Argmax": torch.empty((r_n, c, ph, pw), dtype=torch.int64,
                                      device=dev)}

    r = torch.round(rois.to(dt) * scale)
    x1, y1, x2, y2 = r[:, 0], r[:, 1], r[:, 2], r[:, 3]
    one_ = torch.ones((), dtype=dt, device=dev)
    # divided by device scalars: a CUDA tensor divided by a Python number
    # is multiplied by its reciprocal, which can move a bin's edge
    bin_h = torch.maximum(y2 - y1 + 1, one_) / torch.full((), ph, dtype=dt,
                                                          device=dev)
    bin_w = torch.maximum(x2 - x1 + 1, one_) / torch.full((), pw, dtype=dt,
                                                          device=dev)
    i_idx = torch.arange(ph, dtype=dt, device=dev)
    j_idx = torch.arange(pw, dtype=dt, device=dev)
    mask_h = _bin_masks(
        torch.floor(i_idx[None, :] * bin_h[:, None]) + y1[:, None],
        torch.ceil((i_idx[None, :] + 1) * bin_h[:, None]) + y1[:, None],
        h, dt)                                      # [R, ph, H]
    mask_w = _bin_masks(
        torch.floor(j_idx[None, :] * bin_w[:, None]) + x1[:, None],
        torch.ceil((j_idx[None, :] + 1) * bin_w[:, None]) + x1[:, None],
        w, dt)                                      # [R, pw, W]

    xd = x.detach()
    ninf = torch.full((), -math.inf, dtype=dt, device=dev)
    step = max(1, _ROI_CHUNK // max(1, c * h * pw * w))
    args, keeps = [], []
    for r0 in range(0, r_n, step):
        sl = slice(r0, min(r_n, r0 + step))
        f = xd.index_select(0, batch_of[sl])        # [r, C, H, W]
        # the first maximum over w of each bin column, in every row
        v = torch.where(mask_w[sl, None, None], f[:, :, :, None, :], ninf)
        row_max, row_arg = torch.max(v, dim=-1)    # [r, C, H, pw]
        del v
        # then the first maximum over h of each bin row
        v = torch.where(mask_h[sl, None, :, :, None],
                        row_max[:, :, None], ninf)  # [r, C, ph, H, pw]
        best, h_arg = torch.max(v, dim=3)           # [r, C, ph, pw]
        w_arg = torch.gather(row_arg, 2, h_arg)
        keep = best > -math.inf
        args.append(torch.where(keep, h_arg * w + w_arg,
                                torch.zeros_like(h_arg)))
        keeps.append(keep)
    arg = torch.cat(args) if args else torch.zeros(
        (0, c, ph, pw), dtype=torch.int64, device=dev)
    keep = torch.cat(keeps) if keeps else torch.zeros(
        (0, c, ph, pw), dtype=torch.bool, device=dev)
    plane = (batch_of[:, None] * c + torch.arange(c, device=dev)[None, :])
    at = plane[:, :, None, None] * (h * w) + arg
    out = _PickElements.apply(x, at, keep)
    return {"Out": out, "Argmax": arg}


# ---------------------------------------------------------------------------
# detection_map (host metric, detection_map_op.h)
# ---------------------------------------------------------------------------


@register_op("detection_map", inputs=("DetectRes", "Label"),
             outputs=("MAP",),
             attrs={"overlap_threshold": 0.5, "evaluate_difficult": True,
                    "ap_type": "integral"},
             not_differentiable=True, host=True, lod=True)
def detection_map(ctx, ins, attrs):
    """Mean average precision over a batch.  DetectRes: LoD [Nd, 6]
    (label, score, box); Label: LoD [Ng, 6] (label, box, difficult) or
    [Ng, 5].  Each image's detections take its unused ground truth of
    their class greedily by descending score; each class's precision-
    recall curve ranks its detections of every image by score;
    `integral` or `11point` AP, averaged over the classes with ground
    truth -> float32 [1]."""
    det_v, gt_v = one(ins, "DetectRes"), one(ins, "Label")
    det, gt = _host(det_v), _host(gt_v)
    d_lod, g_lod = det_v.lod[-1], gt_v.lod[-1]
    thresh = float(attrs["overlap_threshold"])
    cls_entries, gt_count = {}, {}
    for b in range(len(d_lod) - 1):
        dets = det[d_lod[b]:d_lod[b + 1]]
        gts = gt[g_lod[b]:g_lod[b + 1]]
        g_cls = gts[:, 0].astype(np.int64)
        used = np.zeros(len(gts), bool)
        for c in set(int(g) for g in g_cls):
            gt_count[c] = gt_count.get(c, 0) + int((g_cls == c).sum())
        if not len(dets):
            continue
        dets = dets[np.argsort(-dets[:, 1], kind="stable")]
        ious = iou_matrix_np(dets[:, 2:6], gts[:, 1:5])   # [Nd, Ng]
        for d, iou in zip(dets, ious):
            c = int(d[0])
            cand = np.where((g_cls == c) & ~used, iou, -1.0)
            best_j = int(np.argmax(cand)) if len(cand) else -1
            tp = best_j >= 0 and cand[best_j] > 0 and \
                bool(_gt(iou[best_j:best_j + 1], thresh)[0])
            if tp:
                used[best_j] = True
            cls_entries.setdefault(c, []).append((float(d[1]),
                                                  1 if tp else 0))
    aps = []
    for c, count in gt_count.items():
        if count == 0:
            continue
        entries = sorted(cls_entries.get(c, []), key=lambda e: -e[0])
        if not entries:
            aps.append(0.0)
            continue
        tps = np.asarray([tp for _, tp in entries], np.float64)
        cum_tp = np.cumsum(tps)
        cum_fp = np.cumsum(1 - tps)
        recall = cum_tp / count
        precision = cum_tp / np.maximum(cum_tp + cum_fp, 1e-10)
        if attrs["ap_type"] == "11point":
            ap = 0.0
            for t in np.linspace(0, 1, 11):
                p = precision[recall >= t].max() if (recall >= t).any() \
                    else 0.0
                ap += p / 11
        else:   # integral: the sequential sum, in the JAX package's order
            ap = np.cumsum(precision * np.diff(recall, prepend=0.0))[-1]
        aps.append(float(ap))
    m_ap = float(np.mean(aps)) if aps else 0.0
    return {"MAP": torch.tensor([m_ap], dtype=torch.float32,
                                device=data_of(det_v).device)}
