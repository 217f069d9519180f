"""Detection layers: the SSD toolchain (counterpart of
paddle_tpu/layers/detection.py).

Reference: PaddlePaddle's python/paddle/v2/fluid/layers/detection.py
(detection_output, prior_box, bipartite_match, target_assign, ssd_loss)
and the wrappers of iou_similarity, box_coder, multiclass_nms,
mine_hard_examples, roi_pool and detection_map.  The layers append the
same ops, in the same order, as the JAX package's (its `a * b` and
`a + b` on Variables are the elementwise_mul and elementwise_add
layers).
"""
from __future__ import annotations

from ..layer_helper import LayerHelper
from . import nn, ops, tensor

__all__ = [
    "prior_box",
    "prior_box_single",
    "box_coder",
    "iou_similarity",
    "bipartite_match",
    "target_assign",
    "mine_hard_examples",
    "multiclass_nms",
    "detection_output",
    "ssd_loss",
    "roi_pool",
    "detection_map",
]


def iou_similarity(x, y):
    helper = LayerHelper("iou_similarity")
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op("iou_similarity", {"X": [x.name], "Y": [y.name]},
                     {"Out": [out.name]})
    return out


def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size"):
    helper = LayerHelper("box_coder")
    out = helper.create_tmp_variable(target_box.dtype)
    helper.append_op(
        "box_coder",
        {"PriorBox": [prior_box.name], "PriorBoxVar": [prior_box_var.name],
         "TargetBox": [target_box.name]},
        {"OutputBox": [out.name]}, {"code_type": code_type})
    return out


def bipartite_match(dist_matrix, name=None):
    helper = LayerHelper("bipartite_match", name=name)
    match_indices = helper.create_tmp_variable("int32", stop_gradient=True)
    match_dist = helper.create_tmp_variable(dist_matrix.dtype,
                                            stop_gradient=True)
    helper.append_op(
        "bipartite_match", {"DistMat": [dist_matrix.name]},
        {"ColToRowMatchIndices": [match_indices.name],
         "ColToRowMatchDist": [match_dist.name]})
    return match_indices, match_dist


def target_assign(input, matched_indices, negative_indices=None,
                  mismatch_value=None, name=None):
    helper = LayerHelper("target_assign", name=name)
    out = helper.create_tmp_variable(input.dtype)
    out_weight = helper.create_tmp_variable("float32")
    inputs = {"X": [input.name], "MatchIndices": [matched_indices.name]}
    if negative_indices is not None:
        inputs["NegIndices"] = [negative_indices.name]
    helper.append_op("target_assign", inputs,
                     {"Out": [out.name], "OutWeight": [out_weight.name]},
                     {"mismatch_value": int(mismatch_value or 0)})
    return out, out_weight


def mine_hard_examples(cls_loss, match_indices, match_dist, loc_loss=None,
                       neg_pos_ratio=3.0, neg_dist_threshold=0.5,
                       mining_type="max_negative", sample_size=0):
    helper = LayerHelper("mine_hard_examples")
    neg_indices = helper.create_tmp_variable("int32", stop_gradient=True)
    neg_indices.lod_level = 1
    updated = helper.create_tmp_variable(match_indices.dtype,
                                         stop_gradient=True)
    inputs = {"ClsLoss": [cls_loss.name],
              "MatchIndices": [match_indices.name],
              "MatchDist": [match_dist.name]}
    if loc_loss is not None:
        inputs["LocLoss"] = [loc_loss.name]
    helper.append_op(
        "mine_hard_examples", inputs,
        {"NegIndices": [neg_indices.name],
         "UpdatedMatchIndices": [updated.name]},
        {"neg_pos_ratio": float(neg_pos_ratio),
         "neg_dist_threshold": float(neg_dist_threshold),
         "mining_type": mining_type, "sample_size": int(sample_size)})
    return neg_indices, updated


def multiclass_nms(bboxes, scores, background_label=0, score_threshold=0.01,
                   nms_top_k=400, nms_threshold=0.3, nms_eta=1.0,
                   keep_top_k=200):
    helper = LayerHelper("multiclass_nms")
    out = helper.create_tmp_variable(bboxes.dtype)
    out.lod_level = 1
    helper.append_op(
        "multiclass_nms",
        {"BBoxes": [bboxes.name], "Scores": [scores.name]},
        {"Out": [out.name]},
        {"background_label": int(background_label),
         "score_threshold": float(score_threshold),
         "nms_top_k": int(nms_top_k), "nms_threshold": float(nms_threshold),
         "nms_eta": float(nms_eta), "keep_top_k": int(keep_top_k)})
    return out


def prior_box_single(input, image, min_sizes, max_sizes=None,
                     aspect_ratios=None, variance=(0.1, 0.1, 0.2, 0.2),
                     flip=True, clip=True, steps=(0.0, 0.0), offset=0.5,
                     name=None):
    """One feature map -> (boxes, variances) [H, W, np, 4]
    (prior_box_op.cc)."""
    helper = LayerHelper("prior_box", name=name)
    boxes = helper.create_tmp_variable(input.dtype, stop_gradient=True)
    variances = helper.create_tmp_variable(input.dtype, stop_gradient=True)
    helper.append_op(
        "prior_box",
        {"Input": [input.name], "Image": [image.name]},
        {"Boxes": [boxes.name], "Variances": [variances.name]},
        {"min_sizes": [float(s) for s in min_sizes],
         "max_sizes": [float(s) for s in (max_sizes or [])],
         "aspect_ratios": [float(a) for a in (aspect_ratios or [1.0])],
         "variances": [float(v) for v in variance],
         "flip": bool(flip), "clip": bool(clip),
         "step_w": float(steps[0]), "step_h": float(steps[1]),
         "offset": float(offset)})
    return boxes, variances


def prior_box(inputs, image, min_ratio, max_ratio, aspect_ratios,
              base_size, steps=None, step_w=None, step_h=None, offset=0.5,
              variance=(0.1, 0.1, 0.2, 0.2), flip=True, clip=True,
              min_sizes=None, max_sizes=None, name=None):
    """Multi-feature-map SSD prior boxes, concatenated to [num_priors, 4]
    (reference layers/detection.py:135 prior_box / prior_boxes)."""
    assert isinstance(inputs, (list, tuple)) and inputs
    num_layer = len(inputs)
    if min_sizes is None or max_sizes is None:
        # reference ratio schedule: evenly spaced between min/max ratio
        min_sizes, max_sizes = [], []
        if num_layer > 2:
            step = int((max_ratio - min_ratio) / (num_layer - 2))
            for ratio in range(min_ratio, max_ratio + 1, step):
                min_sizes.append(base_size * ratio / 100.0)
                max_sizes.append(base_size * (ratio + step) / 100.0)
            min_sizes = [base_size * 0.1] + min_sizes
            max_sizes = [base_size * 0.2] + max_sizes
        else:
            min_sizes = [base_size * min_ratio / 100.0] * num_layer
            max_sizes = [base_size * max_ratio / 100.0] * num_layer
    box_results, var_results = [], []
    for i, inp in enumerate(inputs):
        ms = min_sizes[i]
        mx = max_sizes[i]
        ar = aspect_ratios[i] if isinstance(aspect_ratios[i], (list, tuple)) \
            else [aspect_ratios[i]]
        st = steps[i] if steps else (
            (step_w[i] if step_w else 0.0, step_h[i] if step_h else 0.0))
        b, v = prior_box_single(
            inp, image,
            min_sizes=[ms] if not isinstance(ms, (list, tuple)) else ms,
            max_sizes=[mx] if not isinstance(mx, (list, tuple)) else mx,
            aspect_ratios=ar, variance=variance, flip=flip, clip=clip,
            steps=st, offset=offset)
        box_results.append(ops.reshape(b, shape=[-1, 4]))
        var_results.append(ops.reshape(v, shape=[-1, 4]))
    if len(box_results) == 1:
        return box_results[0], var_results[0]
    return (tensor.concat(box_results, axis=0),
            tensor.concat(var_results, axis=0))


def detection_output(loc, scores, prior_box, prior_box_var,
                     background_label=0, nms_threshold=0.3, nms_top_k=400,
                     keep_top_k=200, score_threshold=0.01, nms_eta=1.0):
    """Decode loc deltas against priors + multiclass NMS (reference
    layers/detection.py:44): loc [N, M, 4], scores [N, C, M]."""
    helper = LayerHelper("detection_output")
    # decode per batch item: box_coder expects [row, 4] targets; use the
    # batched decode path [N, M, 4] treated row-wise
    decoded = helper.create_tmp_variable(loc.dtype)
    helper.append_op(
        "box_coder",
        {"PriorBox": [prior_box.name], "PriorBoxVar": [prior_box_var.name],
         "TargetBox": [loc.name]},
        {"OutputBox": [decoded.name]},
        {"code_type": "decode_center_size"})
    return multiclass_nms(decoded, scores, background_label=background_label,
                          score_threshold=score_threshold,
                          nms_top_k=nms_top_k, nms_threshold=nms_threshold,
                          nms_eta=nms_eta, keep_top_k=keep_top_k)


def ssd_loss(location, confidence, gt_box, gt_label, prior_box,
             prior_box_var=None, background_label=0, overlap_threshold=0.5,
             neg_pos_ratio=3.0, neg_overlap=0.5, sample_size=None,
             loc_loss_weight=1.0, conf_loss_weight=1.0,
             match_type="per_prediction", mining_type="max_negative"):
    """Weighted SSD localization + confidence loss (reference
    layers/detection.py:470) — iou match -> target assign -> hard negative
    mining -> smooth_l1 + softmax CE."""
    if mining_type != "max_negative":
        raise ValueError("Only mining_type == max_negative is supported")
    num, num_prior = location.shape[0], location.shape[1]

    # 1. match gt to priors
    iou = iou_similarity(x=gt_box, y=prior_box)
    matched_indices, matched_dist = bipartite_match(iou)

    # 2. confidence loss for mining
    lbl3 = ops.reshape(gt_label, shape=(-1, 1, 1))
    target_label, _ = target_assign(lbl3, matched_indices,
                                    mismatch_value=background_label)
    conf_2d = ops.reshape(confidence, shape=(-1, confidence.shape[-1]))
    tl_2d = tensor.cast(ops.reshape(target_label, shape=(-1, 1)), "int64")
    conf_loss = nn.softmax_with_cross_entropy(conf_2d, tl_2d)

    # 3. mine hard negatives
    conf_loss_nm = ops.reshape(conf_loss, shape=(num, num_prior))
    neg_indices, updated_indices = mine_hard_examples(
        conf_loss_nm, matched_indices, matched_dist,
        neg_pos_ratio=neg_pos_ratio, neg_dist_threshold=neg_overlap,
        mining_type=mining_type, sample_size=sample_size or 0)

    # 4. regression + classification targets
    encoded_bbox = box_coder(prior_box=prior_box,
                             prior_box_var=prior_box_var,
                             target_box=gt_box,
                             code_type="encode_center_size")
    target_bbox, target_loc_weight = target_assign(
        encoded_bbox, updated_indices, mismatch_value=background_label)
    target_label, target_conf_weight = target_assign(
        lbl3, updated_indices, negative_indices=neg_indices,
        mismatch_value=background_label)

    # 5. losses
    tl_2d = tensor.cast(ops.reshape(target_label, shape=(-1, 1)), "int64")
    conf_loss = nn.softmax_with_cross_entropy(conf_2d, tl_2d)
    conf_loss = ops.elementwise_mul(
        conf_loss, ops.reshape(target_conf_weight, shape=(-1, 1)))

    loc_2d = ops.reshape(location, shape=(-1, 4))
    tb_2d = ops.reshape(target_bbox, shape=(-1, 4))
    loc_loss = nn.smooth_l1(loc_2d, tb_2d)
    loc_loss = ops.elementwise_mul(
        loc_loss, ops.reshape(target_loc_weight, shape=(-1, 1)))

    loss = ops.scale(conf_loss, scale=float(conf_loss_weight))
    loss = ops.elementwise_add(
        loss, ops.scale(loc_loss, scale=float(loc_loss_weight)))
    return loss


def roi_pool(input, rois, pooled_height=1, pooled_width=1,
             spatial_scale=1.0):
    helper = LayerHelper("roi_pool")
    out = helper.create_tmp_variable(input.dtype)
    argmax = helper.create_tmp_variable("int64", stop_gradient=True)
    helper.append_op(
        "roi_pool", {"X": [input.name], "ROIs": [rois.name]},
        {"Out": [out.name], "Argmax": [argmax.name]},
        {"pooled_height": int(pooled_height),
         "pooled_width": int(pooled_width),
         "spatial_scale": float(spatial_scale)})
    return out


def detection_map(detect_res, label, overlap_threshold=0.5,
                  evaluate_difficult=True, ap_type="integral"):
    helper = LayerHelper("detection_map")
    out = helper.create_tmp_variable("float32", stop_gradient=True)
    helper.append_op(
        "detection_map",
        {"DetectRes": [detect_res.name], "Label": [label.name]},
        {"MAP": [out.name]},
        {"overlap_threshold": float(overlap_threshold),
         "evaluate_difficult": bool(evaluate_difficult),
         "ap_type": ap_type})
    return out
