"""The port's detection ops (paddle_tpu_torch/ops/detection.py) and
layers against the JAX package's, on the CPU.

  * The device ops (prior_box, box_coder, iou_similarity, target_assign,
    roi_pool with empty bins and tied maxima) through the op-test
    harness (tests/test_torch_op_test.py): the numpy reference, finite
    differences of the generic gradient, and the JAX lowering with
    jax.vjp at rtol 1e-5, atol 1e-6.
  * The host ops (bipartite_match, mine_hard_examples, multiclass_nms,
    detection_map), vectorised in the port, against the JAX package's
    Python loops on the same inputs, their outputs and LoDs equal: on
    tied distances and losses, the NMS order with eta < 1 and keep_top_k,
    both AP types, and at SSD300's 2278 priors.
  * A cut MobileNet-SSD (chip_smoke's `_ssd_program` at 64x64, width 0.25)
    builds the JAX package's Programs, op for op, takes its first step's
    parameter gradients (1e-3 of the largest) and trains to its losses
    over 3 RMSProp steps with one ground-truth box an image; the decode
    program's detections and mAP equal.
  * The one intended difference: with more than one box in an image,
    the JAX package's ssd_loss reads later images' box targets from the
    wrong rows (ROADMAP.md Queue C); the port reads each image's own.
  * chip_smoke's ssd card-vs-CPU verdicts (detections, matches and mined
    negatives) pass near ties and fail real differences, and its gate
    compares every state.
"""
import os
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu.core.framework as jfw
from paddle_tpu.core import executor as jexecutor
from paddle_tpu.core import registry as jreg
from paddle_tpu.core.execution import ExecContext as JExecContext
from paddle_tpu.core.lod import LoDTensor as JLoDTensor

import paddle_tpu_torch as tfluid
import paddle_tpu_torch.core.framework as tfw
from paddle_tpu_torch.core import executor as texecutor
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core.execution import ExecContext as TExecContext
from paddle_tpu_torch.core.lod import LoDTensor
from paddle_tpu_torch.core.scope import Scope

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))
import chip_smoke  # noqa: E402
from test_torch_op_test import (check_finite_differences, check_jax,  # noqa: E402
                                check_numpy, fd_cases, forward_cases,
                                jax_cases)
from test_torch_training import _assert_same_program, _start_both  # noqa: E402
from torch_op_cases import cases_of  # noqa: E402

CASES = cases_of("detection")
LOSS_RTOL = 1e-5
SSD_CUT = dict(img=64, scale=0.25)
SSD_CUT_LR = 3e-6
# the first step's parameter gradients, the port's against the JAX
# package's, each within this share of max(1, |JAX|): both float32, the
# JAX package's lie up to 2.7e-4 of it from the port's float64 ones at
# this input (batch norm over 2 images), the port's up to 9.6e-5
SSD_GRAD_TOL = 1e-3


@pytest.fixture(autouse=True)
def _fresh_port_state():
    old_main = tfw.switch_main_program(tfw.Program())
    old_startup = tfw.switch_startup_program(tfw.Program())
    old_scope = texecutor.switch_scope(Scope())
    old_jscope = jexecutor.switch_scope(jfluid.Scope())
    tfw.reset_unique_names()
    tflags.reset_flags()
    yield
    tfw.switch_main_program(old_main)
    tfw.switch_startup_program(old_startup)
    texecutor.switch_scope(old_scope)
    jexecutor.switch_scope(old_jscope)
    tflags.reset_flags()

@pytest.fixture
def one_thread():
    """One intra-op thread: the float64 card-vs-CPU gate runs many small
    CPU ops, which stall on thread barriers when test workers share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the device ops through the op-test harness ------------------------------

@pytest.mark.parametrize("case", forward_cases(CASES), ids=str)
def test_forward_matches_numpy(case):
    check_numpy(case)


@pytest.mark.parametrize("case", fd_cases(CASES), ids=str)
def test_gradient_matches_finite_differences(case):
    check_finite_differences(case)


@pytest.mark.parametrize("case", jax_cases(CASES), ids=str)
def test_matches_the_jax_lowering(case):
    check_jax(case)


# -- the host ops against the JAX package's loops ----------------------------

def _both(op, ins, attrs=None):
    """The op's lowering in both packages on the same numpy inputs ({slot:
    array or (array, lod)}) -> ({slot: port value}, {slot: JAX value})."""
    jinfo, tinfo = jreg.get_op_info(op), treg.get_op_info(op)
    jins, tins = {}, {}
    for slot, a in ins.items():
        arr, lod = a if isinstance(a, tuple) else (a, None)
        jins[slot] = [np.asarray(arr) if lod is None
                      else JLoDTensor(np.asarray(arr), lod)]
        t = torch.from_numpy(np.array(arr))
        tins[slot] = [t if lod is None else LoDTensor(t, lod)]
    tout = tinfo.lower(TExecContext("cpu"), tins,
                       {**tinfo.attrs, **(attrs or {})})
    jout = jinfo.lower(JExecContext(), jins, {**jinfo.attrs, **(attrs or {})})
    return tout, jout


def _equal(got, want, what, dtype_kind=None):
    glod = got.lod if isinstance(got, LoDTensor) else None
    wlod = want.lod if isinstance(want, JLoDTensor) else None
    assert (glod or None) == (tuple(tuple(x) for x in wlod) if wlod
                              else None), (what, glod, wlod)
    g = (got.data if isinstance(got, LoDTensor) else got).numpy()
    w = np.asarray(want.data if isinstance(want, JLoDTensor) else want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    if dtype_kind is not None:
        assert g.dtype.kind == dtype_kind, (what, g.dtype)
    np.testing.assert_array_equal(g, w, err_msg=what)


def _iou_lod(r, counts, priors):
    """An IoU matrix of random boxes against `priors` boxes, with ties:
    rows repeated and values rounded to a coarse grid."""
    g = int(sum(counts))
    d = np.round(r.uniform(0, 1, (g, priors)) * 8) / 8
    d[r.uniform(size=d.shape) < 0.3] = 0.0
    if g > 1:
        d[1] = d[0]
    lod = [list(np.cumsum([0] + list(counts)))]
    return d.astype(np.float32), lod


@pytest.mark.parametrize("counts,priors", [([3, 1, 2], 12), ([2, 0, 4], 9),
                                           ([6], 2278)])
def test_bipartite_match_matches_jax_with_ties(counts, priors):
    d, lod = _iou_lod(np.random.RandomState(len(counts) + priors), counts,
                      priors)
    tout, jout = _both("bipartite_match", {"DistMat": (d, lod)})
    _equal(tout["ColToRowMatchIndices"], jout["ColToRowMatchIndices"],
           "indices", "i")
    _equal(tout["ColToRowMatchDist"], jout["ColToRowMatchDist"], "dist")


def _mining_inputs(r, n, m):
    """Losses on a coarse grid (ties), some priors matched, distances
    on a grid too."""
    loss = np.round(r.uniform(0, 4, (n, m)) * 4).astype(np.float32) / 4
    match = np.where(r.uniform(size=(n, m)) < 0.15,
                     r.randint(0, 3, (n, m)), -1).astype(np.int32)
    dist = np.where(match > -1, r.uniform(0.5, 1, (n, m)),
                    np.round(r.uniform(0, 1, (n, m)) * 4) / 4)
    return {"ClsLoss": loss, "MatchIndices": match,
            "MatchDist": dist.astype(np.float32),
            "LocLoss": np.round(r.uniform(0, 2, (n, m)) * 4).astype(
                np.float32) / 4}


@pytest.mark.parametrize("mining,attrs", [
    ("max_negative", {}),
    ("max_negative", {"neg_pos_ratio": 1.5, "neg_dist_threshold": 0.25}),
    ("hard_example", {"sample_size": 5}),
])
def test_mine_hard_examples_matches_jax_with_ties(mining, attrs):
    ins = _mining_inputs(np.random.RandomState(3), 3, 40)
    if mining == "max_negative":
        del ins["LocLoss"]
    tout, jout = _both("mine_hard_examples", ins,
                       {"mining_type": mining, **attrs})
    _equal(tout["NegIndices"], jout["NegIndices"], "NegIndices", "i")
    _equal(tout["UpdatedMatchIndices"], jout["UpdatedMatchIndices"],
           "UpdatedMatchIndices", "i")


def _nms_inputs(r, n, c, m, coarse):
    lo = r.uniform(0, 0.7, (n, m, 2))
    side = r.uniform(0.05, 0.4, (n, m, 2))
    boxes = np.concatenate([lo, lo + side], -1)
    scores = r.uniform(0, 1, (n, c, m))
    if coarse:      # grid corners and scores: tied scores and IoUs
        boxes = np.round(boxes * 10) / 10
        scores = np.round(scores * 8) / 8
    return boxes.astype(np.float32), scores.astype(np.float32)


@pytest.mark.parametrize("attrs,coarse", [
    ({}, False),
    ({}, True),
    ({"nms_eta": 0.7, "nms_threshold": 0.9, "keep_top_k": 11,
      "nms_top_k": 15}, True),
    ({"score_threshold": 0.5, "background_label": -1, "keep_top_k": -1,
      "nms_top_k": -1}, False),
])
def test_multiclass_nms_matches_jax(attrs, coarse):
    boxes, scores = _nms_inputs(np.random.RandomState(7), 3, 4, 30, coarse)
    tout, jout = _both("multiclass_nms", {"BBoxes": boxes,
                                          "Scores": scores}, attrs)
    _equal(tout["Out"], jout["Out"], "Out")
    assert tout["Out"].data.shape[0] > 0


def test_multiclass_nms_at_ssd300_width_matches_jax():
    """2278 priors, 21 classes (the JAX loops' cost: seconds)."""
    boxes, scores = _nms_inputs(np.random.RandomState(8), 1, 21, 2278,
                                False)
    tout, jout = _both("multiclass_nms", {"BBoxes": boxes,
                                          "Scores": scores / 8})
    _equal(tout["Out"], jout["Out"], "Out")


@pytest.mark.parametrize("ap_type", ["integral", "11point"])
def test_detection_map_matches_jax(ap_type):
    r = np.random.RandomState(11)
    boxes, scores = _nms_inputs(r, 3, 4, 30, True)
    det = treg.get_op_info("multiclass_nms").lower(
        TExecContext("cpu"), {"BBoxes": [torch.from_numpy(boxes)],
                              "Scores": [torch.from_numpy(scores)]},
        {**treg.get_op_info("multiclass_nms").attrs, "keep_top_k": 20})["Out"]
    counts = [3, 1, 4]
    g = sum(counts)
    gt = np.concatenate([r.randint(1, 4, (g, 1)),
                         boxes[0, r.randint(0, 30, g)] + r.uniform(
                             -0.02, 0.02, (g, 4)),
                         r.randint(0, 2, (g, 1))], 1).astype(np.float32)
    glod = [list(np.cumsum([0] + counts))]
    tout, jout = _both("detection_map", {
        "DetectRes": (det.data.numpy(), det.lod),
        "Label": (gt, glod)}, {"ap_type": ap_type,
                               "overlap_threshold": 0.3})
    _equal(tout["MAP"], jout["MAP"], "MAP")
    assert 0 < float(tout["MAP"][0]) < 1


# -- ssd_loss ----------------------------------------------------------------

def _ssd_targets(fluid, fw):
    """tests/test_detection_ops.py:199-227's input (2 images, 8 priors,
    three ground-truth boxes, LoD [[0, 2, 3]]): ssd_loss's location
    targets."""
    n, np_, c = 2, 8, 3
    r = np.random.RandomState(0)
    prior = np.sort(r.rand(np_, 4).astype(np.float32), axis=1)
    pvar = np.tile(np.asarray([0.1, 0.1, 0.2, 0.2], np.float32), (np_, 1))
    gt_boxes = np.sort(r.rand(3, 4).astype(np.float32), axis=1)
    gt_labels = r.randint(1, c, (3, 1)).astype(np.int64)
    fw.reset_unique_names()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        feat = fluid.layers.data(name="feat", shape=[16], dtype="float32")
        loc = fluid.layers.reshape(fluid.layers.fc(input=feat, size=np_ * 4),
                                   shape=(-1, np_, 4))
        conf = fluid.layers.reshape(fluid.layers.fc(input=feat,
                                                    size=np_ * c),
                                    shape=(-1, np_, c))
        pb = fluid.layers.data(name="pb", shape=[np_, 4], dtype="float32",
                               append_batch_size=False)
        pbv = fluid.layers.data(name="pbv", shape=[np_, 4], dtype="float32",
                                append_batch_size=False)
        gtb = fluid.layers.data(name="gtb", shape=[4], dtype="float32",
                                lod_level=1)
        gtl = fluid.layers.data(name="gtl", shape=[1], dtype="int64",
                                lod_level=1)
        fluid.layers.ssd_loss(loc, conf, gtb, gtl, pb, pbv)
    ops = main.global_block().ops
    enc = next(op for op in ops if op.type == "box_coder")
    ta = next(op for op in ops if op.type == "target_assign"
              and op.inputs["X"] == enc.outputs["OutputBox"])
    match = next(op for op in ops if op.type == "mine_hard_examples")
    feed = {"feat": r.randn(n, 16).astype(np.float32), "pb": prior,
            "pbv": pvar}
    lods = {"gtb": (gt_boxes, [[0, 2, 3]]), "gtl": (gt_labels, [[0, 2, 3]])}
    return (main, startup, feed, lods, ta.outputs["Out"][0],
            match.outputs["UpdatedMatchIndices"][0],
            enc.outputs["OutputBox"][0])


def test_ssd_targets_read_each_images_own_rows():
    """Image 1's prior 3 is matched to its only box, row 2 of the ground
    truth.  The port's target is row 2's encoding at prior 3; the JAX
    package's is row 1's (image 0's second box), as ROADMAP.md Queue C
    records.  Image 0's targets agree."""
    got = {}
    for name, fluid, fw, lod_t in (("port", tfluid, tfw, LoDTensor),
                                   ("jax", jfluid, jfw, JLoDTensor)):
        main, startup, feed, lods, target, match, enc = _ssd_targets(
            fluid, fw)
        feed = dict(feed, **{k: lod_t(a, lod) for k, (a, lod) in
                             lods.items()})
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup)
        got[name] = [np.asarray(getattr(v, "data", v)) for v in exe.run(
            main, feed=feed, fetch_list=[target, match, enc],
            return_numpy=False)]
    tt, tm, enc = got["port"]
    jt, jm, _ = got["jax"]
    np.testing.assert_array_equal(tm, jm)
    assert tm[1, 3] == 0           # image 1's prior 3: its box 0 = row 2
    np.testing.assert_allclose(tt[1, 3], enc[2, 3], rtol=1e-6)
    np.testing.assert_allclose(jt[1, 3], enc[1, 3], rtol=1e-6)
    np.testing.assert_allclose(tt[1, 3], [-1.427, 0.265, -1.384, -4.541],
                               atol=1e-3)
    np.testing.assert_allclose(jt[1, 3], [6.588, 3.268, -9.820, -4.711],
                               atol=1e-3)
    np.testing.assert_allclose(tt[0], jt[0], rtol=1e-6)


# -- a cut MobileNet-SSD against the JAX package -----------------------------

def _port_feed(feed):
    return {k: LoDTensor(np.asarray(v.data), v.lod)
            if isinstance(v, (LoDTensor, JLoDTensor)) else v
            for k, v in feed.items()}


def _jax_feed(feed):
    return {k: JLoDTensor(np.asarray(v.data), v.lod)
            if isinstance(v, LoDTensor) else v for k, v in feed.items()}


def _params_below(program, names):
    """The trainable parameters the forward ops make `names` from."""
    blk = program.global_block()
    params = {p.name for p in blk.all_parameters() if p.trainable}
    producer = {}
    for op in blk.ops:
        if op.type.endswith("_grad") or any(
                n.endswith("@GRAD") for n in op.output_names()):
            continue
        for n in op.output_names():
            producer.setdefault(n, op)
    below, seen, stack = set(), set(), list(names)
    while stack:
        op = producer.get(stack.pop())
        if op is None or id(op) in seen:
            continue
        seen.add(id(op))
        below |= params & set(op.input_names())
        stack.extend(op.input_names())
    return below


def test_params_below_walks_the_forward_ops():
    """`_params_below` on the cut SSD: the first ReLU's input depends on
    the first conv and batch norm only; the last ReLU's on every
    parameter of the trunk below it."""
    main, *_ = chip_smoke._ssd_program(tfluid, tfw, **SSD_CUT)
    relus = [op.inputs["X"][0] for op in main.global_block().ops
             if op.type == "relu"]
    assert _params_below(main, relus[:1]) == {
        "conv2d_0.w_0", "batch_norm_0.scale_0", "batch_norm_0.offset_0"}
    deep = _params_below(main, relus[-1:])
    assert _params_below(main, relus[:1]) < deep
    assert not any(".mean_" in n or ".var_" in n for n in deep)


def test_cut_mobilenet_ssd_trains_and_decodes_like_jax():
    """The first step's parameter gradients within SSD_GRAD_TOL of max(1,
    |JAX|), but those below a ReLU whose input took the other side of
    zero in the other package (a flipped mask reroutes their gradient);
    3 RMSProp steps on one batch with one box an image (where the
    packages agree): losses within 1e-5 relative and falling; then the
    decode program (test-mode batch norm, box decode, NMS, mAP) on the
    trained weights: the detections' rows within 1e-5 and the mAP equal.
    The learning rate is SSD_CUT_LR: RMSProp's first steps move every
    element by about 4.5 x lr whatever its gradient's size, so the losses
    test the gradients' signs and the gradients their sizes; this
    27-conv trunk at 64x64 has ReLU pre-activations within rounding of
    zero, whose masks the two libraries' summation orders can flip (one
    flip moved an element of a gradient by 14 % of the largest); at 1e-3
    such a flip parts the two runs by 0.5 % in a step, at 3e-6 the runs
    stay within 1e-5 (4e-6 seen)."""
    kw = dict(SSD_CUT, lr=SSD_CUT_LR)
    jm, js, jl, jdec, jnms, jmap = chip_smoke._ssd_program(jfluid, jfw, **kw)
    tm, ts, tl, tdec, tnms, tmap = chip_smoke._ssd_program(tfluid, tfw, **kw)
    _assert_same_program(jm, tm)
    _assert_same_program(jdec, tdec)
    jexe, texe, _ = _start_both(jm, js, tm, ts)
    feed, dfeed = chip_smoke._ssd_feed(np.random.RandomState(5), 2,
                                       img=SSD_CUT["img"], boxes=(1, 1))
    params = sorted(p.name for p in tm.global_block().all_parameters()
                    if p.trainable)
    relus = [op.inputs["X"][0] for op in tm.global_block().ops
             if op.type == "relu"]
    first = [jl.name] + [p + "@GRAD" for p in params] + relus
    jout = [np.asarray(v) for v in jexe.run(jm, feed=_jax_feed(feed),
                                             fetch_list=first)]
    tout = [np.asarray(v) for v in texe.run(tm, feed=feed,
                                             fetch_list=first)]
    grads = dict(zip(params, zip(tout[1:], jout[1:])))
    flipped = [n for n, t, j in zip(relus, tout[1 + len(params):],
                                    jout[1 + len(params):])
               if np.any((t > 0) != (j > 0))]
    held = sorted(set(params) - _params_below(tm, flipped))
    assert len(held) >= len(params) // 2, flipped
    for n in held:
        t, j = grads[n]
        assert np.abs(t - j).max() <= SSD_GRAD_TOL * max(
            1.0, float(np.abs(j).max())), n
    jloss = [float(jout[0].reshape(-1)[0])] + [
        float(np.asarray(jexe.run(jm, feed=_jax_feed(feed),
                                  fetch_list=[jl])[0]).reshape(-1)[0])
        for _ in range(2)]
    tloss = [float(tout[0].reshape(-1)[0])] + [
        float(np.asarray(texe.run(tm, feed=feed,
                                  fetch_list=[tl])[0]).reshape(-1)[0])
        for _ in range(2)]
    np.testing.assert_allclose(tloss, jloss, rtol=LOSS_RTOL)
    assert tloss[-1] < tloss[0], tloss
    jd, jmp = jexe.run(jdec, feed=_jax_feed(dfeed), fetch_list=[jnms, jmap],
                       return_numpy=False)
    td, tmp = texe.run(tdec, feed=dfeed, fetch_list=[tnms, tmap],
                       return_numpy=False)
    assert td.lod == tuple(tuple(x) for x in jd.lod)
    assert np.asarray(td.data).shape[0] > 0
    np.testing.assert_allclose(np.asarray(td.data), np.asarray(jd.data),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(tmp), np.asarray(jmp))


def test_ssd300_program_has_its_priors():
    """The full-width Program chip_smoke trains: 2278 priors, the host
    ops where ssd_loss puts them."""
    main, _, _, decode, _, _ = chip_smoke._ssd_program(tfluid, tfw)
    prior_ops = [op for op in main.global_block().ops
                 if op.type == "prior_box"]
    assert len(prior_ops) == 6
    loc = next(v for v in main.global_block().vars.values()
               if v.shape == (-1, chip_smoke.SSD_PRIORS, 4))
    assert loc is not None
    types = [op.type for op in main.global_block().ops]
    assert types.count("bipartite_match") == 1
    assert types.count("mine_hard_examples") == 1
    assert [op.type for op in decode.global_block().ops][-2:] == \
        ["multiclass_nms", "detection_map"]


# -- chip_smoke's card-vs-CPU verdicts can fail ------------------------------

def _dets(rows):
    return np.asarray(rows, np.float32)


def test_nms_verdict_passes_near_ties_and_fails_a_wrong_row():
    """chip_smoke's `_nms_verdict`: equal detections pass; two rows of
    scores within 1e-5 in the other order pass (a flipped near tie); a
    different class at a far score, or a box dropped whose IoU with its
    suppressor is far from the threshold, fails."""
    cpu = _dets([[3, 0.50, 0.1, 0.1, 0.4, 0.4],
                 [5, 0.4999999, 0.5, 0.5, 0.9, 0.9],
                 [3, 0.30, 0.6, 0.1, 0.9, 0.3]])
    lod = (0, 3)
    ok, rec = chip_smoke._nms_verdict(cpu.copy(), lod, cpu, lod)
    assert ok and rec["equal"]
    swapped = cpu[[1, 0, 2]]
    ok, rec = chip_smoke._nms_verdict(swapped, lod, cpu, lod)
    assert ok and rec["differing_images"][0]["near_tie"] == \
        "score near tie"
    wrong = cpu.copy()
    wrong[1, 0] = 7
    wrong[1, 1] = 0.45
    ok, rec = chip_smoke._nms_verdict(wrong, lod, cpu, lod)
    assert not ok
    dropped = cpu[[0, 2]]
    ok, _ = chip_smoke._nms_verdict(dropped, (0, 2), cpu, lod)
    assert not ok
    # a box of class 3 the card kept whose IoU with the kept 0.5 box is
    # the threshold: a flipped suppression
    edge = _dets([[3, 0.50, 0.0, 0.0, 1.0, 1.0],
                  [3, 0.40, 0.0, 0.0, 1.0, 0.3]])
    ok, rec = chip_smoke._nms_verdict(edge, (0, 2), edge[:1], (0, 1))
    assert ok and rec["differing_images"][0]["near_tie"] == \
        "IoU near the threshold"


def test_ssd_decisions_pass_near_ties_and_fail_far_ones():
    """chip_smoke's `_ssd_decisions`: a differing negative set passes
    only where the CPU's last chosen and first passed-over losses are
    within 1e-5; a differing match passes only where the CPU's winning
    distance beat its runner-up by at most 1e-5."""
    dist = _dets([[0.9, 0.2, 0.6, 0.0], [0.1, 0.8, 0.7, 0.3]])
    match = np.asarray([[0, 1, -1, -1]], np.int32)
    loss = _dets([[0.0, 0.0, 2.0, 1.0]])
    neg = np.asarray([[2]], np.int32)
    offs = (0, 2)
    cpu = (dist, match, loss, neg, (0, 1))
    ok, _ = chip_smoke._ssd_decisions((dist, match, None, neg, (0, 1)), cpu,
                                      offs)
    assert ok
    ok, rec = chip_smoke._ssd_decisions(
        (dist, match, None, np.asarray([[3]], np.int32), (0, 1)), cpu, offs)
    assert not ok and not rec["negative_flips"][0]["near_tie"]
    tied = _dets([[0.0, 0.0, 1.0, 1.0000001]])
    ok, rec = chip_smoke._ssd_decisions(
        (dist, match, None, np.asarray([[2]], np.int32), (0, 1)),
        (dist, match, tied, np.asarray([[3]], np.int32), (0, 1)), offs)
    assert ok and rec["negative_flips"][0]["near_tie"]
    other = np.asarray([[0, -1, 1, -1]], np.int32)
    ok, rec = chip_smoke._ssd_decisions((dist, other, None, neg, (0, 1)),
                                        cpu, offs)
    assert not ok and not rec["match_flips"][0]["near_tie"]
    card = _dets([[0.9, 0.2, 0.6, 0.0], [0.1, 0.8, 0.8000001, 0.3]])
    near = _dets([[0.9, 0.2, 0.6, 0.0], [0.1, 0.8, 0.7999999, 0.3]])
    ok, rec = chip_smoke._ssd_decisions(
        (card, other, None, neg, (0, 1)), (near, match, loss, neg, (0, 1)),
        offs)
    assert ok and rec["match_flips"][0] == {
        "image": 0, "round": 1, "cpu_margin": pytest.approx(1e-7, abs=1e-7),
        "near_tie": True}


def test_ssd_card_vs_cpu_compares_every_state_and_decision(monkeypatch,
                                                           one_thread):
    """chip_smoke's ssd card-vs-CPU gate (`_ssd_card_vs_cpu` on the cut
    SSD in float64, the CPU on both sides): every state is compared at
    each step, with the matches, the mined negatives and the decode; a
    mined negative changed on one side fails it."""
    rec = chip_smoke._ssd_card_vs_cpu(None, tfluid.CPUPlace(), **SSD_CUT)
    main, *_ = chip_smoke._ssd_program(tfluid, tfw, **SSD_CUT)
    assert len(rec["steps"]) == chip_smoke.SSD_CPU_STEPS
    for step in rec["steps"]:
        assert step["states"] == len(chip_smoke._persistables(main))
        assert step["state_max_rel_diff"] == 0.0
        assert step["match_flips"] == step["negative_flips"] == []
    assert rec["decode"]["equal"] and rec["decode"]["detections"] > 0
    step_on = chip_smoke._step_on

    def other_negative(place, program, state, feed, fetch):
        out, after = step_on(place, program, state, feed, fetch)
        if place is not None and len(fetch) == 5:
            neg, lod = out[4]
            neg = neg.copy()
            neg[0] = neg[0] + 1
            out = out[:4] + [(neg, lod)]
        return out, after

    monkeypatch.setattr(chip_smoke, "SSD_CPU_STEPS", 1)
    monkeypatch.setattr(chip_smoke, "_step_on", other_negative)
    with pytest.raises(chip_smoke.CheckFailed,
                       match="step 0: a decision differs"):
        chip_smoke._ssd_card_vs_cpu(None, tfluid.CPUPlace(), **SSD_CUT)
