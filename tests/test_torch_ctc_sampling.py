"""The port's CTC and sampled-loss ops (paddle_tpu_torch/ops/ctc.py,
sampling.py) and layers against the JAX package's, on the CPU.

  * warpctc and hsigmoid through the op-test harness
    (tests/test_torch_op_test.py): a float64 numpy reference (the CTC
    alpha recursion in probabilities), finite differences of the
    generic gradient, and the JAX lowering with jax.vjp at rtol 1e-5,
    atol 1e-6, on ragged LoDs, repeated labels, empty labels, T = 1,
    int32 labels and norm_by_times; hsigmoid with num_classes not a
    power of two and without a bias.
  * warpctc in a Program: the brute-force sum over every alignment of
    tests/test_ctc_nce.py:40, and the loss and the fc weights' gradient
    against the JAX package's Executor (1e-5 and 1e-4 of the largest).
  * ctc_align and ctc_greedy_decoder: ids and LoDs equal to the JAX
    package's, empty results included.
  * nce, whose negatives the JAX package draws from threefry keys: its
    cost and gradients against the JAX formula (jax.vjp) over the port's
    own SampleLabels; the generic gradient's recompute seeing the
    forward's negatives; the negatives uniform (a chi-square test over
    200k draws) and keyed by global row.
  * A cut CRNN-CTC (chip_smoke's `_crnn_program` at 1x16x64, hidden 16, 10
    classes) builds the JAX package's Programs and trains to its losses
    over 3 Momentum steps; the greedy decode and edit distances equal.
    chip_smoke's ocr_ctc decode verdict passes near ties and fails a
    clear winner changed; its card-vs-CPU gate holds every state.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu.core.framework as jfw
from paddle_tpu.core import executor as jexecutor
from paddle_tpu.core.lod import LoDTensor as JLoDTensor

import paddle_tpu_torch as tfluid
import paddle_tpu_torch.core.framework as tfw
from paddle_tpu_torch.core import executor as texecutor
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core.execution import GRAD
from paddle_tpu_torch.core.execution import ExecContext as TExecContext
from paddle_tpu_torch.core.execution import generic_grad_lower
from paddle_tpu_torch.core.lod import LoDTensor
from paddle_tpu_torch.core.scope import Scope
from paddle_tpu_torch.ops.activation import keyed_randint

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))
import chip_smoke  # noqa: E402
from test_ctc_nce import _brute_force_ctc  # noqa: E402
from test_torch_op_test import (check_finite_differences, check_jax,  # noqa: E402
                                check_numpy, fd_cases, forward_cases,
                                jax_cases)
from test_torch_training import _assert_same_program, _start_both  # noqa: E402
from torch_op_cases import cases_of  # noqa: E402

CASES = cases_of("ctc", "sampling")
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4
CRNN_CUT = dict(img=(1, 16, 64), filters=(4, 8, 8, 16), hidden=16,
                classes=10)


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


# -- warpctc and hsigmoid through the op-test harness ------------------------

@pytest.mark.parametrize("case", forward_cases(CASES), ids=str)
def test_forward_matches_numpy(case):
    check_numpy(case)


@pytest.mark.parametrize("case", fd_cases(CASES), ids=str)
def test_gradient_matches_finite_differences(case):
    check_finite_differences(case)


@pytest.mark.parametrize("case", jax_cases(CASES), ids=str)
def test_matches_the_jax_lowering(case):
    check_jax(case)


# -- warpctc in a Program ----------------------------------------------------

def _ctc_program(fluid, fw, c, blank, norm):
    fw.reset_unique_names()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[6], dtype="float32",
                              lod_level=1)
        label = fluid.layers.data(name="label", shape=[1], dtype="int64",
                                  lod_level=1)
        logits = fluid.layers.fc(input=x, size=c)
        loss = fluid.layers.reduce_sum(fluid.layers.warpctc(
            input=logits, label=label, blank=blank, norm_by_times=norm))
        fluid.SGD(learning_rate=0.0).minimize(loss)
    return main, startup, loss


def test_warpctc_matches_brute_force():
    t1, t2, c = 4, 3, 3
    r = np.random.RandomState(0)
    l1 = r.randn(t1, c).astype(np.float32)
    l2 = r.randn(t2, c).astype(np.float32)
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        logits = tfluid.layers.data(name="logits", shape=[c],
                                    dtype="float32", lod_level=1)
        label = tfluid.layers.data(name="label", shape=[1], dtype="int64",
                                   lod_level=1)
        loss = tfluid.layers.warpctc(input=logits, label=label, blank=0)
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup)
    out, = exe.run(main, feed={
        "logits": LoDTensor(np.concatenate([l1, l2]), [[0, t1, t1 + t2]]),
        "label": LoDTensor(np.asarray([1, 2, 2], np.int64).reshape(-1, 1),
                           [[0, 2, 3]])}, fetch_list=[loss])
    np.testing.assert_allclose(
        np.asarray(out).reshape(-1),
        [_brute_force_ctc(l1, [1, 2], 0), _brute_force_ctc(l2, [2], 0)],
        rtol=1e-5)


@pytest.mark.parametrize("t_lens,l_lens,blank,norm", [
    ([7, 3, 9, 1], [3, 1, 0, 1], 0, False),
    ([5, 8], [2, 4], 4, True),
    ([2, 2, 2], [0, 0, 0], 1, False),
])
def test_warpctc_program_matches_jax(t_lens, l_lens, blank, norm):
    """The loss and the fc weights' gradient through each package's
    Executor (append_backward's generic warpctc_grad)."""
    c = 5
    jm, js, jl = _ctc_program(jfluid, jfw, c, blank, norm)
    tm, ts, tl = _ctc_program(tfluid, tfw, c, blank, norm)
    _assert_same_program(jm, tm)
    jexe, texe, _ = _start_both(jm, js, tm, ts)
    r = np.random.RandomState(sum(t_lens))
    lod = [list(np.cumsum([0] + t_lens))]
    llod = [list(np.cumsum([0] + l_lens))]
    x = r.standard_normal((sum(t_lens), 6)).astype(np.float32)
    lab = r.choice([v for v in range(c) if v != blank],
                   sum(l_lens)).astype(np.int64).reshape(-1, 1)
    if len(lab) > 1:
        lab[1] = lab[0]                 # a repeated label
    grad = "fc_0.w_0" + GRAD
    jout = jexe.run(jm, feed={"x": JLoDTensor(x, lod),
                              "label": JLoDTensor(lab, llod)},
                    fetch_list=[jl, grad])
    tout = texe.run(tm, feed={"x": LoDTensor(x, lod),
                              "label": LoDTensor(lab, llod)},
                    fetch_list=[tl, grad])
    np.testing.assert_allclose(tout[0], jout[0], rtol=LOSS_RTOL)
    want = np.asarray(jout[1])
    np.testing.assert_allclose(tout[1], want, rtol=0,
                               atol=GRAD_RTOL * np.abs(want).max())


# -- ctc_align and ctc_greedy_decoder ----------------------------------------

@pytest.mark.parametrize("ids,lod,blank,merge", [
    ([0, 1, 1, 0, 2, 2, 2, 0, 3, 3], [0, 5, 10], 0, True),
    ([0, 1, 1, 0, 2, 2, 2, 0, 3, 3], [0, 5, 10], 0, False),
    ([4, 4, 4, 4, 1, 4, 1, 1], [0, 3, 3, 8], 4, True),
    ([0, 0, 0, 0], [0, 1, 4], 0, True),
])
def test_ctc_align_matches_jax(ids, lod, blank, merge):
    data = np.asarray(ids, np.int64).reshape(-1, 1)
    got = {}
    for name, fluid, lod_t in (("port", tfluid, LoDTensor),
                               ("jax", jfluid, JLoDTensor)):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.layers.data(name="x", shape=[1], dtype="int64",
                                  lod_level=1)
            out = fluid.layers.ctc_align(x, blank=blank,
                                         merge_repeated=merge)
        o, = fluid.Executor(fluid.CPUPlace()).run(
            main, feed={"x": lod_t(data, [lod])}, fetch_list=[out],
            return_numpy=False)
        got[name] = (np.asarray(o.data), tuple(tuple(v) for v in o.lod))
    np.testing.assert_array_equal(got["port"][0], got["jax"][0])
    assert got["port"][0].shape == got["jax"][0].shape
    assert got["port"][1] == got["jax"][1]


def test_ctc_greedy_decoder_matches_jax():
    r = np.random.RandomState(4)
    x = r.standard_normal((17, 6)).astype(np.float32)
    x[3] = x[2]                 # a repeated step: merged
    lod = [[0, 5, 5, 12, 17]]
    got = {}
    for name, fluid, fw, lod_t in (("port", tfluid, tfw, LoDTensor),
                                   ("jax", jfluid, jfw, JLoDTensor)):
        fw.reset_unique_names()
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            xv = fluid.layers.data(name="x", shape=[6], dtype="float32",
                                   lod_level=1)
            out = fluid.layers.ctc_greedy_decoder(input=xv, blank=5)
        got[name] = main, out, fluid.Executor(fluid.CPUPlace()).run(
            main, feed={"x": lod_t(x, lod)}, fetch_list=[out],
            return_numpy=False)[0]
    _assert_same_program(got["jax"][0], got["port"][0])
    t, j = got["port"][2], got["jax"][2]
    np.testing.assert_array_equal(np.asarray(t.data), np.asarray(j.data))
    assert t.lod == tuple(tuple(v) for v in j.lod)


# -- nce ---------------------------------------------------------------------

def _nce_jax_formula(x, w, b, sample_labels, num_true, num_neg, num_total,
                     sw=None):
    """paddle_tpu/ops/sampling.py:72-106's cost over given SampleLabels."""
    logits = jnp.einsum("bd,bsd->bs", x, w[sample_labels])
    if b is not None:
        logits = logits + b[sample_labels]
    o = jax.nn.sigmoid(logits)
    bb = float(num_neg) / float(num_total)
    cost = (jnp.sum(-jnp.log(o[:, :num_true] / (o[:, :num_true] + bb)), 1)
            + jnp.sum(-jnp.log(bb / (o[:, num_true:] + bb)), 1))
    if sw is not None:
        cost = cost * sw.reshape(-1)
    return cost[:, None], o


@pytest.mark.parametrize("case", [c for c in CASES if c.op == "nce"],
                         ids=str)
def test_nce_matches_the_jax_formula_over_its_samples(case):
    """The port's cost, SampleLogits and generic gradients (Input, Weight,
    Bias) against the JAX package's formula and jax.vjp over the port's
    own SampleLabels; SampleLabels int64 [B, true + negatives], the true
    labels first."""
    info = treg.get_op_info("nce")
    attrs = {**info.attrs, **case.attrs}
    ins = {s: [torch.from_numpy(np.array(a))] for s, a in case.ins.items()}
    ctx = TExecContext("cpu", seed=1234)
    outs = info.lower(ctx.child(7), ins, attrs)
    sl = outs["SampleLabels"]
    num_true = case.ins["Label"].shape[1]
    num_neg, num_total = attrs["num_neg_samples"], attrs["num_total_classes"]
    assert sl.dtype == torch.int64 and sl.shape == (
        case.ins["Input"].shape[0], num_true + num_neg)
    np.testing.assert_array_equal(sl[:, :num_true].numpy(),
                                  case.ins["Label"])
    sl = sl.numpy()
    sw = case.ins.get("SampleWeight")
    cot = np.random.RandomState(2).standard_normal(
        tuple(outs["Cost"].shape)).astype(np.float32)

    def f(x, w, b):
        return _nce_jax_formula(x, w, b, jnp.asarray(sl), num_true, num_neg,
                                num_total, None if sw is None
                                else jnp.asarray(sw))

    (jcost, jo), vjp = jax.vjp(f, *[jnp.asarray(case.ins[k]) for k in
                                    ("Input", "Weight", "Bias")])
    jgrads = vjp((jnp.asarray(cot), jnp.zeros_like(jo)))
    np.testing.assert_allclose(outs["Cost"].numpy(), jcost, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(outs["SampleLogits"].numpy(), jo, rtol=1e-5,
                               atol=1e-6)
    g_ins = dict(ins, **{s: [v] for s, v in outs.items()},
                 **{"Cost" + GRAD: [torch.from_numpy(cot)]})
    grads = generic_grad_lower(ctx.child(7), g_ins, attrs, info)
    for slot, jg in zip(("Input", "Weight", "Bias"), jgrads):
        np.testing.assert_allclose(grads[slot + GRAD][0].numpy(),
                                   np.asarray(jg), rtol=1e-5, atol=1e-6,
                                   err_msg=slot)


def test_nce_recompute_sees_the_forward_negatives():
    """One SGD step of a Program with nce: the Weight gradient the
    Executor's generic nce_grad computes equals the JAX formula's over
    the SampleLabels the forward drew, and a second run draws anew."""
    b_n, d, v, neg = 8, 4, 30, 6
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="x", shape=[d], dtype="float32")
        y = tfluid.layers.data(name="y", shape=[1], dtype="int64")
        cost = tfluid.layers.nce(input=x, label=y, num_total_classes=v,
                                 num_neg_samples=neg)
        loss = tfluid.layers.reduce_sum(cost)
        tfluid.SGD(learning_rate=0.0).minimize(loss)
    op = next(o for o in main.global_block().ops if o.type == "nce")
    w_name, b_name = op.inputs["Weight"][0], op.inputs["Bias"][0]
    exe = tfluid.Executor(tfluid.CPUPlace(), seed=3)
    exe.run(startup)
    r = np.random.RandomState(6)
    feed = {"x": r.standard_normal((b_n, d)).astype(np.float32),
            "y": r.randint(0, v, (b_n, 1)).astype(np.int64)}
    scope = tfluid.global_scope()
    w = scope.find_var(w_name).numpy().copy()
    b = scope.find_var(b_name).numpy().copy()
    runs = [exe.run(main, feed=feed, fetch_list=[
        op.outputs["SampleLabels"][0], w_name + GRAD, b_name + GRAD])
        for _ in range(2)]
    for sl, gw, gb in runs:
        _, vjp = jax.vjp(lambda w_, b_: _nce_jax_formula(
            jnp.asarray(feed["x"]), w_, b_, jnp.asarray(sl), 1, neg, v)[0],
            jnp.asarray(w), jnp.asarray(b))
        jw, jb = vjp(jnp.ones((b_n, 1), jnp.float32))
        np.testing.assert_allclose(gw, jw, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(gb, jb, rtol=1e-5, atol=1e-6)
    assert not np.array_equal(runs[0][0], runs[1][0])


def test_nce_negatives_are_uniform_and_keyed_by_row():
    """200k draws over 50 classes: chi-square with 49 degrees of freedom
    below 100 (its 0.9999 quantile is about 93); the rows of a split
    batch, drawn at their row offsets, equal the whole batch's."""
    draws = keyed_randint(20000, 10, 50, seed=11, row_offset=0,
                          device="cpu")
    assert int(draws.min()) == 0 and int(draws.max()) == 49
    counts = np.bincount(draws.numpy().reshape(-1), minlength=50)
    expect = draws.numel() / 50
    chi2 = float(((counts - expect) ** 2 / expect).sum())
    assert chi2 < 100, chi2
    top = keyed_randint(7000, 10, 50, seed=11, row_offset=0, device="cpu")
    rest = keyed_randint(13000, 10, 50, seed=11, row_offset=7000,
                         device="cpu")
    assert torch.equal(torch.cat([top, rest]), draws)
    assert not torch.equal(keyed_randint(100, 10, 50, seed=12, row_offset=0,
                                         device="cpu"), draws[:100])


# -- a cut CRNN-CTC against the JAX package ----------------------------------

def _jax_feed(feed):
    return {k: JLoDTensor(np.asarray(v.data), v.lod)
            if isinstance(v, LoDTensor) else v for k, v in feed.items()}


def test_cut_crnn_ctc_trains_and_decodes_like_jax():
    """3 Momentum steps on one batch of 4: losses within 1e-5 relative and
    falling; then the decode program (test-mode batch norm, greedy
    decode, edit distance) on the trained weights, equal."""
    jm, js, jl, jdec, jout, jdist = chip_smoke._crnn_program(
        jfluid, jfw, **CRNN_CUT)
    tm, ts, tl, tdec, tout, tdist = chip_smoke._crnn_program(
        tfluid, tfw, **CRNN_CUT)
    _assert_same_program(jm, tm)
    _assert_same_program(jdec, tdec)
    jexe, texe, _ = _start_both(jm, js, tm, ts)
    feed = chip_smoke._crnn_feed(np.random.RandomState(9), 4,
                                 img=CRNN_CUT["img"], classes=10,
                                 lens=(1, 2))
    jloss = [float(np.asarray(jexe.run(jm, feed=_jax_feed(feed),
                                       fetch_list=[jl])[0]).reshape(-1)[0])
             for _ in range(3)]
    tloss = [float(np.asarray(texe.run(tm, feed=feed,
                                       fetch_list=[tl])[0]).reshape(-1)[0])
             for _ in range(3)]
    np.testing.assert_allclose(tloss, jloss, rtol=LOSS_RTOL)
    assert tloss[-1] < tloss[0], tloss
    jd, jdd = jexe.run(jdec, feed=_jax_feed(feed), fetch_list=[jout, jdist],
                       return_numpy=False)
    td, tdd = texe.run(tdec, feed=feed, fetch_list=[tout, tdist],
                       return_numpy=False)
    np.testing.assert_array_equal(np.asarray(td.data), np.asarray(jd.data))
    assert td.lod == tuple(tuple(v) for v in jd.lod)
    np.testing.assert_array_equal(np.asarray(tdd), np.asarray(jdd))


def test_crnn_program_at_full_width():
    """The Program chip_smoke trains: 32 steps of 384 into the GRUs, 96
    classes out."""
    main, _, _, decode, _, _ = chip_smoke._crnn_program(tfluid, tfw)
    blk = main.global_block()
    seq = next(op for op in blk.ops if op.type == "im2sequence")
    assert blk.vars[seq.outputs["Out"][0]].shape[-1] == 384
    ctc = next(op for op in blk.ops if op.type == "warpctc")
    assert blk.vars[ctc.inputs["Logits"][0]].shape[-1] == 96
    assert ctc.attrs["blank"] == 95 and ctc.attrs["norm_by_times"]
    assert [op.type for op in decode.global_block().ops][-3:] == \
        ["top_k", "ctc_align", "edit_distance"]


def test_greedy_verdict_passes_near_ties_and_fails_far_ones():
    """chip_smoke's `_greedy_verdict` (the ocr_ctc card-vs-CPU decode
    gate): equal frames pass; a frame whose CPU logits tie within 1e-5
    may differ; a frame with a clear winner may not."""
    logits = np.asarray([[0.1, 2.0, 0.3], [1.0, 1.0000001, 0.0],
                         [3.0, 0.0, 1.0]], np.float32)
    cpu = logits.argmax(1)[:, None]
    assert chip_smoke._greedy_verdict(cpu.copy(), cpu, logits) == \
        (True, 0, None)
    flipped = cpu.copy()
    flipped[1] = 0
    ok, n, _ = chip_smoke._greedy_verdict(flipped, cpu, logits)
    assert ok and n == 1
    wrong = cpu.copy()
    wrong[2] = 2
    ok, n, margin = chip_smoke._greedy_verdict(wrong, cpu, logits)
    assert not ok and n == 1 and margin == pytest.approx(2.0)


def test_card_vs_cpu_gate_holds_every_state(monkeypatch, one_thread):
    """chip_smoke's card-vs-CPU gate (`_card_vs_cpu`, here through
    `_ocr_card_vs_cpu` on the cut CRNN in float64, the CPU on both sides)
    compares every state: equal runs pass; the first conv's weights,
    below every ReLU and both GRUs, moved by 2e-4 on one side fail it, as
    does a loss moved by 2e-5 relative."""
    cut = dict(CRNN_CUT, lens=(1, 2))
    main, *_ = chip_smoke._crnn_program(tfluid, tfw, **CRNN_CUT)
    rec = chip_smoke._ocr_card_vs_cpu(None, tfluid.CPUPlace(), **cut)
    assert [s["states"] for s in rec["steps"]] == \
        [len(chip_smoke._persistables(main))] * chip_smoke.OCR_CPU_STEPS
    assert rec["decode"]["decoded_equal"]
    step_on = chip_smoke._step_on

    def moved(shift, scale):
        calls = []

        def run(place, program, state, feed, fetch):
            out, after = step_on(place, program, state, feed, fetch)
            if place is not None and not calls:
                calls.append(1)
                after = dict(after, **{
                    "conv2d_0.w_0": after["conv2d_0.w_0"] + shift})
                out = [(out[0][0] * scale, out[0][1])] + out[1:]
            return out, after
        return run

    for shift, scale, what in ((2e-4, 1.0, "step 0: conv2d_0.w_0 differs"),
                               (0.0, 1 + 2e-5, "step 0: loss")):
        monkeypatch.setattr(chip_smoke, "_step_on", moved(shift, scale))
        with pytest.raises(chip_smoke.CheckFailed, match=what):
            chip_smoke._ocr_card_vs_cpu(None, tfluid.CPUPlace(), **cut)
