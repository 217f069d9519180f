"""The rest of benchmark/run_image.py in the port against the JAX
package, on the CPU: the `lrn` and `concat` ops, and the AlexNet,
GoogLeNet, SmallNet and VGG-19 builders.

Ops: each forward against the JAX lowering on the same inputs, each
gradient (lrn's and concat's generic gradient: autograd over the
lowering) against `jax.vjp` of the JAX lowering (tests/test_torch_conv.py's
harness).  float32 within 1e-5 of max(1, |JAX|).  bf16: concat bit for
bit; lrn's MidOut within 1 bf16 ulp and Out within 3 ulps of each
element (the JAX lowering's bf16 window sum and power round differently
from torch's: measured at most 1 and 3 ulps over 30 seeded cases), and
lrn's bf16 gradient within 2 ulps of max|g| of the JAX VJP run in
float32 on the same bf16 values (the conv tests' rule).

Models: run_image's `build` (:42-66) in each package, at its sizes
(AlexNet 227, GoogLeNet and VGG-19 224, SmallNet 32), float32 and bf16:
`to_dict()`-equal, so every pool's output geometry is the JAX
package's.  Then 3 Momentum steps from the JAX startup's parameters at
inputs just large enough for each model's pools (AlexNet 65x65, its
pool5 1x1; GoogLeNet 64x64; VGG-19 32x32; SmallNet 32x32), batch 2,
with every dropout op set to is_test in both Programs (the same edit on
both sides: the packages' random bits differ): losses within 1e-5
relative, every parameter and velocity within atol 1e-4
(tests/test_torch_resnet.py's tolerances).  Pure bf16 AlexNet, as
run_image runs it: 2 steps, each loss within one bf16 ulp.  The
training-mode Programs (dropout drawing) are held by the port's
default mode against its interpreter, bit for bit.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu.core.framework as jfw
from paddle_tpu import models as jmodels
from paddle_tpu.core import executor as jexecutor

import paddle_tpu_torch as tfluid
import paddle_tpu_torch.core.framework as tfw
from paddle_tpu_torch import CPUPlace
from paddle_tpu_torch import models as tmodels
from paddle_tpu_torch.core import executor as texecutor
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.core.scope import Scope, scope_to_numpy

from test_torch_conv import (F32_TOL, _assert_close, _assert_grads,
                             _forward, _grad_both, _np, _rand)
from test_torch_training import _assert_same_program, _start_both

LOSS_RTOL, PARAM_ATOL, LOSS_ULPS = 1e-5, 1e-4, 1
LRN_OUT_ULPS, LRN_MID_ULPS = 3, 1
BATCH, STEPS = 2, 3
# run_image's sizes, and the smallest input each model's pools take
SIZES = {"alexnet": (227, 65), "googlenet": (224, 64),
         "smallnet": (32, 32), "vgg19": (224, 32)}


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


# -- lrn ---------------------------------------------------------------------

LRN_CASES = [  # (x shape, attrs)
    ((2, 7, 5, 4), {}),
    ((2, 3, 4, 4), {"n": 3, "k": 1.0, "alpha": 0.5, "beta": 0.5}),
    ((2, 16, 6, 6), {"n": 5, "alpha": 1e-4, "beta": 0.75}),     # AlexNet's
    ((2, 8, 3, 3), {"n": 5, "k": 1.0, "alpha": 0.3, "beta": 0.75}),
    ((2, 12, 4, 4), {"n": 5, "k": 2.0, "alpha": 0.05, "beta": 0.75}),
]


def _ulps(t, j):
    """|t - j| in bf16 ulps of the larger of the two, elementwise."""
    t, j = _np(t), _np(j)
    top = np.maximum(np.abs(t), np.abs(j))
    ulp = 2.0 ** (np.floor(np.log2(np.where(top > 0, top, 1.0))) - 7)
    return np.abs(t - j) / ulp


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", LRN_CASES, ids=range(len(LRN_CASES)))
def test_lrn_matches_jax(case, dtype):
    xs, attrs = case
    for seed in range(6):
        jout, tout = _forward("lrn", {"X": _rand(xs, seed) * 3}, attrs,
                              dtype)
        assert set(tout) == set(jout) == {"Out", "MidOut"}
        if dtype == "float32":
            for slot in jout:
                _assert_close(tout[slot], jout[slot], dtype, F32_TOL, slot)
        else:
            assert tout["Out"].dtype == tout["MidOut"].dtype == \
                torch.bfloat16
            assert _ulps(tout["MidOut"], jout["MidOut"]).max() \
                <= LRN_MID_ULPS
            assert _ulps(tout["Out"], jout["Out"]).max() <= LRN_OUT_ULPS


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", LRN_CASES, ids=range(len(LRN_CASES)))
def test_lrn_grad_matches_jax_vjp(case, dtype):
    xs, attrs = case
    jg, tg, ref = _grad_both("lrn", {"X": _rand(xs, 4) * 3}, attrs, dtype,
                             "Out")
    assert set(tg) == {"X@GRAD"}
    _assert_grads(jg, tg, ref, dtype, F32_TOL)


# -- concat ------------------------------------------------------------------

CONCAT_CASES = [  # (input shapes, axis)
    ([(2, 3, 4, 4), (2, 5, 4, 4), (2, 1, 4, 4), (2, 2, 4, 4)], 1),  # inception
    ([(3, 4), (2, 4)], 0),
    ([(2, 3, 2), (2, 3, 5), (2, 3, 1)], -1),
    ([(4, 6)], 1),
]


def _concat_arrays(shapes, seed=0):
    return [_rand(s, seed + i) for i, s in enumerate(shapes)]


def _concat_ins(arrays, dtype, jax_side):
    import jax.numpy as jnp

    if jax_side:
        return {"X": [jnp.asarray(a, jnp.bfloat16 if dtype == "bfloat16"
                                  else a.dtype) for a in arrays]}
    ts = [torch.from_numpy(a) for a in arrays]
    return {"X": [t.to(torch.bfloat16) if dtype == "bfloat16" else t
                  for t in ts]}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CONCAT_CASES, ids=range(len(CONCAT_CASES)))
def test_concat_and_its_gradient_match_jax(case, dtype):
    """Forward bit for bit; the gradient (the cotangent split back in
    slot order) against jax.vjp of the JAX lowering, bit for bit."""
    import jax

    from paddle_tpu.core import registry as jreg
    from paddle_tpu.core.execution import ExecContext as JExecContext
    from paddle_tpu_torch.core import registry as treg
    from paddle_tpu_torch.core.execution import (ExecContext,
                                                 generic_grad_lower)

    shapes, axis = case
    arrays = _concat_arrays(shapes)
    jinfo, tinfo = jreg.get_op_info("concat"), treg.get_op_info("concat")
    assert (tinfo.inputs, tinfo.outputs, tinfo.attrs, tinfo.dup_inputs) \
        == (jinfo.inputs, jinfo.outputs, jinfo.attrs, jinfo.dup_inputs)
    attrs = {"axis": axis}
    jins = _concat_ins(arrays, dtype, True)
    jout = jinfo.lower(JExecContext(), jins, attrs)["Out"]
    tout = tinfo.lower(ExecContext("cpu"), _concat_ins(arrays, dtype, False),
                       attrs)["Out"]
    np.testing.assert_array_equal(_np(tout), _np(jout))
    cot = _rand(tuple(tout.shape), 9)

    def f(*xs):
        return jinfo.lower(JExecContext(), {"X": list(xs)}, attrs)["Out"]

    _, vjp = jax.vjp(f, *jins["X"])
    jg = vjp(_concat_ins([cot], dtype, True)["X"][0])
    # the port's "concat_grad": its generic gradient
    tins = _concat_ins(arrays, dtype, False)
    tg = generic_grad_lower(
        ExecContext("cpu"), {**tins, "Out": [tout],
                             "Out@GRAD": _concat_ins([cot], dtype,
                                                     False)["X"]},
        attrs, tinfo)["X@GRAD"]
    assert len(tg) == len(jg)
    for i, (t, j) in enumerate(zip(tg, jg)):
        assert t.dtype == tins["X"][i].dtype
        np.testing.assert_array_equal(_np(t), _np(j), err_msg=str(i))


# -- the run_image Programs --------------------------------------------------

def _pkg(which):
    return ((jfluid, jfw, jmodels) if which == "jax"
            else (tfluid, tfw, tmodels))


def _build(which, model, img, dtype="float32"):
    """run_image.py's `build` for `model` in one package -> (main,
    startup, loss, predict)."""
    fluid, fw, models = _pkg(which)
    fw.reset_unique_names()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        data = fluid.layers.data(name="img", shape=[3, img, img],
                                 dtype=dtype)
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        if model == "alexnet":
            predict = models.alexnet(data, class_dim=1000)
        elif model == "googlenet":
            predict = models.googlenet(data, class_dim=1000)
        elif model == "smallnet":
            predict = models.smallnet_mnist_cifar(data, class_dim=10)
        else:
            predict = models.vgg(data, class_dim=1000, depth=19)
        cost = fluid.layers.cross_entropy(input=predict, label=label)
        avg = fluid.layers.mean(cost)
        fluid.Momentum(learning_rate=0.01, momentum=0.9).minimize(avg)
    return main, startup, avg, predict


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("model", list(SIZES))
def test_run_image_programs_match_jax(model, dtype):
    img = SIZES[model][0]
    jm, js, _, _ = _build("jax", model, img, dtype)
    tm, ts, _, pred = _build("torch", model, img, dtype)
    _assert_same_program(jm, tm)
    _assert_same_program(js, ts)
    blk = tm.global_block()
    types = [op.type for op in blk.ops]
    pools = [blk.var(op.output("Out")[0]).shape for op in blk.ops
             if op.type == "pool2d"]
    assert blk.var(pred.name).shape == \
        (-1, 10 if model == "smallnet" else 1000)
    if model == "alexnet":
        assert types.count("lrn") == 2 and types.count("dropout") == 2
        assert pools == [(-1, 96, 27, 27), (-1, 256, 13, 13),
                         (-1, 256, 6, 6)]
    elif model == "googlenet":
        assert types.count("concat") == 9 and types.count("dropout") == 1
        assert types.count("concat_grad") == 9
    elif model == "vgg19":
        assert types.count("conv2d") == 16 and pools[-1] == (-1, 512, 7, 7)
    else:
        assert "dropout" not in types


def test_googlenet_inception_keeps_size_and_channel_order():
    """The 3x3 stride-1 padding-1 max pool keeps the spatial size, and
    the four-way concat joins 1x1 | 3x3 | 5x5 | pool-proj in NCHW order."""
    tm, _, _, _ = _build("torch", "googlenet", 224)
    blk = tm.global_block()
    producer = {n: op for op in blk.ops for n in op.output_names()}
    cat = next(op for op in blk.ops if op.type == "concat")
    assert cat.attrs["axis"] == 1
    widths = [blk.var(n).shape[1] for n in cat.input("X")]
    assert widths == [64, 128, 32, 32]
    assert blk.var(cat.output("Out")[0]).shape == (-1, 256, 27, 27)
    op = producer[cat.input("X")[3]]      # relu <- bias add <- conv <- pool
    while op.type != "pool2d":
        op = producer[(op.input("X") or op.input("Input"))[0]]
    pool = op
    assert pool.attrs["strides"] == [1, 1] and pool.attrs["ksize"] == [3, 3]
    assert blk.var(pool.output("Out")[0]).shape == \
        blk.var(pool.input("X")[0]).shape


# -- training parity ---------------------------------------------------------

def _dropouts_to_test_mode(prog):
    for op in prog.global_block().ops:
        if op.type == "dropout":
            op.attrs["is_test"] = True


def _feeds(model, img, steps, dtype="float32"):
    classes = 10 if model == "smallnet" else 1000
    r = np.random.RandomState(0)
    out = []
    for _ in range(steps):
        x = r.rand(BATCH, 3, img, img).astype(np.float32)
        if dtype == "bfloat16":
            import ml_dtypes

            x = x.astype(ml_dtypes.bfloat16)
        out.append({"img": x, "label": r.randint(0, classes, (BATCH, 1))
                    .astype(np.int64)})
    return out


def _train_both(model, steps, dtype="float32"):
    img = SIZES[model][1]
    jm, js, jl, _ = _build("jax", model, img, dtype)
    tm, ts, tl, _ = _build("torch", model, img, dtype)
    _dropouts_to_test_mode(jm)
    _dropouts_to_test_mode(tm)
    _assert_same_program(jm, tm)
    jexe, texe, names = _start_both(jm, js, tm, ts)
    jloss, tloss = [], []
    for feed in _feeds(model, img, steps, dtype):
        jloss.append(float(np.asarray(jexe.run(
            jm, feed=feed, fetch_list=[jl])[0], np.float32).reshape(-1)[0]))
        tloss.append(float(texe.run(tm, feed=feed,
                                    fetch_list=[tl])[0].reshape(-1)[0]))
    return jloss, tloss, names


@pytest.mark.parametrize("model", list(SIZES))
def test_momentum_steps_match_jax(model):
    jl, tl, names = _train_both(model, STEPS)
    assert np.all(np.isfinite(tl))
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL, atol=0)
    tvals = scope_to_numpy(tfluid.global_scope(), names)
    for n in names:
        np.testing.assert_allclose(
            tvals[n], np.asarray(jexecutor.global_scope().find_var(n)),
            rtol=0, atol=PARAM_ATOL, err_msg=n)


def test_pure_bf16_alexnet_losses_match_jax():
    """run_image's mode (image, parameters and velocities bf16, no amp),
    lrn in bf16: 2 steps, each loss within one bf16 ulp."""
    jl, tl, names = _train_both("alexnet", 2, "bfloat16")
    for j, t in zip(jl, tl):
        assert abs(t - j) <= LOSS_ULPS * 2.0 ** (np.floor(np.log2(abs(j)))
                                                 - 7), (tl, jl)
    assert all(tfluid.global_scope().find_var(n).dtype == torch.bfloat16
               for n in names if ".w_" in n)


@pytest.mark.parametrize("model", ["alexnet", "googlenet", "vgg19"])
def test_training_mode_default_equals_interpreter(model):
    """The Programs as built (dropout drawing): on the CPU the default
    mode runs the dropout ops with the rest; two steps from one state
    and one seed give the interpreter's losses and masks."""
    img = SIZES[model][1]
    main, startup, loss, _ = _build("torch", model, img)
    drop = next(op for op in main.global_block().ops
                if op.type == "dropout")
    mask = drop.output("Mask")[0]
    feeds = _feeds(model, img, 2)
    runs = {}
    for compiled in (None, False):
        texecutor.switch_scope(Scope())
        exe = tfluid.Executor(CPUPlace(), seed=5)
        exe.run(startup)
        runs[compiled] = [exe.run(main, feed=f, fetch_list=[loss, mask],
                                  compiled=compiled) for f in feeds]
    for (la, ma), (lb, mb) in zip(runs[None], runs[False]):
        assert np.isfinite(la).all() and np.array_equal(la, lb)
        np.testing.assert_array_equal(ma, mb)
        assert 0.0 < float(ma.mean()) < 1.0
