"""Conv-net training in the port against the JAX package, on the CPU:
the ResNet and VGG builders, the book's conv models, dropout, and the
weight carrier for bf16 parameters.

Both packages build the same Programs under reset unique names, with
Momentum (or Adam) minimize; their `to_dict()` must be equal, var
dtypes and shapes included (int64 read as int32: the JAX package never
enables x64).  The JAX startup program makes the parameters (the
batch-norm moving statistics among them), which carry into the port
through `scope_from_numpy`; both executors then take the same seeded
feeds.

Tolerances (float32, set from the dtype as tests/test_torch_training.py
sets them for the LM): per-step losses within 1e-5 relative; every
parameter and running statistic after the last step within atol 1e-4
(the convolutions sum in another order; their gradients feed 3 steps
of momentum).  Pure bf16 (run_image's mode: the image, every parameter
and Momentum's velocity bf16, no amp): each step's loss within one bf16
ulp of the JAX package's; the same under bf16 amp (f32 master weights,
bf16 convolutions).  bf16 parameters are not compared: at lr 0.01 a step moves
a weight by less than its own bf16 ulp, so the change after 2 steps is
rounding (the JAX package's compiled and interpreted modes differ by
36 % there, by norm of the change).  The JAX side runs its default
(compiled) mode, as the reference's cells do; in float32 its modes
agree within these tolerances, and for the bf16 losses here too.

Dropout cannot match the JAX package's threefry row keys bit for bit:
it is held by distribution (the keep rate within 4 sigma over 10^5
draws) and by its gradient (`dropout_grad` = cotangent x Mask, exactly).
"""
import contextlib

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu.core.framework as jfw
from paddle_tpu import models as jmodels
from paddle_tpu import nets as jnets
from paddle_tpu.core import executor as jexecutor

import paddle_tpu_torch as tfluid
import paddle_tpu_torch.core.framework as tfw
from paddle_tpu_torch import CPUPlace
from paddle_tpu_torch import models as tmodels
from paddle_tpu_torch import nets as tnets
from paddle_tpu_torch.core import executor as texecutor
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.core.scope import (Scope, scope_from_numpy,
                                         scope_to_numpy)

from test_torch_training import _assert_same_program, _start_both

LOSS_RTOL, PARAM_ATOL, LOSS_ULPS = 1e-5, 1e-4, 1
IMG, CLS, BATCH = 16, 4, 8


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


# -- the models, built by either package -------------------------------------

def _resnet(fluid, models, nets, img):
    return models.resnet_cifar10(img, class_dim=CLS, depth=8)


def _small_vgg(fluid, models, nets, img):
    """tests/book/test_image_classification.py's VGG."""
    conv1 = nets.img_conv_group(
        input=img, pool_size=2, pool_stride=2,
        conv_num_filter=[16, 16], conv_filter_size=3, conv_act="relu",
        conv_with_batchnorm=True, conv_batchnorm_drop_rate=[0.0, 0.0])
    fc1 = fluid.layers.fc(input=conv1, size=64, act="relu")
    return fluid.layers.fc(input=fc1, size=CLS, act="softmax")


def _digits_conv(fluid, models, nets, img):
    """tests/book/test_recognize_digits.py's conv model."""
    conv_pool_1 = nets.simple_img_conv_pool(
        input=img, filter_size=5, num_filters=8, pool_size=2,
        pool_stride=2, act="relu")
    conv_pool_2 = nets.simple_img_conv_pool(
        input=conv_pool_1, filter_size=5, num_filters=16, pool_size=2,
        pool_stride=2, act="relu")
    return fluid.layers.fc(input=conv_pool_2, size=10, act="softmax")


def _resnet_remat(fluid, models, nets, img):
    return models.resnet_cifar10(img, class_dim=CLS, depth=8, remat=True)


MODELS = {"resnet": (_resnet, [3, IMG, IMG]),
          "resnet_remat": (_resnet_remat, [3, IMG, IMG]),
          "vgg": (_small_vgg, [3, IMG, IMG]),
          "digits": (_digits_conv, [1, 28, 28])}


def _pkg(which):
    if which == "jax":
        return jfluid, jfw, jmodels, jnets
    return tfluid, tfw, tmodels, tnets


def _build(which, model, dtype="float32", opt="momentum"):
    fluid, fw, models, nets = _pkg(which)
    net, shape = MODELS[model]
    fw.reset_unique_names()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        img = fluid.layers.data(name="img", shape=shape, dtype=dtype)
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        pred = net(fluid, models, nets, img)
        loss = fluid.layers.mean(fluid.layers.cross_entropy(input=pred,
                                                            label=label))
        acc = fluid.layers.accuracy(input=pred, label=label)
        (fluid.Adam(learning_rate=1e-3) if opt == "adam" else
         fluid.Momentum(learning_rate=0.01, momentum=0.9)).minimize(loss)
    return main, startup, loss, acc


def _feeds(model, steps, dtype="float32"):
    _, shape = MODELS[model]
    classes = 10 if model == "digits" else CLS
    r = np.random.RandomState(0)
    out = []
    for _ in range(steps):
        x = r.rand(BATCH, *shape).astype(np.float32)
        if dtype == "bfloat16":
            import ml_dtypes

            x = x.astype(ml_dtypes.bfloat16)
        out.append({"img": x, "label": r.randint(0, classes, (BATCH, 1))
                    .astype(np.int64)})
    return out


def _both(model, dtype="float32", opt="momentum"):
    jm, js, jl, jacc = _build("jax", model, dtype, opt)
    tm, ts, tl, tacc = _build("torch", model, dtype, opt)
    return (jm, js, jl, jacc), (tm, ts, tl, tacc)


# -- Programs ----------------------------------------------------------------

@pytest.mark.parametrize("model", ["resnet", "vgg", "digits"])
def test_conv_net_programs_match_jax(model):
    (jm, js, *_), (tm, ts, *_) = _both(model)
    _assert_same_program(jm, tm)
    _assert_same_program(js, ts)
    types = {op.type for op in tm.global_block().ops}
    assert {"conv2d", "pool2d", "conv2d_grad", "pool2d_grad", "top_k",
            "accuracy"} <= types
    if model != "digits":
        assert {"batch_norm", "batch_norm_grad"} <= types


def _bf16(mode):
    """(the image dtype, the context the Programs are built and run in):
    pure bf16 as run_image runs ResNet-50, or float32 under bf16 amp."""
    if mode == "pure":
        return "bfloat16", contextlib.nullcontext()
    guards = contextlib.ExitStack()
    guards.enter_context(jfluid.amp.bf16_guard())
    guards.enter_context(tfluid.amp.bf16_guard())
    return "float32", guards


@pytest.mark.parametrize("mode", ["pure", "amp"])
def test_bf16_resnet_program_matches_jax_dtypes(mode):
    """Pure bf16 (run_image's mode): every conv, batch-norm and fc
    parameter bf16; amp: f32 master weights, bf16 activations."""
    dtype, guard = _bf16(mode)
    with guard:
        (jm, js, *_), (tm, ts, *_) = _both("resnet", dtype)
    _assert_same_program(jm, tm)
    _assert_same_program(js, ts)
    params = tm.global_block().all_parameters()
    want = "bfloat16" if mode == "pure" else "float32"
    assert params and all(p.dtype == want for p in params)
    convs = [op for op in tm.global_block().ops if op.type == "conv2d"]
    assert all(tm.global_block().var(op.output("Output")[0]).dtype
               == "bfloat16" for op in convs)


def test_resnet50_program_matches_jax():
    """run_image's ResNet-50 at 224x224, 1000 classes, bf16: the same op
    list and var shapes and dtypes as the JAX package's (built only)."""
    progs = []
    for which in ("jax", "torch"):
        fluid, fw, models, _ = _pkg(which)
        fw.reset_unique_names()
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            img = fluid.layers.data(name="img", shape=[3, 224, 224],
                                    dtype="bfloat16")
            label = fluid.layers.data(name="label", shape=[1],
                                      dtype="int64")
            pred = models.resnet_imagenet(img, class_dim=1000, depth=50)
            loss = fluid.layers.mean(fluid.layers.cross_entropy(
                input=pred, label=label))
            fluid.Momentum(learning_rate=0.01, momentum=0.9).minimize(loss)
        progs.append((main, startup))
    (jm, js), (tm, ts) = progs
    _assert_same_program(jm, tm)
    _assert_same_program(js, ts)
    types = [op.type for op in tm.global_block().ops]
    assert types.count("conv2d") == 53 and types.count("batch_norm") == 53
    assert tm.global_block().var(pred.name).shape == (-1, 1000)


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_resnet_imagenet_layouts_match_jax(fmt):
    """ResNet-18 at 64x64 in either data_format: the same Program."""
    progs = []
    for which in ("jax", "torch"):
        fluid, fw, models, _ = _pkg(which)
        fw.reset_unique_names()
        main, startup = fluid.Program(), fluid.Program()
        shape = [3, 64, 64] if fmt == "NCHW" else [64, 64, 3]
        with fluid.program_guard(main, startup):
            img = fluid.layers.data(name="img", shape=shape)
            models.resnet_imagenet(img, class_dim=10, depth=18,
                                   data_format=fmt)
        progs.append(main)
    _assert_same_program(*progs)


def test_remat_raises():
    """remat=True no longer raises: each residual block is a recompute
    segment (3 at depth 8), the JAX package's Program; 3 Momentum steps
    from the JAX startup give its losses (1e-5 relative) and every
    parameter, velocity and batch-norm running statistic (atol 1e-4),
    the statistics carried out of the segments."""
    (jm, js, *_), (tm, ts, *_) = _both("resnet_remat")
    _assert_same_program(jm, tm)
    assert sum(op.type == "recompute" for op in tm.global_block().ops) == 3
    jl, tl, names = _train_both("resnet_remat", 3)
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL, atol=0)
    stats = [n for n in names if n.endswith(".mean_0")]
    assert stats
    _assert_states_close(names)
    scope = tfluid.global_scope()
    assert all(np.abs(scope_to_numpy(scope, [n])[n]).max() > 0
               for n in stats)


# -- training parity ---------------------------------------------------------

def _train_both(model, steps, dtype="float32", opt="momentum",
                compiled=True):
    """`steps` steps in both packages from the JAX startup's parameters:
    the port in the mode asked for, the JAX package in its default
    (compiled) mode, the reference cells' -> (JAX losses, port losses,
    the persistable names)."""
    (jm, js, jl, _), (tm, ts, tl, _) = _both(model, dtype, opt)
    jexe, texe, names = _start_both(jm, js, tm, ts)
    jloss, tloss = [], []
    for feed in _feeds(model, steps, dtype):
        jloss.append(float(np.asarray(jexe.run(
            jm, feed=feed, fetch_list=[jl])[0], np.float32).reshape(-1)[0]))
        tloss.append(float(texe.run(tm, feed=feed, fetch_list=[tl],
                                    compiled=compiled)[0].reshape(-1)[0]))
    return jloss, tloss, names


def _assert_states_close(names):
    tvals = scope_to_numpy(tfluid.global_scope(), names)
    for n in names:
        np.testing.assert_allclose(
            tvals[n], np.asarray(jexecutor.global_scope().find_var(n)),
            rtol=0, atol=PARAM_ATOL, err_msg=n)


@pytest.mark.parametrize("compiled", [False, True],
                         ids=["interpreted", "compiled"])
@pytest.mark.parametrize("model", ["resnet", "vgg"])
def test_momentum_training_matches_jax(model, compiled):
    """3 Momentum steps from the JAX startup's parameters: losses, and
    every parameter, velocity and batch-norm running statistic."""
    jl, tl, names = _train_both(model, 3, compiled=compiled)
    assert np.all(np.isfinite(tl))
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL, atol=0)
    assert any(n.endswith(".mean_0") for n in names) or model == "digits"
    _assert_states_close(names)


def test_book_digits_conv_trains_with_adam_like_jax():
    jl, tl, names = _train_both("digits", 3, opt="adam")
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL, atol=0)
    _assert_states_close(names)


def _bf16_ulp(v):
    return 2.0 ** (np.floor(np.log2(abs(v))) - 7)


@pytest.mark.parametrize("mode", ["pure", "amp"])
def test_bf16_resnet_losses_match_jax(mode):
    """Pure bf16, as run_image runs ResNet-50, and bf16 amp: 2 steps."""
    dtype, guard = _bf16(mode)
    with guard:
        jl, tl, names = _train_both("resnet", 2, dtype)
    for j, t in zip(jl, tl):
        assert abs(t - j) <= LOSS_ULPS * _bf16_ulp(j), (tl, jl)
    want = torch.bfloat16 if mode == "pure" else torch.float32
    assert all(tfluid.global_scope().find_var(n).dtype == want
               for n in names if ".w_" in n)


def test_running_stats_update_as_paddle():
    """MeanOut = 0.9 old + 0.1 batch mean, with the biased batch
    variance, written back under the moving stats' names."""
    main, startup, loss, _ = _build("torch", "resnet")
    exe = tfluid.Executor(CPUPlace())
    exe.run(startup)
    scope = tfluid.global_scope()
    bn = next(op for op in main.global_block().ops
              if op.type == "batch_norm")
    mname, vname = bn.input("Mean")[0], bn.input("Variance")[0]
    m0 = scope.find_var(mname).clone()
    feed = _feeds("resnet", 1)[0]
    x_name = bn.input("X")[0]
    out = exe.run(main, feed=feed, fetch_list=[x_name], compiled=False)[0]
    x = torch.from_numpy(out).double()
    want_m = 0.9 * m0.double() + 0.1 * x.mean(dim=(0, 2, 3))
    want_v = 0.9 * 1.0 + 0.1 * x.var(dim=(0, 2, 3), unbiased=False)
    torch.testing.assert_close(scope.find_var(mname).double(), want_m,
                               rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(scope.find_var(vname).double(), want_v,
                               rtol=1e-5, atol=1e-6)


# -- dropout -----------------------------------------------------------------

def _dropout_program(p, shape, seed=0, is_test=False):
    tfw.reset_unique_names()
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="x", shape=shape, stop_gradient=False)
        w = tfluid.layers.create_parameter(
            [1], "float32", name="w",
            default_initializer=tfluid.initializer.ConstantInitializer(1.0))
        y = tfluid.layers.dropout(
            tfluid.layers.elementwise_mul(x, w, axis=0), dropout_prob=p,
            seed=seed, is_test=is_test)
        loss = tfluid.layers.mean(tfluid.layers.square(y))
        tfluid.backward.append_backward(loss)
    return main, startup, y, loss


def _run_dropout(p, shape, seed=0, is_test=False, n=128, runs=1):
    main, startup, y, loss = _dropout_program(p, shape, seed, is_test)
    exe = tfluid.Executor(CPUPlace(), seed=3)
    exe.run(startup)
    drop = next(op for op in main.global_block().ops
                if op.type == "dropout")
    grad = next(op for op in main.global_block().ops
                if op.type == "dropout_grad")
    x = np.random.RandomState(1).rand(n, *shape).astype(np.float32) + 0.5
    outs = []
    for _ in range(runs):
        outs.append(exe.run(main, feed={"x": x}, fetch_list=[
            y, drop.output("Mask")[0], grad.input("Out@GRAD")[0],
            grad.output("X@GRAD")[0]]))
    return x, outs


def test_dropout_keep_rate_and_gradient():
    p = 0.3
    x, [(out, mask, og, dx)] = _run_dropout(p, [1000], n=128)
    assert mask.size >= 10 ** 5 and set(np.unique(mask)) <= {0.0, 1.0}
    keep = float(mask.mean())
    sigma = np.sqrt(p * (1 - p) / mask.size)
    assert abs(keep - (1 - p)) <= 4 * sigma, keep
    # no 1/(1-p) upscale; the gradient is the cotangent times the mask
    np.testing.assert_array_equal(out, x * mask)
    np.testing.assert_array_equal(dx, og * mask)


def test_dropout_draws_anew_each_run_unless_seeded():
    _, runs = _run_dropout(0.5, [64], n=32, runs=2)
    assert not np.array_equal(runs[0][1], runs[1][1])
    _, runs = _run_dropout(0.5, [64], seed=7, n=32, runs=2)
    np.testing.assert_array_equal(runs[0][1], runs[1][1])


def test_dropout_test_mode_downgrades():
    x, [(out, mask, _, _)] = _run_dropout(0.3, [16], is_test=True, n=8)
    np.testing.assert_allclose(out, x * np.float32(0.7), rtol=1e-7)
    assert np.all(mask == 1.0)


def test_vgg16_bn_drop_program_matches_jax_and_trains():
    """The book's VGG-16 (dropout between convs and before the fc's) at
    the CIFAR-10 width: the same Program; on the CPU its default mode
    runs the dropout ops with the rest, and two steps (batch 2) from one
    state and one seed give the interpreter's bits."""
    progs = []
    for which in ("jax", "torch"):
        fluid, fw, models, _ = _pkg(which)
        fw.reset_unique_names()
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            img = fluid.layers.data(name="img", shape=[3, 32, 32])
            label = fluid.layers.data(name="label", shape=[1],
                                      dtype="int64")
            pred = models.vgg16_bn_drop(img, class_dim=10)
            loss = fluid.layers.mean(fluid.layers.cross_entropy(
                input=pred, label=label))
            fluid.Momentum(learning_rate=0.01, momentum=0.9).minimize(loss)
        progs.append((main, startup, loss))
    (jm, js, _), (tm, ts, tl) = progs
    _assert_same_program(jm, tm)
    _assert_same_program(js, ts)
    types = [op.type for op in tm.global_block().ops]
    assert types.count("dropout") == 10 and types.count("dropout_grad") == 10
    r = np.random.RandomState(0)
    feed = {"img": r.rand(2, 3, 32, 32).astype(np.float32),
            "label": r.randint(0, 10, (2, 1)).astype(np.int64)}
    losses = {}
    for compiled in (True, False):
        texecutor.switch_scope(Scope())
        exe = tfluid.Executor(CPUPlace(), seed=5)
        exe.run(ts)
        losses[compiled] = [float(exe.run(tm, feed=feed, fetch_list=[tl],
                                          compiled=compiled)[0][0])
                            for _ in range(2)]
    assert np.all(np.isfinite(losses[True]))
    assert losses[True] == losses[False]


# -- the weight carrier ------------------------------------------------------

def test_bf16_parameter_round_trips_bit_for_bit():
    """A JAX bf16 value (numpy dtype ml_dtypes.bfloat16) into the port's
    scope and back: the same bits."""
    import jax.numpy as jnp

    vals = np.random.RandomState(0).standard_normal((7, 5)) * 100
    a = np.asarray(jnp.asarray(vals, jnp.bfloat16))
    assert a.dtype.name == "bfloat16"
    scope = scope_from_numpy({"w": a, "ids": np.arange(4, dtype=np.int32)},
                             CPUPlace())
    t = scope.find_var("w")
    assert t.dtype == torch.bfloat16
    assert scope.find_var("ids").dtype == torch.int64
    back = scope_to_numpy(scope, ["w"])["w"]
    assert back.dtype == np.float32
    np.testing.assert_array_equal(back.astype(a.dtype).view(np.uint16),
                                  a.view(np.uint16))
    t.add_(1)       # the scope owns its memory: the array is untouched
    np.testing.assert_array_equal(np.asarray(a, np.float32),
                                  np.asarray(jnp.asarray(vals, jnp.bfloat16),
                                             np.float32))
