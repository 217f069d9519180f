"""The dense corpus's layer wrappers against the JAX package's: the
generated `layers/ops.py` wrappers (its full unary, binary and bool-out
lists), the `layers/nn.py` and `layers/tensor.py` additions.  Each
case builds one Program in both packages under reset unique names; the
Programs must be equal by `to_dict()` (ops, slots, attrs, var names,
shapes and dtypes, int64 read as int32), and the port's run of it must
fetch the JAX package's values (float32 within rtol 1e-5, atol 1e-6;
ints and bools exactly).
"""
import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu.core.framework as jfw
from paddle_tpu.layers import ops as jops

import paddle_tpu_torch as tfluid
import paddle_tpu_torch.core.framework as tfw
from paddle_tpu_torch import CPUPlace
from paddle_tpu_torch.core import executor as texecutor
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.core.scope import Scope
from paddle_tpu_torch.layers import ops as tops


@pytest.fixture(autouse=True)
def _fresh_port_state():
    old_main = tfw.switch_main_program(tfw.Program())
    old_startup = tfw.switch_startup_program(tfw.Program())
    old_scope = texecutor.switch_scope(Scope())
    tfw.reset_unique_names()
    tflags.reset_flags()
    yield
    tfw.switch_main_program(old_main)
    tfw.switch_startup_program(old_startup)
    texecutor.switch_scope(old_scope)
    tflags.reset_flags()


R = np.random.RandomState(0)
FEED = {"x": R.uniform(0.2, 2.0, (4, 6)).astype(np.float32),
        "y": R.uniform(-1.0, 1.0, (4, 6)).astype(np.float32),
        "v": R.uniform(-1.0, 1.0, (6,)).astype(np.float32),
        "z": R.standard_normal((2, 4, 6)).astype(np.float32),
        "w": R.standard_normal((2, 6, 3)).astype(np.float32),
        "ids": np.array([[1], [0], [3], [2]], np.int64),
        "bits": R.rand(4, 6) > 0.5, "bits2": R.rand(4, 6) > 0.5}

_SHAPES = {"x": ([6], "float32"), "y": ([6], "float32"),
           "v": ([6], "float32", False), "z": ([4, 6], "float32"),
           "w": ([6, 3], "float32"), "ids": ([1], "int64"),
           "bits": ([6], "bool"), "bits2": ([6], "bool")}


def _data(fluid, name):
    spec = _SHAPES[name]
    return fluid.layers.data(name=name, shape=spec[0], dtype=spec[1],
                             append_batch_size=len(spec) < 3)


def _unary(fluid, d):
    x = d("x")
    return [getattr(fluid.layers, t)(x) for t in tops._UNARY
            if t not in ("transpose", "reshape", "slice", "clip",
                         "clip_by_norm")] + [
        fluid.layers.transpose(x, axis=[1, 0]),
        fluid.layers.reshape(x, shape=[6, 4]),
        fluid.layers.slice(x, axes=[1], starts=[1], ends=[4]),
        fluid.layers.clip(x, min=0.5, max=1.5),
        fluid.layers.clip_by_norm(x, max_norm=1.0),
        fluid.layers.cumsum(x, axis=0, exclusive=True),
        fluid.layers.leaky_relu(d("y"), alpha=0.1)]


def _binary(fluid, d):
    x, y = d("x"), d("y")
    outs = [getattr(fluid.layers, t)(x, y) for t in tops._BINARY
            if not t.startswith("logical")]
    b1, b2 = d("bits"), d("bits2")
    outs += [getattr(fluid.layers, t)(b1, b2) for t in tops._BINARY
             if t.startswith("logical")]
    outs.append(fluid.layers.logical_not(b1))
    outs.append(fluid.layers.elementwise_min(x, d("v"), axis=1))
    return outs


def _matmul(fluid, d):
    z, w = d("z"), d("w")
    return [fluid.layers.matmul(z, w),
            fluid.layers.matmul(d("x"), d("y"), transpose_y=True),
            fluid.layers.matmul(z, d("v"))]


def _reductions(fluid, d):
    z = d("z")
    return [fluid.layers.reduce_mean(z), fluid.layers.reduce_mean(z, dim=1),
            fluid.layers.reduce_max(z, dim=[1, 2], keep_dim=True),
            fluid.layers.reduce_min(z, dim=-1),
            fluid.layers.reduce_sum(z, dim=0),
            fluid.layers.argmax(z, axis=1)]


def _split(fluid, d):
    z = d("z")
    return (fluid.layers.split(z, 2, dim=-1)
            + fluid.layers.split(z, [1, 3], dim=1))


def _norms_and_losses(fluid, d):
    x, y = d("x"), d("y")
    lbl = fluid.layers.cast(fluid.layers.greater_than(y, x), "float32")
    return [fluid.layers.l2_normalize(x, axis=1),
            fluid.layers.cos_sim(x, y),
            fluid.layers.sigmoid_cross_entropy_with_logits(y, lbl),
            fluid.layers.smooth_l1(x, y),
            fluid.layers.smooth_l1(x, y, inside_weight=x, outside_weight=x,
                                   sigma=2.0)]


def _index_ops(fluid, d):
    x, y, ids = d("x"), d("y"), d("ids")
    idx = fluid.layers.cast(
        fluid.layers.scale(fluid.layers.cast(ids, "float32"), scale=0.5),
        "int64")
    return [fluid.layers.one_hot(ids, depth=4),
            fluid.layers.multiplex([x, y, fluid.layers.exp(y)], idx)]


def _tensors(fluid, d):
    x = d("x")
    g = fluid.layers.create_global_var([2, 3], 1.5, "float32",
                                       persistable=True, name="g")
    t = fluid.layers.create_tensor("float32", name="t")
    fluid.layers.assign(x, output=t)
    c = fluid.layers.assign(np.arange(6, dtype=np.float32).reshape(2, 3))
    k = fluid.layers.assign(np.array([4, -1, 2], np.int32))
    inc = fluid.layers.increment(fluid.layers.fill_constant(
        [1], "float32", 2.0), value=3.0, in_place=False)
    return [g, t, c, k, inc, fluid.layers.ones([2, 2], "int64"),
            fluid.layers.zeros([3], "float32"), fluid.layers.zeros_like(x),
            fluid.layers.fill_constant_batch_size_like(x, [-1, 5], "float32",
                                                       0.25),
            fluid.layers.cast(x, "int32"),
            fluid.layers.elementwise_add(g, c)]


def _step_counter(fluid, d):
    d("x")
    return [fluid.layers.autoincreased_step_counter(begin=5, step=2),
            fluid.layers.autoincreased_step_counter(counter_name="@c@")]


BUILDERS = {f.__name__[1:]: f for f in (
    _unary, _binary, _matmul, _reductions, _split, _norms_and_losses,
    _index_ops, _tensors, _step_counter)}


def _build(fluid, fw, builder):
    fw.reset_unique_names()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        used = []

        def d(name):
            used.append(name)
            return _data(fluid, name)

        outs = builder(fluid, d)
    return main, startup, outs, {n: FEED[n] for n in used}


def _int_as_int32(d):
    for blk in d["blocks"]:
        for v in blk["vars"]:
            if v["dtype"] == "int64":
                v["dtype"] = "int32"
    return d


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_layers_build_and_run_as_the_jax_packages(name):
    jm, js, jouts, feed = _build(jfluid, jfw, BUILDERS[name])
    tm, ts, touts, _ = _build(tfluid, tfw, BUILDERS[name])
    assert _int_as_int32(tm.to_dict()) == _int_as_int32(jm.to_dict())
    assert _int_as_int32(ts.to_dict()) == _int_as_int32(js.to_dict())
    jexe, texe = jfluid.Executor(jfluid.CPUPlace()), tfluid.Executor(
        CPUPlace())
    jexe.run(js)
    texe.run(ts)
    for _ in range(2):      # the step counters move
        jv = jexe.run(jm, feed=dict(feed), fetch_list=jouts)
        tv = texe.run(tm, feed=dict(feed), fetch_list=touts)
    for o, a, b in zip(touts, tv, jv):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, o.name
        if np.issubdtype(b.dtype, np.floating):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6,
                                       err_msg=o.name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=o.name)


def test_generated_wrapper_lists_are_the_jax_packages():
    assert tops._UNARY == jops._UNARY and tops._BINARY == jops._BINARY
    assert tops._BOOL_OUT == jops._BOOL_OUT
    assert sorted(tops.__all__) == sorted(jops.__all__)
    for name in ("matmul", "reduce_mean", "reduce_max", "reduce_min",
                 "split", "l2_normalize", "one_hot", "cos_sim",
                 "sigmoid_cross_entropy_with_logits", "smooth_l1",
                 "multiplex", "autoincreased_step_counter", "create_tensor",
                 "create_global_var", "fill_constant_batch_size_like",
                 "ones", "zeros", "cast", "assign", "argmax", "increment",
                 "zeros_like"):
        assert hasattr(tfluid.layers, name), name
