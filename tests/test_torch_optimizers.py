"""The port's optimizers, update ops and learning-rate schedules against
the JAX package, on the CPU (ROADMAP A2).

  * the 12 update ops (sgd, momentum, adam, adamax, adagrad, adadelta,
    decayed_adagrad, rmsprop, ftrl, proximal_gd, proximal_adagrad,
    average_accumulates), each against its JAX lowering from the same
    seeded inputs, with a dense and a SelectedRows gradient (duplicate
    rows; average_accumulates takes no gradient), in float32 and in bf16
    storage, which both packages compute in float32 and store back;
  * the registration of the nine optimizer types and
    split_selected_rows, as the JAX package registers them;
  * each optimizer class's 20-step fit-a-line, Program dict and losses,
    the way tests/test_torch_training.py holds SGD; ModelAverage's
    apply/restore values; SGD driven by a decayed learning rate;
  * the five learning-rate schedules at steps 0, 5, 10 and 25, against
    the JAX package's and the closed forms.

Tolerances (tests/test_torch_training.py): op outputs atol 1e-6 in
float32, scaled by m = max(1, max|JAX output|) — FTRL's linear
accumulator reaches 30 here, where one float32 ulp is 2e-6 and the two
libraries' pow(x, 0.6) differ by an ulp or two before a division by the
learning rate; bf16 outputs bit-equal (both round the same float32
value); losses 1e-5 relative, parameters atol 1e-5, the accumulators
(sums of squared gradients reach 160) 1e-5 relative; schedules 1e-6.
"""
import os
import sys
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu.core.framework as jfw
from paddle_tpu.core import executor as jexecutor
from paddle_tpu.core import registry as jreg
from paddle_tpu.core.execution import ExecContext as JExecContext
from paddle_tpu.core.lod import SelectedRows as JSelectedRows

import paddle_tpu_torch as tfluid
import paddle_tpu_torch.core.framework as tfw
from paddle_tpu_torch import CPUPlace
from paddle_tpu_torch.core import executor as texecutor
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core.execution import ExecContext as TExecContext
from paddle_tpu_torch.core.lod import SelectedRows
from paddle_tpu_torch.core.scope import Scope, scope_to_numpy
from paddle_tpu_torch.ops.optimizer_ops import UPDATE_OPS

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_training import (  # noqa: E402
    _assert_losses_close, _assert_params_close, _assert_same_program,
    _line_batches, _start_both)

OP_ATOL, SCHEDULE_ATOL, ACC_RTOL = 1e-6, 1e-6, 1e-5
HEIGHT, DIM = 10, 4
IDS = np.array([1, 3, 1, 7, 2, 3, 1, 9], np.int64)
NEW_TYPES = ("adamax", "adagrad", "adadelta", "decayed_adagrad", "rmsprop",
             "ftrl", "proximal_gd", "proximal_adagrad", "average_accumulates",
             "split_selected_rows")


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


# -- the update ops ----------------------------------------------------------

# slot -> kind: "p" parameter, "g" gradient, "s" signed state, "+" positive
# state, "lr" learning rate, "b1"/"b2" beta powers (f32 [1]), "n" an int32
# counter [1]
_SLOTS = {
    "sgd": {"Param": "p", "Grad": "g", "LearningRate": "lr"},
    "momentum": {"Param": "p", "Grad": "g", "Velocity": "s",
                 "LearningRate": "lr"},
    "adam": {"Param": "p", "Grad": "g", "Moment1": "s", "Moment2": "+",
             "LearningRate": "lr", "Beta1Pow": "b1", "Beta2Pow": "b2"},
    "adamax": {"Param": "p", "Grad": "g", "Moment": "s", "InfNorm": "+",
               "LearningRate": "lr", "Beta1Pow": "b1"},
    "adagrad": {"Param": "p", "Grad": "g", "Moment": "+",
                "LearningRate": "lr"},
    "adadelta": {"Param": "p", "Grad": "g", "AvgSquaredGrad": "+",
                 "AvgSquaredUpdate": "+"},
    "decayed_adagrad": {"Param": "p", "Grad": "g", "Moment": "+",
                        "LearningRate": "lr"},
    "rmsprop": {"Param": "p", "Grad": "g", "MeanSquare": "+", "Moment": "s",
                "LearningRate": "lr"},
    "ftrl": {"Param": "p", "SquaredAccumulator": "+",
             "LinearAccumulator": "s", "Grad": "g", "LearningRate": "lr"},
    "proximal_gd": {"Param": "p", "Grad": "g", "LearningRate": "lr"},
    "proximal_adagrad": {"Param": "p", "Moment": "+", "Grad": "g",
                         "LearningRate": "lr"},
    "average_accumulates": {"Param": "p", "InSum1": "s", "InSum2": "s",
                            "InSum3": "s", "InNumAccumulates": "n",
                            "InOldNumAccumulates": "n",
                            "InNumUpdates": "n"},
}
_ATTRS = {
    "momentum": [{}, {"mu": 0.8, "use_nesterov": True}],
    "rmsprop": [{}, {"momentum": 0.9, "epsilon": 1e-6}],
    "ftrl": [{}, {"l1": 0.05, "l2": 0.1, "lr_power": -0.6}],
    "proximal_gd": [{"l1": 0.05, "l2": 0.1}],
    "proximal_adagrad": [{"l1": 0.05, "l2": 0.1}],
    # the first rolls its window into sum_3, the second does not
    "average_accumulates": [
        {"average_window": 0.5, "min_average_window": 2,
         "max_average_window": 4},
        {"average_window": 0.15, "min_average_window": 10000,
         "max_average_window": 10000}],
}
_COUNTERS = {"InNumAccumulates": 3, "InOldNumAccumulates": 2,
             "InNumUpdates": 5}


def _cases():
    for op in UPDATE_OPS:
        grads = ("dense",) if op == "average_accumulates" \
            else ("dense", "sparse")
        for i, attrs in enumerate(_ATTRS.get(op, [{}])):
            for grad in grads:
                for dtype in ("float32", "bfloat16"):
                    yield pytest.param(op, attrs, grad, dtype,
                                       id=f"{op}-{i}-{grad}-{dtype}")


def _inputs(op, grad, dtype):
    """{slot: (port value, JAX value)} from seeded numpy draws; floats
    stored in `dtype` but the learning rate and beta powers (f32, as the
    optimizers keep them)."""
    r = np.random.RandomState(zlib.crc32(op.encode()))
    tdt, jdt = getattr(torch, dtype), jnp.dtype(dtype)
    out = {}
    for slot, kind in _SLOTS[op].items():
        if kind == "lr":
            v = np.array([0.05], np.float32)
            out[slot] = (torch.as_tensor(v), jnp.asarray(v))
        elif kind in ("b1", "b2"):
            v = np.array([(0.9 if kind == "b1" else 0.999) ** 3], np.float32)
            out[slot] = (torch.as_tensor(v), jnp.asarray(v))
        elif kind == "n":
            v = np.array([_COUNTERS[slot]], np.int32)
            out[slot] = (torch.as_tensor(v), jnp.asarray(v))
        elif kind == "g" and grad == "sparse":
            v = r.standard_normal((len(IDS), DIM)).astype(np.float32)
            out[slot] = (
                SelectedRows(torch.as_tensor(IDS),
                             torch.as_tensor(v).to(tdt), HEIGHT),
                JSelectedRows(jnp.asarray(IDS, jnp.int32),
                              jnp.asarray(v).astype(jdt), HEIGHT))
        else:
            if kind == "+":
                v = r.uniform(0.5, 1.5, (HEIGHT, DIM)).astype(np.float32)
            else:
                v = r.standard_normal((HEIGHT, DIM)).astype(np.float32)
            if kind == "s" and op == "average_accumulates":
                out[slot] = (torch.as_tensor(v), jnp.asarray(v))  # f32 sums
                continue
            out[slot] = (torch.as_tensor(v).to(tdt),
                         jnp.asarray(v).astype(jdt))
    return out


def _as_np(v):
    if isinstance(v, torch.Tensor):
        return v.float().numpy() if v.is_floating_point() else v.numpy()
    return np.asarray(jnp.asarray(v).astype(jnp.float32)) \
        if jnp.issubdtype(jnp.asarray(v).dtype, jnp.floating) \
        else np.asarray(v)


@pytest.mark.parametrize("op,attrs,grad,dtype", list(_cases()))
def test_update_op_matches_its_jax_lowering(op, attrs, grad, dtype):
    ins = _inputs(op, grad, dtype)
    tinfo, jinfo = treg.get_op_info(op), jreg.get_op_info(op)
    t = tinfo.lower(TExecContext("cpu"), {s: [v[0]] for s, v in ins.items()},
                    {**tinfo.attrs, **attrs})
    j = jinfo.lower(JExecContext(), {s: [v[1]] for s, v in ins.items()},
                    {**jinfo.attrs, **attrs})
    assert set(t) == set(j) == set(tinfo.outputs)
    for slot in tinfo.outputs:
        tv, jv = t[slot], j[slot]
        src = ins[tinfo.inplace[slot]][0]
        assert tv.dtype == src.dtype, slot     # stored back in its dtype
        assert tuple(tv.shape) == tuple(jv.shape), slot
        if dtype == "bfloat16" or not tv.is_floating_point():
            np.testing.assert_array_equal(_as_np(tv), _as_np(jv),
                                          err_msg=slot)
        else:
            m = max(1.0, float(np.max(np.abs(_as_np(jv)))))
            np.testing.assert_allclose(_as_np(tv), _as_np(jv), rtol=0,
                                       atol=OP_ATOL * m, err_msg=slot)
    if op == "sgd" and grad == "sparse":     # only the named rows move
        untouched = sorted(set(range(HEIGHT)) - set(IDS.tolist()))
        assert torch.equal(t["ParamOut"][untouched],
                           ins["Param"][0][untouched])


@pytest.mark.parametrize("op", NEW_TYPES)
def test_registration_matches_the_jax_package(op):
    j, t = jreg.get_op_info(op), treg.get_op_info(op)
    for field in ("inputs", "outputs", "dup_inputs", "dup_outputs",
                  "attrs", "inplace", "random", "not_differentiable",
                  "host", "diff_inputs", "diff_outputs"):
        assert getattr(t, field) == getattr(j, field), field
    assert t.sparse == (op != "average_accumulates")


def test_the_update_ops_are_all_wrapped_in_f32():
    """_in_f32 runs over every update op (a bf16 Param computes in f32)."""
    assert len(UPDATE_OPS) == 12
    for op in UPDATE_OPS:
        lower = treg.get_op_info(op).lower
        assert lower.__wrapped__.__name__ == op, op


# -- optimizer classes: fit-a-line -------------------------------------------

def _make_optimizer(fluid, kind):
    return {
        "adagrad": lambda: fluid.Adagrad(learning_rate=0.1),
        "adamax": lambda: fluid.Adamax(learning_rate=0.05),
        "decayed_adagrad": lambda: fluid.DecayedAdagrad(learning_rate=0.05),
        "adadelta": lambda: fluid.Adadelta(rho=0.9, epsilon=1e-4),
        "rmsprop": lambda: fluid.RMSProp(learning_rate=0.01, momentum=0.5),
        "ftrl": lambda: fluid.Ftrl(learning_rate=0.1, l1=1e-3, l2=1e-3),
        "model_average": lambda: fluid.SGD(learning_rate=0.01),
        "sgd_decay": lambda: fluid.SGD(
            learning_rate=fluid.learning_rate_decay.exponential_decay(
                learning_rate=0.05, global_step=(
                    fluid.layers.autoincreased_step_counter()),
                decay_steps=5, decay_rate=0.5)),
    }[kind]()


def _fit_a_line(fluid, fw, kind):
    fw.reset_unique_names()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[13], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        pred = fluid.layers.fc(input=x, size=1)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
        _make_optimizer(fluid, kind).minimize(loss)
        avg = None
        if kind == "model_average":
            avg = fluid.optimizer.ModelAverage(
                average_window_rate=0.5, min_average_window=3,
                max_average_window=6)
    return main, startup, loss, avg


FIT_KINDS = ["adagrad", "adamax", "decayed_adagrad", "adadelta", "rmsprop",
             "ftrl", "model_average", "sgd_decay"]


@pytest.mark.parametrize("kind", FIT_KINDS)
def test_fit_a_line_program_matches_jax(kind):
    jm, js, _, _ = _fit_a_line(jfluid, jfw, kind)
    tm, ts, _, _ = _fit_a_line(tfluid, tfw, kind)
    _assert_same_program(jm, tm)
    _assert_same_program(js, ts)
    assert tfw.Program.from_dict(jm.to_dict()).to_dict() == jm.to_dict()


@pytest.mark.parametrize("kind", FIT_KINDS)
def test_fit_a_line_trains_like_jax(kind):
    """20 steps from the JAX startup's parameters: losses and every
    persistable (accumulators, window sums and counters included)."""
    jm, js, jl, javg = _fit_a_line(jfluid, jfw, kind)
    tm, ts, tl, tavg = _fit_a_line(tfluid, tfw, kind)
    jexe, texe, names = _start_both(jm, js, tm, ts)
    jloss, tloss = [], []
    for feed in _line_batches(20):
        jloss.append(jexe.run(jm, feed=feed, fetch_list=[jl])[0][0])
        tloss.append(texe.run(tm, feed=feed, fetch_list=[tl])[0][0])
    _assert_losses_close(jloss, tloss)
    assert tloss[-1] < tloss[0]
    params = {p.name for p in tm.global_block().all_parameters()}
    _assert_params_close(sorted(params))
    accs = [n for n in names if n not in params]
    got = scope_to_numpy(tfluid.global_scope(), accs)
    for n in accs:
        np.testing.assert_allclose(
            got[n], np.asarray(jexecutor.global_scope().find_var(n)),
            rtol=ACC_RTOL, atol=0, err_msg=n)
    if kind == "model_average":
        _check_model_average(javg, tavg, jexe, texe)


def _check_model_average(javg, tavg, jexe, texe):
    """apply(): every parameter the JAX package's window average (atol
    1e-5); restore(): the trained values back, bit for bit."""
    jscope, tscope = jexecutor.global_scope(), tfluid.global_scope()
    params = [p.name for p in tavg._params]
    assert params == [p.name for p in javg._params] and params
    trained = scope_to_numpy(tscope, params)
    with javg.apply(jexe), tavg.apply(texe):
        for n in params:
            got = scope_to_numpy(tscope, [n])[n]
            want = np.asarray(jscope.find_var(n))
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5,
                                       err_msg=n)
            assert not np.allclose(got, trained[n], rtol=0, atol=1e-7), n
    for n in params:
        np.testing.assert_array_equal(scope_to_numpy(tscope, [n])[n],
                                      trained[n])


# -- learning-rate schedules -------------------------------------------------

_SCHEDULES = {
    "exponential": (lambda m, s: m.exponential_decay(
        learning_rate=0.1, global_step=s, decay_steps=10, decay_rate=0.5),
        lambda s: 0.1 * 0.5 ** (s / 10)),
    "exponential_staircase": (lambda m, s: m.exponential_decay(
        learning_rate=0.1, global_step=s, decay_steps=10, decay_rate=0.5,
        staircase=True), lambda s: 0.1 * 0.5 ** (s // 10)),
    "natural_exp": (lambda m, s: m.natural_exp_decay(
        learning_rate=0.1, global_step=s, decay_steps=10, decay_rate=0.5),
        lambda s: 0.1 * np.exp(-0.5 * s / 10)),
    "inverse_time": (lambda m, s: m.inverse_time_decay(
        learning_rate=0.1, global_step=s, decay_steps=10, decay_rate=0.5),
        lambda s: 0.1 / (1 + 0.5 * s / 10)),
    "polynomial": (lambda m, s: m.polynomial_decay(
        learning_rate=0.1, global_step=s, decay_steps=10,
        end_learning_rate=0.01, power=2.0),
        lambda s: 0.09 * (1 - min(s, 10) / 10) ** 2 + 0.01),
    "polynomial_cycle": (lambda m, s: m.polynomial_decay(
        learning_rate=0.1, global_step=s, decay_steps=10,
        end_learning_rate=0.01, power=2.0, cycle=True),
        lambda s: 0.09 * (1 - s / (10 * max(1, np.ceil(s / 10)))) ** 2
        + 0.01),
    "piecewise": (lambda m, s: m.piecewise_decay(
        global_step=s, boundaries=[5, 10], values=[0.1, 0.05, 0.01]),
        lambda s: 0.1 if s < 5 else 0.05 if s < 10 else 0.01),
}


def _schedule(fluid, fw, name):
    fw.reset_unique_names()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        step = fluid.layers.data(name="step", shape=[1], dtype="int64")
        lr = _SCHEDULES[name][0](fluid.learning_rate_decay, step)
    return main, startup, lr


@pytest.mark.parametrize("name", sorted(_SCHEDULES))
def test_lr_schedule_matches_jax(name):
    jm, js, jlr = _schedule(jfluid, jfw, name)
    tm, ts, tlr = _schedule(tfluid, tfw, name)
    _assert_same_program(jm, tm)
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(js)
    texe = tfluid.Executor(CPUPlace())
    texe.run(ts)
    for s in (0, 5, 10, 25):
        feed = {"step": np.asarray([s], np.int64)}
        t = float(texe.run(tm, feed=feed, fetch_list=[tlr])[0][0])
        j = float(jexe.run(jm, feed=feed, fetch_list=[jlr])[0][0])
        assert abs(t - j) < SCHEDULE_ATOL, (s, t, j)
        assert abs(t - _SCHEDULES[name][1](s)) < SCHEDULE_ATOL, (s, t)
