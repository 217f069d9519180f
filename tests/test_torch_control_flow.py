"""The control-flow slice (ops/control_flow.py, layers/control_flow.py)
in the port against the JAX package, on the CPU, from the same numpy
inputs and the JAX startup's parameters.

The JAX package's tests/test_control_flow.py (While over tensor arrays,
StaticRNN, DynamicRNN, rank tables, beam search, conditional_block),
tests/test_ifelse.py (split/merge and IfElse) and tests/test_parallel_do.py
run here in both packages, their Programs equal op for op; and beyond
them:

  * the generic gradients of `dynamic_rnn` and of the StaticRNN's
    `recurrent` form (autograd through the Python loop over time) against
    the JAX package's, which is `jax.vjp` of its `lax.scan`, at 1e-5;
  * beam_search on beam_search_op.h's documented example, ids and LoDs
    exact; beam_search_decode on a hand-built three-step array whose
    ended prefixes finish early;
  * a Switch, IfElse's gradient, the rank-table ops' round trip;
  * a `dynamic_rnn` under two LoDs in the interpreter, compiled and
    segmented modes: equal bit for bit, each LoD a cache entry of its
    own; a host op at any depth of nesting makes the outer op a host op.

Forward values are held to the JAX package at 1e-6 relative plus 1e-6
absolute (outputs of order one, a tanh's or a softmax's, carry a few
ulps of 1.0, 1.2e-7 each, from the two libraries' summation orders: a
StaticRNN's fc + tanh over 4 steps differs by 1.8e-7 at an element of
0.023), gradients and losses at 1e-5 relative plus 1e-6.
"""
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as jfluid
import paddle_tpu.core.framework as jfw
from paddle_tpu.core import executor as jexecutor
from paddle_tpu.core import registry as jreg
from paddle_tpu.core.execution import ExecContext as JExecContext
from paddle_tpu.core.lod import LoDTensor as JLoDTensor
from paddle_tpu.core.lod import TensorArray as JTensorArray

import paddle_tpu_torch as tfluid
import paddle_tpu_torch.core.framework as tfw
from paddle_tpu_torch import CPUPlace
from paddle_tpu_torch.core import executor as texecutor
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core.execution import ExecContext as TExecContext
from paddle_tpu_torch.core.lod import LoDTensor, TensorArray
from paddle_tpu_torch.core.scope import Scope, scope_from_numpy

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_op_test import (check_finite_differences,  # noqa: E402
                                check_jax, check_numpy, fd_cases,
                                forward_cases)
from test_torch_training import (_assert_same_program,  # noqa: E402
                                 _start_both)
from torch_op_cases import cases_of  # noqa: E402

FWD_RTOL, FWD_ATOL = 1e-6, 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-6


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


# -- plumbing ----------------------------------------------------------------

def _np(v):
    """A fetched value of either package as numpy (a LoDTensor's data)."""
    if isinstance(v, (LoDTensor, JLoDTensor)):
        v = v.data
    return np.asarray(v)


def _lod(v):
    return tuple(tuple(lv) for lv in v.lod) \
        if isinstance(v, (LoDTensor, JLoDTensor)) else None


def _feed(fluid, feed):
    """A feed dict for `fluid`: (array, lod) pairs become its LoDTensor."""
    cls = LoDTensor if fluid is tfluid else JLoDTensor
    return {k: cls(v[0], v[1]) if isinstance(v, tuple) else v
            for k, v in feed.items()}


def _both(build, feeds, fetch_of, mode="default", start=True):
    """Build `build(fluid)` in each package (Programs equal), run the
    startups (the JAX parameters copied into the port), then every feed
    of `feeds` in both -> (JAX results, port results), one list of
    fetched values a feed.  `mode`: "default" (each package's default
    mode), "interpreted", or "segment"."""
    progs = {}
    for fluid, fw in ((jfluid, jfw), (tfluid, tfw)):
        fw.reset_unique_names()
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            out = build(fluid)
        progs[fluid] = (main, startup, out)
    (jm, js, jo), (tm, ts, to) = progs[jfluid], progs[tfluid]
    _assert_same_program(jm, tm)
    if start:
        jexe, texe, _ = _start_both(jm, js, tm, ts)
    else:
        jexe, texe = jfluid.Executor(jfluid.CPUPlace()), \
            tfluid.Executor(CPUPlace())
    compiled = False if mode == "interpreted" else None
    res = {jfluid: [], tfluid: []}
    for feed in feeds:
        for fluid, exe, main, outs in ((jfluid, jexe, jm, jo),
                                       (tfluid, texe, tm, to)):
            flag = tflags if fluid is tfluid else None
            if mode == "segment" and flag is not None:
                flag.set_flags({"jit_granularity": "segment"})
            res[fluid].append(exe.run(main, feed=_feed(fluid, feed),
                                      fetch_list=fetch_of(outs),
                                      compiled=compiled))
            if flag is not None:
                flag.reset_flags()
    return res[jfluid], res[tfluid]


def _close(t, j, rtol=FWD_RTOL, atol=FWD_ATOL, what=""):
    assert _lod(t) == _lod(j), (what, _lod(t), _lod(j))
    a, b = _np(t), _np(j)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    if np.issubdtype(b.dtype, np.floating):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=what)
    else:
        np.testing.assert_array_equal(a.astype(np.int64), b.astype(np.int64),
                                      err_msg=what)


# -- tests/test_control_flow.py ------------------------------------------------

def _while_with_arrays(fluid):
    limit = fluid.layers.fill_constant(shape=[1], dtype="int64", value=10)
    counter = fluid.layers.zeros(shape=[1], dtype="int64")
    total = fluid.layers.zeros(shape=[1], dtype="float32")
    arr = fluid.layers.create_array("float32")
    cond = fluid.layers.less_than(x=counter, y=limit)
    w = fluid.layers.While(cond=cond)
    with w.block():
        val = fluid.layers.cast(counter, "float32")
        new_total = fluid.layers.elementwise_add(total, val)
        fluid.layers.assign(new_total, output=total)
        fluid.layers.array_write(val, i=counter, array=arr)
        fluid.layers.increment(x=counter, value=1, in_place=True)
        fluid.layers.less_than(x=counter, y=limit, cond=cond)
    length = fluid.layers.array_length(arr)
    last = fluid.layers.array_read(arr, i=fluid.layers.fill_constant(
        shape=[1], dtype="int64", value=9))
    return [total, length, last]


@pytest.mark.parametrize("mode", ["default", "interpreted"])
def test_while_with_arrays(mode):
    """The sum over i = 0..9 by a While loop writing a tensor array."""
    (j,), (t,) = _both(_while_with_arrays, [{}], lambda o: o, mode)
    for a, b in zip(t, j):
        _close(a, b)
    assert float(t[0][0]) == sum(range(10))
    assert int(t[1][0]) == 10 and float(t[2][0]) == 9.0


def _static_rnn(fluid, T=5, B=3, D=4, fc=False, H=6):
    x = fluid.layers.data(name="x", shape=[B, D], dtype="float32")
    x.shape = (T, B, D)     # a static time-major input
    x.stop_gradient = False
    rnn = fluid.layers.StaticRNN()
    with rnn.step():
        xt = rnn.step_input(x)
        if fc:
            h = rnn.memory(shape=[B, H], value=0.0)
            nh = fluid.layers.fc(input=[xt, h], size=H, act="tanh",
                                 bias_attr=False)
        else:
            h = rnn.memory(shape=[B, D], value=0.0)
            nh = fluid.layers.tanh(fluid.layers.elementwise_add(xt, h))
        rnn.update_memory(h, nh)
        rnn.output(nh)
    return [rnn()]


def test_static_rnn_matches_numpy():
    """h_t = tanh(x_t + h_{t-1}) against numpy and the JAX package."""
    T, B, D = 5, 3, 4
    xin = np.random.RandomState(0).randn(T, B, D).astype(np.float32)
    (j,), (t,) = _both(_static_rnn, [{"x": xin}], lambda o: o)
    h, want = np.zeros((B, D), np.float32), []
    for step in range(T):
        h = np.tanh(xin[step] + h)
        want.append(h)
    np.testing.assert_allclose(t[0], np.stack(want), rtol=1e-5, atol=1e-5)
    _close(t[0], j[0])


def test_static_rnn_with_fc():
    """An fc inside a StaticRNN sizes its weights from the feature dim:
    [T, B, H] out, the JAX package's values."""
    xin = np.random.RandomState(4).randn(4, 3, 5).astype(np.float32)
    (j,), (t,) = _both(lambda f: _static_rnn(f, T=4, B=3, D=5, fc=True),
                       [{"x": xin}], lambda o: o)
    assert t[0].shape == (4, 3, 6)
    _close(t[0], j[0])


def _dyn_rnn_train(fluid, D=3, H=4):
    x = fluid.layers.data(name="x", shape=[D], dtype="float32", lod_level=1)
    rnn = fluid.layers.DynamicRNN()
    with rnn.block():
        xt = rnn.step_input(x)
        h = rnn.memory(shape=[H], value=0.0)
        nh = fluid.layers.fc(input=[xt, h], size=H, act="tanh",
                             bias_attr=False)
        rnn.update_memory(h, nh)
        rnn.output(nh)
    out = rnn()
    pooled = fluid.layers.sequence_pool(out, pool_type="last")
    loss = fluid.layers.mean(pooled)
    fluid.SGD(learning_rate=0.1).minimize(loss)
    return [loss, out]


def test_dynamic_rnn_grad_flows():
    """21 SGD steps through a DynamicRNN over a ragged batch: the JAX
    package's losses, the output's shape and LoD, and a falling loss."""
    xin = np.random.RandomState(1).randn(6, 3).astype(np.float32)
    feed = {"x": (xin, [[0, 3, 4, 6]])}
    j, t = _both(_dyn_rnn_train, [feed] * 21, lambda o: o)
    assert t[0][1].data.shape == (6, 4) and t[0][1].lod == ((0, 3, 4, 6),)
    _close(t[0][1], j[0][1])
    tl = [float(r[0].reshape(-1)[0]) for r in t]
    jl = [float(np.asarray(r[0]).reshape(-1)[0]) for r in j]
    np.testing.assert_allclose(tl, jl, rtol=GRAD_RTOL, atol=GRAD_ATOL)
    assert tl[-1] < tl[0]


def _dyn_rnn_forward(fluid, D=3):
    x = fluid.layers.data(name="x", shape=[D], dtype="float32", lod_level=1)
    rnn = fluid.layers.DynamicRNN()
    with rnn.block():
        xt = rnn.step_input(x)
        h = rnn.memory(shape=[D], value=0.0)
        nh = fluid.layers.tanh(fluid.layers.elementwise_add(xt, h))
        rnn.update_memory(h, nh)
        rnn.output(nh)
    return [rnn()]


def test_dynamic_rnn_forward_numeric():
    """h_t = tanh(x_t + h) per sequence against numpy and the JAX
    package; the output keeps the input's LoD."""
    lod = [0, 2, 6, 7]
    xin = np.random.RandomState(2).randn(7, 3).astype(np.float32)
    (j,), (t,) = _both(_dyn_rnn_forward, [{"x": (xin, [lod])}],
                       lambda o: o, start=False)
    want = np.zeros_like(xin)
    for s in range(3):
        h = np.zeros((3,), np.float32)
        for r in range(lod[s], lod[s + 1]):
            h = np.tanh(xin[r] + h)
            want[r] = h
    np.testing.assert_allclose(t[0].data, want, rtol=1e-5, atol=1e-5)
    assert t[0].lod == (tuple(lod),)
    _close(t[0], j[0])


def _rank_table(fluid):
    x = fluid.layers.data(name="x", shape=[1], dtype="float32", lod_level=1)
    table = fluid.layers.lod_rank_table(x)
    mx = fluid.layers.max_sequence_len(table)
    reordered = fluid.layers.reorder_lod_tensor_by_rank(x, table)
    arr = fluid.layers.lod_tensor_to_array(x, table)
    back = fluid.layers.array_to_lod_tensor(arr, table)
    i = fluid.layers.fill_constant(shape=[1], dtype="int64", value=1)
    mem = fluid.layers.fill_constant(shape=[3, 2], dtype="float32",
                                     value=0.5)
    shrunk = fluid.layers.shrink_memory(mem, i, table)
    return [mx, reordered, back, shrunk, fluid.layers.array_length(arr)]


def test_lod_rank_table_and_reorder():
    """The rank table orders sequences by length (lens 1, 3, 2 -> 1, 2,
    0); reorder, max_sequence_len, the lod_tensor_to_array /
    array_to_lod_tensor round trip and shrink_memory as the JAX
    package's."""
    data = np.arange(6, dtype=np.float32).reshape(6, 1)
    (j,), (t,) = _both(_rank_table, [{"x": (data, [[0, 1, 4, 6]])}],
                       lambda o: o, start=False)
    assert int(t[0][0]) == 3
    np.testing.assert_array_equal(t[1].data.reshape(-1), [1, 2, 3, 4, 5, 0])
    assert t[1].lod == ((0, 3, 5, 6),)
    np.testing.assert_array_equal(t[2].data, data)
    assert t[2].lod == ((0, 1, 4, 6),)
    assert t[3].shape == (2, 2) and int(t[4][0]) == 3
    for a, b in zip(t, j):
        _close(a, b)


def _beam_step(fluid):
    pre_ids = fluid.layers.data(name="pre_ids", shape=[1], dtype="int64",
                                lod_level=2)
    ids = fluid.layers.data(name="ids", shape=[3], dtype="int64",
                            lod_level=2)
    scores = fluid.layers.data(name="scores", shape=[3], dtype="float32",
                               lod_level=2)
    return list(fluid.layers.beam_search(pre_ids, ids, scores, beam_size=2,
                                         end_id=0, level=0))


def test_beam_search_step():
    """beam_search_op.h's documented example (test_control_flow.py:170):
    source 0 keeps (4, .5), (2, .3) on its one prefix; source 1 (2, .6)
    on row 1 and (3, .9) on row 2; each prefix's picks by (row, id)."""
    lod = [[0, 1, 3], [0, 1, 2, 3]]
    feed = {"pre_ids": (np.array([[1], [2], [3]], np.int64), lod),
            "ids": (np.array([[4, 2, 5], [2, 1, 3], [3, 5, 2]], np.int64),
                    lod),
            "scores": (np.array([[0.5, 0.3, 0.2], [0.6, 0.3, 0.1],
                                 [0.9, 0.5, 0.1]], np.float32), lod)}
    (j,), (t,) = _both(_beam_step, [feed], lambda o: o, start=False)
    np.testing.assert_array_equal(t[0].data.reshape(-1), [2, 4, 2, 3])
    assert t[0].data.dtype == np.int64
    np.testing.assert_allclose(t[1].data.reshape(-1), [0.3, 0.5, 0.6, 0.9])
    assert t[0].lod == t[1].lod == ((0, 1, 3), (0, 2, 3, 4))
    for a, b in zip(t, j):
        _close(a, b, rtol=0, atol=0)


def _conditional_block(fluid):
    x = fluid.layers.data(name="x", shape=[1], dtype="float32")
    out = fluid.layers.zeros(shape=[1], dtype="float32")
    cond = fluid.layers.fill_constant(shape=[1], dtype="bool", value=True)
    program = fluid.default_main_program()
    parent = program.current_block
    sub = program.create_block()
    fluid.layers.assign(fluid.layers.scale(x, scale=2.0), output=out)
    program.rollback()
    parent.append_op("conditional_block",
                     {"X": [cond.name], "Params": []}, {"Out": []},
                     {"sub_block": {"__block__": sub.idx},
                      "is_scalar_condition": True})
    return [out]


def test_conditional_block():
    (j,), (t,) = _both(_conditional_block,
                       [{"x": np.asarray([3.0], np.float32)}], lambda o: o,
                       start=False)
    assert float(t[0][0]) == 6.0
    _close(t[0], j[0])


# -- tests/test_ifelse.py ------------------------------------------------------

@pytest.mark.parametrize("case", forward_cases(cases_of("control_flow")),
                         ids=str)
def test_split_merge_forward_matches_numpy(case):
    """The split/merge ops and their gradient ops (test_ifelse.py's
    OpTest cases, dense and LoD) against numpy."""
    check_numpy(case)


@pytest.mark.parametrize("case", fd_cases(cases_of("control_flow")),
                         ids=str)
def test_split_merge_gradient_matches_finite_differences(case):
    check_finite_differences(case)


@pytest.mark.parametrize("case", cases_of("control_flow"), ids=str)
def test_split_merge_match_the_jax_lowering(case):
    check_jax(case)


def _split_merge(fluid):
    x = fluid.layers.data(name="x", shape=[2], dtype="float32", lod_level=1)
    m = fluid.layers.data(name="m", shape=[1], dtype="bool")
    t, f = fluid.layers.split_lod_tensor(x, m)
    return [t, f, fluid.layers.merge_lod_tensor(t, f, x, m)]


def test_split_lod_sequences_roundtrip():
    """The mask selects whole sequences; merge restores the order."""
    data = np.arange(14, dtype=np.float32).reshape(7, 2)
    feed = {"x": (data, [(0, 3, 5, 7)]),
            "m": np.array([[1], [0], [1]], dtype=bool)}
    (j,), (t,) = _both(_split_merge, [feed], lambda o: o, start=False)
    np.testing.assert_array_equal(t[0].data, data[[0, 1, 2, 5, 6]])
    np.testing.assert_array_equal(t[1].data, data[[3, 4]])
    np.testing.assert_array_equal(t[2].data, data)
    for a, b in zip(t, j):
        _close(a, b, rtol=0, atol=0)


def _ifelse(fluid, with_fc=False, single=False):
    x = fluid.layers.data(name="x", shape=[4], dtype="float32")
    sel = fluid.layers.data(name="sel", shape=[1], dtype="bool")
    ie = fluid.layers.IfElse(sel)
    with ie.true_block():
        xt = ie.input(x)
        xt.shape = (-1, 4)      # a split's rows are known at run time
        ie.output(fluid.layers.fc(input=xt, size=3) if with_fc
                  else fluid.layers.scale(xt, scale=2.0))
    if not single:
        with ie.false_block():
            xf = ie.input(x)
            xf.shape = (-1, 4)
            ie.output(fluid.layers.fc(input=xf, size=3, act="tanh")
                      if with_fc else fluid.layers.scale(xf, scale=-1.0))
    out = ie()[0]
    if not with_fc:
        return [out]
    loss = fluid.layers.mean(out)
    fluid.SGD(learning_rate=0.1).minimize(loss)
    grads = [n + "@GRAD" for n in ("fc_0.w_0", "fc_0.b_0", "fc_1.w_0",
                                   "fc_1.b_0")]
    return [loss, out] + grads


def test_ifelse_forward_and_training():
    """Rows with sel go through one branch, the others through the
    other; the merged result is the JAX package's."""
    rng = np.random.RandomState(42)
    xv = rng.rand(8, 4).astype(np.float32)
    selv = xv[:, :1] > 0.5
    (j,), (t,) = _both(_ifelse, [{"x": xv, "sel": selv}], lambda o: o,
                       start=False)
    np.testing.assert_allclose(t[0], np.where(selv, xv * 2.0, -xv),
                               rtol=1e-6)
    _close(t[0], j[0])


def test_ifelse_gradient_matches_jax():
    """IfElse with an fc in each branch: 3 SGD steps, the losses, the
    merged outputs and every parameter gradient (through
    merge_lod_tensor_grad and split_lod_tensor_grad) as the JAX
    package's."""
    rng = np.random.RandomState(7)
    feeds = []
    for _ in range(3):
        xv = rng.rand(8, 4).astype(np.float32)
        feeds.append({"x": xv, "sel": xv[:, :1] > 0.5})
    j, t = _both(lambda f: _ifelse(f, with_fc=True), feeds, lambda o: o)
    for jr, tr in zip(j, t):
        for a, b in zip(tr, jr):
            _close(a, b, GRAD_RTOL, GRAD_ATOL)


def test_ifelse_single_branch():
    xv = np.arange(8, dtype=np.float32).reshape(2, 4)
    selv = np.array([[1], [0]], dtype=bool)
    (j,), (t,) = _both(lambda f: _ifelse(f, single=True),
                       [{"x": xv, "sel": selv}], lambda o: o, start=False)
    np.testing.assert_allclose(t[0], xv[[0]] * 2.0)
    _close(t[0], j[0])


# -- tests/test_parallel_do.py ------------------------------------------------

def _parallel_do(fluid, parallel):
    x = fluid.layers.data(name="x", shape=[8], dtype="float32")
    names = {"w0": {"name": "pdo_w0"}, "b0": {"name": "pdo_b0"},
             "w1": {"name": "pdo_w1"}, "b1": {"name": "pdo_b1"}}

    def net(inp):
        h = fluid.layers.fc(input=inp, size=16, act="tanh",
                            param_attr=names["w0"], bias_attr=names["b0"])
        return fluid.layers.fc(input=h, size=4, param_attr=names["w1"],
                               bias_attr=names["b1"])

    if parallel:
        # the place count is recorded, not read: 2 in both packages
        pd = fluid.layers.ParallelDo(fluid.layers.get_places()[:1] * 2)
        with pd.do():
            pd.write_output(net(pd.read_input(x)))
        out = pd()
    else:
        out = net(x)
    loss = fluid.layers.mean(out)
    grads = fluid.append_backward(loss)
    return [loss] + [g.name for _, g in grads]


@pytest.mark.parametrize("parallel", [False, True])
def test_parallel_do_matches_serial(parallel):
    """ParallelDo's loss and parameter gradients equal the serial
    network's, in the port and in the JAX package (whose dp mesh only
    annotates the same computation)."""
    xv = np.random.RandomState(3).rand(16, 8).astype(np.float32)
    (j,), (t,) = _both(lambda f: _parallel_do(f, parallel), [{"x": xv}],
                       lambda o: o)
    for a, b in zip(t, j):
        _close(a, b, GRAD_RTOL, GRAD_ATOL)
    if parallel:
        (_,), (serial,) = _both(lambda f: _parallel_do(f, False),
                                [{"x": xv}], lambda o: o)
        for a, b in zip(t, serial):
            np.testing.assert_allclose(a, b, rtol=2e-5, atol=1e-6)


def test_get_places():
    """The layer gives this host's places (a CPU place without a card);
    the op gives the executing context's kind; `device_count` keeps the
    first that many."""
    assert len(tfluid.layers.get_places()) >= 1
    assert len(tfluid.layers.get_places(device_count=1)) == 1
    out = treg.get_op_info("get_places").lower(TExecContext("cpu"), {},
                                               {"device_count": 0})
    assert out["Out"] == [CPUPlace()]


def test_parallel_do_across_ranks_raises_naming_a8(monkeypatch):
    """More than one place with a process group of several ranks no
    longer raises (it did while the GSPMD step was ROADMAP A8): the op
    runs its sub-block over the whole batch, so a rank's loss is the
    serial network's, as ParallelExecutor's replicated form runs it on
    every rank (tests/test_torch_parallel.py holds that across gloo
    ranks)."""
    tfw.reset_unique_names()
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        loss = _parallel_do(tfluid, True)[0]
    exe = tfluid.Executor(CPUPlace())
    exe.run(startup)
    feed = {"x": np.random.RandomState(3).rand(4, 8).astype(np.float32)}
    want, = exe.run(main, feed=feed, fetch_list=[loss])
    dist = torch.distributed
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda *a, **k: 2)
    got, = exe.run(main, feed=feed, fetch_list=[loss])
    np.testing.assert_array_equal(got, want)


# -- beyond the JAX package's tests -------------------------------------------

def _rnn_grads(fluid, dynamic):
    """A recurrence with a static input and an initial memory, its loss
    and the gradients of its input, initial memory, static input and
    captured parameters."""
    D, H = 3, 4
    if dynamic:
        x = fluid.layers.data(name="x", shape=[D], dtype="float32",
                              lod_level=1)
        rnn = fluid.layers.DynamicRNN()
        block = rnn.block
    else:
        x = fluid.layers.data(name="x", shape=[3, D], dtype="float32")
        x.shape = (5, 3, D)
        rnn = fluid.layers.StaticRNN()
        block = rnn.step
    h0 = fluid.layers.data(name="h0", shape=[H], dtype="float32")
    s = fluid.layers.data(name="s", shape=[H], dtype="float32")
    for v in (x, h0, s):
        v.stop_gradient = False
    if not dynamic:
        h0.shape = s.shape = (3, H)     # a static recurrence's batch
    with block():
        xt = rnn.step_input(x)
        st = rnn.static_input(s)
        h = rnn.memory(init=h0)
        nh = fluid.layers.fc(input=[xt, h], size=H, act="tanh")
        nh = fluid.layers.elementwise_mul(nh, st)
        rnn.update_memory(h, nh)
        rnn.output(fluid.layers.sigmoid(nh))
    out = rnn()
    if dynamic:
        out = fluid.layers.sequence_pool(out, pool_type="sum")
    loss = fluid.layers.mean(fluid.layers.square(out))
    grads = fluid.append_backward(loss)
    return [loss] + [n + "@GRAD" for n in ("x", "h0", "s")] + \
        [g.name for _, g in grads]


@pytest.mark.parametrize("dynamic", [True, False], ids=["dynamic", "static"])
def test_recurrence_gradient_matches_jax_vjp(dynamic):
    """The generic gradient of `dynamic_rnn` (and of the StaticRNN's
    static form): autograd through the port's loop against jax.vjp of
    the JAX package's scan, for the step input, the initial memory, the
    static input and the captured fc parameters."""
    r = np.random.RandomState(5)
    if dynamic:
        feed = {"x": (r.randn(7, 3).astype(np.float32), [[0, 2, 6, 7]]),
                "h0": r.randn(3, 4).astype(np.float32),
                "s": r.rand(3, 4).astype(np.float32) + 0.5}
    else:
        feed = {"x": r.randn(5, 3, 3).astype(np.float32),
                "h0": r.randn(3, 4).astype(np.float32),
                "s": r.rand(3, 4).astype(np.float32) + 0.5}
    (j,), (t,) = _both(lambda f: _rnn_grads(f, dynamic), [feed],
                       lambda o: o)
    assert len(t) == 7      # the loss, 3 inputs, fc's 2 weights and bias
    for i, (a, b) in enumerate(zip(t, j)):
        _close(a, b, GRAD_RTOL, GRAD_ATOL, what=f"fetch {i}")


def _decode_arrays(cls, arr):
    """The three steps of a beam search over two sources, beam 2: step 0
    starts one prefix each; at step 1 source 0's prefix extends twice,
    source 1's once; at step 2 source 0's first prefix ends (no
    continuation) and its second extends, and source 1's extends twice."""
    steps = [
        ([[1], [2]], [0.5, 0.6], ((0, 1, 2), (0, 1, 2))),
        ([[3], [4], [5]], [0.4, 0.3, 0.7], ((0, 1, 2), (0, 2, 3))),
        ([[6], [7], [8]], [0.2, 0.9, 0.1], ((0, 2, 3), (0, 0, 1, 3))),
    ]
    ids = arr([cls(np.asarray(i, np.int64), lod) for i, _, lod in steps])
    scores = arr([cls(np.asarray(s, np.float32).reshape(-1, 1), lod)
                  for _, s, lod in steps])
    return ids, scores


def test_beam_search_decode_finishes_ended_prefixes_early():
    """A prefix with no continuation at a step is a finished sentence of
    its own; the JAX package's sentences, scores and LoDs."""
    tids, tsc = _decode_arrays(
        lambda a, lod: LoDTensor(torch.from_numpy(a), lod), TensorArray)
    jids, jsc = _decode_arrays(
        lambda a, lod: JLoDTensor(jnp.asarray(a), lod), JTensorArray)
    t = treg.get_op_info("beam_search_decode").lower(
        TExecContext("cpu"), {"Ids": [tids], "Scores": [tsc]}, {})
    j = jreg.get_op_info("beam_search_decode").lower(
        JExecContext(), {"Ids": [jids], "Scores": [jsc]}, {})
    ids, sc = t["SentenceIds"], t["SentenceScores"]
    # source 0: [1, 3] (ended at step 2), [1, 4, 6]; source 1: [2, 5, 7],
    # [2, 5, 8]
    assert ids.lod == ((0, 2, 4), (0, 2, 5, 8, 11))
    np.testing.assert_array_equal(ids.data.numpy(),
                                  [1, 3, 1, 4, 6, 2, 5, 7, 2, 5, 8])
    assert ids.data.dtype == torch.int64 and sc.lod == ids.lod
    _close(LoDTensor(ids.data.numpy(), ids.lod), j["SentenceIds"], 0, 0)
    _close(LoDTensor(sc.data.numpy(), sc.lod), j["SentenceScores"], 0, 0)


def _switch(fluid):
    x = fluid.layers.data(name="x", shape=[1], dtype="float32")
    zero = fluid.layers.fill_constant(shape=[1], dtype="float32", value=0.0)
    five = fluid.layers.fill_constant(shape=[1], dtype="float32", value=5.0)
    out = fluid.layers.fill_constant(shape=[1], dtype="float32", value=-9.0)
    with fluid.layers.Switch() as switch:
        with switch.case(fluid.layers.less_than(x=x, y=zero)):
            fluid.layers.assign(fluid.layers.scale(x, scale=-1.0),
                                output=out)
        with switch.case(fluid.layers.less_than(x=x, y=five)):
            fluid.layers.assign(fluid.layers.scale(x, scale=10.0),
                                output=out)
        with switch.default():
            fluid.layers.assign(five, output=out)
    return [out]


def test_switch_runs_the_first_true_case():
    """-2 takes the first case, 3 the second (its condition and the
    first's negation), 7 the default."""
    feeds = [{"x": np.asarray([v], np.float32)} for v in (-2.0, 3.0, 7.0)]
    j, t = _both(_switch, feeds, lambda o: o, start=False)
    assert [float(r[0][0]) for r in t] == [2.0, 30.0, 5.0]
    for a, b in zip(t, j):
        _close(a[0], b[0])


def _nested_rnn(fluid, inner_print):
    """A DynamicRNN whose step runs a StaticRNN over a [2, B, D] static
    input (two levels of sub-blocks)."""
    x = fluid.layers.data(name="x", shape=[3], dtype="float32", lod_level=1)
    rnn = fluid.layers.DynamicRNN()
    with rnn.block():
        xt = rnn.step_input(x)
        h = rnn.memory(shape=[3], value=0.0)
        pair = fluid.layers.reshape(fluid.layers.concat([xt, h], axis=0),
                                    shape=[2, -1, 3])
        pair.shape = (2, -1, 3)
        inner = fluid.layers.StaticRNN()
        with inner.step():
            it = inner.step_input(pair)
            acc = inner.memory(init=h)
            nacc = fluid.layers.tanh(fluid.layers.elementwise_add(it, acc))
            if inner_print:
                nacc = fluid.layers.Print(nacc, message="inner")
            inner.update_memory(acc, nacc)
            inner.output(nacc)
        nh = fluid.layers.reduce_sum(inner(), dim=0)
        rnn.update_memory(h, nh)
        rnn.output(nh)
    return [rnn()]


def test_a_host_op_at_any_depth_makes_the_outer_op_a_host_op():
    """Executor._op_is_host sees a `print` two sub-blocks down; without
    it the nested recurrences (a dynamic_rnn running a recurrent op a
    step) give the JAX package's values."""
    xin = np.random.RandomState(9).randn(6, 3).astype(np.float32)
    (j,), (t,) = _both(lambda f: _nested_rnn(f, False),
                       [{"x": (xin, [[0, 3, 4, 6]])}], lambda o: o,
                       start=False)
    _close(t[0], j[0])
    exe = tfluid.Executor(CPUPlace())
    for inner_print in (False, True):
        tfw.reset_unique_names()
        main, startup = tfluid.Program(), tfluid.Program()
        with tfluid.program_guard(main, startup):
            _nested_rnn(tfluid, inner_print)
        rnn_op, = [op for op in main.global_block().ops
                   if op.type == "dynamic_rnn"]
        assert exe._op_is_host(rnn_op) is inner_print


def _lod_rnn_feeds():
    r = np.random.RandomState(11)
    return [{"x": (r.randn(sum(lens), 3).astype(np.float32),
                   [np.cumsum([0] + lens).tolist()])}
            for lens in ([3, 1, 2], [2, 4])]


@pytest.mark.parametrize("mode", ["compiled", "segment"])
def test_dynamic_rnn_modes_equal_the_interpreter_bit_for_bit(mode):
    """Two LoDs through a training DynamicRNN, each fed twice: the
    compiled (or segmented) mode's losses, outputs and parameters equal
    the interpreter's bit for bit, and each LoD is a cache entry of its
    own (a miss, then a hit)."""
    feeds = [f for f in _lod_rnn_feeds() for _ in range(2)]
    results = {}
    for m in ("interpreted", mode):
        tfw.reset_unique_names()
        texecutor.switch_scope(Scope())
        main, startup = tfluid.Program(), tfluid.Program()
        with tfluid.program_guard(main, startup):
            loss, out = _dyn_rnn_train(tfluid)
        exe = tfluid.Executor(CPUPlace())
        exe.run(startup)
        if m == "segment":
            tflags.set_flags({"jit_granularity": "segment"})
        outs = [exe.run(main, feed=_feed(tfluid, f), fetch_list=[loss, out],
                        compiled=False if m == "interpreted" else None)
                for f in feeds]
        tflags.reset_flags()
        w = tfluid.global_scope().find_var("fc_0.w_0").clone()
        results[m] = (outs, w, exe.cache_stats())
    (i_outs, i_w, _), (c_outs, c_w, stats) = results["interpreted"], \
        results[mode]
    for a, b in zip(c_outs, i_outs):
        assert np.array_equal(a[0], b[0])
        assert np.array_equal(a[1].data, b[1].data) and a[1].lod == b[1].lod
    assert torch.equal(c_w, i_w)
    assert stats["entries"] >= 2 and stats["misses"] >= 2 \
        and stats["hits"] >= 2


def test_recompute_raises_naming_a4b():
    """layers.recompute no longer raises: a segment of two fc layers
    builds the JAX package's Program (the `recompute` op over its
    read-set, one sub-block), and 3 SGD steps from the JAX startup give
    the JAX package's losses (1e-5 relative) and parameters (atol
    1e-5), in the default mode and the interpreter."""
    def build(fluid, fw):
        fw.reset_unique_names()
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.layers.data(name="x", shape=[6], dtype="float32")
            y = fluid.layers.data(name="y", shape=[1], dtype="float32")

            def segment():
                h = fluid.layers.fc(input=x, size=16, act="relu")
                return fluid.layers.fc(input=h, size=8, act="tanh")

            h = fluid.layers.recompute(segment)
            loss = fluid.layers.mean(fluid.layers.square_error_cost(
                fluid.layers.fc(input=h, size=1), y))
            fluid.SGD(learning_rate=0.1).minimize(loss)
        return main, startup, loss

    jm, js, jl = build(jfluid, jfw)
    tm, ts, tl = build(tfluid, tfw)
    assert tm.to_dict() == jm.to_dict()
    rec = [op for op in tm.global_block().ops if op.type == "recompute"]
    assert len(rec) == 1 and len(tm.blocks) == 2
    for compiled in (None, False):
        _recompute_steps(jm, js, jl, tm, tl, compiled)


def _recompute_steps(jm, js, jl, tm, tl, compiled):
    jscope = jfluid.Scope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(js, scope=jscope)
    names = sorted(v.name for v in jm.list_vars() if v.persistable)
    tscope = scope_from_numpy({n: np.asarray(jscope.find_var(n))
                               for n in names}, CPUPlace())
    texe = tfluid.Executor(CPUPlace())
    r = np.random.RandomState(0)
    feed = {"x": r.rand(8, 6).astype(np.float32),
            "y": r.rand(8, 1).astype(np.float32)}
    jloss, tloss = [], []
    for _ in range(3):
        jloss.append(np.asarray(jexe.run(jm, feed=feed, fetch_list=[jl],
                                         scope=jscope)[0]).reshape(-1)[0])
        tloss.append(texe.run(tm, feed=feed, fetch_list=[tl], scope=tscope,
                              compiled=compiled)[0].reshape(-1)[0])
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    assert tloss[-1] < tloss[0]
    for n in names:
        np.testing.assert_allclose(tscope.find_var(n).numpy(),
                                   np.asarray(jscope.find_var(n)),
                                   rtol=0, atol=1e-5, err_msg=n)


def _cond(fluid):
    """tests/test_parity_ops.py:166's `cond` op: the then block writes 3,
    the else block 7."""
    main = fluid.default_main_program()
    c = fluid.layers.data(name="c", shape=[1], dtype="bool",
                          append_batch_size=False)
    out = fluid.layers.fill_constant(shape=[1], dtype="float32", value=0.0)
    blk = main.current_block
    blocks = []
    for value in (3.0, 7.0):
        sub = main.create_block()
        sub.append_op("assign_value", {}, {"Out": [out.name]},
                      {"shape": [1], "dtype": "float32", "values": [value]})
        main.rollback()
        blocks.append(sub)
    blk.append_op("cond", {"Cond": [c.name]}, {},
                  {"sub_block": {"__block__": blocks[0].idx},
                   "else_block": {"__block__": blocks[1].idx}})
    return [out]


def test_cond_op_runs_its_then_or_else_block():
    j, t = _both(_cond, [{"c": np.array([True])}, {"c": np.array([False])}],
                 lambda o: o, start=False)
    assert [float(r[0][0]) for r in t] == [3.0, 7.0]
    for a, b in zip(t, j):
        _close(a[0], b[0])


def _non_scalar_block(fluid):
    """conditional_block over a fed tensor: the block runs only when
    every input is non-empty."""
    x = fluid.layers.data(name="x", shape=[2], dtype="float32")
    out = fluid.layers.fill_constant(shape=[1], dtype="float32", value=-1.0)
    with fluid.layers.ConditionalBlock([x]).block():
        fluid.layers.assign(fluid.layers.reduce_sum(x), output=out)
    return [out]


def test_conditional_block_runs_on_non_empty_inputs():
    feeds = [{"x": np.ones((3, 2), np.float32)},
             {"x": np.zeros((0, 2), np.float32)}]
    j, t = _both(_non_scalar_block, feeds, lambda o: o, start=False)
    assert [float(r[0].reshape(-1)[0]) for r in t] == [6.0, -1.0]
    for a, b in zip(t, j):
        _close(a[0], b[0])


def test_recurrent_op_is_the_static_rnn():
    """The reference's `recurrent` op type (a StaticRNN Program's
    `dynamic_rnn` op renamed) gives the StaticRNN's values, in both
    packages."""
    xin = np.random.RandomState(6).randn(4, 3, 5).astype(np.float32)

    def build(fluid):
        out = _static_rnn(fluid, T=4, B=3, D=5, fc=True)
        for op in fluid.default_main_program().global_block().ops:
            if op.type == "dynamic_rnn":
                op.type = "recurrent"
        return out

    (j,), (t,) = _both(build, [{"x": xin}], lambda o: o)
    (_,), (s,) = _both(lambda f: _static_rnn(f, T=4, B=3, D=5, fc=True),
                       [{"x": xin}], lambda o: o)
    _close(t[0], j[0])
    np.testing.assert_array_equal(t[0], s[0])


def test_rnn_memory_helper_is_the_identity_and_its_gradient():
    """rnn_memory_helper: Out = X, and the generic gradient passes the
    cotangent through, as the JAX lowering and jax.vjp do."""
    import jax

    from paddle_tpu_torch.core.execution import generic_grad_lower

    x = np.random.RandomState(8).randn(3, 4).astype(np.float32)
    g = np.random.RandomState(9).randn(3, 4).astype(np.float32)
    info = treg.get_op_info("rnn_memory_helper")
    tx = torch.from_numpy(x)
    out = info.lower(TExecContext("cpu"), {"X": [tx]}, {})["Out"]
    jout = jreg.get_op_info("rnn_memory_helper").lower(
        JExecContext(), {"X": [jnp.asarray(x)]}, {})["Out"]
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    grad = generic_grad_lower(TExecContext("cpu"),
                              {"X": [tx], "Out": [out],
                               "Out@GRAD": [torch.from_numpy(g)]},
                              {}, info)["X@GRAD"][0]
    _, vjp = jax.vjp(lambda v: jreg.get_op_info("rnn_memory_helper").lower(
        JExecContext(), {"X": [v]}, {})["Out"], jnp.asarray(x))
    np.testing.assert_array_equal(grad.numpy(), np.asarray(vjp(
        jnp.asarray(g))[0]))
