"""The `recompute` op and `layers.recompute` (rematerialised segments)
in the port against the JAX package, on the CPU.

A segment's forward runs its sub-block in an env of its own and keeps
only its outputs; its gradient re-runs the segment under autograd from
the read-set (the generic gradient), so the segment runs twice forward
a step.  Held here: a segment equals the same layers without it, and
the JAX package's remat build (losses and parameters after 3 steps at
1e-5); several outputs; batch norm's running statistics carried out of
the segment and written once a step; a dropout inside a segment whose
gradient's re-run redraws the forward's mask; flash attention inside a
segment (its plain version on the CPU) with its gradient through the
kernel wrapper's autograd; the default mode equal to the interpreter
bit for bit; and the remat decoder under bf16 amp within one bf16 ulp
of the build without remat.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu.core.framework as jfw

import paddle_tpu_torch as tfluid
import paddle_tpu_torch.core.framework as tfw
from paddle_tpu_torch import CPUPlace
from paddle_tpu_torch.core import executor as texecutor
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.core.scope import Scope, scope_from_numpy

from test_torch_training import _assert_same_program

CPU = CPUPlace()


@pytest.fixture(autouse=True)
def _fresh_port_state():
    old_scope = texecutor.switch_scope(Scope())
    tfw.reset_unique_names()
    tflags.reset_flags()
    yield
    texecutor.switch_scope(old_scope)
    tflags.reset_flags()


def _mlp(fluid, fw, remat, opt="sgd"):
    """tests/test_memory_optimize.py's segment of two fc layers."""
    fw.reset_unique_names()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[6], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")

        def segment():
            h = fluid.layers.fc(input=x, size=16, act="relu")
            return fluid.layers.fc(input=h, size=8, act="tanh")

        h = fluid.layers.recompute(segment) if remat else segment()
        pred = fluid.layers.fc(input=h, size=1)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
        (fluid.SGD(learning_rate=0.1) if opt == "sgd" else
         fluid.Momentum(learning_rate=0.1, momentum=0.9)).minimize(loss)
    return main, startup, loss


def _mlp_feed():
    r = np.random.RandomState(0)
    return {"x": r.rand(8, 6).astype(np.float32),
            "y": r.rand(8, 1).astype(np.float32)}


def _persistables(prog):
    return sorted(v.name for v in prog.list_vars() if v.persistable)


def _jax_run(main, startup, loss, feed_of, steps):
    scope = jfluid.Scope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    exe.run(startup, scope=scope)
    names = _persistables(main)
    init = {n: np.asarray(scope.find_var(n)).copy() for n in names}
    losses = [float(np.asarray(exe.run(main, feed=feed_of(i),
                                       fetch_list=[loss],
                                       scope=scope)[0]).reshape(-1)[0])
              for i in range(steps)]
    return init, losses, {n: np.asarray(scope.find_var(n)) for n in names}


def _port_run(main, loss, init, feed_of, steps, compiled=None):
    scope = scope_from_numpy(init, CPU)
    exe = tfluid.Executor(CPU)
    losses = [float(exe.run(main, feed=feed_of(i), fetch_list=[loss],
                            scope=scope, compiled=compiled)[0]
                    .reshape(-1)[0]) for i in range(steps)]
    return losses, {n: scope.find_var(n).numpy() for n in init}


def _assert_close(got, want, rtol=1e-5, atol=1e-5):
    (gl, gs), (wl, ws) = got, want
    np.testing.assert_allclose(gl, wl, rtol=rtol)
    for n in ws:
        np.testing.assert_allclose(gs[n], ws[n], rtol=0, atol=atol,
                                   err_msg=n)


@pytest.mark.parametrize("opt", ["sgd", "momentum"])
def test_segment_equals_the_plain_build_and_the_jax_package(opt):
    jm, js, jl = _mlp(jfluid, jfw, True, opt)
    tm, _, tl = _mlp(tfluid, tfw, True, opt)
    pm, _, pl = _mlp(tfluid, tfw, False, opt)
    _assert_same_program(jm, tm)
    init, jloss, jstate = _jax_run(jm, js, jl, lambda i: _mlp_feed(), 3)
    remat = _port_run(tm, tl, init, lambda i: _mlp_feed(), 3)
    _assert_close(remat, (jloss, jstate))
    assert remat[0][-1] < remat[0][0]
    # the same layers without the segment: the same parameter names
    plain = _port_run(pm, pl, init, lambda i: _mlp_feed(), 3)
    _assert_close(remat, plain, rtol=1e-6, atol=1e-6)
    # the default mode equals the interpreter bit for bit
    interp = _port_run(tm, tl, init, lambda i: _mlp_feed(), 3,
                       compiled=False)
    assert interp[0] == remat[0]
    for n in init:
        assert np.array_equal(interp[1][n], remat[1][n]), n


def test_several_outputs_in_both_modes():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="x", shape=[4], dtype="float32")

        def seg():
            return [tfluid.layers.scale(x, scale=2.0),
                    tfluid.layers.scale(x, scale=3.0)]

        a, b = tfluid.layers.recompute(seg)
        s = tfluid.layers.elementwise_add(a, b)
    exe = tfluid.Executor(CPU)
    xs = np.ones((2, 4), np.float32)
    for compiled in (None, False):
        got, av = exe.run(main, feed={"x": xs}, fetch_list=[s, a],
                          compiled=compiled)
        np.testing.assert_allclose(got, 5.0 * xs)
        np.testing.assert_allclose(av, 2.0 * xs)
    with pytest.raises(ValueError, match="not produced inside"):
        with tfluid.program_guard(tfluid.Program(), tfluid.Program()):
            y = tfluid.layers.data(name="y", shape=[4], dtype="float32")
            tfluid.layers.recompute(lambda: y)


def _bn(fluid, fw, remat):
    fw.reset_unique_names()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[4, 8, 8], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="int64")

        def seg():
            h = fluid.layers.conv2d(input=x, num_filters=4, filter_size=3,
                                    padding=1, act=None)
            return fluid.layers.batch_norm(h, act="relu")

        h = fluid.layers.recompute(seg) if remat else seg()
        logits = fluid.layers.fc(input=h, size=3)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, y))
        fluid.Momentum(learning_rate=0.1, momentum=0.9).minimize(loss)
    return main, startup, loss


def _bn_feed(i):
    r = np.random.RandomState(i)
    return {"x": r.rand(6, 4, 8, 8).astype(np.float32),
            "y": r.randint(0, 3, (6, 1)).astype(np.int64)}


def test_batch_norm_statistics_leave_the_segment_once_a_step():
    """The running mean and variance are the segment's extra outputs:
    after 3 steps they equal the JAX package's remat build's and the
    port's build without the segment (the gradient's re-run writes
    them no second time)."""
    jm, js, jl = _bn(jfluid, jfw, True)
    tm, _, tl = _bn(tfluid, tfw, True)
    pm, _, pl = _bn(tfluid, tfw, False)
    _assert_same_program(jm, tm)
    rec, = [op for op in tm.global_block().ops if op.type == "recompute"]
    stats = [n for n in rec.output("Out") if ".mean" in n or ".var" in n]
    assert len(stats) == 2
    init, jloss, jstate = _jax_run(jm, js, jl, _bn_feed, 3)
    remat = _port_run(tm, tl, init, _bn_feed, 3)
    _assert_close(remat, (jloss, jstate))
    plain = _port_run(pm, pl, init, _bn_feed, 3)
    for n in stats:
        assert np.abs(remat[1][n] - init[n]).max() > 1e-6, n
        np.testing.assert_allclose(remat[1][n], plain[1][n], rtol=0,
                                   atol=1e-6, err_msg=n)


def test_dropout_in_a_segment_redraws_its_mask():
    """out = dropout(x W) inside a segment, loss = mean(out): W's
    gradient is x^T (mask / n), with the mask the forward drew (out's
    zeros).  A re-run drawing another mask would route it elsewhere."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="x", shape=[8], dtype="float32")

        def seg():
            h = tfluid.layers.fc(input=x, size=16, bias_attr=False)
            return tfluid.layers.dropout(h, dropout_prob=0.5)

        out = tfluid.layers.recompute(seg)
        loss = tfluid.layers.mean(out)
        tfluid.SGD(learning_rate=0.0).minimize(loss)
    w = main.global_block().all_parameters()[0]
    exe = tfluid.Executor(CPU)
    exe.run(startup)
    xs = np.random.RandomState(0).rand(32, 8).astype(np.float32) + 0.5
    for compiled in (None, False):
        o, gw = exe.run(main, feed={"x": xs},
                        fetch_list=[out, w.name + "@GRAD"],
                        compiled=compiled)
        mask = (o != 0).astype(np.float32)
        assert 0.3 < mask.mean() < 0.7
        np.testing.assert_allclose(gw, xs.T @ (mask / mask.size),
                                   rtol=1e-5, atol=1e-7)


def _attention_lm(fluid, fw, remat):
    fw.reset_unique_names()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        ids = fluid.layers.data(name="ids", shape=[8], dtype="int64")
        lbl = fluid.layers.data(name="lbl", shape=[8, 1], dtype="int64")
        from importlib import import_module

        tr = import_module(fluid.__name__ + ".models.transformer")
        h = tr.transformer_decoder(ids, None, 13, d_model=16, n_heads=2,
                                   n_layers=2, max_len=8, remat=remat)
        logits = fluid.layers.fc(input=h, size=13, num_flatten_dims=2)
        loss = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(
            fluid.layers.reshape(logits, shape=[-1, 13]),
            fluid.layers.reshape(lbl, shape=[-1, 1])))
        fluid.Momentum(learning_rate=0.05, momentum=0.9).minimize(loss)
    return main, startup, loss


def _lm_feed(i):
    base = np.arange(4 * 8).reshape(4, 8) % 13
    return {"ids": ((base + i) % 13).astype(np.int64),
            "lbl": ((base + i + 1) % 13).astype(np.int64)[..., None]}


def test_flash_attention_in_a_segment():
    """Each decoder block a segment: the flash op (its plain version on
    the CPU) runs in the forward and again in the gradient's re-run, its
    gradient through the kernel wrapper's autograd (no flash grad op).
    The JAX package's remat build's losses and parameters (1e-5), and
    the port's build without remat (1e-5)."""
    jm, js, jl = _attention_lm(jfluid, jfw, True)
    tm, _, tl = _attention_lm(tfluid, tfw, True)
    pm, _, pl = _attention_lm(tfluid, tfw, False)
    _assert_same_program(jm, tm)
    types = [op.type for op in tm.global_block().ops]
    assert "flash_attention_grad" not in types
    assert types.count("recompute") == 2
    sub = [op.type for b in tm.blocks[1:] for op in b.ops]
    assert sub.count("flash_attention") == 2
    init, jloss, jstate = _jax_run(jm, js, jl, _lm_feed, 3)
    remat = _port_run(tm, tl, init, _lm_feed, 3)
    _assert_close(remat, (jloss, jstate))
    plain = _port_run(pm, pl, init, _lm_feed, 3)
    _assert_close(remat, plain)


def test_remat_decoder_under_amp_within_a_bf16_ulp():
    """bf16 amp inside the segments: the casts' gradients give the
    cotangents the dtypes the explicit mul gradient gives; the remat
    build's losses stay within one bf16 ulp of the build without remat
    over 3 steps, and every parameter stays float32."""
    with tfluid.amp.bf16_guard():
        tm, ts, tl = _attention_lm(tfluid, tfw, True)
        pm, _, pl = _attention_lm(tfluid, tfw, False)
        exe = tfluid.Executor(CPU)
        scope = Scope()
        exe.run(ts, scope=scope)
        init = {n: scope.find_var(n).numpy().copy()
                for n in _persistables(tm)}
        remat = _port_run(tm, tl, init, _lm_feed, 3)
        plain = _port_run(pm, pl, init, _lm_feed, 3)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(plain[0]))) - 7)
    assert np.all(np.abs(np.array(remat[0]) - plain[0]) <= ulp), \
        (remat[0], plain[0])
    assert all(v.dtype == np.float32 for v in remat[1].values()
               if v.dtype.kind == "f")
