"""The port's CTR models (models/ctr.py: wide&deep and DeepFM, every slot
an `is_sparse=True` embedding) against the JAX package, on the CPU, at
tests/test_ctr.py's size: slots of 7, 11 and 5 ids, 4 dense features,
embed_dim 4, hidden sizes (16, 8), Adam 0.02, batch 64, clicks driven
by a slot interaction (test_ctr.py's `_batch`).

  * the training Program equals the JAX package's, field for field, and
    round-trips through `Program.from_dict`;
  * 20 steps from the JAX startup's parameters match the reference, in
    the interpreter and the default (compiled) mode;
  * `is_sparse=True` equals `is_sparse=False` in the port bit for bit
    (both gradients reach the same ordered accumulation);
  * the 150-step convergence bounds of tests/test_ctr.py hold.

Tolerances (tests/test_torch_training.py): losses 1e-5 relative,
parameters atol 1e-5.
"""
import os
import sys

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu.core.framework as jfw
from paddle_tpu.core import executor as jexecutor
from paddle_tpu.models import ctr as jctr

import paddle_tpu_torch as tfluid
import paddle_tpu_torch.core.framework as tfw
from paddle_tpu_torch import CPUPlace
from paddle_tpu_torch.core import executor as texecutor
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.core.lod import SelectedRows
from paddle_tpu_torch.core.scope import Scope, scope_to_numpy
from paddle_tpu_torch.models import ctr as tctr

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_training import (  # noqa: E402
    _assert_losses_close, _assert_params_close, _assert_same_program,
    _persistables, _start_both)

VOCABS = [7, 11, 5]
DENSE, BATCH = 4, 64
MODELS = ["deepfm", "wide_deep"]


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


def _batch(rng, n):
    """tests/test_ctr.py's clicks: an interaction (slot 0 parity == slot
    1 parity) plus a dense effect."""
    ids = [rng.randint(0, v, (n, 1)).astype(np.int64) for v in VOCABS]
    dense = rng.rand(n, DENSE).astype(np.float32)
    p = 0.15 + 0.6 * ((ids[0] % 2) == (ids[1] % 2)) + 0.2 * (
        dense[:, :1] > 0.5)
    label = (rng.rand(n, 1) < p).astype(np.float32)
    return ids, dense, label


def _feeds(steps):
    rng = np.random.RandomState(0)
    for _ in range(steps):
        ids, dense, label = _batch(rng, BATCH)
        feed = {f"slot{i}": ids[i] for i in range(len(VOCABS))}
        feed["dense"], feed["label"] = dense, label
        yield feed


def _build(fluid, fw, ctr, model, is_sparse=True):
    fw.reset_unique_names()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        sparse_in = [fluid.layers.data(name=f"slot{i}", shape=[1],
                                       dtype="int64")
                     for i in range(len(VOCABS))]
        dense_in = fluid.layers.data(name="dense", shape=[DENSE],
                                     dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="float32")
        _, logit = getattr(ctr, model)(
            sparse_in, VOCABS, dense_input=dense_in, embed_dim=4,
            hidden_sizes=(16, 8), is_sparse=is_sparse)
        loss = fluid.layers.mean(
            fluid.layers.sigmoid_cross_entropy_with_logits(logit, label))
        fluid.Adam(learning_rate=0.02).minimize(loss)
    return main, startup, loss


def _tables(program):
    return sorted(op.input("W")[0] for op in program.global_block().ops
                  if op.type == "lookup_table")


@pytest.mark.parametrize("model", MODELS)
def test_ctr_program_matches_jax(model):
    jm, js, _ = _build(jfluid, jfw, jctr, model)
    tm, ts, _ = _build(tfluid, tfw, tctr, model)
    _assert_same_program(jm, tm)
    _assert_same_program(js, ts)
    assert tfw.Program.from_dict(tm.to_dict()).to_dict() == tm.to_dict()
    assert jfw.Program.from_dict(tm.to_dict()).to_dict() == tm.to_dict()
    grads = [op for op in tm.global_block().ops
             if op.type == "lookup_table_grad"]
    # a wide and a deep table a slot, every gradient sparse
    assert len(grads) == 2 * len(VOCABS)
    assert all(op.attrs["is_sparse"] for op in grads)


@pytest.mark.parametrize("compiled", [False, None])
@pytest.mark.parametrize("model", MODELS)
def test_ctr_trains_like_jax(model, compiled):
    """20 Adam steps from the same parameters; `compiled=None` is each
    package's default mode (the JAX package's jit, the port's compiled
    plan)."""
    jm, js, jl = _build(jfluid, jfw, jctr, model)
    tm, ts, tl = _build(tfluid, tfw, tctr, model)
    jexe, texe, names = _start_both(jm, js, tm, ts)
    jloss, tloss = [], []
    for feed in _feeds(20):
        jloss.append(jexe.run(jm, feed=feed, fetch_list=[jl],
                              compiled=compiled)[0][0])
        tloss.append(texe.run(tm, feed=feed, fetch_list=[tl],
                              compiled=compiled)[0][0])
    _assert_losses_close(jloss, tloss)
    assert tloss[-1] < tloss[0]
    _assert_params_close(names)


def _train_port(model, is_sparse, steps, fetch_grad=False):
    tfw.reset_unique_names()
    main, startup, loss = _build(tfluid, tfw, tctr, model, is_sparse)
    exe = tfluid.Executor(CPUPlace())
    exe.run(startup)
    table = _tables(main)[0]
    losses, grads = [], []
    for feed in _feeds(steps):
        out = exe.run(main, feed=feed, fetch_list=[loss] + (
            [table + "@GRAD"] if fetch_grad else []))
        losses.append(float(out[0][0]))
        grads += out[1:]
    return losses, scope_to_numpy(tfluid.global_scope(),
                                  _persistables(main)), grads


@pytest.mark.parametrize("model", MODELS)
def test_ctr_sparse_equals_dense_in_the_port(model):
    """is_sparse changes the gradient's representation, not the update:
    20 steps give the same losses and states bit for bit."""
    s_loss, s_state, s_grads = _train_port(model, True, 20, True)
    texecutor.switch_scope(Scope())
    d_loss, d_state, d_grads = _train_port(model, False, 20, True)
    assert s_loss == d_loss
    assert s_state.keys() == d_state.keys()
    for n in s_state:
        np.testing.assert_array_equal(s_state[n], d_state[n], err_msg=n)
    for s, d in zip(s_grads, d_grads):
        assert isinstance(s, SelectedRows) and isinstance(d, np.ndarray)
        assert s.height == d.shape[0]
        dense = np.zeros_like(d)
        np.add.at(dense, s.rows, s.value)
        np.testing.assert_allclose(dense, d, rtol=0, atol=1e-7)


@pytest.mark.parametrize("model", MODELS)
def test_ctr_converges(model):
    """tests/test_ctr.py's bounds over 150 steps."""
    losses, _, _ = _train_port(model, True, 150)
    assert losses[-1] < losses[0], (losses[0], losses[-1])
    assert np.mean(losses[-10:]) < 0.55, np.mean(losses[-10:])
