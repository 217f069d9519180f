"""Attention-weight dropout: the composed attention path of
`nets.scaled_dot_product_attention` (paddle_tpu/nets.py:96-113), which
the transformer builders take in training with `dropout_rate > 0`.

  * The 2-layer LM with dropout_rate=0.1 builds the JAX package's
    Program (to_dict, var dtypes included), and with every dropout op's
    `dropout_prob` set to 0 in both Programs after building (the
    composed path stays; only the draw becomes the identity) trains
    like it: 3 Momentum steps from the JAX startup's parameters, losses
    within 1e-5 relative and parameters within atol 1e-5
    (tests/test_torch_training.py's tolerances).  Under bf16 amp the
    Programs are equal too, dtypes included.
  * The composed path is causal, pinned as tests/test_transformer.py:86
    pins it, in training: a change to the last token moves no earlier
    logit (two executors of one seed draw the same masks).
  * The attention dropout's keep rate over its draws is within 4 sigma
    of 0.9.
  * With the draws zeroed, the composed path equals the flash path
    (dropout_rate=0) from the same parameters.
  * The causal mask (`assign_value`, 256 floats here, 262,144 at the
    full width) is built once per device and reused by every run.
"""
import os
import sys

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu.core.framework as jfw
from paddle_tpu.models import transformer as jtr

import paddle_tpu_torch as tfluid
import paddle_tpu_torch.core.framework as tfw
from paddle_tpu_torch import CPUPlace
from paddle_tpu_torch.core import executor as texecutor
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.core.scope import Scope, scope_to_numpy
from paddle_tpu_torch.models import transformer as ttr

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_training import (  # noqa: E402
    _assert_losses_close, _assert_params_close, _assert_same_program,
    _lm_feeds, _start_both)

V, D, H, L, SEQ, BATCH = 29, 32, 2, 2, 16, 4
P = 0.1


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


def _lm(fluid, fw, tr, dropout_rate=P, optimize=True):
    fw.reset_unique_names()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        ids = fluid.layers.data(name="ids", shape=[SEQ], dtype="int64")
        lbl = fluid.layers.data(name="lbl", shape=[SEQ, 1], dtype="int64")
        logits = tr.transformer_lm(ids, V, d_model=D, n_heads=H, n_layers=L,
                                   max_len=SEQ, dropout_rate=dropout_rate,
                                   return_logits=True)
        cost = fluid.layers.softmax_with_cross_entropy(
            fluid.layers.reshape(logits, shape=[-1, V]),
            fluid.layers.reshape(lbl, shape=[-1, 1]))
        loss = fluid.layers.mean(cost)
        if optimize:
            fluid.Momentum(learning_rate=0.01, momentum=0.9).minimize(loss)
    return main, startup, loss, logits


def _zero_draws(program):
    drops = [op for op in program.global_block().ops if op.type == "dropout"]
    for op in drops:
        op.attrs["dropout_prob"] = 0.0
    return drops


def _attention_dropouts(program):
    """The dropout ops that draw over [b, h, s, s] attention weights."""
    blk = program.global_block()
    return [op for op in blk.ops if op.type == "dropout"
            and len(blk.var(op.input("X")[0]).shape) == 4]


def test_dropout_lm_program_matches_jax():
    jm, js, _, _ = _lm(jfluid, jfw, jtr)
    tm, ts, _, _ = _lm(tfluid, tfw, ttr)
    _assert_same_program(jm, tm)
    _assert_same_program(js, ts)
    types = [op.type for op in tm.global_block().ops]
    assert "flash_attention" not in types
    for t in ("transpose", "matmul", "assign_value", "softmax",
              "matmul_grad", "softmax_grad", "dropout_grad"):
        assert t in types, t
    # per layer: the attention weights' dropout and the FFN's; and the
    # embedding's
    assert types.count("dropout") == 2 * L + 1
    assert len(_attention_dropouts(tm)) == L


def test_amp_dropout_lm_program_matches_jax():
    """Under bf16 amp (chip_smoke's lm_dropout mode) the composed path's
    dtypes are the JAX package's: bf16 products, f32 softmax and dropout
    over the weights, f32 parameters."""
    import contextlib

    with contextlib.ExitStack() as stack:
        stack.enter_context(jfluid.amp.bf16_guard())
        stack.enter_context(tfluid.amp.bf16_guard())
        jm, js, _, _ = _lm(jfluid, jfw, jtr)
        tm, ts, _, _ = _lm(tfluid, tfw, ttr)
    _assert_same_program(jm, tm)
    _assert_same_program(js, ts)
    blk = tm.global_block()
    mm = [op for op in blk.ops if op.type == "matmul"]
    assert mm and all(blk.var(op.output("Out")[0]).dtype == "bfloat16"
                      for op in mm)
    assert all(blk.var(op.output("Out")[0]).dtype == "float32"
               for op in _attention_dropouts(tm))
    assert all(p.dtype == "float32" for p in blk.all_parameters())


def test_dropout_lm_with_the_draws_zeroed_trains_like_jax():
    jm, js, jl, _ = _lm(jfluid, jfw, jtr)
    tm, ts, tl, _ = _lm(tfluid, tfw, ttr)
    assert len(_zero_draws(jm)) == len(_zero_draws(tm)) == 2 * L + 1
    jexe, texe, names = _start_both(jm, js, tm, ts)
    jloss, tloss = [], []
    for step in range(3):
        feed = _lm_feeds(step)
        jloss.append(jexe.run(jm, feed=feed, fetch_list=[jl])[0][0])
        tloss.append(texe.run(tm, feed=feed, fetch_list=[tl])[0][0])
    _assert_losses_close(jloss, tloss)
    assert tloss[-1] < tloss[0]
    _assert_params_close(names)


def test_composed_path_is_causal_in_training():
    main, startup, _, logits = _lm(tfluid, tfw, ttr, optimize=False)
    assert _attention_dropouts(main)
    tfluid.Executor(CPUPlace(), seed=1).run(startup)
    rng = np.random.RandomState(3)
    a = rng.randint(0, V, (1, SEQ)).astype(np.int64)
    b = a.copy()
    b[0, -1] = (b[0, -1] + 5) % V
    feeds = [{"ids": x, "lbl": np.zeros((1, SEQ, 1), np.int64)}
             for x in (a, b)]
    # two executors of one seed at the same run index: the same masks
    la, lb = (tfluid.Executor(CPUPlace(), seed=7).run(
        main, feed=f, fetch_list=[logits])[0] for f in feeds)
    np.testing.assert_allclose(la[0, :-1], lb[0, :-1], rtol=1e-5, atol=1e-5)
    assert not np.allclose(la[0, -1], lb[0, -1])


def test_attention_dropout_keep_rate_is_held_by_distribution():
    main, startup, loss, _ = _lm(tfluid, tfw, ttr)
    masks = [op.output("Mask")[0] for op in _attention_dropouts(main)]
    exe = tfluid.Executor(CPUPlace(), seed=11)
    exe.run(startup)
    kept, n, steps = 0.0, 0, 4
    for step in range(steps):
        out = exe.run(main, feed=_lm_feeds(step), fetch_list=[loss] + masks)
        assert np.isfinite(out[0]).all()
        for m in out[1:]:
            assert m.shape == (BATCH, H, SEQ, SEQ)
            assert set(np.unique(m)) <= {0.0, 1.0}
            kept += float(m.sum())
            n += m.size
    keep = kept / n
    sigma = np.sqrt(P * (1 - P) / n)
    assert abs(keep - (1 - P)) <= 4 * sigma, (keep, sigma)


def test_composed_path_with_the_draws_zeroed_equals_the_flash_path():
    """One Momentum step of each from the same parameters: the composed
    matmul/softmax chain and the flash_attention op agree (float32, the
    same arithmetic in another order)."""
    runs = {}
    for rate in (P, 0.0):
        texecutor.switch_scope(Scope())
        main, startup, loss, _ = _lm(tfluid, tfw, ttr, dropout_rate=rate)
        _zero_draws(main)
        exe = tfluid.Executor(CPUPlace(), seed=3)
        exe.run(startup)
        params = sorted(p.name for p in main.global_block().all_parameters())
        init = scope_to_numpy(tfluid.global_scope(), params)
        if rate == 0.0:     # the flash path starts where the composed did
            from paddle_tpu_torch.core.scope import scope_from_numpy
            scope_from_numpy(runs[P]["init"], CPUPlace(),
                             tfluid.global_scope())
        l0 = exe.run(main, feed=_lm_feeds(0), fetch_list=[loss])[0][0]
        runs[rate] = {"init": init, "loss": l0, "params": scope_to_numpy(
            tfluid.global_scope(), params),
            "types": [op.type for op in main.global_block().ops]}
    assert "flash_attention" in runs[0.0]["types"]
    assert "flash_attention" not in runs[P]["types"]
    assert sorted(runs[P]["params"]) == sorted(runs[0.0]["params"])
    np.testing.assert_allclose(runs[P]["loss"], runs[0.0]["loss"], rtol=1e-5)
    for n, v in runs[P]["params"].items():
        np.testing.assert_allclose(v, runs[0.0]["params"][n], rtol=0,
                                   atol=1e-5, err_msg=n)


def test_the_causal_mask_is_built_once_per_device():
    from paddle_tpu_torch.ops import creation

    main, startup, loss, _ = _lm(tfluid, tfw, ttr)
    op = next(o for o in main.global_block().ops if o.type == "assign_value")
    assert len(op.attrs["values"]) == SEQ * SEQ
    exe = tfluid.Executor(CPUPlace(), seed=2)
    exe.run(startup)
    exe.run(main, feed=_lm_feeds(0), fetch_list=[loss])
    keys = [k for k, (vals, _) in creation._CONSTANTS.items()
            if vals is op.attrs["values"]]
    assert len(keys) == 1
    built = creation._CONSTANTS[keys[0]][1]
    for step in (1, 2):
        exe.run(main, feed=_lm_feeds(step), fetch_list=[loss],
                compiled=step == 2)
    assert creation._CONSTANTS[keys[0]][1] is built
    want = np.triu(np.full((SEQ, SEQ), -1e9, np.float32), k=1)
    np.testing.assert_array_equal(built.numpy(), want)
