"""The seq2seq transformer (`transformer_encoder`, `transformer_translate`)
in the port against the JAX package, on the CPU.

The Program is benchmark/run_seq2seq.py's `build_transformer` at a tiny
width: the translator's logits into softmax_with_cross_entropy, mean,
Adam.  Both packages build it under reset unique names; `to_dict()`
must be equal, in float32 and under bf16 amp (dtypes included).  Then
5 Adam steps from the JAX startup's parameters on both sides:

  * float32: tests/test_torch_training.py's tolerances (per-step losses
    within 1e-5 relative, parameters within atol 1e-5 at lr 1e-4);
  * bf16 amp: tests/test_torch_amp.py's rules against the JAX
    interpreter (each loss within 1 bf16 ulp, each weight matrix and
    table within 16 ulps of its largest value, each parameter's change
    within 15 %, and the key-projection biases — 3 x n_layers here: the
    encoder's self-attention, the decoder's self- and cross-attention;
    softmax is shift-invariant per query, so their exact gradient is 0
    and their moves are rounding noise — within a relative difference
    of 2).

The encoder's self-attention and the decoder's cross-attention are
non-causal: the flash op runs both kinds.  The port's default (compiled)
mode equals its interpreter bit for bit on the CPU, and `remat=True`
builds and trains as the JAX package's remat build does.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu.core.framework as jfw
from paddle_tpu.core import executor as jexecutor
from paddle_tpu.models import transformer as jtr

import paddle_tpu_torch as tfluid
import paddle_tpu_torch.core.framework as tfw
from paddle_tpu_torch import CPUPlace
from paddle_tpu_torch.core import executor as texecutor
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.core.scope import Scope, scope_to_numpy
from paddle_tpu_torch.models import transformer as ttr

from test_torch_amp import (CHANGE_RTOL, LOSS_ULPS, NOISE_RTOL, TABLE_ULPS,
                            _bf16_ulp, _both_amp, _k_biases)
from test_torch_training import (_assert_losses_close, _assert_params_close,
                                 _assert_same_program, _start_both)

SV, TV, D, H, L, SRC, TGT, BATCH = 23, 29, 32, 2, 2, 12, 10, 4
STEPS = 5


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


def _translate(fluid, fw, tr, dropout_rate=0.0, is_test=False,
               optimize=True, remat=False):
    """run_seq2seq's build_transformer (:39-60) at a tiny width."""
    fw.reset_unique_names()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        src = fluid.layers.data(name="src", shape=[SRC], dtype="int64")
        tgt = fluid.layers.data(name="tgt", shape=[TGT], dtype="int64")
        lbl = fluid.layers.data(name="lbl", shape=[TGT, 1], dtype="int64")
        logits = tr.transformer_translate(
            src, tgt, SV, TV, d_model=D, n_heads=H, n_layers=L,
            max_len=max(SRC, TGT), dropout_rate=dropout_rate,
            is_test=is_test, return_logits=True, remat=remat)
        cost = fluid.layers.softmax_with_cross_entropy(
            fluid.layers.reshape(logits, shape=[-1, TV]),
            fluid.layers.reshape(lbl, shape=[-1, 1]))
        loss = fluid.layers.mean(cost)
        if optimize:
            fluid.Adam(learning_rate=1e-4).minimize(loss)
    return main, startup, loss


def _feeds(step):
    """Seeded token ids; the label is the target shifted by one."""
    r = np.random.RandomState(step)
    tgt = r.randint(0, TV, (BATCH, TGT + 1)).astype(np.int64)
    return {"src": r.randint(0, SV, (BATCH, SRC)).astype(np.int64),
            "tgt": tgt[:, :-1], "lbl": tgt[:, 1:, None]}


# -- Programs ----------------------------------------------------------------

@pytest.mark.parametrize("amp", [False, True], ids=["fp32", "amp"])
def test_translate_program_matches_jax(amp):
    guard = _both_amp() if amp else _nullcontext()
    with guard:
        jm, js, _ = _translate(jfluid, jfw, jtr)
        tm, ts, _ = _translate(tfluid, tfw, ttr)
    _assert_same_program(jm, tm)
    _assert_same_program(js, ts)
    blk = tm.global_block()
    flash = [op for op in blk.ops if op.type == "flash_attention"]
    # per layer: encoder self (full), decoder self (causal), cross (full)
    assert [op.attrs["causal"] for op in flash] == \
        [False] * L + [True, False] * L
    cross = flash[L + 1]
    assert blk.var(cross.input("Q")[0]).shape[1] == TGT
    assert blk.var(cross.input("K")[0]).shape[1] == SRC
    if amp:
        assert {blk.var(op.output("Out")[0]).dtype for op in flash} == \
            {"bfloat16"}
        assert {p.dtype for p in blk.all_parameters()} == {"float32"}


def _nullcontext():
    import contextlib

    return contextlib.nullcontext()


@pytest.mark.parametrize("is_test", [False, True], ids=["train", "infer"])
def test_dropout_translate_program_matches_jax(is_test):
    """dropout_rate > 0: the embedding and FFN dropouts as the JAX
    package builds them (an inference Program, and a training Program
    without the optimizer); in training the attentions take the
    composed path, whose dropout draws over the attention weights (the
    encoder's, the decoder's and the cross attentions: 3 a layer)."""
    jm, js, _ = _translate(jfluid, jfw, jtr, 0.1, is_test, optimize=False)
    tm, ts, _ = _translate(tfluid, tfw, ttr, 0.1, is_test, optimize=False)
    _assert_same_program(jm, tm)
    _assert_same_program(js, ts)
    drops = [op for op in tm.global_block().ops if op.type == "dropout"]
    assert len(drops) == 2 + 2 * L + (0 if is_test else 3 * L)
    assert all(op.attrs["is_test"] == is_test for op in drops)


def test_lm_with_dropout_layers_matches_jax():
    """The LM builder's embedding and FFN dropouts (dropout_rate > 0 in
    an inference Program) build the JAX package's Program."""
    progs = []
    for fluid, fw, tr in ((jfluid, jfw, jtr), (tfluid, tfw, ttr)):
        fw.reset_unique_names()
        main = fluid.Program()
        with fluid.program_guard(main, fluid.Program()):
            ids = fluid.layers.data(name="ids", shape=[TGT], dtype="int64")
            tr.transformer_lm(ids, TV, d_model=D, n_heads=H, n_layers=L,
                              max_len=TGT, dropout_rate=0.2, is_test=True)
        progs.append(main)
    _assert_same_program(*progs)


def test_remat_raises_naming_a4b():
    """remat no longer raises: with remat=True every encoder and decoder
    block is a recompute segment, the JAX package's Program, and STEPS
    Adam steps from the JAX startup train as the JAX package's remat
    build does (losses 1e-5 relative, parameters atol 1e-5); the
    `remat` flag builds the same segments with remat=None."""
    jm, js, _ = _translate(jfluid, jfw, jtr, remat=True)
    tm, ts, _ = _translate(tfluid, tfw, ttr, remat=True)
    _assert_same_program(jm, tm)
    _assert_same_program(js, ts)
    assert sum(op.type == "recompute"
               for op in tm.global_block().ops) == 2 * L
    jl, tl, names, *_ = _train(amp=False, remat=True)
    _assert_losses_close(jl, tl)
    assert tl[-1] < tl[0]
    _assert_params_close(names)
    tflags.set_flags({"remat": True})
    with tfluid.program_guard(tfluid.Program(), tfluid.Program()):
        src = tfluid.layers.data(name="src", shape=[SRC], dtype="int64")
        ttr.transformer_encoder(src, SV, d_model=D, n_heads=H, n_layers=1)
        assert [op.type for op in tfluid.default_main_program()
                .global_block().ops].count("recompute") == 1


# -- training parity ---------------------------------------------------------

def _train(amp, compiled_jax=None, remat=False):
    """STEPS Adam steps on both sides from the JAX startup -> (JAX
    losses, port losses, persistable names, parameter names, initial
    parameters, the port's main Program)."""
    jm, js, jl = _translate(jfluid, jfw, jtr, remat=remat)
    tm, ts, tl = _translate(tfluid, tfw, ttr, remat=remat)
    jexe, texe, names = _start_both(jm, js, tm, ts)
    params = sorted(p.name for p in tm.global_block().all_parameters())
    init = {n: np.asarray(jexecutor.global_scope().find_var(n)).copy()
            for n in params}
    jloss, tloss = [], []
    feed = _feeds(0)        # one batch: the loss must fall on it
    for _ in range(STEPS):
        jloss.append(float(np.asarray(jexe.run(
            jm, feed=feed, fetch_list=[jl], compiled=compiled_jax)[0],
            np.float32).reshape(-1)[0]))
        tloss.append(float(texe.run(tm, feed=feed,
                                    fetch_list=[tl])[0].reshape(-1)[0]))
    return jloss, tloss, names, params, init, tm


def test_fp32_adam_trains_like_jax():
    jl, tl, names, *_ = _train(amp=False)
    _assert_losses_close(jl, tl)
    assert tl[-1] < tl[0]
    _assert_params_close(names)


def test_amp_adam_trains_like_jax():
    with _both_amp():
        jl, tl, names, params, init, tm = _train(amp=True,
                                                 compiled_jax=False)
    assert np.all(np.isfinite(tl)) and tl[-1] < tl[0]
    jl = np.array(jl)
    assert np.all(np.abs(np.array(tl) - jl) <= LOSS_ULPS * _bf16_ulp(jl)), \
        (tl, jl)
    scope = tfluid.global_scope()
    assert all(scope.find_var(n).dtype == torch.float32 for n in names)
    tvals = scope_to_numpy(scope, params)
    noise = _k_biases(tm)
    assert len(noise) == 3 * L
    for n in params:
        j = np.asarray(jexecutor.global_scope().find_var(n))
        t = tvals[n]
        if t.ndim == 2:
            lim = TABLE_ULPS * _bf16_ulp(np.abs(j).max())
            assert np.abs(t - j).max() <= lim, n
        dj, dt = j - init[n], t - init[n]
        rel = np.linalg.norm(dt - dj) / np.linalg.norm(dj)
        assert rel <= (NOISE_RTOL if n in noise else CHANGE_RTOL), (n, rel)


@pytest.mark.parametrize("amp", [False, True], ids=["fp32", "amp"])
def test_default_mode_equals_the_interpreter(amp):
    """The port's default (compiled) mode against its interpreter from
    one startup: losses and every persistable bit for bit."""
    guard = tfluid.amp.bf16_guard() if amp else _nullcontext()
    with guard:
        main, startup, loss = _translate(tfluid, tfw, ttr)
        names = sorted(v.name for v in main.list_vars() if v.persistable)
        result = {}
        for compiled in (None, False):
            texecutor.switch_scope(Scope())
            exe = tfluid.Executor(CPUPlace(), seed=1)
            exe.run(startup)
            losses = [float(exe.run(main, feed=_feeds(s), fetch_list=[loss],
                                    compiled=compiled)[0][0])
                      for s in range(3)]
            result[compiled] = (losses, scope_to_numpy(
                tfluid.global_scope(), names))
    assert result[None][0] == result[False][0]
    for n in names:
        np.testing.assert_array_equal(result[None][1][n],
                                      result[False][1][n], err_msg=n)


def test_enc_out_gradient_accumulates_in_float32_under_amp():
    """enc_out (the encoder's final layer norm, f32) feeds 2 x n_layers
    K/V projections: its gradient is the `sum` of their cotangents, and
    in a step under amp every term and the sum are f32 on both sides
    (the Program types the first term f32 and leaves the renamed terms
    and the sum to run time, in both packages)."""
    with _both_amp():
        jm, js, jl = _translate(jfluid, jfw, jtr)
        tm, ts, tl = _translate(tfluid, tfw, ttr)
        blk = tm.global_block()
        lns = [op for op in blk.ops if op.type == "layer_norm"]
        enc_out = lns[2 * L].output("Y")[0]   # after the encoder's blocks
        readers = [op for op in blk.ops if enc_out in op.input_names()
                   and not op.type.endswith("_grad")]
        assert [op.type for op in readers] == ["mul"] * (2 * L)
        sums = [op for op in blk.ops if op.type == "sum" and
                op.input("X")[0] == enc_out + "@GRAD"]
        assert len(sums) == 1 and len(sums[0].input("X")) == 2 * L
        assert blk.var(enc_out + "@GRAD").dtype == "float32"
        names = sums[0].input("X") + sums[0].output("Out")
        jexe, texe, _ = _start_both(jm, js, tm, ts)
        jv = jexe.run(jm, feed=_feeds(0), fetch_list=names, compiled=False)
        tv = texe.run(tm, feed=_feeds(0), fetch_list=names,
                      return_numpy=False)
    assert [np.asarray(v).dtype for v in jv] == [np.float32] * len(names)
    assert [v.dtype for v in tv] == [torch.float32] * len(names)
    np.testing.assert_allclose(tv[-1].numpy(), np.asarray(jv[-1]),
                               rtol=0, atol=1e-2 * np.abs(jv[-1]).max())
