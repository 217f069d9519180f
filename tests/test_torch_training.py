"""The port's training path against the JAX package, on the CPU.

Both packages build the same training Programs under reset unique
names; `Optimizer.minimize` must rewrite them identically (grad ops,
slots, attrs, sum insertion, zero cotangents, accumulators).  The JAX
startup program makes the parameters, which carry into the port's
scope through `scope_from_numpy`; then both executors take the same
numpy-seeded feeds.

Tolerances (float32 on both sides; the same arithmetic summed in
another order by another library): per-step losses within 1e-5
relative, parameters after the last step within atol 1e-5.  Adam runs
at learning rate 1e-4: it scales each gradient element to about unit
size, so an element whose exact gradient is 0 — the key-projection
biases, as softmax is shift-invariant per query — moves by about
lr x sign(rounding noise), and the two libraries' noise differs.  At
1e-4 that move stays inside atol 1e-5.

Program dicts are compared with int64 read as int32: the JAX package
never enables x64, so its shape inference types an int64 label's
reshape as int32 where the port keeps Paddle's int64.
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
from paddle_tpu_torch.core.scope import (Scope, scope_from_numpy,
                                         scope_to_numpy)
from paddle_tpu_torch.models import transformer as ttr

V, D, H, L, SEQ, BATCH = 29, 32, 2, 2, 16, 4
LOSS_RTOL, PARAM_ATOL = 1e-5, 1e-5


@pytest.fixture(autouse=True)
def _fresh_port_state():
    """The port's unique names, default programs, global scope and flags,
    per test (the suite's conftest resets only the JAX package)."""
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


def _optimizer(fluid, kind):
    if kind == "sgd":
        return fluid.SGD(learning_rate=0.01)
    if kind == "momentum":
        return fluid.Momentum(learning_rate=0.01, momentum=0.9)
    return fluid.Adam(learning_rate=1e-4)


def _fit_a_line(fluid, fw, kind="sgd", clip=None, reg=None, two_inputs=False):
    """The README example: fc regression with a mean squared error."""
    fw.reset_unique_names()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[13], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        inp = [x, fluid.layers.data(name="x2", shape=[5], dtype="float32")] \
            if two_inputs else x
        pred = fluid.layers.fc(input=inp, size=1)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
        if clip is not None:
            fluid.clip.set_gradient_clip(clip)
        opt = _optimizer(fluid, kind)
        opt.regularization = reg
        opt.minimize(loss)
    return main, startup, loss


def _lm(fluid, fw, tr, kind):
    """The transformer LM training Program of benchmark/run_ridge.py at
    a tiny width."""
    fw.reset_unique_names()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        ids = fluid.layers.data(name="ids", shape=[SEQ], dtype="int64")
        lbl = fluid.layers.data(name="lbl", shape=[SEQ, 1], dtype="int64")
        logits = tr.transformer_lm(ids, V, d_model=D, n_heads=H, n_layers=L,
                                   max_len=SEQ, return_logits=True)
        cost = fluid.layers.softmax_with_cross_entropy(
            fluid.layers.reshape(logits, shape=[-1, V]),
            fluid.layers.reshape(lbl, shape=[-1, 1]))
        loss = fluid.layers.mean(cost)
        _optimizer(fluid, kind).minimize(loss)
    return main, startup, loss


def _int_as_int32(d):
    """Program dict with every var dtype int64 read as int32."""
    for blk in d["blocks"]:
        for v in blk["vars"]:
            if v["dtype"] == "int64":
                v["dtype"] = "int32"
    return d


def _assert_same_program(jprog, tprog):
    assert _int_as_int32(tprog.to_dict()) == _int_as_int32(jprog.to_dict())


def _persistables(prog):
    return sorted(v.name for v in prog.list_vars() if v.persistable)


def _start_both(jmain, jstart, tmain, tstart):
    """Run both startup programs; copy the JAX parameters into the port.
    The port's own startup values of the other persistables (learning
    rate, optimizer accumulators) must equal the JAX package's."""
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jstart)
    names = _persistables(jmain)
    assert _persistables(tmain) == names
    jvals = {n: np.asarray(jexecutor.global_scope().find_var(n))
             for n in names}
    texe = tfluid.Executor(CPUPlace())
    texe.run(tstart)
    params = {v.name for v in tmain.global_block().all_parameters()}
    tvals = scope_to_numpy(tfluid.global_scope(), names)
    for n in names:
        assert tvals[n].shape == jvals[n].shape, n
        if n not in params:
            np.testing.assert_array_equal(tvals[n], jvals[n], err_msg=n)
    scope_from_numpy({n: jvals[n] for n in params}, CPUPlace(),
                     tfluid.global_scope())
    return jexe, texe, names


def _assert_params_close(names):
    tvals = scope_to_numpy(tfluid.global_scope(), names)
    for n in names:
        np.testing.assert_allclose(
            tvals[n], np.asarray(jexecutor.global_scope().find_var(n)),
            rtol=0, atol=PARAM_ATOL, err_msg=n)


def _assert_losses_close(jl, tl):
    jl, tl = np.asarray(jl), np.asarray(tl)
    assert np.all(np.isfinite(tl))
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL, atol=0)


# -- Programs ----------------------------------------------------------------

@pytest.mark.parametrize("kind", ["sgd", "momentum", "adam"])
def test_lm_training_program_matches_jax(kind):
    jm, js, _ = _lm(jfluid, jfw, jtr, kind)
    tm, ts, _ = _lm(tfluid, tfw, ttr, kind)
    _assert_same_program(jm, tm)
    _assert_same_program(js, ts)
    types = [op.type for op in tm.global_block().ops]
    # generic grad ops, the embedding's own grad op, sum insertion where
    # a value fans out (the residual stream)
    assert "flash_attention_grad" in types and "sum" in types
    assert "lookup_table_grad" in types and "layer_norm_grad" in types


@pytest.mark.parametrize("case", ["plain", "two_inputs", "clip_reg"])
def test_fit_a_line_program_matches_jax(case):
    kw = {"two_inputs": case == "two_inputs"}

    def build(fluid, fw):
        if case == "clip_reg":
            kw["clip"] = fluid.clip.GradientClipByGlobalNorm(1.0)
            kw["reg"] = fluid.regularizer.L2Decay(1e-3)
        return _fit_a_line(fluid, fw, "momentum", **kw)

    jm, js, _ = build(jfluid, jfw)
    tm, ts, _ = build(tfluid, tfw)
    _assert_same_program(jm, tm)
    _assert_same_program(js, ts)


# -- training parity ---------------------------------------------------------

def _line_batches(n, two_inputs=False):
    """Batches of a noisy linear target the model can fit."""
    r = np.random.RandomState(0)
    w = r.standard_normal((13, 1)).astype(np.float32)
    for _ in range(n):
        x = r.standard_normal((8, 13)).astype(np.float32)
        y = x @ w + 0.1 * r.standard_normal((8, 1)).astype(np.float32)
        feed = {"x": x, "y": y}
        if two_inputs:
            feed["x2"] = r.standard_normal((8, 5)).astype(np.float32)
        yield feed


@pytest.mark.parametrize("case", ["sgd", "two_inputs", "clip_reg"])
def test_fit_a_line_trains_like_jax(case):
    """The README's fit-a-line: 20 SGD steps (the other cases: fc over
    two inputs, and global-norm clipping with L2 decay, 10 steps)."""
    kw = {"two_inputs": True} if case == "two_inputs" else {}
    steps = 20 if case == "sgd" else 10

    def build(fluid, fw):
        if case == "clip_reg":
            kw["clip"] = fluid.clip.GradientClipByGlobalNorm(0.5)
            kw["reg"] = fluid.regularizer.L2Decay(1e-2)
        return _fit_a_line(fluid, fw, "sgd", **kw)

    jm, js, jl = build(jfluid, jfw)
    tm, ts, tl = build(tfluid, tfw)
    jexe, texe, names = _start_both(jm, js, tm, ts)
    jloss, tloss = [], []
    for feed in _line_batches(steps, two_inputs=case == "two_inputs"):
        jloss.append(jexe.run(jm, feed=feed, fetch_list=[jl])[0][0])
        tloss.append(texe.run(tm, feed=feed, fetch_list=[tl])[0][0])
    _assert_losses_close(jloss, tloss)
    if case != "clip_reg":      # clipped to norm 0.5, it barely moves
        assert tloss[-1] < tloss[0]
    _assert_params_close(names)


def _lm_feeds(step):
    """The periodic next-token data of examples/transformer_lm.py."""
    base = np.arange(BATCH * SEQ).reshape(BATCH, SEQ) % 97
    ids = ((base + step) % V).astype(np.int64)
    nxt = ((base + step + 1) % V).astype(np.int64)[..., None]
    return {"ids": ids, "lbl": nxt}


@pytest.mark.parametrize("kind", ["momentum", "adam"])
def test_transformer_lm_trains_like_jax(kind):
    jm, js, jl = _lm(jfluid, jfw, jtr, kind)
    tm, ts, tl = _lm(tfluid, tfw, ttr, kind)
    jexe, texe, names = _start_both(jm, js, tm, ts)
    jloss, tloss = [], []
    for step in range(5):
        feed = _lm_feeds(step)
        jloss.append(jexe.run(jm, feed=feed, fetch_list=[jl])[0][0])
        tloss.append(texe.run(tm, feed=feed, fetch_list=[tl])[0][0])
    _assert_losses_close(jloss, tloss)
    assert tloss[-1] < tloss[0]
    _assert_params_close(names)


def test_calc_gradient_matches_jax():
    """calc_gradient of a loss wrt an intermediate and a parameter."""
    def build(fluid, fw):
        fw.reset_unique_names()
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.layers.data(name="x", shape=[6], dtype="float32")
            h = fluid.layers.fc(input=x, size=4, act="relu")
            loss = fluid.layers.mean(fluid.layers.square(h))
            w = main.global_block().all_parameters()[0]
            grads = fluid.backward.calc_gradient(loss, [h, w])
        return main, startup, grads

    jm, js, jg = build(jfluid, jfw)
    tm, ts, tg = build(tfluid, tfw)
    _assert_same_program(jm, tm)
    _assert_same_program(js, ts)
    jexe, texe, _ = _start_both(jm, js, tm, ts)
    feed = next(_line_batches(1))
    feed = {"x": feed["x"][:, :6]}
    jv = jexe.run(jm, feed=feed, fetch_list=jg)
    tv = texe.run(tm, feed=feed, fetch_list=tg)
    for a, b in zip(jv, tv):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)


# -- op lowerings -------------------------------------------------------------

def _op_cases():
    r = np.random.RandomState(3)
    f = lambda *s: r.standard_normal(s).astype(np.float32)  # noqa: E731
    pos = lambda *s: (r.rand(*s) + 0.1).astype(np.float32)  # noqa: E731
    x = f(4, 6)
    lbl = r.randint(0, 6, (4, 1)).astype(np.int64)
    lr = np.array([0.05], np.float32)
    pg = {"Param": [f(5, 3)], "Grad": [f(5, 3)], "LearningRate": [lr]}
    return [
        ("mean", {"X": [x]}, {}),
        ("reduce_sum", {"X": [x]}, {"reduce_all": True, "dim": [0]}),
        ("reduce_sum", {"X": [f(2, 3, 4)]}, {"dim": [-1], "keep_dim": True}),
        ("square", {"X": [x]}, {}),
        ("sqrt", {"X": [pos(4, 6)]}, {}),
        ("scale", {"X": [x]}, {"scale": 0.9, "bias": 0.5}),
        ("elementwise_sub", {"X": [x], "Y": [f(6)]}, {"axis": -1}),
        ("elementwise_mul", {"X": [f(2, 4, 6)], "Y": [f(4)]}, {"axis": 1}),
        ("elementwise_div", {"X": [x], "Y": [pos(4, 6)]}, {}),
        ("elementwise_max", {"X": [x], "Y": [f(1)]}, {}),
        ("sum", {"X": [x, f(4, 6), f(4, 6)]}, {}),
        ("clip", {"X": [x]}, {"min": -0.5, "max": 0.5}),
        ("clip_by_norm", {"X": [x]}, {"max_norm": 1.0}),
        ("fill_zeros_like", {"X": [x]}, {}),
        ("assign", {"X": [x]}, {}),
        ("increment", {"X": [lr]}, {"step": 2.0}),
        ("cross_entropy", {"X": [pos(4, 6)], "Label": [lbl]}, {}),
        ("softmax_with_cross_entropy", {"Logits": [x], "Label": [lbl]}, {}),
        ("sgd", pg, {}),
        ("momentum", {**pg, "Velocity": [f(5, 3)]}, {"mu": 0.9}),
        ("momentum", {**pg, "Velocity": [f(5, 3)]},
         {"mu": 0.8, "use_nesterov": True}),
        ("adam", {**pg, "Moment1": [f(5, 3)], "Moment2": [pos(5, 3)],
                  "Beta1Pow": [np.array([0.81], np.float32)],
                  "Beta2Pow": [np.array([0.998], np.float32)]}, {}),
        ("lookup_table_grad",
         {"Ids": [np.array([[1], [3], [1], [0]], np.int64)], "W": [f(5, 3)],
          "Out@GRAD": [f(4, 3)]}, {"padding_idx": 0}),
        ("pruning_mask", {"Param": [f(7, 9)]}, {"sparsity_ratio": 0.6}),
    ]


@pytest.mark.parametrize("case", range(len(_op_cases())))
def test_training_op_lowering_matches_jax(case):
    import jax.numpy as jnp

    from paddle_tpu.core import registry as jreg
    from paddle_tpu.core.execution import ExecContext as JExecContext
    from paddle_tpu_torch.core import registry as treg
    from paddle_tpu_torch.core.execution import ExecContext as TExecContext

    op, ins, attrs = _op_cases()[case]
    jinfo, tinfo = jreg.get_op_info(op), treg.get_op_info(op)
    assert (tinfo.inputs, tinfo.outputs) == (jinfo.inputs, jinfo.outputs)
    assert tinfo.attrs == jinfo.attrs
    assert (tinfo.diff_inputs, tinfo.diff_outputs) == \
        (jinfo.diff_inputs, jinfo.diff_outputs)
    jout = jinfo.lower(JExecContext(), {k: [jnp.asarray(a) for a in v]
                                        for k, v in ins.items()},
                       {**jinfo.attrs, **attrs})
    tout = tinfo.lower(TExecContext("cpu"),
                       {k: [torch.from_numpy(a) for a in v]
                        for k, v in ins.items()},
                       {**tinfo.attrs, **attrs})
    assert set(tout) == set(jout)
    for slot in jout:
        np.testing.assert_allclose(tout[slot].numpy(), np.asarray(jout[slot]),
                                   rtol=0, atol=1e-6, err_msg=f"{op}.{slot}")


# -- contracts ---------------------------------------------------------------

def test_executor_without_cuda_raises(monkeypatch):
    """No silent CPU: the default place is CUDAPlace(0)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfluid.Executor()


def test_compiled_mode_is_not_ported():
    main, startup, loss = _fit_a_line(tfluid, tfw)
    exe = tfluid.Executor(CPUPlace())
    exe.run(startup)
    with pytest.raises(NotImplementedError, match="A4"):
        exe.run(main, feed=next(_line_batches(1)), fetch_list=[loss],
                compiled=True)


def test_main_before_startup_names_the_missing_parameter():
    main, _, loss = _fit_a_line(tfluid, tfw)
    with pytest.raises(RuntimeError, match="run the startup program"):
        tfluid.Executor(CPUPlace()).run(
            main, feed=next(_line_batches(1)), fetch_list=[loss])


def test_remat_and_sparse_embedding_grads_raise():
    ids = tfluid.layers.data(name="ids", shape=[SEQ], dtype="int64")
    with pytest.raises(NotImplementedError, match="A4"):
        ttr.transformer_decoder(ids, None, V, d_model=D, n_heads=H,
                                n_layers=1, max_len=SEQ, remat=True)
    from paddle_tpu_torch.core.registry import get_op_info

    lower = get_op_info("lookup_table_grad").lower
    ins = {"Ids": [torch.zeros(2, dtype=torch.int64)],
           "W": [torch.zeros(4, 3)], "Out@GRAD": [torch.ones(2, 3)]}
    with pytest.raises(NotImplementedError, match="A1"):
        lower(None, ins, {"is_sparse": True, "padding_idx": -1})
    out = lower(None, ins, {"is_sparse": False, "padding_idx": -1})
    assert out["W@GRAD"][0].tolist() == [2.0, 2.0, 2.0]


def test_scope_carrier_round_trip_keeps_int64():
    arrays = {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
              "ids": np.array([1, 2], dtype=np.int32)}
    scope = scope_from_numpy(arrays, CPUPlace())
    assert scope.find_var("ids").dtype == torch.int64
    back = scope_to_numpy(scope, ["w", "ids"])
    np.testing.assert_array_equal(back["w"], arrays["w"])
    np.testing.assert_array_equal(back["ids"], arrays["ids"])
    with pytest.raises(KeyError):
        scope_to_numpy(scope, ["missing"])


def test_random_streams_are_keyed_by_op_identity():
    """A per-op stream depends on (step seed, op identity) only, and the
    generic gradient's recomputation context redraws the forward's
    numbers."""
    from paddle_tpu_torch.core.execution import ExecContext
    from paddle_tpu_torch.core.registry import get_op_info

    lower = get_op_info("gaussian_random").lower
    attrs = {"shape": [16], "mean": 0.0, "std": 1.0, "dtype": "float32"}
    step = ExecContext("cpu", seed=7)
    first = lower(step.child(1), {}, attrs)["Out"]
    assert torch.equal(first, lower(step.child(1), {}, attrs)["Out"])
    assert torch.equal(first, lower(step.child(1).pure(), {}, attrs)["Out"])
    assert not torch.equal(first, lower(step.child(2), {}, attrs)["Out"])
    assert not torch.equal(
        first, lower(ExecContext("cpu", seed=8).child(1), {}, attrs)["Out"])


def test_scope_guard_swaps_the_global_scope():
    main, startup, loss = _fit_a_line(tfluid, tfw)
    scope = Scope()
    with tfluid.scope_guard(scope):
        assert tfluid.global_scope() is scope
        tfluid.Executor(CPUPlace()).run(startup)
    assert tfluid.global_scope() is not scope
    assert not tfluid.global_scope().has_var("fc_0.w_0")
    out, = tfluid.Executor(CPUPlace()).run(
        main, feed=next(_line_batches(1)), fetch_list=[loss], scope=scope)
    assert out.shape == (1,) and np.isfinite(out).all()
