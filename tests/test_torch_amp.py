"""bf16 mixed precision (`paddle_tpu_torch.amp`) against the JAX
package's `paddle_tpu.amp`, on the CPU.

Programs: built under `bf16_guard`, the transformer LM and the MoE LM
of each package are equal by `to_dict()`, var dtypes included (the amp
dtype map is the Program's: bf16 `mul` outputs, bias adds and
attention; f32 layer-norm outputs, losses and every parameter).

Training: the LM from the JAX startup's parameters, 5 steps under amp
with Momentum and with Adam, against the JAX package's interpreter
(`compiled=False`, op by op as the port runs).  Tolerances, stated in
bf16 ulps (ulp(v) = 2^(floor(log2|v|) - 7)):

  * each step's loss within 1 ulp of the JAX loss (measured: at most
    0.4 ulp);
  * each weight matrix and table within 16 ulps of its largest value
    (measured: at most 0.5 for the projections, 6.4 for the embedding
    and position tables, whose rows sum bf16 cotangents);
  * every parameter's change over the 5 steps within 15 % of the JAX
    change (relative norm; measured at most 10 %).  The step-0 forward
    is bit-equal, but the two libraries round bf16 reductions (bias and
    layer-norm gradients) differently by 1-3 ulps, and bf16 training
    amplifies that: the JAX package's own compiled and interpreted
    modes differ by up to 13.5 % on this model.  The key-projection
    biases have an exactly-zero gradient (softmax is shift-invariant
    per query), so their moves are rounding noise on both sides (the
    JAX modes differ by up to 148 % there): they are held to the same
    size of move, a relative difference of at most 2.

Then analogues of the JAX package's tests/test_amp.py tests 1-3, with a
two-layer fc net in place of the conv net: bf16 activations with f32
master weights and convergence, amp off giving f32 again, and an f32
bias under Adam; and its test 4 as it stands there: an explicitly bf16
model (no amp) trains under Adam, with f32 beta-pow accumulators.
"""
import os
import sys

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
from paddle_tpu_torch.models.moe import build_moe_lm

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmark"))
import run_moe  # noqa: E402  (the JAX package's MoE LM builder)
from test_torch_training import (  # noqa: E402
    _assert_same_program, _lm, _lm_feeds, _start_both)

MOE = dict(batch=2, seq=8, vocab=31, d_model=32, n_heads=2, n_layers=2,
           experts=4, top_k=2, capacity_factor=1.25)
STEPS = 5
LOSS_ULPS, TABLE_ULPS, CHANGE_RTOL, NOISE_RTOL = 1, 16, 0.15, 2.0


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


def _bf16_ulp(v):
    return 2.0 ** (np.floor(np.log2(np.abs(v))) - 7)


def _both_amp():
    """bf16_guard of both packages at once."""
    import contextlib

    stack = contextlib.ExitStack()
    stack.enter_context(jfluid.amp.bf16_guard())
    stack.enter_context(tfluid.amp.bf16_guard())
    return stack


# -- the amp API -------------------------------------------------------------

def test_amp_api_mirrors_the_jax_package():
    from paddle_tpu_torch import amp

    assert sorted(amp.__all__) == sorted(jfluid.amp.__all__)
    assert not amp.is_bf16_enabled()
    x32, x16 = torch.ones(2), torch.ones(2, dtype=torch.bfloat16)
    ids = torch.ones(2, dtype=torch.int64)
    assert amp.amp_cast(x32) is x32 and amp.amp_upcast(x16) is x16
    with amp.bf16_guard():
        assert amp.is_bf16_enabled()
        a, b, c = amp.amp_cast(x32, x16, ids)
        assert (a.dtype, b.dtype, c.dtype) == (torch.bfloat16,
                                               torch.bfloat16, torch.int64)
        assert amp.amp_upcast(x16).dtype == torch.float32
        assert amp.amp_upcast(ids) is ids
    assert not amp.is_bf16_enabled()
    amp.enable_bf16()
    assert tflags.get_flag("amp_bf16")
    amp.disable_bf16()
    assert not tflags.get_flag("amp_bf16")


def test_elementwise_mixed_widths_compute_in_bf16_only_under_amp():
    from paddle_tpu_torch.core.execution import ExecContext
    from paddle_tpu_torch.core.registry import get_op_info

    lower = get_op_info("elementwise_add").lower
    ins = {"X": [torch.ones(2, 3, dtype=torch.bfloat16)],
           "Y": [torch.ones(3)]}
    assert lower(ExecContext(), ins, {"axis": -1})["Out"].dtype \
        == torch.float32
    with tfluid.amp.bf16_guard():
        assert lower(ExecContext(), ins, {"axis": -1})["Out"].dtype \
            == torch.bfloat16


# -- Programs ----------------------------------------------------------------

def test_amp_lm_program_matches_jax():
    with _both_amp():
        jm, js, _ = _lm(jfluid, jfw, jtr, "momentum")
        tm, ts, _ = _lm(tfluid, tfw, ttr, "momentum")
    _assert_same_program(jm, tm)
    _assert_same_program(js, ts)
    blk = tm.global_block()
    dtype = {op.type: blk.var(op.output_names()[0]).dtype
             for op in blk.ops if not op.type.endswith("_grad")}
    assert dtype["mul"] == dtype["flash_attention"] == "bfloat16"
    assert dtype["layer_norm"] == dtype["softmax_with_cross_entropy"] \
        == "float32"
    assert {p.dtype for p in blk.all_parameters()} == {"float32"}


def test_amp_moe_lm_program_matches_jax():
    with _both_amp():
        jfw.reset_unique_names()
        jm, js, _ = run_moe.build_moe_lm(**MOE)
        tfw.reset_unique_names()
        tm, ts, _ = build_moe_lm(**MOE)
    _assert_same_program(jm, tm)
    _assert_same_program(js, ts)
    blk = tm.global_block()
    moe = [op for op in blk.ops if op.type == "moe_ffn"]
    # the MoE FFN takes the f32 layer-norm output: no amp cast in it
    assert moe and {blk.var(op.input("X")[0]).dtype for op in moe} \
        == {"float32"}
    assert {p.dtype for p in blk.all_parameters()} == {"float32"}


def test_amp_cross_entropy_program_matches_jax():
    """An fc softmax into `cross_entropy` under amp: the explicit
    cross_entropy shape inference types its loss as the JAX package's
    does (f32: softmax upcasts the bf16 logits, so the probabilities are
    f32 too)."""
    def build(fluid, fw):
        fw.reset_unique_names()
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.layers.data(name="x", shape=[8], dtype="float32")
            y = fluid.layers.data(name="y", shape=[1], dtype="int64")
            p = fluid.layers.fc(input=x, size=50, act="softmax")
            loss = fluid.layers.mean(
                fluid.layers.cross_entropy(input=p, label=y))
            fluid.Adam(learning_rate=1e-3).minimize(loss)
        return main, startup

    with _both_amp():
        jm, js = build(jfluid, jfw)
        tm, ts = build(tfluid, tfw)
    _assert_same_program(jm, tm)
    _assert_same_program(js, ts)


# -- training parity ---------------------------------------------------------

def _k_biases(prog):
    """The key projections' bias parameters: flash_attention's K input
    <- reshape <- the bias add, whose Y is the bias."""
    blk = prog.global_block()
    producer = {n: op for op in blk.ops for n in op.output_names()}
    out = set()
    for op in blk.ops:
        if op.type == "flash_attention":
            add = producer[producer[op.input("K")[0]].input("X")[0]]
            assert add.type == "elementwise_add"
            out.add(add.input("Y")[0])
    return out


@pytest.mark.parametrize("kind", ["momentum", "adam"])
def test_amp_lm_trains_like_jax(kind):
    with _both_amp():
        jm, js, jl = _lm(jfluid, jfw, jtr, kind)
        tm, ts, tl = _lm(tfluid, tfw, ttr, kind)
        jexe, texe, names = _start_both(jm, js, tm, ts)
        params = sorted(p.name for p in tm.global_block().all_parameters())
        init = {n: np.asarray(jexecutor.global_scope().find_var(n)).copy()
                for n in params}
        jloss, tloss = [], []
        for step in range(STEPS):
            feed = _lm_feeds(step)
            jloss.append(float(jexe.run(jm, feed=feed, fetch_list=[jl],
                                        compiled=False)[0][0]))
            tloss.append(float(texe.run(tm, feed=feed,
                                        fetch_list=[tl])[0][0]))
    assert np.all(np.isfinite(tloss)) and tloss[-1] < tloss[0]
    jloss = np.array(jloss)
    assert np.all(np.abs(np.array(tloss) - jloss)
                  <= LOSS_ULPS * _bf16_ulp(jloss)), (tloss, jloss)
    scope = tfluid.global_scope()
    assert all(scope.find_var(n).dtype == torch.float32 for n in names)
    tvals = scope_to_numpy(scope, params)
    noise = _k_biases(tm)
    assert len(noise) == 2
    for n in params:
        j = np.asarray(jexecutor.global_scope().find_var(n))
        t = tvals[n]
        if t.ndim == 2:
            lim = TABLE_ULPS * _bf16_ulp(np.abs(j).max())
            assert np.abs(t - j).max() <= lim, n
        dj, dt = j - init[n], t - init[n]
        rel = np.linalg.norm(dt - dj) / np.linalg.norm(dj)
        assert rel <= (NOISE_RTOL if n in noise else CHANGE_RTOL), (n, rel)


# -- data parallel -----------------------------------------------------------

def _dp_lm():
    with tfluid.amp.bf16_guard():
        main, startup, loss = _lm(tfluid, tfw, ttr, "sgd")
    return main, startup, loss


def _dp_executor(main, startup, loss):
    t = tfluid.ShardingTranspiler()
    t.transpile(program=main, startup_program=startup, mesh={"dp": 1},
                overlap="bucketed", shard_optimizer_states=False)
    return t.build_executor(["ids", "lbl"], [loss], place=CPUPlace())


def test_amp_dp_fused_step_equals_serial():
    """The dp path under amp (every bucket f32: master weights and their
    gradients), fused bucket update armed, against the serial Executor
    on the same Program: bit for bit, as in float32."""
    main, startup, loss = _dp_lm()
    texe = tfluid.Executor(CPUPlace())
    texe.run(startup)
    params = sorted(p.name for p in main.global_block().all_parameters())
    init = scope_to_numpy(tfluid.global_scope(), params)
    tflags.set_flags({"serving_kernels": "on"})
    with tfluid.amp.bf16_guard():
        pe = _dp_executor(main, startup, loss)
        assert pe.overlap_info["update"] == "fused"
        for n in params:
            pe.set_state(n, init[n])
        dp = [float(pe.run(_lm_feeds(s))[0][0]) for s in range(2)]
        serial = [float(texe.run(main, feed=_lm_feeds(s),
                                 fetch_list=[loss])[0][0]) for s in range(2)]
    assert dp == serial
    tvals = scope_to_numpy(tfluid.global_scope(), params)
    for n in params:
        np.testing.assert_array_equal(pe.state(n), tvals[n], err_msg=n)


def test_a_bf16_gradient_in_an_f32_bucket_raises():
    """A gradient of another dtype than its parameter's (a bf16 gradient
    of an f32 master weight) raises in the overlap step instead of being
    promoted into its f32 bucket."""
    from paddle_tpu_torch.core.registry import get_op_info

    main, startup, loss = _dp_lm()
    tfluid.Executor(CPUPlace()).run(startup)
    info = get_op_info("mul")
    explicit = info.grad_lower

    def bf16_weight_grad(ctx, ins, attrs):
        out = explicit(ctx, ins, attrs)
        return dict(out, **{"Y@GRAD": [out["Y@GRAD"][0].bfloat16()]})

    with tfluid.amp.bf16_guard():
        pe = _dp_executor(main, startup, loss)
        info.grad_lower = bf16_weight_grad
        try:
            with pytest.raises(TypeError, match="bucket holds float32"):
                pe.run(_lm_feeds(0))
        finally:
            info.grad_lower = explicit


# -- analogues of tests/test_amp.py (an fc net for the conv net) -------------

def _fc_net():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        img = tfluid.layers.data(name="img", shape=[64], dtype="float32")
        label = tfluid.layers.data(name="label", shape=[1], dtype="int64")
        hidden = tfluid.layers.fc(input=img, size=16, act="relu")
        prob = tfluid.layers.fc(input=hidden, size=10, act="softmax")
        loss = tfluid.layers.mean(
            tfluid.layers.cross_entropy(input=prob, label=label))
        tfluid.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, hidden, loss


def _feed(rng):
    return {"img": rng.rand(8, 64).astype(np.float32),
            "label": rng.randint(0, 10, (8, 1)).astype(np.int64)}


def test_bf16_guard_activations_and_master_weights():
    rng = np.random.RandomState(0)
    main, startup, hidden, loss = _fc_net()
    scope = Scope()
    exe = tfluid.Executor(CPUPlace())
    exe.run(startup, scope=scope)
    param_names = [p.name for p in main.global_block().all_parameters()]
    assert param_names
    with tfluid.amp.bf16_guard():
        feed = _feed(rng)
        hidden_v, loss0 = exe.run(main, feed=feed,
                                  fetch_list=[hidden, loss], scope=scope,
                                  return_numpy=False)
        # the activations flow in bf16...
        assert hidden_v.dtype == torch.bfloat16
        losses = [float(loss0.reshape(-1)[0])]
        for _ in range(30):
            lv, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
            losses.append(float(lv.reshape(-1)[0]))
    # ...while the master weights stay float32 and training converges
    for n in param_names:
        assert scope.find_var(n).dtype == torch.float32, n
    assert losses[-1] < losses[0] * 0.9, losses


def test_amp_off_keeps_f32():
    rng = np.random.RandomState(1)
    main, startup, hidden, loss = _fc_net()
    scope = Scope()
    exe = tfluid.Executor(CPUPlace())
    exe.run(startup, scope=scope)
    feed = _feed(rng)

    def hidden_dtype():
        return exe.run(main, feed=feed, fetch_list=[hidden], scope=scope,
                       return_numpy=False)[0].dtype

    assert hidden_dtype() == torch.float32
    with tfluid.amp.bf16_guard():
        assert hidden_dtype() == torch.bfloat16
    assert hidden_dtype() == torch.float32


def test_amp_master_weights_adam_converges():
    """Under amp a layer whose input is a bf16 intermediate (the fc bias
    after the bf16 product) still makes f32 parameters, and Adam on
    them trains."""
    r = np.random.RandomState(0)
    vocab, batch = 50, 16
    xs = r.rand(batch, 8).astype(np.float32)
    ys = r.randint(0, vocab, (batch, 1)).astype(np.int64)
    tfluid.amp.enable_bf16()
    try:
        main, startup = tfluid.Program(), tfluid.Program()
        with tfluid.program_guard(main, startup):
            x = tfluid.layers.data(name="x", shape=[8], dtype="float32")
            y = tfluid.layers.data(name="y", shape=[1], dtype="int64")
            p = tfluid.layers.fc(input=x, size=vocab, act="softmax")
            loss = tfluid.layers.mean(
                tfluid.layers.cross_entropy(input=p, label=y))
            tfluid.Adam(learning_rate=1e-3).minimize(loss)
        assert main.global_block().var("fc_0.tmp_1").dtype == "bfloat16"
        scope = Scope()
        exe = tfluid.Executor(CPUPlace())
        exe.run(startup, scope=scope)
        bias = [n for n in scope.local_names() if n.endswith(".b_0")]
        assert bias and scope.find_var(bias[0]).dtype == torch.float32
        tr = [float(exe.run(main, feed={"x": xs, "y": ys},
                            fetch_list=[loss], scope=scope)[0].reshape(-1)[0])
              for _ in range(10)]
        assert tr[-1] < tr[0] and tr[-1] < 5.0, tr
        assert all(scope.find_var(n).dtype == torch.float32
                   for n in scope.local_names()
                   if isinstance(scope.find_var(n), torch.Tensor)
                   and scope.find_var(n).is_floating_point())
    finally:
        tfluid.amp.disable_bf16()


def test_explicit_bf16_adam_actually_trains():
    """tests/test_amp.py:113 in the port: an explicitly bf16 model (no
    amp) under Adam.  The beta-pow accumulators must be f32 (bf16 rounds
    0.999 to 1.0, pinning lr_t at 0) and the update arithmetic f32."""
    import ml_dtypes

    r = np.random.RandomState(1)
    xs = r.rand(8, 4).astype(np.float32).astype(ml_dtypes.bfloat16)
    ys = r.rand(8, 1).astype(np.float32).astype(ml_dtypes.bfloat16)
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="x", shape=[4], dtype="bfloat16")
        y = tfluid.layers.data(name="y", shape=[1], dtype="bfloat16")
        pred = tfluid.layers.fc(input=x, size=1)
        loss = tfluid.layers.mean(
            tfluid.layers.cast(
                tfluid.layers.square_error_cost(pred, y), "float32"))
        tfluid.Adam(learning_rate=0.05).minimize(loss)
    scope = Scope()
    exe = tfluid.Executor(CPUPlace())
    exe.run(startup, scope=scope)
    b2p = [n for n in scope.local_names() if "beta2_pow" in n]
    assert scope.find_var(b2p[0]).dtype == torch.float32
    w0 = scope.find_var("fc_0.w_0").float().clone()
    tr = [np.asarray(exe.run(main, feed={"x": xs, "y": ys},
                             fetch_list=[loss], scope=scope)[0])
          .reshape(-1)[0].item() for _ in range(20)]
    w1 = scope.find_var("fc_0.w_0").float()
    assert scope.find_var("fc_0.w_0").dtype == torch.bfloat16
    assert not torch.allclose(w0, w1), "params frozen"
    assert tr[-1] < tr[0], tr
    # beta2_pow actually decays
    assert float(scope.find_var(b2p[0]).reshape(-1)[0]) < 0.999


def test_the_port_casts_at_op_edges_only():
    """No PyTorch automatic mixed precision anywhere in the port or its
    smoke script: amp is the op lowerings' own casts."""
    import ast

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    files = [os.path.join(root, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(root, "paddle_tpu_torch")):
        files += [os.path.join(dirpath, n) for n in names
                  if n.endswith(".py")]
    used = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            name = (node.attr if isinstance(node, ast.Attribute) else
                    node.id if isinstance(node, ast.Name) else None)
            if name in ("autocast", "GradScaler"):
                used.append((path, node.lineno))
    assert len(files) > 50 and not used, used
