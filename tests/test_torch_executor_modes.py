"""The port's Executor modes (interpreted, compiled, segmented) against
each other and against the JAX package's, on the CPU.

On the CPU a compiled block or device segment is a plan resolved once
and run eagerly (a CUDA graph exists only on a card), so the default
mode must give the interpreter's bits: the same lowerings run in the
same order on the same values.  Against the JAX package's default
(compiled) mode the small LM is held at the tolerances
tests/test_torch_training.py (float32: losses 1e-5 relative,
parameters atol 1e-5) and tests/test_torch_amp.py (bf16 amp: losses
within one bf16 ulp, weight matrices within 16 ulps of their largest
value, each parameter's change within 15 %, the key-projection biases'
noise-sized moves within 2) already state.  The cache telemetry
(`cache_stats()`) and the mode chosen for a block and flags must equal
the JAX package's for the same runs (tests/test_executor_cache.py's
sequences).
"""
import contextlib
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu.core.framework as jfw
from paddle_tpu.core import executor as jexecutor
from paddle_tpu.core import flags as jflags
from paddle_tpu.models import transformer as jtr
from paddle_tpu.observability import metrics as jmetrics

import paddle_tpu_torch as tfluid
import paddle_tpu_torch.core.framework as tfw
from paddle_tpu_torch import CPUPlace
from paddle_tpu_torch.core import executor as texecutor
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.core import registry as tregistry
from paddle_tpu_torch.core.execution import ExecContext
from paddle_tpu_torch.core.scope import Scope, scope_to_numpy
from paddle_tpu_torch.models import transformer as ttr
from paddle_tpu_torch.observability import metrics as tmetrics

from test_torch_amp import (CHANGE_RTOL, LOSS_ULPS, NOISE_RTOL, TABLE_ULPS,
                            _bf16_ulp, _k_biases)
from test_torch_training import (LOSS_RTOL, PARAM_ATOL, _fit_a_line, _lm,
                                 _lm_feeds, _line_batches, _start_both)

STEPS = 3
MODES = ("interpreted", "segmented", "compiled")


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


def _amp(on):
    return tfluid.amp.bf16_guard() if on else contextlib.nullcontext()


def _persistables(prog):
    return sorted(v.name for v in prog.list_vars() if v.persistable)


# -- the default mode against the interpreter --------------------------------

def _build(model):
    if model == "fit_a_line":
        return _fit_a_line(tfluid, tfw, "momentum")
    return _lm(tfluid, tfw, ttr, "momentum")


def _feeds(model, n):
    if model == "fit_a_line":
        return list(_line_batches(n))
    return [_lm_feeds(step) for step in range(n)]


@pytest.mark.parametrize("amp", [False, True], ids=["fp32", "amp"])
@pytest.mark.parametrize("model", ["fit_a_line", "lm"])
def test_default_mode_is_the_interpreter_bit_for_bit(model, amp):
    """The same startup values, then 3 steps in each mode from them:
    every loss and every persistable bit-equal."""
    with _amp(amp):
        main, startup, loss = _build(model)
        names = _persistables(main)
        exe = tfluid.Executor(CPUPlace(), seed=3)
        exe.run(startup)
        init = scope_to_numpy(tfluid.global_scope(), names)
        result = {}
        for compiled in (None, False):
            scope = Scope()
            for n, a in init.items():
                scope.set_var(n, torch.from_numpy(a.copy()))
            run = tfluid.Executor(CPUPlace(), seed=3)
            losses = [run.run(main, feed=f, fetch_list=[loss], scope=scope,
                              compiled=compiled)[0]
                      for f in _feeds(model, STEPS)]
            result[compiled] = (losses, scope_to_numpy(scope, names))
            if compiled is None:
                assert run.cache_stats()["hits"] == STEPS - 1
    (lc, pc), (li, pi) = result[None], result[False]
    for a, b in zip(lc, li):
        assert a.tobytes() == b.tobytes(), (lc, li)
    for n in names:
        assert pc[n].tobytes() == pi[n].tobytes(), n


# -- the default mode against the JAX package's ------------------------------

@pytest.mark.parametrize("amp", [False, True], ids=["fp32", "amp"])
def test_default_mode_trains_like_the_jax_default_mode(amp):
    """The small LM from the JAX startup's parameters, 5 Momentum steps,
    both packages in their default mode (the JAX package's compiles the
    block with XLA)."""
    guard = contextlib.ExitStack()
    if amp:
        guard.enter_context(jfluid.amp.bf16_guard())
        guard.enter_context(tfluid.amp.bf16_guard())
    with guard:
        jm, js, jl = _lm(jfluid, jfw, jtr, "momentum")
        tm, ts, tl = _lm(tfluid, tfw, ttr, "momentum")
        jexe, texe, names = _start_both(jm, js, tm, ts)
        params = sorted(p.name for p in tm.global_block().all_parameters())
        init = {n: np.asarray(jexecutor.global_scope().find_var(n)).copy()
                for n in params}
        jloss, tloss = [], []
        for step in range(5):
            feed = _lm_feeds(step)
            jloss.append(float(jexe.run(jm, feed=feed, fetch_list=[jl])[0][0]))
            tloss.append(float(texe.run(tm, feed=feed, fetch_list=[tl])[0][0]))
        assert texe.cache_stats()["hits"] == 4
        assert jexe.cache_stats()["hits"] == 4
    jloss, tloss = np.array(jloss), np.array(tloss)
    assert np.all(np.isfinite(tloss)) and tloss[-1] < tloss[0]
    tvals = scope_to_numpy(tfluid.global_scope(), names)
    if not amp:
        np.testing.assert_allclose(tloss, jloss, rtol=LOSS_RTOL, atol=0)
        for n in names:
            np.testing.assert_allclose(
                tvals[n], np.asarray(jexecutor.global_scope().find_var(n)),
                rtol=0, atol=PARAM_ATOL, err_msg=n)
        return
    assert np.all(np.abs(tloss - jloss) <= LOSS_ULPS * _bf16_ulp(jloss)), \
        (tloss, jloss)
    noise = _k_biases(tm)
    for n in params:
        j, t = np.asarray(jexecutor.global_scope().find_var(n)), tvals[n]
        if t.ndim == 2:
            assert np.abs(t - j).max() <= TABLE_ULPS * _bf16_ulp(
                np.abs(j).max()), n
        dj, dt = j - init[n], t - init[n]
        rel = np.linalg.norm(dt - dj) / np.linalg.norm(dj)
        assert rel <= (NOISE_RTOL if n in noise else CHANGE_RTOL), (n, rel)


# -- cache telemetry against the JAX package's -------------------------------

def _mlp(fluid):
    """tests/test_executor_cache.py's MLP, in either package."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[16], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        h = fluid.layers.fc(input=x, size=32, act="relu")
        p = fluid.layers.fc(input=h, size=1)
        loss = fluid.layers.mean(
            fluid.layers.square_error_cost(input=p, label=y))
        fluid.SGD(learning_rate=0.01).minimize(loss)
    return main, startup, loss


def _segmented_net(fluid, host_op=True):
    """tests/test_executor_cache.py's segmented program, with its host op
    (`Print`, which the port lacks) replaced by a `scale` op forced onto
    the host (`force_cpu`, a host op in both packages)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        h = fluid.layers.fc(input=x, size=4)
        h = fluid.layers.scale(h, scale=2.0)
        if host_op:
            main.global_block().ops[-1].attrs["force_cpu"] = True
        loss = fluid.layers.mean(fluid.layers.fc(input=h, size=4))
    return main, startup, loss


def _feed(seed=0, rows=8):
    r = np.random.RandomState(seed)
    return {"x": r.rand(rows, 16).astype(np.float32),
            "y": r.rand(rows, 1).astype(np.float32)}


def _counts(stats):
    return {k: v for k, v in stats.items() if k != "compile_s"}


def _both(scenario):
    """Run `scenario(fluid, exe, scope, record)` in each package; the
    recorded cache_stats() sequences, compile_s left out."""
    seqs = []
    for fluid in (jfluid, tfluid):
        tfw.reset_unique_names()
        jfw.reset_unique_names()
        scope = fluid.Scope() if fluid is jfluid else Scope()
        exe = fluid.Executor(fluid.CPUPlace())
        seq = []
        scenario(fluid, exe, scope, lambda: seq.append(exe.cache_stats()))
        seqs.append(seq)
    for j, t in zip(*seqs):
        assert _counts(t) == _counts(j), (t, j)
    return seqs[1]


def _set_both_flags(flags):
    jflags.set_flags(flags)
    tflags.set_flags(flags)


def test_cache_stats_steady_state_like_jax():
    """Startup + 5 steps, then 3 more: startup and main miss once each,
    every other step hits, and compile_s does not grow in steady state."""
    def scenario(fluid, exe, scope, record):
        main, startup, loss = _mlp(fluid)
        record()
        exe.run(startup, scope=scope)
        record()
        for _ in range(5):
            exe.run(main, feed=_feed(), fetch_list=[loss], scope=scope)
            record()
        for _ in range(3):
            exe.run(main, feed=_feed(), fetch_list=[loss], scope=scope)
        record()

    seq = _both(scenario)
    assert _counts(seq[-1]) == {"hits": 7, "misses": 2, "entries": 2,
                                "recompiles_after_warmup": 0}
    assert seq[-2]["compile_s"] > 0
    assert seq[-1]["compile_s"] == seq[-2]["compile_s"]


def test_recompile_after_warmup_counted_and_warned_like_jax():
    """A new batch size on a warm program: one recompile, and the
    `log_recompiles` warning; a second new size counts again."""
    def scenario(fluid, exe, scope, record):
        main, startup, loss = _mlp(fluid)
        exe.run(startup, scope=scope)
        for _ in range(3):
            exe.run(main, feed=_feed(), fetch_list=[loss], scope=scope)
        record()
        _set_both_flags({"log_recompiles": True})
        try:
            with pytest.warns(RuntimeWarning,
                              match="recompile after warmup"):
                exe.run(main, feed=_feed(rows=3), fetch_list=[loss],
                        scope=scope)
        finally:
            _set_both_flags({"log_recompiles": False})
        record()
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            exe.run(main, feed=_feed(rows=5), fetch_list=[loss], scope=scope)
        record()

    seq = _both(scenario)
    assert [s["recompiles_after_warmup"] for s in seq] == [0, 1, 2]


def test_segmented_run_counts_one_recompile_like_jax():
    """A host op between two device segments: a new batch size misses in
    both segments but counts one recompile."""
    def scenario(fluid, exe, scope, record):
        main, startup, loss = _segmented_net(fluid)
        exe.run(startup, scope=scope)
        feed = {"x": np.ones((2, 4), np.float32)}
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        record()
        exe.run(main, feed={"x": np.ones((3, 4), np.float32)},
                fetch_list=[loss], scope=scope)
        record()

    before, after = _both(scenario)
    assert after["entries"] - before["entries"] == 2
    assert after["recompiles_after_warmup"] == 1


def test_op_granularity_is_the_interpreter_like_jax():
    """jit_granularity="op": no lookup at all, in either package."""
    def scenario(fluid, exe, scope, record):
        main, startup, loss = _mlp(fluid)
        _set_both_flags({"jit_granularity": "op"})
        try:
            exe.run(startup, scope=scope)
            for _ in range(3):
                exe.run(main, feed=_feed(), fetch_list=[loss], scope=scope)
        finally:
            _set_both_flags({"jit_granularity": "block"})
        record()

    seq = _both(scenario)
    assert _counts(seq[0]) == {"hits": 0, "misses": 0, "entries": 0,
                               "recompiles_after_warmup": 0}


def _mode_of(pkg_executor, exe):
    ran = [m for m in MODES
           if pkg_executor._M_RUN_SECONDS.labels(exe=exe._exe_id,
                                                 mode=m).count]
    assert len(ran) == 1, ran
    return ran[0]


@pytest.mark.parametrize("host_op", [False, True], ids=["device", "host"])
@pytest.mark.parametrize("compiled", [None, True, False])
@pytest.mark.parametrize("gran", ["block", "segment", "op"])
def test_mode_choice_is_the_jax_packages(gran, compiled, host_op):
    modes = []
    _set_both_flags({"jit_granularity": gran})
    jmetrics.set_enabled(True)
    tmetrics.set_enabled(True)
    try:
        for fluid, pkg in ((jfluid, jexecutor), (tfluid, texecutor)):
            tfw.reset_unique_names()
            jfw.reset_unique_names()
            main, startup, loss = _segmented_net(fluid, host_op)
            scope = fluid.Scope() if fluid is jfluid else Scope()
            fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope)
            exe = fluid.Executor(fluid.CPUPlace())
            exe.run(main, feed={"x": np.ones((2, 4), np.float32)},
                    fetch_list=[loss], scope=scope, compiled=compiled)
            modes.append(_mode_of(pkg, exe))
            exe.close()
    finally:
        jmetrics.set_enabled(False)
        tmetrics.set_enabled(False)
        _set_both_flags({"jit_granularity": "block"})
    assert modes[1] == modes[0]


# -- what a cache must never serve -------------------------------------------

def _warm(main, loss, feed, exe, n=3):
    return [exe.run(main, feed=feed, fetch_list=[loss])[0] for _ in range(n)]


def _forward_net():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="x", shape=[4], dtype="float32")
        out = tfluid.layers.mean(tfluid.layers.fc(input=x, size=3))
    return main, startup, out


def test_a_swapped_lowering_is_never_served_from_the_cache():
    main, startup, out = _forward_net()
    exe = tfluid.Executor(CPUPlace())
    exe.run(startup)
    feed = {"x": np.ones((2, 4), np.float32)}
    base = _warm(main, out, feed, exe)[-1]
    info = tregistry.get_op_info("mean")
    lower = info.lower
    info.lower = lambda ctx, ins, attrs: {
        "Out": 2 * lower(ctx, ins, attrs)["Out"]}
    try:
        swapped = exe.run(main, feed=feed, fetch_list=[out])[0]
    finally:
        info.lower = lower
    again = exe.run(main, feed=feed, fetch_list=[out])[0]
    np.testing.assert_array_equal(swapped, 2 * base)
    np.testing.assert_array_equal(again, base)
    assert exe.cache_stats()["misses"] == 4   # startup, warm-up, 2 swaps


def test_a_rebound_state_is_read_by_the_next_compiled_run():
    main, startup, out = _forward_net()
    exe = tfluid.Executor(CPUPlace())
    exe.run(startup)
    feed = {"x": np.ones((2, 4), np.float32)}
    _warm(main, out, feed, exe)
    scope = tfluid.global_scope()
    w = next(p.name for p in main.global_block().all_parameters()
             if len(p.shape) == 2)
    scope.set_var(w, torch.full_like(scope.find_var(w), 0.5))
    got = exe.run(main, feed=feed, fetch_list=[out])[0]
    want = tfluid.Executor(CPUPlace()).run(main, feed=feed, fetch_list=[out],
                                           compiled=False)[0]
    np.testing.assert_array_equal(got, want)
    assert exe.cache_stats()["recompiles_after_warmup"] == 0


@pytest.mark.parametrize("compiled", [None, True, False])
def test_missing_startup_raises_naming_the_variable(compiled):
    main, _, loss = _fit_a_line(tfluid, tfw)
    tflags.set_flags({"jit_granularity": "segment" if compiled else "block"})
    with pytest.raises(RuntimeError,
                       match=r"'fc_0\.[wb]_0'.*run the startup"):
        tfluid.Executor(CPUPlace()).run(
            main, feed=next(_line_batches(1)), fetch_list=[loss],
            compiled=compiled)


@pytest.mark.parametrize("mode", MODES)
def test_a_failed_run_leaks_no_local_scope(mode):
    main, startup, loss = _fit_a_line(tfluid, tfw)
    exe = tfluid.Executor(CPUPlace())
    exe.run(startup)
    scope = tfluid.global_scope()
    tflags.set_flags({"jit_granularity": "segment" if mode == "segmented"
                      else "block"})
    bad = {"x": np.ones((8, 7), np.float32), "y": np.ones((8, 1), np.float32)}
    with pytest.raises(RuntimeError):
        exe.run(main, feed=bad, fetch_list=[loss],
                compiled=mode != "interpreted")
    assert scope.kids == []


def test_close_drops_the_cache_and_every_mode_series():
    tmetrics.set_enabled(True)
    try:
        main, startup, loss = _fit_a_line(tfluid, tfw)
        exe = tfluid.Executor(CPUPlace())
        exe.run(startup)
        feed = next(_line_batches(1))
        for compiled in (None, False):
            exe.run(main, feed=feed, fetch_list=[loss], compiled=compiled)
        tflags.set_flags({"jit_granularity": "segment"})
        exe.run(main, feed=feed, fetch_list=[loss])
        key = (exe._exe_id,)
        fam = texecutor._M_RUN_SECONDS
        assert {k[1] for k in fam._children if k[:1] == key} == set(MODES)
        exe.close()
        assert not [k for k in fam._children if k[:1] == key]
        assert exe.cache_stats()["entries"] == 0
    finally:
        tmetrics.set_enabled(False)


# -- segments and random ops -------------------------------------------------

def _random_net():
    """x -> scale -> + N(0, 1) draws [2, 4] -> mean: a random op between
    device ops."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="x", shape=[4], dtype="float32")
        h = tfluid.layers.scale(x, scale=3.0)
        blk = main.global_block()
        noise = blk.create_var(name="noise", shape=[2, 4], dtype="float32")
        blk.append_op(type="gaussian_random", outputs={"Out": [noise]},
                      attrs={"shape": [2, 4], "mean": 0.0, "std": 1.0,
                             "dtype": "float32"})
        out = tfluid.layers.elementwise_add(h, noise)
    return main, startup, out


def test_segmented_random_op_draws_fresh_each_run_like_the_interpreter():
    main, _, out = _random_net()
    feed = {"x": np.ones((2, 4), np.float32)}
    draws = {}
    for compiled in (True, False):
        tflags.set_flags({"jit_granularity": "segment"})
        exe = tfluid.Executor(CPUPlace(), seed=11)
        draws[compiled] = [exe.run(main, feed=feed, fetch_list=[out],
                                   compiled=compiled)[0] for _ in range(3)]
        if compiled:
            assert exe.cache_stats()["hits"] == 2
    for a, b in zip(draws[True], draws[False]):
        assert a.tobytes() == b.tobytes()
    assert not np.array_equal(draws[True][0], draws[True][1])


def test_a_random_op_ends_a_segment_on_a_cuda_place():
    """On a card a random op runs eagerly between two device segments (a
    graph would replay its first draws); on the CPU it stays inside."""
    main, _, _ = _random_net()
    blk = main.global_block()
    exe = tfluid.Executor(CPUPlace())
    fp = exe._fingerprint(main)
    on_cpu = [(h, [op.type for op in ops])
              for h, ops, _ in exe._segments(blk, fp)]
    assert on_cpu == [(False, ["scale", "gaussian_random",
                               "elementwise_add"])]
    exe.device = torch.device("cuda", 0)   # the segmenter reads the type
    exe._segs.clear()
    on_card = [(h, [op.type for op in ops])
               for h, ops, _ in exe._segments(blk, fp)]
    assert on_card == [(False, ["scale"]), (True, ["gaussian_random"]),
                       (False, ["elementwise_add"])]


def test_write_back_keeps_aliased_outputs_and_fills_the_buffers():
    """The graph's write-back (read-write values into their input
    buffers), on CPU tensors: a new value that is a view of another
    buffer, and an output aliasing a buffer, keep their pre-write-back
    values."""
    a, b = torch.arange(4.0), torch.arange(4.0) + 10
    bufs = {"a": a, "b": b}
    outs = {"a": b.flip(0), "b": a * 2, "alias": a, "c": torch.ones(2)}
    assert texecutor._Entry._write_back(bufs, outs) == 32
    assert outs["a"] is a and outs["b"] is b
    assert a.tolist() == [13.0, 12.0, 11.0, 10.0]
    assert b.tolist() == [0.0, 2.0, 4.0, 6.0]
    assert outs["alias"].tolist() == [0.0, 1.0, 2.0, 3.0]
    assert outs["c"].tolist() == [1.0, 1.0]


@pytest.mark.parametrize("alias", [False, True])
def test_write_through_donates_state_buffers_unless_aliased(alias):
    """The capture's in-place update, on the CPU: each parameter and
    velocity is copied into the buffer it was read from right after its
    momentum op, with the values of a plain run; a fetched alias of a
    buffer (an `assign` of the weight) keeps that buffer out of it."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="x", shape=[4], dtype="float32")
        loss = tfluid.layers.mean(tfluid.layers.fc(input=x, size=3))
        blk = main.global_block()
        w = blk.all_parameters()[0]
        old_w = None
        if alias:
            old_w = blk.create_var(name="old_w", shape=w.shape,
                                   dtype="float32")
            blk.append_op(type="assign", inputs={"X": [w]},
                          outputs={"Out": [old_w]})
        tfluid.Momentum(learning_rate=0.1, momentum=0.9).minimize(loss)
    scope = Scope()
    tfluid.Executor(CPUPlace()).run(startup, scope=scope)
    plan = texecutor._Plan(main.global_block().ops)
    persist = {v.name for v in main.list_vars() if v.persistable}
    bufs = {n: scope.find_var(n).clone() for n in plan.reads if n in persist}
    bufs["x"] = torch.ones(2, 4)
    w0 = bufs[w.name].clone()
    want = plan.run(ExecContext("cpu", seed=1), dict(bufs))
    keep = [loss.name] + ([old_w.name] if alias else []) + plan.writes
    got = plan.run(ExecContext("cpu", seed=1), dict(bufs),
                   plan.write_through(bufs, keep))
    donated = {n for n in plan.writes if n in bufs and got[n] is bufs[n]}
    rw = {n for n in plan.writes if n in bufs}
    assert donated == (rw - {w.name} if alias else rw)
    assert plan.through_bytes == sum(4 * bufs[n].numel() for n in donated)
    for n in rw:
        assert torch.equal(got[n], want[n]), n
    if alias:
        assert torch.equal(got[old_w.name], w0)


def test_a_failed_capture_raises_naming_the_op(monkeypatch):
    """A capture that fails (here a lowering raising as a host sync does
    inside a CUDA graph capture) raises naming the op, on the CPU with
    the graph API stubbed; no eager rerun hides it."""
    class _Graph:
        def replay(self):
            raise AssertionError("a failed capture must not replay")

    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda g: contextlib.nullcontext())
    main, startup, out = _forward_net()
    scope = Scope()
    tfluid.Executor(CPUPlace()).run(startup, scope=scope)
    info = tregistry.get_op_info("mean")

    def syncing(ctx, ins, attrs):
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")

    monkeypatch.setattr(info, "lower", syncing)
    plan = texecutor._Plan(main.global_block().ops)
    vals = {n: scope.find_var(n) for n in plan.reads if scope.has_var(n)}
    vals["x"] = torch.ones(2, 4)
    entry = texecutor._Entry(plan, [out.name])
    with pytest.raises(RuntimeError, match=r"capture of the compiled block "
                       r"failed at op #\d+ 'mean': RuntimeError: operation "
                       "not permitted"):
        entry.capture(ExecContext("cpu", seed=0), vals, "the compiled block")
    assert entry.graph is None


# -- capture-safe constants --------------------------------------------------

def _old_const(v, x):
    """The constants the lowerings made before: a host tensor copied to
    the device."""
    return torch.tensor(v, dtype=x.dtype, device=x.device)


def _old_lowering(op, ins, attrs):
    one = lambda s: ins[s][0]  # noqa: E731
    if op == "scale":
        x = one("X")
        return {"Out": x * _old_const(attrs["scale"], x)
                + _old_const(attrs["bias"], x)}
    if op == "increment":
        x = one("X")
        return {"Out": x + _old_const(attrs["step"], x)}
    p, g = one("Param"), one("Grad")
    lr = one("LearningRate").reshape(()).float().to(p.dtype)
    if op == "momentum":
        mu = _old_const(attrs["mu"], p)
        v_out = mu * one("Velocity") + g
        return {"ParamOut": p - lr * v_out, "VelocityOut": v_out}
    m1, m2 = one("Moment1"), one("Moment2")
    b1p = one("Beta1Pow").reshape(()).to(p.dtype)
    b2p = one("Beta2Pow").reshape(()).to(p.dtype)
    b1, b2 = _old_const(attrs["beta1"], p), _old_const(attrs["beta2"], p)
    eps = _old_const(attrs["epsilon"], p)
    lr_t = lr * torch.sqrt(1 - b2p) / (1 - b1p)
    m1_out = b1 * m1 + (1 - b1) * g
    m2_out = b2 * m2 + (1 - b2) * torch.square(g)
    return {"ParamOut": p - lr_t * m1_out / (torch.sqrt(m2_out) + eps),
            "Moment1Out": m1_out, "Moment2Out": m2_out}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("op,attrs", [
    ("momentum", {"mu": 0.9, "use_nesterov": False}),
    ("adam", {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}),
    ("scale", {"scale": 0.3, "bias": 0.1, "bias_after_scale": True}),
    ("increment", {"step": 0.7})])
def test_capture_safe_constants_keep_their_bits(op, attrs, dtype):
    gen = torch.Generator().manual_seed(0)
    shape = (37, 5)

    def t(scale=1.0, positive=False):
        v = torch.randn(shape, generator=gen) * scale
        return (v.abs() if positive else v).to(dtype)

    if op in ("scale", "increment"):
        ins = {"X": [t(3.0)]}
    else:
        ins = {"Param": [t()], "Grad": [t(0.1)],
               "LearningRate": [torch.tensor([0.01])]}
        if op == "momentum":
            ins["Velocity"] = [t(0.1)]
        else:
            ins.update(Moment1=[t(0.1)], Moment2=[t(0.01, True)],
                       Beta1Pow=[torch.tensor([0.9 ** 3])],
                       Beta2Pow=[torch.tensor([0.999 ** 3])])
    info = tregistry.get_op_info(op)
    got = info.lower(ExecContext("cpu"), ins, {**info.attrs, **attrs})
    if op in ("momentum", "adam"):
        # the updates compute in float32 and cast each state back to its
        # stored dtype, as the JAX package's (bf16 states included)
        want = {k: v.to(dtype) for k, v in _old_lowering(
            op, {k: [v.float() for v in vs] for k, vs in ins.items()},
            {**info.attrs, **attrs}).items()}
    else:
        want = _old_lowering(op, ins, {**info.attrs, **attrs})
    assert set(got) == set(want)
    for slot, w in want.items():
        g = got[slot]
        assert g.dtype == w.dtype == dtype
        assert g.view(torch.int16 if dtype == torch.bfloat16
                      else torch.int32).tolist() == \
            w.view(torch.int16 if dtype == torch.bfloat16
                   else torch.int32).tolist(), slot
