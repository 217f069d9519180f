"""The port's memory layer (paddle_tpu_torch/memory_optimization_transpiler.py
and the executors) against the JAX package's, on the CPU: the
counterparts of tests/test_memory_optimize.py and tests/test_memory_plan.py.

The transpiler functions run on the same Program built in both packages
under reset unique names, and must give the same liveness, the same
eliminated count and renamed Program, and the same free and donation
plans.  Then the executors: DonationError at build time in every mode,
the interpreter erasing dead names under the `memory_optimize` flag,
parameters bit-identical with the flag on and off, fetches skipped by
the rename, the compiled mode's frees (values dropped after their last
reader, fetches and states kept), zero recompiles after warm-up on one
shared bucketed LoD, the `remat` flag's default in the builders, and
ParallelExecutor with the flag.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu.core.framework as jfw
from paddle_tpu import memory_optimization_transpiler as jmot

import paddle_tpu_torch as tfluid
import paddle_tpu_torch.core.framework as tfw
from paddle_tpu_torch import CPUPlace
from paddle_tpu_torch import memory_optimization_transpiler as tmot
from paddle_tpu_torch.core import executor as texecutor
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.core.scope import Scope

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


def _build_mlp(fluid, donate_x=False, depth=2):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[16], dtype="float32",
                              donate=donate_x)
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        h = x
        for _ in range(depth):
            h = fluid.layers.fc(input=h, size=16, act="relu")
        pred = fluid.layers.fc(input=h, size=1)
        loss = fluid.layers.mean(
            fluid.layers.square_error_cost(input=pred, label=y))
        fluid.SGD(learning_rate=0.01).minimize(loss)
    return main, startup, loss


def _build_conv(fluid):
    """Book-builder-shaped conv net (recognize_digits)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        img = fluid.layers.data(name="img", shape=[1, 8, 8],
                                dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        cp = fluid.nets.simple_img_conv_pool(
            input=img, filter_size=3, num_filters=4, pool_size=2,
            pool_stride=2, act="relu")
        pred = fluid.layers.fc(input=cp, size=10, act="softmax")
        loss = fluid.layers.mean(
            fluid.layers.cross_entropy(input=pred, label=label))
        fluid.Adam(learning_rate=0.01).minimize(loss)
    return main, startup, loss


def _both(build, **kw):
    jfw.reset_unique_names()
    j = build(jfluid, **kw)
    tfw.reset_unique_names()
    t = build(tfluid, **kw)
    return j, t


def _mlp_feed(rng, n=4):
    return {"x": rng.rand(n, 16).astype(np.float32),
            "y": rng.rand(n, 1).astype(np.float32)}


# -- the transpiler against the JAX package's --------------------------------

def test_liveness_equals_the_jax_package():
    (jm, _, jl), (tm, _, tl) = _both(_build_mlp, depth=4)
    jcfg = jmot.ControlFlowGraph(jm.global_block().ops)
    tcfg = tmot.ControlFlowGraph(tm.global_block().ops)
    for f in ("uses", "defs", "live_in", "live_out"):
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    assert tcfg.last_touch() == jcfg.last_touch()
    def_idx = max(i for i, d in enumerate(tcfg.defs) if tl.name in d)
    assert tl.name in tcfg.live_out[def_idx] \
        or def_idx == len(tcfg.ops) - 1


@pytest.mark.parametrize("skip", ["variable", "name", "mixed"])
def test_memory_optimize_renames_as_the_jax_package(skip):
    """The same eliminated count and the same renamed Program; the
    skipped names (a bare Variable, a bare name, or a mixed list with a
    relu output) survive."""
    (jm, _, jl), (tm, _, tl) = _both(_build_mlp, depth=4)

    def skips(prog, loss):
        relu = [op.output("Out")[0] for op in prog.global_block().ops
                if op.type == "relu"][0]
        return {"variable": loss, "name": loss.name,
                "mixed": [loss, relu]}[skip], relu

    jskip, jrelu = skips(jm, jl)
    tskip, trelu = skips(tm, tl)
    j_n = jmot.memory_optimize(jm, skip_vars=jskip)
    t_n = tmot.memory_optimize(tm, skip_vars=tskip)
    assert t_n == j_n > 0
    _assert_same_program(jm, tm)
    names = {n for op in tm.global_block().ops
             for ns in op.outputs.values() for n in ns}
    assert tl.name in names
    if skip == "mixed":
        assert trelu in names


def test_plans_equal_the_jax_package():
    (jm, _, jl), (tm, _, tl) = _both(_build_mlp)
    assert tmot.plan_dead_frees(tm, [tl.name]) == \
        jmot.plan_dead_frees(jm, [jl.name])
    for args in ((["x", "y"], [tl.name], ["w0"], ()),
                 (["x", "y"], [tl.name, "x"], (), ())):
        jp = jmot.plan_donation(jm, *args)
        tp = tmot.plan_donation(tm, *args)
        assert (tp.feeds, tp.states, tp.rejected) == \
            (jp.feeds, jp.states, jp.rejected)
    pname = tm.global_block().all_parameters()[0].name
    for req, fetch, match in ((["x"], ["x"], "fetched"),
                              ([pname], [tl.name], "persistable")):
        tp = tmot.plan_donation(tm, ["x"], fetch, requested=req)
        jp = jmot.plan_donation(jm, ["x"], fetch, requested=req)
        assert tp.rejected == jp.rejected
        with pytest.raises(tmot.DonationError, match=match):
            tp.check()
    tm.global_block().create_var(name="orphan", shape=[1], dtype="float32")
    with pytest.raises(tmot.DonationError, match="never consumed"):
        tmot.plan_donation(tm, ["orphan"], [], requested=["orphan"]).check()
    assert tfluid.memory_optimize is tmot.memory_optimize


def test_plan_dead_frees_protections():
    main, _, loss = _build_mlp(tfluid)
    frees = tmot.plan_dead_frees(main, [loss.name])
    freed = {n for ns in frees.values() for n in ns}
    assert freed and loss.name not in freed
    for p in main.global_block().all_parameters():
        assert p.name not in freed
    for idx, names in frees.items():
        for later in main.global_block().ops[idx + 1:]:
            for n in names:
                assert n not in later.input_names()
                assert n not in later.output_names()


# -- the executors -----------------------------------------------------------

@pytest.mark.parametrize("compiled", [None, False])
def test_donated_then_fetched_raises_at_build_time(compiled):
    """A donate=True feed that is also fetched fails before any op runs,
    in the compiled mode and the interpreter; a safe fetch list runs."""
    main, startup, loss = _build_mlp(tfluid, donate_x=True)
    exe = tfluid.Executor(CPU)
    scope = Scope()
    exe.run(startup, scope=scope)
    feed = _mlp_feed(np.random.RandomState(0))
    before = {v.name: scope.find_var(v.name).clone()
              for v in main.global_block().all_parameters()}
    with pytest.raises(tmot.DonationError, match="donat"):
        exe.run(main, feed=feed, fetch_list=[loss, "x"], scope=scope,
                compiled=compiled)
    for n, v in before.items():
        assert torch.equal(scope.find_var(n), v), "an op ran"
    out, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                   compiled=compiled)
    assert np.isfinite(out).all()


def test_parallel_executor_rejects_an_unsafe_hint():
    main, startup, loss = _build_mlp(tfluid, donate_x=True)
    with pytest.raises(tmot.DonationError, match="fetch"):
        tfluid.ParallelExecutor(main, ["x", "y"], [loss, "x"],
                                mesh={"dp": 1}, startup_program=startup,
                                place=CPU)


@pytest.mark.parametrize("mode", ["interpreted", "segmented"])
def test_the_flag_erases_dead_names(mode, monkeypatch):
    """Under memory_optimize the interpreter drops each dead local value
    after its op, the segmented mode after its segment; the loss is
    never erased."""
    main, startup, loss = _build_mlp(tfluid)
    exe = tfluid.Executor(CPU)
    scope = Scope()
    exe.run(startup, scope=scope)
    erased = []
    orig = Scope.erase

    def spy(self, name):
        erased.append(name)
        return orig(self, name)

    monkeypatch.setattr(Scope, "erase", spy)
    tflags.set_flags({"memory_optimize": True,
                      "jit_granularity": "segment" if mode == "segmented"
                      else "block"})
    out, = exe.run(main, feed=_mlp_feed(np.random.RandomState(0)),
                   fetch_list=[loss], scope=scope,
                   compiled=None if mode == "segmented" else False)
    assert erased and loss.name not in erased
    assert np.isfinite(out).all()


def _train_params(build, feeds, flag, steps=5):
    tflags.set_flags({"memory_optimize": flag})
    tfw.reset_unique_names()
    main, startup, loss = build(tfluid)
    exe = tfluid.Executor(CPU)
    scope = Scope()
    exe.run(startup, scope=scope)
    losses = []
    for i in range(steps):
        f = feeds[i % len(feeds)]
        losses.append(exe.run(main, feed=f, fetch_list=[loss],
                              scope=scope)[0])
        losses.append(exe.run(main, feed=f, fetch_list=[loss], scope=scope,
                              compiled=False)[0])
    return losses, {v.name: scope.find_var(v.name).clone()
                    for v in main.global_block().all_parameters()}


@pytest.mark.parametrize("model", ["mlp", "conv"])
def test_flag_keeps_parameters_bit_identical(model):
    """Rename + frees change no bit of the losses or the trained
    parameters, in both modes (the book builders' shapes)."""
    r = np.random.RandomState(0)
    if model == "mlp":
        build, feeds = _build_mlp, [_mlp_feed(r) for _ in range(3)]
    else:
        build = _build_conv
        feeds = [{"img": r.rand(4, 1, 8, 8).astype(np.float32),
                  "label": r.randint(0, 10, (4, 1)).astype(np.int64)}
                 for _ in range(3)]
    ref_l, ref = _train_params(build, feeds, False)
    got_l, got = _train_params(build, feeds, True)
    assert all(np.array_equal(a, b) for a, b in zip(got_l, ref_l))
    assert set(ref) == set(got)
    for name in ref:
        assert torch.equal(ref[name], got[name]), name


def test_the_flag_skips_fetched_temporaries():
    tflags.set_flags({"memory_optimize": True})
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="x", shape=[8], dtype="float32")
        h = tfluid.layers.fc(input=x, size=8, act="relu")
        out = tfluid.layers.fc(input=h, size=1)
    exe = tfluid.Executor(CPU)
    scope = Scope()
    exe.run(startup, scope=scope)
    hv, ov = exe.run(main, feed={"x": np.ones((2, 8), np.float32)},
                     fetch_list=[h, out], scope=scope, compiled=False)
    assert hv.shape == (2, 8) and ov.shape == (2, 1)
    # the caller's Program is not renamed
    assert all(op.type != "relu" or op.output("Out")[0] == h.name
               for op in main.global_block().ops)


def test_compiled_mode_drops_dead_values():
    """The compiled plan drops each value after its last reader: a
    spy on the run's env sees every intermediate go, while the fetch
    and the written states stay; the losses equal the interpreter's."""
    main, startup, loss = _build_mlp(tfluid, depth=3)
    exe = tfluid.Executor(CPU)
    scope = Scope()
    exe.run(startup, scope=scope)
    plan = exe._segments(main.global_block(), exe._fingerprint(main))[0][2]
    entry = texecutor._Entry(plan, [loss.name] + [
        n for n in plan.writes if n in plan.persistable])
    freed = {n for ns in entry.frees.values() for n in ns}
    assert loss.name not in freed and not freed & plan.persistable
    temps = {n for n in plan.writes if n not in plan.persistable
             and n != loss.name}
    assert temps <= freed
    vals = {n: scope.find_var(n) for n in plan.reads if scope.has_var(n)}
    vals.update({k: torch.as_tensor(v) for k, v in
                 _mlp_feed(np.random.RandomState(0)).items()})
    seen_max = []

    class _Watch(dict):
        def __setitem__(self, k, v):
            super().__setitem__(k, v)
            seen_max.append(len(self))

    env = plan.run(texecutor.ExecContext("cpu", seed=0), _Watch(vals), None,
                   entry.frees)
    assert loss.name in env and not temps & set(env)
    # never more than a fraction of the step's names live at once
    assert max(seen_max) < len(vals) + len(temps)


def test_zero_recompiles_after_warmup_on_a_shared_bucketed_lod():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        words = tfluid.layers.data(name="words", shape=[1], dtype="int64",
                                   lod_level=1)
        emb = tfluid.layers.embedding(input=words, size=[16, 8])
        pooled = tfluid.layers.sequence_pool(input=emb, pool_type="sum")
        out = tfluid.layers.reduce_mean(tfluid.layers.fc(input=pooled,
                                                         size=1))
    r = np.random.RandomState(0)

    def batch(lens):
        flat = r.randint(0, 16, (int(np.sum(lens)), 1)).astype(np.int64)
        return {"words": tfluid.create_lod_tensor(flat, [list(lens)])}

    exe = tfluid.Executor(CPU)
    scope = Scope()
    exe.run(startup, scope=scope)
    entries0 = exe.cache_stats()["entries"]
    lens = r.randint(1, 5, 8)
    batches = [batch(lens) for _ in range(4)]
    for f in batches:
        exe.run(main, feed=f, fetch_list=[out], scope=scope)
    assert exe.cache_stats()["entries"] == entries0 + 1
    for _ in range(2):
        for f in batches:
            exe.run(main, feed=f, fetch_list=[out], scope=scope)
    assert exe.cache_stats()["recompiles_after_warmup"] == 0
    for f in [batch(r.randint(1, 5, 8)) for _ in range(3)]:
        exe.run(main, feed=f, fetch_list=[out], scope=scope)
    assert exe.cache_stats()["recompiles_after_warmup"] >= 2


@pytest.mark.parametrize("builder", ["resnet", "encoder", "decoder"])
def test_remat_flag_default_in_the_builders(builder):
    """remat=None reads the flag: recompute ops appear with it on, as
    in the JAX package's Program; the flag never applies to a pipeline
    build, and remat=True with pipeline stages raises."""
    from paddle_tpu_torch.models import resnet, transformer

    def count(flag, **kw):
        tflags.set_flags({"remat": flag})
        tfw.reset_unique_names()
        main = tfluid.Program()
        with tfluid.program_guard(main, tfluid.Program()):
            if builder == "resnet":
                img = tfluid.layers.data(name="img", shape=[3, 8, 8],
                                         dtype="float32")
                resnet.resnet_cifar10(img, class_dim=4, depth=8)
            else:
                ids = tfluid.layers.data(name="ids", shape=[6],
                                         dtype="int64")
                fn = (transformer.transformer_encoder if builder ==
                      "encoder" else transformer.transformer_decoder)
                args = (ids, 11) if builder == "encoder" else (ids, None,
                                                               11)
                fn(*args, d_model=16, n_heads=2, n_layers=2, max_len=6,
                   **kw)
        return sum(op.type == "recompute" for op in main.global_block().ops)

    assert count(False) == 0
    assert count(True) == (3 if builder == "resnet" else 2)
    if builder == "decoder":
        assert count(True, pipeline_stages=2) == 0
        with pytest.raises(NotImplementedError, match="pipeline"):
            count(False, pipeline_stages=2, remat=True)


def test_parallel_executor_trains_with_the_flag():
    """ParallelExecutor at dp 1 with memory_optimize on: its losses and
    states bit-identical to the flag off, and the loss falls."""
    r = np.random.RandomState(0)
    feeds = [_mlp_feed(r, 8) for _ in range(3)]
    runs = []
    for flag in (False, True):
        tflags.set_flags({"memory_optimize": flag})
        tfw.reset_unique_names()
        main, startup, loss = _build_mlp(tfluid)
        pe = tfluid.ParallelExecutor(main, ["x", "y"], [loss],
                                     mesh={"dp": 1},
                                     startup_program=startup, place=CPU)
        losses = [float(pe.run(f)[0].reshape(-1)[0]) for f in feeds * 2]
        runs.append((losses, {n: pe.state(n) for n in pe._states}))
        pe.close()
    (l0, s0), (l1, s1) = runs
    assert l0 == l1 and l1[-1] < l1[0]
    for n in s0:
        assert np.array_equal(s0[n], s1[n]), n
