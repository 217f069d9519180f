"""The port's pipeline parallelism against the JAX package, on the CPU.

The JAX package runs each case on the conftest's virtual CPU devices;
the port runs it on gloo ranks (one spawn of 4 processes and one of 2,
each rank one mesh position).  Held to the JAX package:

  * the raw schedules: GPipe (`spmd_pipeline`, differentiated with torch
    autograd) and 1F1B (`spmd_pipeline_1f1b`) at pp 2 and pp 4 give the JAX package's loss, stage and last gradients and input
    cotangents (tests/test_1f1b.py:46-80's setup), within 1e-4 relative
    and 1e-5 absolute (dp x pp composes in the executor cases below);
  * `PipelineExecutor` on the DSL transformer at tests/test_pipeline_tp.py's
    sizes, 5 steps, from the JAX executor's initial states, on dp2 x pp2
    (GPipe, with and without ZeRO-1; 1F1B), pp2 x tp2 (the alternation
    rule's column and row counts) and pp2 x sp2: every parameter within
    1e-4 of the JAX PipelineExecutor's (that file's `delta < 1e-4`) and
    within 2e-4 relative and 1e-5 absolute of the port's serial
    Executor from the same states (tests/test_strategy_equivalence.py:
    278-301), every rank holding the same values.

Then the port's own pins: a dropout trunk pipelined at pp4 with one
microbatch draws the serial run's masks and gives its losses and
parameters bit for bit (dp2 x pp2 within 1e-4); build_executor
dispatches a staged program over 'pp' to PipelineExecutor; a stateful
post section trains under GPipe; and the JAX package's refusals
(tests/test_pipeline_tp.py:141-158, tests/test_1f1b.py:165-260,
tests/test_pipeline.py:307-335), raised before any process group is
needed.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu.core.framework as jfw
from paddle_tpu.models import transformer as jtr
from paddle_tpu.parallel import make_mesh as jmake_mesh
from paddle_tpu.parallel import pipeline as jpipe

import paddle_tpu_torch as tfluid
import paddle_tpu_torch.core.framework as tfw
from paddle_tpu_torch.models import transformer as ttr
from paddle_tpu_torch.parallel import pipeline as tpipe

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL, DELTA = 2e-4, 1e-5, 1e-4

# the programs and data, built by either package as `fluid`
_PROGRAMS = r'''
import numpy as np

V, S, D, L, STEPS = 8, 8, 8, 4, 5


def lm(fluid, fw, tr, pp, dropout=0.0):
    """tests/test_pipeline_tp.py's and tests/test_1f1b.py's LM."""
    fw.reset_unique_names()
    pm, ps = fluid.Program(), fluid.Program()
    with fluid.program_guard(pm, ps):
        ids = fluid.layers.data(name="ids", shape=[S], dtype="int64")
        lab = fluid.layers.data(name="lab", shape=[S, 1], dtype="int64")
        lg = tr.transformer_lm(ids, V, d_model=D, n_heads=2, n_layers=L,
                               max_len=S, return_logits=True,
                               dropout_rate=dropout, pipeline_stages=pp)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(
                fluid.layers.reshape(lg, shape=[-1, V]),
                fluid.layers.reshape(lab, shape=[-1, 1])))
        fluid.Momentum(learning_rate=0.05, momentum=0.9).minimize(loss)
    return pm, ps, loss


def bn_post(fluid, fw):
    """tests/test_1f1b.py:171's batch_norm after the trunk."""
    fw.reset_unique_names()
    pm, ps = fluid.Program(), fluid.Program()
    with fluid.program_guard(pm, ps):
        x = fluid.layers.data(name="x", shape=[8], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="int64")
        h = fluid.layers.fc(input=x, size=8, act="relu")
        for st in range(2):
            with fluid.pipeline_stage(st):
                h = fluid.layers.fc(input=h, size=8, act="tanh")
        h = fluid.layers.batch_norm(h)
        lg = fluid.layers.fc(input=h, size=4)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(lg, y))
        fluid.Momentum(learning_rate=0.1, momentum=0.9).minimize(loss)
    return pm, ps, loss


def batches(n=STEPS, batch=8):
    r = np.random.RandomState(0)
    return [{"ids": r.randint(0, V, (batch, S)).astype(np.int64),
             "lab": r.randint(0, V, (batch, S, 1)).astype(np.int64)}
            for _ in range(n)]


CASES = {
    "gpipe_dp2_pp2": ({"dp": 2, "pp": 2}, {}),
    "zero1_dp2_pp2": ({"dp": 2, "pp": 2}, {"shard_optimizer_states": True}),
    "1f1b_dp2_pp2": ({"dp": 2, "pp": 2}, {"schedule": "1f1b"}),
    "tp_pp2_tp2": ({"dp": 1, "pp": 2, "tp": 2}, {"tp_axis": "tp"}),
    "sp_pp2_sp2": ({"dp": 1, "pp": 2, "sp": 2}, {"sp_axis": "sp"}),
}
# the raw schedules: (mesh, batch axis) a world size
RAW = {4: {"pp4": ({"pp": 4}, None)}, 2: {"pp2": ({"pp": 2}, None)}}
NM, RD, MB = 8, 8, 4


def raw_inputs(pp):
    """tests/test_1f1b.py:46-80's arrays."""
    r = np.random.RandomState(0)
    per = [(np.float32(r.randn(RD, RD)) * np.float32(0.4),
            np.float32(r.randn(RD)) * np.float32(0.1)) for _ in range(pp)]
    w = np.float32(r.randn(RD, 3)) * np.float32(0.3)
    x = np.float32(r.randn(NM * MB, RD))
    lab = r.randint(0, 3, (NM * MB,)).astype(np.int32)
    return per, w, x, lab
'''

_WORKER = r"""
import json, os, sys, time
import numpy as np
import torch
import torch.distributed as dist
import paddle_tpu_torch as fluid
import paddle_tpu_torch.core.framework as fw
from paddle_tpu_torch.models import transformer as tr
from paddle_tpu_torch.parallel import make_mesh
from paddle_tpu_torch.parallel import pipeline as pl

rank, world = int(sys.argv[1]), int(sys.argv[2])
store, init_path, out_path, programs = sys.argv[3:7]
exec(open(programs).read())
dist.init_process_group("gloo", store=dist.FileStore(store, world),
                        rank=rank, world_size=world)
out, meta = {}, {}
cpu = fluid.CPUPlace()


def serial(pm, ps, loss, states, feeds):
    exe, sc = fluid.Executor(cpu), fluid.Scope()
    fluid.Executor(cpu).run(ps, scope=sc)
    for n, v in states.items():
        sc.set_var(n, torch.from_numpy(np.ascontiguousarray(v)))
    losses = [float(exe.run(pm, feed=f, fetch_list=[loss], scope=sc)[0][0])
              for f in feeds]
    names = [p.name for p in pm.global_block().all_parameters()]
    return losses, {n: np.asarray(sc.find_var(n)) for n in names}


def raw(name, axes, batch_axis):
    mesh = make_mesh(axes)
    pp = axes["pp"]
    per, w, x, lab = raw_inputs(pp)
    stacked = pl.stack_stage_params(
        [tuple(torch.from_numpy(a) for a in p) for p in per])
    W, X = torch.from_numpy(w), torch.from_numpy(x)
    Y = torch.from_numpy(lab).long()
    B = X.shape[0]

    def stage_fn(p, h):
        return torch.tanh(h @ p[0] + p[1])

    def last_fn(lp, h, yb, m):
        logp = torch.log_softmax(h @ lp, -1)
        return -logp.gather(-1, yb[:, None])[:, 0].sum() / B

    ps_ = [t.clone().requires_grad_(True) for t in stacked]
    wv, xv = W.clone().requires_grad_(True), X.clone().requires_grad_(True)
    y = pl.spmd_pipeline(stage_fn, ps_, pl.microbatch(xv, NM), mesh,
                         batch_axis=batch_axis)
    logp = torch.log_softmax(pl.unmicrobatch(y) @ wv, -1)
    loss = -logp.gather(-1, Y[:, None])[:, 0].mean()
    loss.backward()
    stage = mesh.axis_index("pp")
    out[f"raw.{name}.gpipe.loss"] = loss.detach().numpy()
    out[f"raw.{name}.gpipe.g_stage"] = np.concatenate(
        [p.grad[stage].reshape(-1).numpy() for p in ps_])
    out[f"raw.{name}.gpipe.g_last"] = wv.grad.numpy()
    out[f"raw.{name}.gpipe.dx"] = xv.grad.numpy()
    l1, outs, gs, gl, dx = pl.spmd_pipeline_1f1b(
        stage_fn, last_fn, stacked, W, pl.microbatch(X, NM),
        pl.microbatch(Y, NM), mesh, batch_axis=batch_axis)
    out[f"raw.{name}.1f1b.loss"] = l1.numpy()
    out[f"raw.{name}.1f1b.g_stage"] = np.concatenate(
        [g.reshape(-1).numpy() for g in gs])
    out[f"raw.{name}.1f1b.g_last"] = gl.numpy()
    out[f"raw.{name}.1f1b.dx"] = pl.unmicrobatch(dx).numpy()
    out[f"raw.{name}.1f1b.outs"] = pl.unmicrobatch(outs).numpy()
    meta[f"raw.{name}.stage"] = stage


try:
    for name, (axes, batch_axis) in RAW[world].items():
        raw(name, axes, batch_axis)
    if world == 4:
        # the JAX package's initial states, written while the parts
        # above ran
        while not os.path.exists(init_path):
            time.sleep(0.05)
        init = dict(np.load(init_path))
        feeds = batches()
        for name, (axes, kw) in CASES.items():
            pm, ps, loss = lm(fluid, fw, tr, axes["pp"])
            pe = fluid.PipelineExecutor(pm, ["ids", "lab"], [loss],
                                        mesh=axes, startup_program=ps,
                                        n_micro=2, place=cpu, **kw)
            keys = sorted(k[len(name) + 6:] for k in init
                          if k.startswith(name + ".init."))
            meta[f"{name}.states"] = sorted(pe._meta)
            states = {k: init[f"{name}.init.{k}"] for k in keys}
            for k, v in states.items():
                pe.set_state(k, v)
            losses = [float(pe.run(f)[0][0]) for f in feeds]
            out[f"{name}.loss"] = np.array(losses)
            names = [p.name for p in pm.global_block().all_parameters()]
            for n in names:
                out[f"{name}.state.{n}"] = pe.state(n)
            meta[f"{name}.collectives"] = pe.compiled_collectives(feeds[0])
            meta[f"{name}.tp_specs"] = {
                n: list(s) for n, s in pe.tp_param_specs.items()}
            if rank == 0:
                sl, sp = serial(pm, ps, loss, states, feeds)
                out[f"{name}.serial_loss"] = np.array(sl)
                for n, v in sp.items():
                    out[f"{name}.serial.{n}"] = v
        # dropout: pp4 with one microbatch is the serial run's ops on the
        # serial rows; dp2 x pp2 with two microbatches
        drop = batches(3)
        for name, axes, n_micro in (("drop_pp4", {"dp": 1, "pp": 4}, 1),
                                    ("drop_dp2_pp2", {"dp": 2, "pp": 2}, 2)):
            pm, ps, loss = lm(fluid, fw, tr, axes["pp"], dropout=0.2)
            exe, sc = fluid.Executor(cpu), fluid.Scope()
            fluid.Executor(cpu).run(ps, scope=sc)
            sl = [float(exe.run(pm, feed=f, fetch_list=[loss],
                                scope=sc)[0][0]) for f in drop]
            pm, ps, loss = lm(fluid, fw, tr, axes["pp"], dropout=0.2)
            pe = fluid.PipelineExecutor(pm, ["ids", "lab"], [loss],
                                        mesh=axes, startup_program=ps,
                                        n_micro=n_micro, place=cpu)
            out[f"{name}.loss"] = np.array([float(pe.run(f)[0][0])
                                            for f in drop])
            out[f"{name}.serial_loss"] = np.array(sl)
            for p in pm.global_block().all_parameters():
                out[f"{name}.state.{p.name}"] = pe.state(p.name)
                out[f"{name}.serial.{p.name}"] = np.asarray(
                    sc.find_var(p.name))
            meta[f"{name}.random"] = pe._trunk_has_random
        # build_executor's dispatch
        pm, ps, loss = lm(fluid, fw, tr, 2)
        t = fluid.ShardingTranspiler()
        t.transpile(program=pm, startup_program=ps, mesh={"dp": 2, "pp": 2})
        pe = t.build_executor(["ids", "lab"], [loss], place=cpu, n_micro=2)
        meta["dispatch.type"] = type(pe).__name__
        meta["dispatch.loss"] = float(pe.run(batches(1)[0])[0][0])
        # a stateful post section trains under gpipe
        pm, ps, loss = bn_post(fluid, fw)
        pe = fluid.PipelineExecutor(pm, ["x", "y"], [loss],
                                    mesh={"dp": 2, "pp": 2},
                                    startup_program=ps, n_micro=2,
                                    place=cpu)
        r = np.random.RandomState(0)
        meta["bn_post.loss"] = float(pe.run(
            {"x": r.randn(16, 8).astype(np.float32),
             "y": r.randint(0, 4, (16, 1)).astype(np.int64)})[0][0])
finally:
    dist.destroy_process_group()
np.savez(out_path, **out)
with open(out_path + ".json", "w") as fh:
    json.dump(meta, fh)
"""

_NS = {}
exec(_PROGRAMS, _NS)


def _jax_cases():
    """The JAX PipelineExecutor over every case -> (its initial states
    for the ranks, its losses and parameters)."""
    init, res = {}, {}
    feeds = _NS["batches"]()
    for name, (axes, kw) in _NS["CASES"].items():
        pm, ps, loss = _NS["lm"](jfluid, jfw, jtr, axes["pp"])
        pe = jfluid.PipelineExecutor(pm, ["ids", "lab"], [loss], mesh=axes,
                                     startup_program=ps, n_micro=2, **kw)
        for n in pe._state_map:
            init[f"{name}.init.{n}"] = np.asarray(pe.state(n))
        losses = [float(np.asarray(pe.run(f)[0]).reshape(-1)[0])
                  for f in feeds]
        names = [p.name for p in pm.global_block().all_parameters()]
        res[name] = {"loss": np.array(losses),
                     "states": {n: np.asarray(pe.state(n)) for n in names},
                     "init": sorted(pe._state_map),
                     "tp_specs": {n: tuple(s) for n, s in
                                  getattr(pe, "tp_param_specs", {}).items()}}
    return init, res


def _jax_raw(axes, batch_axis):
    """tests/test_1f1b.py:46-80 on the virtual devices -> {schedule:
    (loss, stage grads [pp, ...] flattened a stage, last grads, dx)}."""
    pp = axes["pp"]
    per, w, x, lab = _NS["raw_inputs"](pp)
    n_dev = int(np.prod(list(axes.values())))
    mesh = jmake_mesh(axes, devices=jax.devices()[:n_dev])
    stacked = jpipe.stack_stage_params(
        [tuple(jnp.asarray(a) for a in p) for p in per])
    W, X, Y = jnp.asarray(w), jnp.asarray(x), jnp.asarray(lab)
    B = X.shape[0]
    NM = _NS["NM"]

    def stage_fn(p, h):
        return jnp.tanh(h @ p[0] + p[1])

    def last_fn(lp, h, yb, m):
        logp = jax.nn.log_softmax(h @ lp, -1)
        return jnp.sum(-jnp.take_along_axis(logp, yb[:, None],
                                            axis=-1)[:, 0]) / B

    def gpipe_loss(params, lp, xx):
        y = jpipe.spmd_pipeline(stage_fn, params, jpipe.microbatch(xx, NM),
                                mesh, batch_axis=batch_axis)
        logp = jax.nn.log_softmax(jpipe.unmicrobatch(y) @ lp, -1)
        return jnp.mean(-jnp.take_along_axis(logp, Y[:, None], -1)[:, 0])

    loss, (gs, gl, dx) = jax.jit(jax.value_and_grad(
        gpipe_loss, argnums=(0, 1, 2)))(stacked, W, X)

    def per_stage(g):
        return [np.concatenate([np.asarray(a[s]).reshape(-1) for a in g])
                for s in range(pp)]

    out = {"gpipe": (float(loss), per_stage(gs), np.asarray(gl),
                     np.asarray(dx))}
    l1, outs, g1, gl1, dx1 = jax.jit(
        lambda p, w_, x_, y_: jpipe.spmd_pipeline_1f1b(
            stage_fn, last_fn, p, w_, x_, y_, mesh,
            batch_axis=batch_axis))(stacked, W, jpipe.microbatch(X, NM),
                                    jpipe.microbatch(Y, NM))
    out["1f1b"] = (float(l1), per_stage(g1), np.asarray(gl1),
                   np.asarray(jpipe.unmicrobatch(dx1)),
                   np.asarray(jpipe.unmicrobatch(outs)))
    return out


def _spawn(world, tmp, jax_side):
    """The ranks, started before `jax_side()` runs here (-> the JAX
    results; it writes the ranks' initial states to init.npz, which they
    wait for) -> (JAX results, rank arrays, rank metas)."""
    programs = tmp / "programs.py"
    programs.write_text(_PROGRAMS)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), str(world),
         str(tmp / "store"), str(tmp / "init.npz"),
         str(tmp / f"rank{r}.npz"), str(programs)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    try:
        res = jax_side()
    except BaseException:
        for p in procs:
            p.kill()
            p.wait()
        raise
    for p in procs:
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, out[-3000:]
    arrays = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(world)]
    metas = []
    for r in range(world):
        with open(tmp / f"rank{r}.npz.json") as f:
            metas.append(json.load(f))
    return res, arrays, metas


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{world: (JAX results, raw JAX results, rank arrays, rank metas)},
    each world spawned once, at first use."""
    cache = {}

    def get(world):
        if world not in cache:
            tmp = tmp_path_factory.mktemp(f"pipeline{world}")

            def jax_side():
                init, res = (_jax_cases() if world == 4 else ({}, {}))
                # renamed into place whole: the ranks wait for the name
                np.savez(tmp / "init.part.npz", **init)
                os.replace(tmp / "init.part.npz", tmp / "init.npz")
                raw = {name: _jax_raw(axes, ba) for name, (axes, ba)
                       in _NS["RAW"][world].items()}
                return res, raw

            (res, raw), arrays, metas = _spawn(world, tmp, jax_side)
            cache[world] = (res, raw, arrays, metas)
        return cache[world]
    return get


_RAW = [(w, n, s) for w in (4, 2) for n in _NS["RAW"][w]
        for s in ("gpipe", "1f1b")]


@pytest.mark.parametrize("world,name,schedule", _RAW,
                         ids=[f"world{w}-{n}-{s}" for w, n, s in _RAW])
def test_raw_schedules_match_the_jax_package(runs, world, name, schedule):
    """spmd_pipeline (torch autograd's reverse schedule) and
    spmd_pipeline_1f1b on every rank: the JAX package's loss, this
    rank's stage gradients, the last gradients and the input
    cotangents."""
    _, raw, arrays, metas = runs(world)
    want = raw[name][schedule]
    for r in range(world):
        a, stage = arrays[r], metas[r][f"raw.{name}.stage"]
        k = f"raw.{name}.{schedule}."
        np.testing.assert_allclose(float(a[k + "loss"]), want[0],
                                   rtol=1e-5)
        np.testing.assert_allclose(a[k + "g_stage"], want[1][stage],
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(a[k + "g_last"], want[2], rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(a[k + "dx"], want[3], rtol=1e-4,
                                   atol=1e-5)
        if schedule == "1f1b":
            np.testing.assert_allclose(a[k + "outs"], want[4], rtol=1e-4,
                                       atol=1e-5)


@pytest.mark.parametrize("case", sorted(_NS["CASES"]))
def test_pipeline_executor_is_the_jax_package(runs, case):
    """PipelineExecutor on the DSL transformer: the JAX package's
    parameters after 5 steps (delta < 1e-4) and the port's serial
    run's (rtol 2e-4, atol 1e-5), the same values on every rank."""
    res, _, arrays, metas = runs(4)
    want = res[case]
    ref = arrays[0]
    assert metas[0][f"{case}.states"] == want["init"]
    for r in range(1, 4):
        for k in ref:
            if k.startswith(case + ".state.") or k == case + ".loss":
                np.testing.assert_array_equal(arrays[r][k], ref[k],
                                              err_msg=f"rank {r} {k}")
    delta = max(float(np.abs(ref[f"{case}.state.{n}"] - v).max())
                for n, v in want["states"].items())
    assert delta < DELTA, delta
    np.testing.assert_allclose(ref[f"{case}.loss"], want["loss"],
                               rtol=1e-4)
    np.testing.assert_allclose(ref[f"{case}.loss"],
                               ref[f"{case}.serial_loss"], rtol=1e-4)
    for n in want["states"]:
        np.testing.assert_allclose(ref[f"{case}.state.{n}"],
                                   ref[f"{case}.serial.{n}"], rtol=RTOL,
                                   atol=ATOL, err_msg=n)
    cc = metas[0][f"{case}.collectives"]
    assert cc.get("collective-permute", 0) >= 1, cc
    if case == "tp_pp2_tp2":
        specs = {n: tuple(s) for n, s in
                 metas[0][f"{case}.tp_specs"].items()}
        assert specs == want["tp_specs"]
        col = [n for n, s in specs.items() if s == (None, "tp")]
        row = [n for n, s in specs.items() if s == ("tp", None)]
        assert len(col) == 4 * 2 and len(row) == 2 * 2, (col, row)
        assert cc.get("all-reduce", 0) > 1, cc
    if case == "sp_pp2_sp2":
        # the ring's K/V shifts beyond the stage hops
        assert cc["collective-permute"] > 2, cc


@pytest.mark.parametrize("case", ["drop_pp4", "drop_dp2_pp2"])
def test_dropout_pipelined_draws_the_serial_masks(runs, case):
    """The trunk's dropout under the pipeline draws the serial run's
    masks: at pp4 with one microbatch (the serial ops on the serial
    rows) the losses and parameters are the serial run's bit for bit;
    at dp2 x pp2 within tests/test_pipeline.py's 1e-4."""
    _, _, arrays, metas = runs(4)
    a = arrays[0]
    assert metas[0][f"{case}.random"]
    names = sorted(k[len(case) + 7:] for k in a
                   if k.startswith(case + ".state."))
    if case == "drop_pp4":
        np.testing.assert_array_equal(a[f"{case}.loss"],
                                      a[f"{case}.serial_loss"])
        for n in names:
            np.testing.assert_array_equal(a[f"{case}.state.{n}"],
                                          a[f"{case}.serial.{n}"], n)
    else:
        np.testing.assert_allclose(a[f"{case}.loss"],
                                   a[f"{case}.serial_loss"], rtol=1e-4)
        for n in names:
            np.testing.assert_allclose(a[f"{case}.state.{n}"],
                                       a[f"{case}.serial.{n}"],
                                       rtol=1e-4, atol=1e-5, err_msg=n)


def test_build_executor_dispatches_and_bn_post_trains(runs):
    """ShardingTranspiler.build_executor gives a staged program over
    'pp' a PipelineExecutor (the JAX package's dispatch); batch_norm
    after the trunk trains under GPipe (tests/test_1f1b.py:190-200)."""
    _, _, _, metas = runs(4)
    for m in metas:
        assert m["dispatch.type"] == "PipelineExecutor"
        assert np.isfinite(m["dispatch.loss"])
        assert np.isfinite(m["bn_post.loss"])


def test_schedule_accounting_is_the_jax_packages():
    for nm, pp, sch in ((8, 4, "gpipe"), (8, 4, "1f1b"), (64, 4, "1f1b"),
                        (2, 2, "gpipe")):
        assert tpipe.schedule_steps(nm, pp, sch) == \
            jpipe.schedule_steps(nm, pp, sch)
        assert tpipe.bubble_fraction(nm, pp, sch) == \
            jpipe.bubble_fraction(nm, pp, sch)
    with pytest.raises(ValueError):
        tpipe.schedule_steps(8, 4, "interleaved")


def _lm(pp=2):
    return _NS["lm"](tfluid, tfw, ttr, pp)


def _refusal_programs():
    """(name, build, mesh, kw, error, match): the JAX package's pinned
    refusals."""
    def stochastic():
        tfw.reset_unique_names()
        main, startup = tfluid.Program(), tfluid.Program()
        with tfluid.program_guard(main, startup):
            x = tfluid.layers.data(name="x", shape=[8], dtype="float32")
            y = tfluid.layers.data(name="y", shape=[1], dtype="int64")
            h = tfluid.layers.fc(input=x, size=8, act="relu")
            blk = main.global_block()
            for st in range(2):
                with tfluid.pipeline_stage(st):
                    h = tfluid.layers.fc(input=h, size=8, act="tanh")
                    noise = blk.create_var(name=f"noise_{st}",
                                           dtype="float32", shape=[-1, 8])
                    blk.append_op("uniform_random_batch_size_like",
                                  {"Input": [h.name]},
                                  {"Out": [noise.name]},
                                  {"shape": [-1, 8], "dtype": "float32"})
                    h = tfluid.layers.elementwise_add(h, noise)
            lg = tfluid.layers.fc(input=h, size=4)
            loss = tfluid.layers.mean(
                tfluid.layers.softmax_with_cross_entropy(lg, y))
            tfluid.Momentum(learning_rate=0.1, momentum=0.9).minimize(loss)
        return main, startup, loss, ["x", "y"]

    def seqless():
        tfw.reset_unique_names()
        S, V = _NS["S"], _NS["V"]
        pm, ps = tfluid.Program(), tfluid.Program()
        with tfluid.program_guard(pm, ps):
            ids = tfluid.layers.data(name="ids", shape=[S], dtype="int64")
            y = tfluid.layers.data(name="y", shape=[1], dtype="int64")
            lg = ttr.transformer_lm(ids, V, d_model=_NS["D"], n_heads=2,
                                    n_layers=2, max_len=S,
                                    return_logits=True, pipeline_stages=2)
            pooled = tfluid.layers.reduce_mean(lg, dim=[1])
            loss = tfluid.layers.mean(
                tfluid.layers.softmax_with_cross_entropy(pooled, y))
            tfluid.Momentum(learning_rate=0.05, momentum=0.9).minimize(loss)
        return pm, ps, loss, ["ids", "y"]

    def lm2():
        pm, ps, loss = _lm(2)
        return pm, ps, loss, ["ids", "lab"]

    def bn():
        pm, ps, loss = _NS["bn_post"](tfluid, tfw)
        return pm, ps, loss, ["x", "y"]

    return [
        ("unknown_schedule", lm2, {"dp": 4, "pp": 2},
         {"schedule": "interleaved"}, ValueError, "schedule"),
        ("unknown_axis", lm2, {"dp": 4, "pp": 2}, {"tp_axis": "tp"},
         ValueError, "not a mesh axis"),
        ("sp_divisibility", lm2, {"dp": 1, "pp": 2, "sp": 3},
         {"sp_axis": "sp"}, ValueError, "sequence dim"),
        ("stage_count", lm2, {"dp": 1, "pp": 4}, {}, ValueError,
         "must match"),
        ("1f1b_stateful_post", bn, {"dp": 4, "pp": 2},
         {"schedule": "1f1b"}, NotImplementedError, "persistable"),
        ("1f1b_sp_seqless_labels", seqless, {"dp": 2, "pp": 2, "sp": 2},
         {"sp_axis": "sp", "schedule": "1f1b"}, NotImplementedError,
         "sequence dim"),
        ("stochastic_trunk", stochastic, {"dp": 4, "pp": 2}, {},
         NotImplementedError, "stochastic op"),
    ]


@pytest.mark.parametrize("spec", _refusal_programs(),
                         ids=[s[0] for s in _refusal_programs()])
def test_refusals_are_the_jax_packages(spec):
    """Each configuration the JAX package refuses raises the same error
    here, before any process group is needed."""
    _, build, mesh, kw, err, match = spec
    pm, ps, loss, feeds = build()
    with pytest.raises(err, match=match):
        tfluid.PipelineExecutor(pm, feeds, [loss], mesh=mesh,
                                startup_program=ps, n_micro=2,
                                place=tfluid.CPUPlace(), **kw)
