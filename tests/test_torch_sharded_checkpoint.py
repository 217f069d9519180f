"""Sharded checkpoints of the port's parallel executors, on the CPU.

tests/test_sharded_checkpoint.py's pins, across process counts: a
PipelineExecutor run at dp2 x pp2 with ZeRO-1 on four gloo ranks and a
ParallelExecutor run at dp4 with ZeRO-1, each saved after 5 of 10
steps (every rank writing its own blocks to its own file), restore on
two ranks (dp1 x pp2, and dp2) and finish equal to the uninterrupted
serial run, within 2e-4 relative and 1e-5 absolute.  A float32
checkpoint the JAX ParallelExecutor writes restores into the port's
ParallelExecutor, which then finishes equal to the JAX run
uninterrupted; a checkpoint of another program fails loudly.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu.core.framework as jfw

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 2e-4, 1e-5

_PROGRAMS = r'''
import numpy as np

STEPS, FEATS, CLS, HIDDEN = 10, 16, 4, 32


def batches():
    r = np.random.RandomState(17)
    return [{"x": r.randn(32, FEATS).astype(np.float32),
             "y": r.randint(0, CLS, (32, 1)).astype(np.int64)}
            for _ in range(STEPS)]


def build(fluid, fw, stages=0, width=1):
    """tests/test_sharded_checkpoint.py's MLP (stages=0) or its staged
    trunk; width=2 adds a layer (another program)."""
    fw.reset_unique_names()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[FEATS], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="int64")
        h = fluid.layers.fc(input=x, size=HIDDEN, act="relu")
        for _ in range(width - 1):
            h = fluid.layers.fc(input=h, size=HIDDEN, act="relu")
        for s in range(stages):
            with fluid.pipeline_stage(s):
                h = fluid.layers.fc(input=h, size=HIDDEN, act="tanh")
        logits = fluid.layers.fc(input=h, size=CLS)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, y))
        fluid.Momentum(learning_rate=0.1, momentum=0.9).minimize(loss)
    return main, startup, loss, [p.name for p in
                                 main.global_block().all_parameters()]
'''

_WORKER = r"""
import json, sys
import numpy as np
import torch.distributed as dist
import paddle_tpu_torch as fluid
import paddle_tpu_torch.core.framework as fw

rank, world, mode, tmp, programs = (int(sys.argv[1]), int(sys.argv[2]),
                                    sys.argv[3], sys.argv[4], sys.argv[5])
exec(open(programs).read())
dist.init_process_group("gloo", store=dist.FileStore(f"{tmp}/store_{mode}",
                                                      world),
                        rank=rank, world_size=world)
cpu, feeds, out, meta = fluid.CPUPlace(), batches(), {}, {}


def pipe(axes, **kw):
    main, startup, loss, names = build(fluid, fw, stages=2)
    return fluid.PipelineExecutor(main, ["x", "y"], [loss], mesh=axes,
                                  startup_program=startup, n_micro=4,
                                  place=cpu, **kw), names


def par(axes, **kw):
    main, startup, loss, names = build(fluid, fw)
    return fluid.ParallelExecutor(main, ["x", "y"], [loss], mesh=axes,
                                  startup_program=startup, place=cpu,
                                  **kw), names


try:
    if mode == "save":
        pe, _ = pipe({"dp": 2, "pp": 2}, shard_optimizer_states=True)
        for f in feeds[:5]:
            pe.run(f)
        meta["pipe_zero"] = sorted(pe._zero)
        pe.save_checkpoint(f"{tmp}/pipe")
        pe, _ = par({"dp": 4}, shard_optimizer_states=True)
        for f in feeds[:5]:
            pe.run(f)
        pe.save_checkpoint(f"{tmp}/par")
        if rank == 0:
            for stages in (2, 0):
                main, startup, loss, names = build(fluid, fw, stages)
                exe, sc = fluid.Executor(cpu), fluid.Scope()
                fluid.Executor(cpu).run(startup, scope=sc)
                for f in feeds:
                    exe.run(main, feed=f, fetch_list=[loss], scope=sc)
                for n in names:
                    out[f"serial{stages}.{n}"] = np.asarray(sc.find_var(n))
    else:
        pe, names = pipe({"dp": 1, "pp": 2})
        meta["pipe_meta"] = pe.restore_checkpoint(f"{tmp}/pipe") is not None
        meta["pipe_step"] = pe._step
        for f in feeds[5:]:
            pe.run(f)
        for n in names:
            out[f"pipe.{n}"] = pe.state(n)
        for src in ("par", "jax"):
            pe, names = par({"dp": 2})
            pe.restore_checkpoint(f"{tmp}/{src}")
            for f in feeds[5:]:
                pe.run(f)
            for n in names:
                out[f"{src}.{n}"] = pe.state(n)
        pe, _ = par({"dp": 2})
        main, startup, loss, _ = build(fluid, fw, width=2)
        other = fluid.ParallelExecutor(main, ["x", "y"], [loss],
                                       mesh={"dp": 2},
                                       startup_program=startup, place=cpu)
        try:
            other.restore_checkpoint(f"{tmp}/par")
            meta["missing"] = "no error"
        except RuntimeError as e:
            meta["missing"] = str(e)
finally:
    dist.destroy_process_group()
np.savez(f"{tmp}/{mode}{rank}.npz", **out)
with open(f"{tmp}/{mode}{rank}.json", "w") as fh:
    json.dump(meta, fh)
"""

_NS = {}
exec(_PROGRAMS, _NS)


def _spawn(world, mode, tmp, programs):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), str(world), mode, str(tmp),
         str(programs)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    for p in procs:
        log, _ = p.communicate(timeout=300)
        assert p.returncode == 0, log[-3000:]
    metas = []
    for r in range(world):
        with open(tmp / f"{mode}{r}.json") as f:
            metas.append(json.load(f))
    return [dict(np.load(tmp / f"{mode}{r}.npz")) for r in range(world)], \
        metas


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX ParallelExecutor's checkpoint and uninterrupted run, the
    four ranks' saves, the two ranks' restores."""
    tmp = tmp_path_factory.mktemp("ckpt")
    programs = tmp / "programs.py"
    programs.write_text(_PROGRAMS)
    feeds = _NS["batches"]()
    main, startup, loss, names = _NS["build"](jfluid, jfw)
    pe = jfluid.ParallelExecutor(main, ["x", "y"], [loss], mesh={"dp": 2},
                                 startup_program=startup)
    for f in feeds[:5]:
        pe.run(f)
    pe.save_checkpoint(str(tmp / "jax"))
    for f in feeds[5:]:
        pe.run(f)
    jax_full = {n: np.asarray(pe.state(n)) for n in names}
    saved, save_meta = _spawn(4, "save", tmp, programs)
    restored, meta = _spawn(2, "restore", tmp, programs)
    return jax_full, saved, save_meta, restored, meta


@pytest.mark.parametrize("kind", ["pipe", "par"])
def test_checkpoint_at_world4_restores_at_world2(runs, kind):
    """Saved by four ranks mid-run, restored by two on a smaller mesh:
    the finished run equals the uninterrupted serial run, on both
    ranks."""
    _, saved, save_meta, restored, meta = runs
    serial = {k.split(".", 1)[1]: v for k, v in saved[0].items()
              if k.startswith("serial2." if kind == "pipe" else "serial0.")}
    assert serial
    if kind == "pipe":
        assert save_meta[0]["pipe_zero"], "ZeRO-1 split no accumulator"
        assert meta[0]["pipe_meta"] and meta[0]["pipe_step"] == 5
    for r, got in enumerate(restored):
        for n, v in serial.items():
            np.testing.assert_allclose(got[f"{kind}.{n}"], v, rtol=RTOL,
                                       atol=ATOL, err_msg=f"rank {r} {n}")


def test_a_jax_checkpoint_restores_into_the_port(runs):
    """The JAX ParallelExecutor's float32 single-process checkpoint,
    restored by the port's ParallelExecutor on two ranks, finishes
    equal to the JAX run uninterrupted."""
    jax_full, _, _, restored, _ = runs
    for r, got in enumerate(restored):
        for n, v in jax_full.items():
            np.testing.assert_allclose(got[f"jax.{n}"], v, rtol=RTOL,
                                       atol=ATOL, err_msg=f"rank {r} {n}")


def test_restore_of_another_program_fails_loudly(runs):
    _, _, _, _, meta = runs
    for m in meta:
        assert "lacks state var" in m["missing"], m["missing"]
