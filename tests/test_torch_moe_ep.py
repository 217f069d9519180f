"""The port's expert parallelism against the JAX package, on the CPU.

One spawn of 2 and one of 4 gloo ranks.  `moe_ffn` (replicated routing)
and `moe_ffn_a2a` (token-sharded routing, all_to_all dispatch) over an
'ep' axis as wide as the world, top-1 and top-2, on tests/test_moe.py's
T, D, E, H = 64, 16, 8, 32 with its parameter scales: the output, the
aux loss and the gradients of <y, cotangent> + aux with respect to x,
the gate and both expert weights, against the JAX package's functions
on the conftest's virtual devices (float32, 2e-4 relative and 2e-5
absolute: tests/test_moe.py's tolerance), on every rank.  The two forms
also agree at a capacity that drops nothing (tests/test_moe.py:125).

Then the DSL path at world 4: a `layers.moe_ffn` program trained by
ParallelExecutor(mesh={"dp": 2, "ep": 2}) with its expert weights placed
P("ep"), without and with ZeRO-1, against the JAX ParallelExecutor on
the same program from the same initial states: losses and every state after the steps within
2e-4 relative and 1e-5 absolute.  A dp shard routes its own tokens
(capacity from its own count, as the port's data-parallel step runs
every op on local rows), so the program's capacity factor drops no
token and its loss leaves out the aux term, whose product of per-shard
means is not the global one.
"""
import importlib
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu.core.framework as jfw
from paddle_tpu.parallel import PartitionSpec as JP
from paddle_tpu.parallel import make_mesh as jmake_mesh

jmoe = importlib.import_module("paddle_tpu.parallel.moe")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T, D, E, H = 64, 16, 8, 32
RTOL, ATOL = 2e-4, 2e-5
STEPS = 3

_PROGRAMS = r'''
import numpy as np

FEATS, CLS, BATCH, EXPERTS = 16, 4, 16, 4


def moe_program(fluid, fw):
    """An fc, a top-2 moe_ffn (no drops at this capacity) and a
    classifier, trained with Momentum."""
    fw.reset_unique_names()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[FEATS], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="int64")
        h = fluid.layers.fc(input=x, size=FEATS, act="relu")
        m, aux = fluid.layers.moe_ffn(h, num_experts=EXPERTS, d_inner=32,
                                      top_k=2, capacity_factor=4.0)
        logits = fluid.layers.fc(input=m, size=CLS)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, y))
        fluid.Momentum(learning_rate=0.1, momentum=0.9).minimize(loss)
    experts = [p.name for p in main.global_block().all_parameters()
               if ".w_in" in p.name or ".w_out" in p.name]
    return main, startup, loss, experts


def feeds(n):
    r = np.random.RandomState(5)
    return [{"x": r.randn(BATCH, FEATS).astype(np.float32),
             "y": r.randint(0, CLS, (BATCH, 1)).astype(np.int64)}
            for _ in range(n)]
'''

_WORKER = r"""
import importlib, json, sys
import numpy as np
import torch
import torch.distributed as dist
import paddle_tpu_torch as fluid
import paddle_tpu_torch.core.framework as fw
from paddle_tpu_torch.parallel import PartitionSpec as P, make_mesh
moe = importlib.import_module("paddle_tpu_torch.parallel.moe")

rank, world, steps = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
store, in_path, out_path, programs = sys.argv[4:8]
exec(open(programs).read())
dist.init_process_group("gloo", store=dist.FileStore(store, world),
                        rank=rank, world_size=world)
inp = dict(np.load(in_path))
mesh = make_mesh({"ep": world})
out, meta = {}, {}
try:
    for form, fn, cf in (("rep", moe.moe_ffn, 1.25),
                         ("a2a", moe.moe_ffn_a2a, 1.25),
                         ("rep_wide", moe.moe_ffn, 16.0),
                         ("a2a_wide", moe.moe_ffn_a2a, 16.0)):
        for k in (1, 2):
            args = [torch.from_numpy(inp[n]).requires_grad_(True)
                    for n in ("x", "gate_w", "w_in", "w_out")]
            y, aux = fn(*args, mesh, capacity_factor=cf, top_k=k)
            ((y * torch.from_numpy(inp["ct"])).sum() + aux).backward()
            key = f"{form}.{k}"
            out[key + ".y"] = y.detach().numpy()
            out[key + ".aux"] = aux.detach().numpy()
            for n, a in zip(("x", "gate_w", "w_in", "w_out"), args):
                out[key + ".d_" + n] = a.grad.numpy()
    for case, zero in (("dsl", False), ("dsl_zero1", True)):
        if world != 4:
            break
        main, startup, loss, experts = moe_program(fluid, fw)
        pe = fluid.ParallelExecutor(
            main, ["x", "y"], [loss], mesh={"dp": 2, "ep": 2},
            startup_program=startup, place=fluid.CPUPlace(),
            param_shardings={n: P("ep") for n in experts},
            shard_optimizer_states=zero)
        for n in sorted(pe._states):
            pe.set_state(n, inp[f"{case}.init." + n])
        out[f"{case}.loss"] = np.array([float(pe.run(f)[0].reshape(-1)[0])
                                        for f in feeds(steps)])
        for n in sorted(pe._states):
            out[f"{case}.state." + n] = pe.state(n)
        meta[case] = {"form": pe.gspmd_form, "experts": experts,
                      "local": {n: list(pe._states[n].shape)
                                for n in experts},
                      "zero": sorted(pe._zero_states),
                      "record": [[c.kind, c.axis]
                                 for c in pe.collective_record]}
finally:
    dist.destroy_process_group()
np.savez(out_path, **out)
with open(out_path + ".json", "w") as fh:
    json.dump(meta, fh)
"""

_NS = {}
exec(_PROGRAMS, _NS)


def _inputs():
    r = np.random.RandomState(0)
    x = r.randn(T, D).astype(np.float32)
    gate_w = r.randn(D, E).astype(np.float32) * 0.1
    w_in = r.randn(E, D, H).astype(np.float32) * 0.1
    w_out = r.randn(E, H, D).astype(np.float32) * 0.1
    ct = r.randn(T, D).astype(np.float32)
    return {"x": x, "gate_w": gate_w, "w_in": w_in, "w_out": w_out,
            "ct": ct}


def _jax(world):
    inp = {k: jnp.asarray(v) for k, v in _inputs().items()}
    mesh = jmake_mesh({"ep": world}, devices=jax.devices()[:world])
    res = {}
    for form, fn, cf in (("rep", jmoe.moe_ffn, 1.25),
                         ("a2a", jmoe.moe_ffn_a2a, 1.25)):
        for k in (1, 2):
            def f(x, g, wi, wo):
                y, aux = fn(x, g, wi, wo, mesh, capacity_factor=cf,
                            top_k=k)
                return jnp.sum(y * inp["ct"]) + aux, (y, aux)

            grads, (y, aux) = jax.jit(jax.grad(f, argnums=(0, 1, 2, 3),
                                               has_aux=True))(
                inp["x"], inp["gate_w"], inp["w_in"], inp["w_out"])
            key = f"{form}.{k}"
            res[key + ".y"] = np.asarray(y)
            res[key + ".aux"] = np.asarray(aux)
            for n, g in zip(("x", "gate_w", "w_in", "w_out"), grads):
                res[key + ".d_" + n] = np.asarray(g)
    return res


def _jax_dsl():
    """The JAX ParallelExecutor on the program, without and with ZeRO-1
    -> (the initial states for the ranks, {case: losses and states})."""
    init, res = {}, {}
    for case, zero in (("dsl", False), ("dsl_zero1", True)):
        main, startup, loss, experts = _NS["moe_program"](jfluid, jfw)
        pe = jfluid.ParallelExecutor(main, ["x", "y"], [loss],
                                     mesh={"dp": 2, "ep": 2},
                                     startup_program=startup,
                                     param_shardings={n: JP("ep")
                                                      for n in experts},
                                     shard_optimizer_states=zero)
        init.update({f"{case}.init.{n}": np.asarray(pe.state(n))
                     for n in pe._states})
        losses = [float(np.asarray(pe.run(f)[0]).reshape(-1)[0])
                  for f in _NS["feeds"](STEPS)]
        res[case] = {"loss": np.array(losses),
                     "states": {n: np.asarray(pe.state(n))
                                for n in pe._states}}
    return init, res


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cache = {}

    def get(world):
        if world in cache:
            return cache[world]
        tmp = tmp_path_factory.mktemp(f"moe_ep{world}")
        init, dsl = _jax_dsl() if world == 4 else ({}, None)
        np.savez(tmp / "in.npz", **_inputs(), **init)
        programs = tmp / "programs.py"
        programs.write_text(_PROGRAMS)
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env["PYTHONPATH"] = ROOT
        env["OMP_NUM_THREADS"] = "1"
        procs = [subprocess.Popen(
            [sys.executable, "-c", _WORKER, str(r), str(world), str(STEPS),
             str(tmp / "store"), str(tmp / "in.npz"),
             str(tmp / f"rank{r}.npz"), str(programs)], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]
        for p in procs:
            log, _ = p.communicate(timeout=300)
            assert p.returncode == 0, log[-3000:]
        import json

        metas = []
        for r in range(world):
            with open(tmp / f"rank{r}.npz.json") as f:
                metas.append(json.load(f))
        cache[world] = (_jax(world), dsl,
                        [dict(np.load(tmp / f"rank{r}.npz"))
                         for r in range(world)], metas)
        return cache[world]
    return get


_CASES = [(w, f, k) for w in (2, 4) for f in ("rep", "a2a") for k in (1, 2)]


@pytest.mark.parametrize("world,form,top_k", _CASES,
                         ids=[f"world{w}-{f}-top{k}" for w, f, k in _CASES])
def test_expert_parallel_forms_are_the_jax_packages(runs, world, form,
                                                    top_k):
    want, _, ranks, _ = runs(world)
    key = f"{form}.{top_k}"
    for r, got in enumerate(ranks):
        for part in ("y", "aux", "d_x", "d_gate_w", "d_w_in", "d_w_out"):
            np.testing.assert_allclose(got[f"{key}.{part}"],
                                       want[f"{key}.{part}"], rtol=RTOL,
                                       atol=ATOL,
                                       err_msg=f"rank {r} {part}")


@pytest.mark.parametrize("world", [2, 4])
def test_a2a_equals_replicated_without_drops(runs, world):
    """tests/test_moe.py:125: at a capacity that never overflows the
    token-sharded form gives the replicated form's output."""
    _, _, ranks, _ = runs(world)
    for k in (1, 2):
        np.testing.assert_allclose(ranks[0][f"a2a_wide.{k}.y"],
                                   ranks[0][f"rep_wide.{k}.y"], rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("case", ["dsl", "dsl_zero1"])
def test_dsl_expert_parallel_is_the_jax_parallel_executor(runs, case):
    """moe_ffn over 'ep' through ParallelExecutor's sharded form, and
    with ZeRO-1 (the accumulators of the unplaced parameters split over
    dp, the experts' following their placement): each rank holds half
    the experts; losses and every state equal the JAX
    ParallelExecutor's, on every rank."""
    _, dsl, ranks, metas = runs(4)
    want = dsl[case]
    for m in metas:
        m = m[case]
        assert m["form"] == "sharded"
        for n in m["experts"]:
            assert m["local"][n][0] == _NS["EXPERTS"] // 2, m["local"]
            assert not any(z.startswith(n) for z in m["zero"]), m["zero"]
        assert bool(m["zero"]) == (case == "dsl_zero1"), m["zero"]
        # the output's all-reduce over 'ep', the gradients' over 'dp'
        axes = {tuple(x) for x in m["record"]}
        assert ("all-reduce", "ep") in axes and ("all-reduce", "dp") in axes
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got[f"{case}.loss"], want["loss"],
                                   rtol=RTOL, atol=1e-5)
        for n, v in want["states"].items():
            np.testing.assert_allclose(got[f"{case}.state.{n}"], v,
                                       rtol=RTOL, atol=1e-5,
                                       err_msg=f"rank {r} {n}")
        assert got[f"{case}.loss"][-1] != got[f"{case}.loss"][0]
