"""The port's composite oracle steps against the JAX package's, on the
CPU.

`make_composite_step` (a Megatron-split MLP stage) and
`make_transformer_composite_step` (a pre-LN transformer LM) over dp x pp
x tp meshes: the JAX package's steps run on the conftest's virtual
devices, the port's on gloo ranks (one spawn of 2 and one of 4), from
the JAX oracle's initial parameters (as numpy arrays) over
tests/test_composite.py's data.  After the steps every rank's blocks of
the parameters and of the ZeRO-1 momentum equal the same blocks of the
JAX package's arrays, and the losses equal its losses, within 2e-4
relative and 1e-5 absolute; the step's collective record holds the
stage hops, the all-reduces and (with dp) the ZeRO-1 all-gathers.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from paddle_tpu import parallel as jpar

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 2e-4, 1e-5
STEPS = 3
MESHES = {4: {"mlp_tp2": {"dp": 1, "pp": 2, "tp": 2},
              "mlp_dp2": {"dp": 2, "pp": 2, "tp": 1},
              "tfm_tp2": {"dp": 1, "pp": 2, "tp": 2},
              "tfm_dp2": {"dp": 2, "pp": 2, "tp": 1}},
          2: {"mlp_pp2": {"dp": 1, "pp": 2, "tp": 1},
              "tfm_pp2": {"dp": 1, "pp": 2, "tp": 1}}}


def _data(kind, meta=None):
    r = np.random.RandomState(0)
    if kind == "mlp":
        return (r.randn(2, 16, 8).astype(np.float32),
                r.randn(2, 16, 8).astype(np.float32) * np.float32(0.1))
    shape = (2, 8, meta["seq"])
    return (r.randint(0, meta["vocab"], shape).astype(np.int32),
            r.randint(0, meta["vocab"], shape).astype(np.int32))


def _flat(tree, prefix):
    """{key: array} of a (dict | tuple) pytree."""
    if isinstance(tree, dict):
        return {k: v for n in sorted(tree)
                for k, v in _flat(tree[n], f"{prefix}.{n}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, t in enumerate(tree)
                for k, v in _flat(t, f"{prefix}.{i}").items()}
    return {prefix: np.asarray(tree)}


def _jax(name, axes):
    n = int(np.prod(list(axes.values())))
    mesh = jpar.make_mesh(axes, devices=jax.devices()[:n])
    if name.startswith("mlp"):
        step, params, vel = jpar.make_composite_step(mesh)
        meta = None
    else:
        step, params, vel, meta = jpar.make_transformer_composite_step(mesh)
    init = _flat(params, f"{name}.init")
    xs, ys = _data(name[:3], meta)
    losses = []
    for _ in range(STEPS):
        params, vel, loss = step(params, vel, jnp.asarray(xs),
                                 jnp.asarray(ys))
        losses.append(float(loss))
    return init, {**_flat(params, f"{name}.params"),
                  **_flat(vel, f"{name}.vel"),
                  f"{name}.loss": np.array(losses)}


_WORKER = r"""
import importlib, json, sys
import numpy as np
import torch
import torch.distributed as dist
from paddle_tpu_torch.parallel import make_mesh
from paddle_tpu_torch.parallel.mesh import PartitionSpec, _blocks
comp = importlib.import_module("paddle_tpu_torch.parallel.composite")

rank, world, steps = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
store, in_path, out_path, meshes = sys.argv[4:8]
dist.init_process_group("gloo", store=dist.FileStore(store, world),
                        rank=rank, world_size=world)
inp = dict(np.load(in_path))
out, meta = {}, {}


def tree(prefix, like):
    if isinstance(like, dict):
        return {k: tree(f"{prefix}.{k}", like[k]) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(tree(f"{prefix}.{i}", v)
                          for i, v in enumerate(like))
    return inp[prefix]


def leaves(t, prefix):
    if isinstance(t, dict):
        return [x for k in sorted(t) for x in leaves(t[k], f"{prefix}.{k}")]
    if type(t) in (list, tuple):
        return [x for i, v in enumerate(t)
                for x in leaves(v, f"{prefix}.{i}")]
    return [(prefix, t)]


try:
    for name, axes in json.loads(meshes).items():
        mesh = make_mesh(axes)
        if name.startswith("mlp"):
            init = tuple(inp[f"{name}.init.{i}"] for i in range(4))
            step, params, vel = comp.make_composite_step(mesh, init=init)
        else:
            keys = ("cls_b", "cls_w", "emb", "pos")
            init = ({k: inp[f"{name}.init.0.{k}"] for k in keys},
                    tuple(inp[f"{name}.init.1.{i}"] for i in range(13)))
            step, params, vel, m = comp.make_transformer_composite_step(
                mesh, init=init)
        xs, ys = inp[f"{name}.xs"], inp[f"{name}.ys"]
        losses = []
        for i in range(steps):
            if i == 0:
                cc = comp.collective_counts(step, params, vel, xs, ys)
            params, vel, loss = step(params, vel, xs, ys)
            losses.append(loss)
        out[f"{name}.loss"] = np.array(losses)
        meta[name] = cc
        # each block against the same block of the JAX package's array
        for what, t, specs in (("params", params, step.p_specs),
                               ("vel", vel, step.v_specs)):
            for (key, v), (_, s) in zip(leaves(t, f"{name}.{what}"),
                                        leaves(specs, "")):
                stage = key.startswith(f"{name}.{what}.1.") or \
                    name.startswith("mlp")
                full = inp[key]
                spec = (("pp",) + tuple(s)) if stage else tuple(s)
                want = _blocks(mesh, torch.from_numpy(full),
                               PartitionSpec(*spec))
                out[key + ".got"] = v.detach().numpy()
                out[key + ".want"] = (want[0] if stage else want).numpy()
finally:
    dist.destroy_process_group()
np.savez(out_path, **out)
with open(out_path + ".json", "w") as fh:
    json.dump(meta, fh)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cache = {}

    def get(world):
        if world in cache:
            return cache[world]
        tmp = tmp_path_factory.mktemp(f"composite{world}")
        arrays, want = {}, {}
        for name, axes in MESHES[world].items():
            init, res = _jax(name, axes)
            arrays.update(init)
            arrays.update({k: v for k, v in res.items()
                           if k.startswith((f"{name}.params",
                                            f"{name}.vel"))})
            meta = ({"seq": 8, "vocab": int(np.lcm(32, axes["dp"]))}
                    if name.startswith("tfm") else None)
            arrays[f"{name}.xs"], arrays[f"{name}.ys"] = _data(name[:3],
                                                               meta)
            want[name] = res[f"{name}.loss"]
        np.savez(tmp / "in.npz", **arrays)
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env["PYTHONPATH"] = ROOT
        env["OMP_NUM_THREADS"] = "1"
        procs = [subprocess.Popen(
            [sys.executable, "-c", _WORKER, str(r), str(world), str(STEPS),
             str(tmp / "store"), str(tmp / "in.npz"),
             str(tmp / f"rank{r}.npz"), json.dumps(MESHES[world])],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(world)]
        for p in procs:
            log, _ = p.communicate(timeout=300)
            assert p.returncode == 0, log[-3000:]
        metas = []
        for r in range(world):
            with open(tmp / f"rank{r}.npz.json") as f:
                metas.append(json.load(f))
        cache[world] = (want, [dict(np.load(tmp / f"rank{r}.npz"))
                               for r in range(world)], metas)
        return cache[world]
    return get


_CASES = [(w, n) for w in (4, 2) for n in MESHES[w]]


@pytest.mark.parametrize("world,name", _CASES,
                         ids=[f"world{w}-{n}" for w, n in _CASES])
def test_composite_step_is_the_jax_oracle(runs, world, name):
    want, ranks, metas = runs(world)
    axes = MESHES[world][name]
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got[f"{name}.loss"], want[name],
                                   rtol=RTOL, atol=ATOL)
        keys = [k[:-4] for k in got if k.startswith(name + ".")
                and k.endswith(".got")]
        assert keys
        for k in keys:
            np.testing.assert_allclose(got[k + ".got"], got[k + ".want"],
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"rank {r} {k}")
        cc = metas[r][name]
        assert cc.get("collective-permute", 0) >= 1, cc
        if axes["tp"] > 1 or axes["dp"] > 1:
            assert cc.get("all-reduce", 0) >= 1, cc
        if axes["dp"] > 1:
            assert cc.get("all-gather", 0) >= 1, cc
    assert want[name][-1] < want[name][0]
