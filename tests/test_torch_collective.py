"""The port's collective ops, tensor-parallel autograd collectives, mesh
axis groups and sharded embedding, on the CPU.

Four gloo ranks (one module-scoped spawn) run each `c_*` op under the
port's `shard_map` over a {"dp": 4} mesh, and over the 'tp' axis of a
{"dp": 2, "tp": 2} one, against the JAX op under `shard_map` on the
conftest's virtual CPU devices (tests/test_parallel.py:260), within
1e-6 (sums of float32 values in another order); the sharded embedding's
lookup and gradient against the JAX functions and numpy
(tests/test_parallel.py:241); the mesh's rank layout (row-major, as
jax.make_mesh lays out devices); and Megatron's four regions as autograd
Functions, whose backwards are the conjugate collectives.  In-process:
the collective record's digests, `pvary`, and the ops outside a mesh.
"""
import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as JP

import paddle_tpu as jfluid  # noqa: F401  (registers the JAX c_* ops)
from paddle_tpu import parallel as jparallel
from paddle_tpu.core.execution import DictEnv as JDictEnv
from paddle_tpu.core.execution import ExecContext as JExecContext
from paddle_tpu.core.execution import run_op as jrun_op
from paddle_tpu.core.framework import Program as JProgram
from paddle_tpu.parallel.mesh import shard_map as jshard_map

import torch

import paddle_tpu_torch  # noqa: F401
from paddle_tpu_torch.core.execution import ExecContext
from paddle_tpu_torch.core.framework import Program
from paddle_tpu_torch.core.registry import registered_ops
from paddle_tpu_torch.parallel import mesh as tmesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4

# (name, op type, attrs); a "tp_" case runs over the tp axis of dp2 x tp2
OP_CASES = [
    ("allreduce_sum", "c_allreduce_sum", {"ring_id": "dp"}),
    ("allreduce_mean", "c_allreduce_mean", {"ring_id": "dp"}),
    ("allreduce_max", "c_allreduce_max", {"ring_id": "dp"}),
    ("allgather_0", "c_allgather", {"ring_id": "dp", "axis": 0}),
    ("allgather_1", "c_allgather", {"ring_id": "dp", "axis": 1}),
    ("reducescatter_0", "c_reducescatter", {"ring_id": "dp", "axis": 0}),
    ("reducescatter_1", "c_reducescatter", {"ring_id": "dp", "axis": 1}),
    ("broadcast_0", "c_broadcast", {"ring_id": "dp", "root": 0}),
    ("broadcast_2", "c_broadcast", {"ring_id": "dp", "root": 2}),
    ("ppermute_1", "c_ppermute", {"ring_id": "dp", "shift": 1}),
    ("ppermute_3", "c_ppermute", {"ring_id": "dp", "shift": 3}),
    ("tp_allreduce_sum", "c_allreduce_sum", {"ring_id": "tp"}),
    ("tp_allgather_1", "c_allgather", {"ring_id": "tp", "axis": 1}),
    ("tp_ppermute_1", "c_ppermute", {"ring_id": "tp", "shift": 1}),
]
X_SHAPE = (16, 4)


def _x():
    return np.random.RandomState(0).randn(*X_SHAPE).astype(np.float32)


def _mesh_of(name):
    return ({"dp": 2, "tp": 2} if name.startswith("tp_") else {"dp": 4})


def _entry(name):
    return ("dp", "tp") if name.startswith("tp_") else "dp"


_WORKER = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist
import paddle_tpu_torch  # noqa: F401
from paddle_tpu_torch.core.execution import DictEnv, ExecContext, run_op
from paddle_tpu_torch.core.framework import Program
from paddle_tpu_torch.parallel import collective as coll
from paddle_tpu_torch.parallel.mesh import Mesh, PartitionSpec as P, shard_map

rank, world, store, out_path = (int(sys.argv[1]), int(sys.argv[2]),
                                sys.argv[3], sys.argv[4])
cases = json.loads(sys.argv[5])
dist.init_process_group("gloo", store=dist.FileStore(store, world),
                        rank=rank, world_size=world)
# every rank makes the meshes (and their axis groups) in one order
meshes = {"dp": Mesh({"dp": 4}, dist.group.WORLD),
          "dp_tp": Mesh({"dp": 2, "tp": 2}, dist.group.WORLD),
          "mp": Mesh({"mp": 4}, dist.group.WORLD)}
out, meta = {}, {}
try:
    x = torch.from_numpy(
        np.random.RandomState(0).randn(16, 4).astype(np.float32))
    for name, op_type, attrs in cases:
        multi = name.startswith("tp_")
        mesh = meshes["dp_tp" if multi else "dp"]
        spec = P(("dp", "tp")) if multi else P("dp")
        prog = Program()
        b = prog.global_block()
        b.create_var(name="x", shape=(16, 4), dtype="float32")
        b.append_op(op_type, {"X": ["x"]}, {"Out": ["y"]}, attrs)
        groups = mesh.axis_groups()
        record = []
        for g in groups.values():
            g.record = record

        def body(xl):
            env = DictEnv({"x": xl})
            run_op(ExecContext(groups=groups), b.ops[0], env)
            return env.get("y")

        y = shard_map(body, mesh=mesh, in_specs=spec, out_specs=spec)(x)
        out[name] = y.numpy()
        meta[name] = [[c.kind, c.axis, list(c.shape)] for c in record]
    m = meshes["dp_tp"]
    meta["layout"] = {a: {"ranks": m.axis_group(a).ranks,
                          "index": m.axis_index(a)} for a in ("dp", "tp")}
    # Megatron's regions over the tp axis, forward and backward
    tp = m.axis_group("tp")
    c = float(rank + 1)
    v = torch.arange(4.0) + 10 * rank
    for kind in ("copy_to", "reduce_from", "gather_from", "scatter_to"):
        leaf = v.clone().requires_grad_(True)
        if kind == "copy_to":
            y = coll.copy_to(leaf, tp) * c
        elif kind == "reduce_from":
            y = coll.reduce_from(leaf, tp) * c
        elif kind == "gather_from":
            y = coll.gather_from(leaf, tp, 0) * torch.arange(8.0)
        else:
            y = coll.scatter_to(leaf, tp, 0) * c
        out[f"fn.{kind}.fwd"] = y.detach().numpy()
        y.sum().backward()
        out[f"fn.{kind}.grad"] = leaf.grad.numpy()
    # the sharded embedding over mp
    r = np.random.RandomState(6)
    table = r.randn(64, 16).astype(np.float32)
    ids = r.randint(0, 64, (40,)).astype(np.int64)
    g = r.randn(40, 16).astype(np.float32)
    mp = meshes["mp"]
    block = coll.shard_embedding_table(mp, table, axis="mp")
    out["emb.block"] = block.numpy()
    out["emb.lookup"] = coll.sharded_embedding_lookup(
        torch.from_numpy(ids), block, mp, axis="mp").numpy()
    out["emb.grad"] = coll.sharded_embedding_grad(
        torch.from_numpy(ids), torch.from_numpy(g), 64, mp,
        axis="mp").numpy()
finally:
    dist.destroy_process_group()
np.savez(out_path, **out)
with open(out_path + ".json", "w") as fh:
    json.dump(meta, fh)
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("collective")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), str(WORLD),
         str(tmp / "store"), str(tmp / f"rank{r}.npz"),
         json.dumps(OP_CASES)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    for p in procs:
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, out[-3000:]
    arrays = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]
    metas = []
    for r in range(WORLD):
        with open(tmp / f"rank{r}.npz.json") as f:
            metas.append(json.load(f))
    return arrays, metas


@pytest.fixture(scope="module")
def jax_ops():
    """Every OP_CASES op of the JAX package under its shard_map: one
    Program and one shard_map a mesh, every op reading x -> {name:
    the assembled result}."""
    out = {}
    for multi in (False, True):
        cases = [c for c in OP_CASES if c[0].startswith("tp_") == multi]
        mesh = jparallel.make_mesh(_mesh_of(cases[0][0]))
        prog = JProgram()
        b = prog.global_block()
        b.create_var(name="x", shape=X_SHAPE, dtype="float32")
        for name, op_type, attrs in cases:
            b.append_op(op_type, {"X": ["x"]}, {"Out": [name]}, attrs)
        spec = JP(_entry(cases[0][0]))

        @functools.partial(jshard_map, mesh=mesh, in_specs=spec,
                           out_specs=spec)
        def run(x):
            env = JDictEnv({"x": x})
            ctx = JExecContext(jax.random.key(0), compiled=True)
            for op in b.ops:
                jrun_op(ctx, op, env)
            return {name: env.get(name) for name, _, _ in cases}

        out.update({k: np.asarray(v) for k, v in
                    jax.jit(run)(jnp.asarray(_x())).items()})
    return out


@pytest.mark.parametrize("case", OP_CASES, ids=[c[0] for c in OP_CASES])
def test_collective_op_is_the_jax_op_under_shard_map(ranks, jax_ops, case):
    """Each rank's assembled result equals the JAX op's under the JAX
    package's shard_map on the same mesh and input, and every rank has
    the same; the record holds the op's kind on its axis."""
    arrays, metas = ranks
    name, op_type, _ = case
    want = jax_ops[name]
    for r in range(WORLD):
        np.testing.assert_allclose(arrays[r][name], want, rtol=1e-6,
                                   atol=1e-6, err_msg=f"rank {r}")
    kinds = {"c_allgather": "all-gather", "c_ppermute":
             "collective-permute", "c_reducescatter": "reduce-scatter"}
    axis = "tp" if name.startswith("tp_") else "dp"
    got = [(k, a) for k, a, _ in metas[0][name]]
    assert got[0] == (kinds.get(op_type, "all-reduce"), axis), got


def test_mesh_axes_are_row_major(ranks):
    """{"dp": 2, "tp": 2}: the tp groups are ranks {0, 1} and {2, 3},
    the dp groups {0, 2} and {1, 3} (jax.make_mesh's device layout)."""
    _, metas = ranks
    for r, meta in enumerate(metas):
        lay = meta["layout"]
        assert lay["tp"]["ranks"] == ([0, 1] if r < 2 else [2, 3])
        assert lay["dp"]["ranks"] == ([0, 2] if r % 2 == 0 else [1, 3])
        assert (lay["dp"]["index"], lay["tp"]["index"]) == divmod(r, 2)
    want = np.asarray(jparallel.make_mesh({"dp": 2, "tp": 2}).devices)
    ids = np.vectorize(lambda d: d.id)(want)
    assert (ids - ids.min()).tolist() == [[0, 1], [2, 3]]


@pytest.mark.parametrize("kind", ["copy_to", "reduce_from", "gather_from",
                                  "scatter_to"])
def test_megatron_regions_have_conjugate_backwards(ranks, kind):
    """Over the tp axis (ranks {0, 1} and {2, 3}), v = arange(4) + 10 r
    on rank r, c = r + 1: copy_to is the identity forward and sums the
    gradient (c) over the group; reduce_from sums v forward and passes
    the gradient through; gather_from concatenates the group's v and
    keeps this rank's block of the gradient; scatter_to takes this
    rank's half and all-gathers the gradient."""
    arrays, _ = ranks
    for r in range(WORLD):
        mates = [r - r % 2, r - r % 2 + 1]
        v = {m: np.arange(4.0) + 10 * m for m in mates}
        i = r % 2
        fwd, grad = arrays[r][f"fn.{kind}.fwd"], arrays[r][f"fn.{kind}.grad"]
        if kind == "copy_to":
            want_f, want_g = v[r] * (r + 1), np.full(4, sum(
                m + 1.0 for m in mates))
        elif kind == "reduce_from":
            want_f, want_g = (v[mates[0]] + v[mates[1]]) * (r + 1), \
                np.full(4, r + 1.0)
        elif kind == "gather_from":
            want_f = np.concatenate([v[m] for m in mates]) * np.arange(8.0)
            want_g = np.arange(8.0)[4 * i:4 * i + 4]
        else:
            want_f = v[r][2 * i:2 * i + 2] * (r + 1)
            want_g = np.concatenate([np.full(2, m + 1.0) for m in mates])
        np.testing.assert_array_equal(fwd, want_f, err_msg=f"rank {r}")
        np.testing.assert_array_equal(grad, want_g, err_msg=f"rank {r}")


def test_sharded_embedding(ranks):
    """tests/test_parallel.py:241: the lookup equals table[ids] and the
    JAX function's; the gradient's row blocks, in mp order, equal the
    dense scatter-add and the JAX function's."""
    arrays, _ = ranks
    r = np.random.RandomState(6)
    table = r.randn(64, 16).astype(np.float32)
    ids = r.randint(0, 64, (40,)).astype(np.int64)
    g = r.randn(40, 16).astype(np.float32)
    mesh = jparallel.make_mesh({"mp": 4})
    jtable = jparallel.shard_embedding_table(mesh, table, axis="mp")
    jlook = np.asarray(jparallel.sharded_embedding_lookup(
        jnp.asarray(ids.astype(np.int32)), jtable, mesh, axis="mp"))
    jgrad = np.asarray(jparallel.sharded_embedding_grad(
        jnp.asarray(ids.astype(np.int32)), jnp.asarray(g), 64, mesh,
        axis="mp"))
    dense = np.zeros_like(table)
    np.add.at(dense, ids, g)
    for k in range(WORLD):
        np.testing.assert_array_equal(arrays[k]["emb.block"],
                                      table[16 * k:16 * (k + 1)])
        np.testing.assert_allclose(arrays[k]["emb.lookup"], table[ids],
                                   rtol=1e-6)
        np.testing.assert_allclose(arrays[k]["emb.lookup"], jlook,
                                   rtol=1e-6)
    grad = np.concatenate([arrays[k]["emb.grad"] for k in range(WORLD)])
    np.testing.assert_allclose(grad, dense, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(grad, jgrad, rtol=1e-5, atol=1e-6)


# -- in-process ----------------------------------------------------------------


def test_the_port_registers_the_collectives():
    ops = set(registered_ops())
    assert {c[1] for c in OP_CASES} | {"c_allreduce_mean"} <= ops
    assert len(ops) == 230


@pytest.mark.parametrize("op_type,attrs,out_shape", [
    ("c_allgather", {"ring_id": "dp", "axis": 1}, (4, 16)),
    ("c_reducescatter", {"ring_id": "dp", "axis": 0}, (1, 4)),
    ("c_allreduce_max", {"ring_id": "dp"}, (4, 4)),
    ("c_ppermute", {"ring_id": "dp", "shift": 1}, (4, 4))])
def test_collective_ops_on_meta_tensors_and_outside_a_mesh(op_type, attrs,
                                                          out_shape):
    """With the axis bound, an op on meta tensors gives its result's
    shape without communicating; outside a mesh it raises naming the
    unbound axis, as the JAX lowering does outside shard_map (so
    build-time shape inference reports both packages' ops alike)."""
    from paddle_tpu_torch.core import registry

    info = registry.get_op_info(op_type)
    x = torch.empty((4, 4), device="meta")
    group = tmesh.AxisGroup("dp", 4, 0, None, [0])
    out = info.lower(ExecContext("meta", groups={"dp": group}), {"X": [x]},
                     {**info.attrs, **attrs})["Out"]
    assert tuple(out.shape) == out_shape and out.device.type == "meta"
    with pytest.raises(NameError, match="unbound axis name 'dp'"):
        info.lower(ExecContext(), {"X": [torch.zeros(4, 4)]},
                   {**info.attrs, **attrs})
    prog = Program()
    b = prog.global_block()
    b.create_var(name="x", shape=(4, 4), dtype="float32")
    b.append_op(op_type, {"X": ["x"]}, {"Out": ["y"]}, attrs)
    assert b.vars["y"].shape is None


def test_collective_record_digests():
    """count_collectives and collective_bytes on a record: kinds in the
    JAX package's order, each entry's result-shape bytes."""
    C = tmesh.Collective
    rec = [C("all-reduce", "float32", (4, 8), "dp"),
           C("all-gather", "bfloat16", (16,), "tp"),
           C("all-reduce", "bfloat16", (2, 2), "tp"),
           C("collective-permute", "int64", (3,), "dp")]
    assert tmesh.count_collectives(rec) == {
        "all-reduce": 2, "all-gather": 1, "collective-permute": 1}
    assert tmesh.collective_bytes(rec) == {
        "all-reduce": 4 * 8 * 4 + 4 * 2, "all-gather": 32,
        "collective-permute": 24}
    assert tmesh.count_collectives([]) == {}


def test_pvary_and_shard_map_on_a_mesh_of_one():
    x = torch.arange(6.0).reshape(2, 3)
    assert tmesh.pvary(x, ("dp",)) is x
    mesh = tmesh.make_mesh({"dp": 1})
    f = tmesh.shard_map(lambda a, b: (a * 2, b.sum()), mesh=mesh,
                        in_specs=(tmesh.PartitionSpec("dp"),
                                  tmesh.PartitionSpec()),
                        out_specs=(tmesh.PartitionSpec("dp"),
                                   tmesh.PartitionSpec()))
    a, s = f(x, x)
    assert torch.equal(a, x * 2) and float(s) == 15.0
    assert mesh.axis_index("dp") == 0
