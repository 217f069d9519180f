"""The port's tensor parallelism and ZeRO-1 against the JAX package, on
the CPU.

The JAX ParallelExecutor runs each case on the conftest's virtual CPU
devices; the port runs it on gloo ranks (one module-scoped spawn of 2
and one of 4 processes, each rank one mesh position), from the JAX
executor's initial states, over the same feeds.  Losses and every
parameter after the steps are held to the JAX package's in float32
within 2e-4 relative and 1e-5 absolute (tests/test_spmd_sharding.py's
tolerance: another library's summation order, and a mean of per-rank
gradients where the JAX step sums once), every rank holding the same
values; the placements (`state_specs` against the JAX package's
NamedSharding specs), the overlap report and the form are its own
checks.  The cases mirror the JAX package's tests: ZeRO-1 against the
replicated optimizer states (tests/test_parallel.py:69) with Momentum
and Adam, and under the bucketed overlap step; tensor parallelism from
one activation annotation (tests/test_spmd_sharding.py:406) and from
explicit `param_shardings` (tests/test_parallel.py:102, at tp 4 on four
ranks); a small `transformer_lm` with Megatron's placement and ZeRO-1
at dp2 x tp2; a replicated feed annotation
(tests/test_spmd_sharding.py:548); and the collective structure that
`compiled_collectives` and the step's collective record show
(tests/test_parallel.py:294).  Then the annotation surface,
`layers.shard` and `set_program_mesh`, against the JAX package's
(tests/test_spmd_sharding.py:36-188).
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu.core.framework as jfw
from paddle_tpu.models import transformer as jtr
from paddle_tpu.parallel import PartitionSpec as JP

import paddle_tpu_torch as tfluid
import paddle_tpu_torch.core.framework as tfw
from paddle_tpu_torch.parallel.tensor_parallel import megatron_placement

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 2e-4, 1e-5
STEPS = 3

# the programs, built by either package as `fluid` (the same source for
# the JAX side here and the port's ranks)
_PROGRAMS = r'''
import numpy as np

FEATS, CLS, HIDDEN, BATCH = 16, 4, 32, 16
V, D, H, L, S, LB = 64, 32, 4, 2, 16, 8


def opt(fluid, kind):
    if kind == "adam":
        return fluid.Adam(learning_rate=1e-3)
    if kind == "sgd":
        return fluid.SGD(learning_rate=0.1)
    return fluid.Momentum(learning_rate=0.1, momentum=0.9)


def mlp(fluid, fw, kind="momentum", annotate=False):
    """tests/test_spmd_sharding.py's `_annotated_mlp`."""
    fw.reset_unique_names()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[FEATS], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="int64")
        h = fluid.layers.fc(input=x, size=HIDDEN, act="relu")
        if annotate:
            fluid.layers.shard(h, (None, "tp"))
        h2 = fluid.layers.fc(input=h, size=HIDDEN, act="relu")
        logits = fluid.layers.fc(input=h2, size=CLS)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, y))
        opt(fluid, kind).minimize(loss)
    return main, startup, loss, ["x", "y"]


def classifier(fluid, fw):
    """tests/test_parallel.py's `_build_classifier`."""
    fw.reset_unique_names()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[FEATS], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="int64")
        h = fluid.layers.fc(input=x, size=HIDDEN, act="relu")
        logits = fluid.layers.fc(input=h, size=CLS)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, y))
        fluid.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, loss, ["x", "y"]


def lm(fluid, fw, tr):
    fw.reset_unique_names()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        ids = fluid.layers.data(name="ids", shape=[S], dtype="int64")
        lbl = fluid.layers.data(name="lbl", shape=[S, 1], dtype="int64")
        logits = tr.transformer_lm(ids, V, d_model=D, n_heads=H,
                                   n_layers=L, max_len=S,
                                   return_logits=True)
        loss = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(
            fluid.layers.reshape(logits, shape=[-1, V]),
            fluid.layers.reshape(lbl, shape=[-1, 1])))
        fluid.Momentum(learning_rate=0.1, momentum=0.9).minimize(loss)
    return main, startup, loss, ["ids", "lbl"]


def feed_tbl(fluid, fw):
    """tests/test_spmd_sharding.py:548's program."""
    fw.reset_unique_names()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[FEATS], dtype="float32")
        tbl = fluid.layers.data(name="tbl", shape=[FEATS],
                                dtype="float32", append_batch_size=False,
                                sharding=(None,))
        h = fluid.layers.fc(input=x, size=FEATS)
        loss = fluid.layers.mean(fluid.layers.elementwise_add(h, tbl))
        fluid.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, loss, ["x", "tbl"]


def regression(fluid, fw, kind="sgd"):
    """tests/test_parallel.py:294's program."""
    fw.reset_unique_names()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        p = fluid.layers.fc(input=x, size=1)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(p, y))
        opt(fluid, kind).minimize(loss)
    return main, startup, loss, ["x", "y"]


def feeds(kind, steps, seed=7):
    r = np.random.RandomState(seed)
    out = []
    for _ in range(steps):
        if kind == "lm":
            out.append({"ids": r.randint(0, V, (LB, S)).astype(np.int64),
                        "lbl": r.randint(0, V, (LB, S, 1))
                        .astype(np.int64)})
        elif kind == "tbl":
            out.append({"x": r.randn(BATCH, FEATS).astype(np.float32),
                        "tbl": r.randn(FEATS).astype(np.float32)})
        elif kind == "regression":
            out.append({"x": r.randn(8, 4).astype(np.float32),
                        "y": r.randn(8, 1).astype(np.float32)})
        else:
            out.append({"x": r.randn(BATCH, FEATS).astype(np.float32),
                        "y": r.randint(0, CLS, (BATCH, 1))
                        .astype(np.int64)})
    return out


def cases(world):
    """{name: (program args, feed kind, mesh, how, executor kwargs)}:
    `how` "pe" builds ParallelExecutor, "transpiler" goes through
    ShardingTranspiler (whose shard_optimizer_states defaults to True);
    `param_shardings` "megatron" is megatron_placement's.  Two ranks run
    the ZeRO-1 cases at dp 2; four run them at dp 4 and the rest."""
    zero = {
        "zero_momentum": (("mlp", "momentum"), "mlp", {"dp": world}, "pe",
                          {"shard_optimizer_states": True}),
        "zero_adam": (("mlp", "adam"), "mlp", {"dp": world}, "pe",
                      {"shard_optimizer_states": True}),
        "zero_bucketed": (("mlp", "momentum"), "mlp", {"dp": world},
                          "transpiler", {"overlap": "bucketed"}),
    }
    if world == 2:
        return zero
    return {
        **zero,
        "tp_annotation": (("mlp", "momentum", True), "mlp",
                          {"dp": 2, "tp": 2}, "transpiler",
                          {"overlap": "auto"}),
        "tp_param_shardings": (("classifier",), "mlp", {"dp": 1, "tp": 4},
                               "pe", {"param_shardings": {
                                   "fc_0.w_0": (None, "tp")}}),
        "lm_megatron_zero": (("lm",), "lm", {"dp": 2, "tp": 2},
                             "transpiler", {"param_shardings": "megatron"}),
        "replicated_feed": (("feed_tbl",), "tbl", {"dp": world},
                            "transpiler", {}),
    }


def build(fluid, fw, tr, args):
    fn = globals()[args[0]]
    if args[0] == "lm":
        return fn(fluid, fw, tr)
    return fn(fluid, fw, *args[1:])
'''

_WORKER = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist
import paddle_tpu_torch as fluid
import paddle_tpu_torch.core.framework as fw
from paddle_tpu_torch.models import transformer as tr
from paddle_tpu_torch.parallel import PartitionSpec as P
from paddle_tpu_torch.parallel.mesh import count_collectives
from paddle_tpu_torch.parallel.tensor_parallel import megatron_placement

rank, world = int(sys.argv[1]), int(sys.argv[2])
store, init_path, out_path, programs = sys.argv[3:7]
exec(open(programs).read())
dist.init_process_group("gloo", store=dist.FileStore(store, world),
                        rank=rank, world_size=world)
init = dict(np.load(init_path))
out, meta = {}, {}


def make(name, spec):
    args, kind, mesh, how, kw = spec
    main, startup, loss, feed_names = build(fluid, fw, tr, args)
    kw = dict(kw)
    if kw.get("param_shardings") == "megatron":
        kw["param_shardings"] = megatron_placement(main)
    if "param_shardings" in kw:
        kw["param_shardings"] = {n: P(*s) for n, s in
                                 kw["param_shardings"].items()}
    if how == "pe":
        pe = fluid.ParallelExecutor(main, feed_names, [loss], mesh=mesh,
                                    startup_program=startup,
                                    place=fluid.CPUPlace(), **kw)
    else:
        t = fluid.ShardingTranspiler()
        t.transpile(program=main, startup_program=startup, mesh=mesh,
                    overlap=kw.pop("overlap", "auto"))
        pe = t.build_executor(feed_names, [loss], place=fluid.CPUPlace(),
                              **kw)
    return main, pe, kind


try:
    for name, spec in cases(world).items():
        main, pe, kind = make(name, spec)
        for n in sorted(pe._states):
            pe.set_state(n, init[f"{name}.init.{n}"])
        losses = [float(np.asarray(pe.run(f)[0]).reshape(-1)[0])
                  for f in feeds(kind, STEPS)]
        record = pe.collective_record
        out[f"{name}.loss"] = np.array(losses)
        for n in sorted(pe._states):
            out[f"{name}.state.{n}"] = pe.state(n)
        meta[name] = {
            "form": pe.gspmd_form, "overlap_info": pe.overlap_info,
            "specs": {n: list(s) for n, s in pe.state_specs.items()},
            "feed_specs": {n: list(s) for n, s in pe._feed_specs.items()},
            "calls": pe.collective_calls,
            "record": [[c.kind, c.axis] for c in record],
            "zero": sorted(pe._zero_states),
            "zero_ops": len(pe._zero_ops)}
    # tests/test_parallel.py:294: dp-N all-reduces and nothing else;
    # ZeRO-1 adds the parameters' all-gathers
    for kind in ("sgd", "momentum"):
        main, startup, loss, names = regression(fluid, fw, kind)
        pe = fluid.ParallelExecutor(main, names, [loss], mesh={"dp": world},
                                    startup_program=startup,
                                    shard_optimizer_states=True,
                                    place=fluid.CPUPlace())
        f = feeds("regression", 1)[0]
        before = {n: pe.state(n) for n in sorted(pe._states)}
        meta[f"compiled_collectives.{kind}"] = {
            "counts": pe.compiled_collectives(f),
            "unchanged": all(np.array_equal(pe.state(n), v)
                             for n, v in before.items())}
finally:
    dist.destroy_process_group()
np.savez(out_path, **out)
with open(out_path + ".json", "w") as fh:
    json.dump(meta, fh)
"""

_NS = {}
exec(_PROGRAMS, _NS)
_NS["STEPS"] = STEPS


def _jax_runs(world, tmp):
    """The JAX ParallelExecutor over every case -> (its initial states,
    its results); the initial states written for the ranks."""
    init, res = {}, {}
    for name, (args, kind, mesh, how, kw) in _NS["cases"](world).items():
        main, startup, loss, feed_names = _NS["build"](jfluid, jfw, jtr,
                                                       args)
        kw = dict(kw)
        if kw.get("param_shardings") == "megatron":
            kw["param_shardings"] = megatron_placement(main)
        if "param_shardings" in kw:
            kw["param_shardings"] = {n: JP(*s) for n, s in
                                     kw["param_shardings"].items()}
        if how == "pe":
            pe = jfluid.ParallelExecutor(main, feed_names, [loss],
                                         mesh=mesh, startup_program=startup,
                                         **kw)
        else:
            t = jfluid.ShardingTranspiler()
            t.transpile(program=main, startup_program=startup, mesh=mesh,
                        overlap=kw.pop("overlap", "auto"))
            pe = t.build_executor(feed_names, [loss], **kw)
        for n in pe._states:
            init[f"{name}.init.{n}"] = np.asarray(pe.state(n))
        fs = _NS["feeds"](kind, STEPS)
        hlo = pe.compiled_collectives(fs[0])
        losses = [float(np.asarray(pe.run(f)[0]).reshape(-1)[0])
                  for f in fs]
        res[name] = {
            "hlo": hlo,
            "loss": np.array(losses),
            "states": {n: np.asarray(pe.state(n)) for n in pe._states},
            "specs": {n: list(sh.spec) for n, sh in
                      pe._state_shardings.items()},
            "feed_specs": {n: list(sh.spec) for n, sh in
                           pe._feed_shardings.items()},
            "overlap_info": dict(pe.overlap_info)}
    np.savez(tmp / "init.npz", **init)
    return res


def _spawn(world, tmp_path_factory):
    """The JAX runs and one spawn of `world` gloo ranks over every case
    -> (world, JAX results, [each rank's arrays], [each rank's meta])."""
    tmp = tmp_path_factory.mktemp(f"sharding{world}")
    jax_res = _jax_runs(world, tmp)
    programs = tmp / "programs.py"
    programs.write_text(_PROGRAMS + f"\nSTEPS = {STEPS}\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), str(world),
         str(tmp / "store"), str(tmp / "init.npz"),
         str(tmp / f"rank{r}.npz"), str(programs)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    for p in procs:
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, out[-3000:]
    arrays = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(world)]
    metas = []
    for r in range(world):
        with open(tmp / f"rank{r}.npz.json") as f:
            metas.append(json.load(f))
    return world, jax_res, arrays, metas


@pytest.fixture(scope="module")
def sharded_runs(tmp_path_factory):
    """{world: _spawn's record}, each world spawned once, at first use."""
    runs = {}

    def get(world):
        if world not in runs:
            runs[world] = _spawn(world, tmp_path_factory)
        return runs[world]
    return get


_RUNS = [(w, c) for w in (2, 4) for c in sorted(_NS["cases"](w))]
_IDS = [f"world{w}-{c}" for w, c in _RUNS]
_FORMS = {"zero_momentum": "sync_bn", "zero_adam": "sync_bn",
          "zero_bucketed": None, "tp_annotation": "sharded",
          "tp_param_shardings": "sharded", "lm_megatron_zero": "sharded",
          "replicated_feed": "replicated"}


def _spec(s):
    return [tuple(e) if isinstance(e, list) else e for e in s]


@pytest.mark.parametrize("world,case", _RUNS, ids=_IDS)
def test_the_port_is_the_jax_parallel_executor(sharded_runs, world, case):
    """Every rank's losses and states bit-equal across ranks and, after
    the steps, equal to the JAX ParallelExecutor's; the same
    placements and overlap report; the form the case takes."""
    world, jax_res, arrays, metas = sharded_runs(world)
    want = jax_res[case]
    ref = arrays[0]
    for r in range(1, world):
        for k in ref:
            if k.startswith(case + "."):
                np.testing.assert_array_equal(arrays[r][k], ref[k],
                                              err_msg=f"rank {r} {k}")
    np.testing.assert_allclose(ref[f"{case}.loss"], want["loss"],
                               rtol=RTOL, atol=ATOL)
    assert sorted(want["states"]) == sorted(
        k[len(case) + 7:] for k in ref if k.startswith(case + ".state."))
    for n, v in want["states"].items():
        np.testing.assert_allclose(ref[f"{case}.state.{n}"], v, rtol=RTOL,
                                   atol=ATOL, err_msg=n)
    assert ref[f"{case}.loss"][-1] != ref[f"{case}.loss"][0]
    meta = metas[0][case]
    assert {n: _spec(s) for n, s in meta["specs"].items()} == {
        n: _spec(s) for n, s in want["specs"].items()}
    assert meta["overlap_info"]["mode"] == want["overlap_info"]["mode"]
    assert meta["overlap_info"].get("reason") == \
        want["overlap_info"].get("reason")
    assert meta["form"] == _FORMS[case]
    for n, s in want["feed_specs"].items():
        assert _spec(meta["feed_specs"][n]) == _spec(s), n


@pytest.mark.parametrize("world,case", [
    (w, c) for w, c in _RUNS if c.startswith(("zero", "lm"))],
    ids=[i for (w, c), i in zip(_RUNS, _IDS)
         if c.startswith(("zero", "lm"))])
def test_zero_splits_the_accumulators_rows(sharded_runs, world, case):
    """ZeRO-1: the accumulators placed over the batch axis hold their
    rows on each rank, and a step all-gathers each parameter they
    update (one record entry a parameter, over 'dp')."""
    world, _, _, metas = sharded_runs(world)
    meta = metas[0][case]
    zero = [n for n, s in meta["specs"].items() if s == ["dp"]]
    assert meta["zero"] == sorted(zero) and zero
    gathers = [a for k, a in meta["record"] if k == "all-gather"]
    assert set(gathers) == {"dp"}
    assert len(gathers) == meta["zero_ops"] == meta["calls"][
        "zero_all_gather"] // STEPS


@pytest.mark.parametrize("case", ["tp_annotation", "tp_param_shardings",
                                  "lm_megatron_zero"])
def test_tensor_parallel_collectives(sharded_runs, case):
    """The tensor-parallel step's collectives: a row-parallel layer's
    all-reduce over 'tp' in the forward, and a column layer's dX
    all-reduced in the backward where that gradient is wanted (not for
    a feed: the annotated MLP's first layer reads x); a placement that
    leaves a split activation meeting a whole bias all-gathers it (the
    param_shardings case); the small LM's attention runs on local heads,
    so no all-gather over 'tp' (2 layers x (2 forward + 4 backward))."""
    world, _, _, metas = sharded_runs(4)
    meta = metas[0][case]
    tp_ops = [k for k, a in meta["record"] if a == "tp"]
    calls = meta["calls"]
    steps = STEPS
    if case == "tp_param_shardings":
        assert calls["tp_all_gather"] > 0 and "all-gather" in tp_ops
        assert calls.get("tp_all_reduce", 0) == 0
        return
    assert tp_ops.count("all-reduce") >= 1
    assert "all-gather" not in tp_ops
    per_step = {"tp_annotation": 1, "lm_megatron_zero": 12}[case]
    assert calls["tp_all_reduce"] == steps * per_step, calls


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("kind", ["sgd", "momentum"])
def test_compiled_collectives_structure(sharded_runs, world, kind):
    """tests/test_parallel.py:294 on the port's record: dp-N issues
    all-reduces and nothing else; ZeRO-1 (Momentum: accumulators) adds
    all-gathers; the states are left as they were."""
    world, _, _, metas = sharded_runs(world)
    got = metas[0][f"compiled_collectives.{kind}"]
    assert got["unchanged"]
    counts = got["counts"]
    assert counts.get("all-reduce", 0) >= 1, counts
    if kind == "sgd":
        assert set(counts) == {"all-reduce"}, counts
    else:
        assert set(counts) == {"all-reduce", "all-gather"}, counts


@pytest.mark.parametrize("world", [2, 4])
def test_collective_structure_beside_the_jax_hlo(sharded_runs, world):
    """The port's collective record of a step beside the JAX package's
    optimized-HLO counts (`compiled_collectives`) for each case, printed
    (`-s`) for PERF.md.  They differ by design — XLA fuses and
    reshapes collectives, the port issues one a bucket, a row-parallel
    product, a wanted column dX and a ZeRO-1 parameter — so the pin is
    the port's own structure: over dp only all-reduces and ZeRO-1's
    all-gathers, over tp only all-reduces (no case gathers over tp but
    the param_shardings one, whose split activation meets a whole
    bias), and a collective in every step but the replicated form's
    (every rank the global batch)."""
    world, jax_res, _, metas = sharded_runs(world)
    for case in sorted(jax_res):
        record = metas[0][case]["record"]
        port = {}
        for kind, axis in record:
            port[f"{kind}@{axis}"] = port.get(f"{kind}@{axis}", 0) + 1
        print(f"world {world} {case}: port {port} jax hlo "
              f"{jax_res[case]['hlo']}")
        assert {k for k, _ in record} <= {"all-reduce", "all-gather"}
        assert {a for k, a in record if k == "all-gather"} <= (
            {"dp", "tp"} if case == "tp_param_shardings" else {"dp"})
        assert bool(record) == (world > 1 and metas[0][case]["form"]
                                != "replicated"), case


# ---------------------------------------------------------------------------
# the annotation surface (tests/test_spmd_sharding.py:36-188)
# ---------------------------------------------------------------------------


def _pkg(kind):
    return (jfluid, jfw) if kind == "jax" else (tfluid, tfw)


def _diag_keys(program):
    return sorted((d.pass_id, d.severity, d.op_idx, d.op_type, d.message)
                  for d in program.verify(level=None,
                                          passes=["sharding-consistency"]))


def test_sharding_annotation_roundtrip():
    for kind in ("jax", "torch"):
        fluid, fw = _pkg(kind)
        fw.reset_unique_names()
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.layers.data(name="x", shape=[16], dtype="float32",
                                  sharding=("dp", None))
            h = fluid.layers.fc(input=x, size=32)
            fluid.layers.shard(h, (None, ("tp", "dp")))
            fluid.layers.set_program_mesh({"dp": 4, "tp": 2})
        assert x.sharding == ("dp", None)
        assert h.sharding == (None, ("tp", "dp"))
        assert h.op.dist_attr["sharding"][h.name] == [None, ["tp", "dp"]]
        clone = fluid.Program.from_dict(main.to_dict())
        blk = clone.global_block()
        assert blk.vars["x"].sharding == ("dp", None)
        assert blk.vars[h.name].sharding == (None, ("tp", "dp"))
        assert clone.mesh_axes == {"dp": 4, "tp": 2}
    tfw.reset_unique_names()


@pytest.mark.parametrize("fixture", [
    "contradiction", "bare_string", "rank_and_duplicate",
    "unknown_axis", "not_divisible", "contraction", "hotspot",
    "unannotated"])
def test_consistency_diagnostics_match_the_jax_package(fixture):
    """Each of tests/test_spmd_sharding.py's seeded-bad annotations: the
    same error raised, or the same sharding-consistency diagnostics."""
    results = {}
    for kind in ("jax", "torch"):
        fluid, fw = _pkg(kind)
        fw.reset_unique_names()
        main, startup = fluid.Program(), fluid.Program()
        raised = None
        with fluid.program_guard(main, startup):
            try:
                if fixture in ("contradiction", "bare_string"):
                    x = fluid.layers.data(name="x", shape=[16],
                                          dtype="float32")
                    h = fluid.layers.fc(input=x, size=32)
                    if fixture == "bare_string":
                        fluid.layers.shard(x, "dp")
                    fluid.layers.shard(h, (None, "tp"))
                    fluid.layers.shard(h, ("tp", None))
                elif fixture == "rank_and_duplicate":
                    x = fluid.layers.data(name="x", shape=[16],
                                          dtype="float32",
                                          sharding=("dp", None, "tp"))
                    h = fluid.layers.fc(input=x, size=32)
                    fluid.layers.shard(h, ("tp", "tp"))
                elif fixture in ("unknown_axis", "not_divisible"):
                    x = fluid.layers.data(name="x", shape=[16],
                                          dtype="float32")
                    h = fluid.layers.fc(input=x, size=30)
                    fluid.layers.shard(h, (None, "mp" if fixture ==
                                           "unknown_axis" else "tp"))
                    fluid.layers.set_program_mesh({"dp": 2, "tp": 4})
                elif fixture == "contraction":
                    x = fluid.layers.data(name="x", shape=[16],
                                          dtype="float32")
                    h = fluid.layers.fc(input=x, size=32)
                    fluid.layers.shard(h, (None, "tp"))
                    fluid.layers.fc(input=h, size=4)
                    fluid.layers.shard("fc_1.w_0", ("dp", None))
                elif fixture == "hotspot":
                    a = fluid.layers.data(name="a", shape=[16],
                                          dtype="float32",
                                          sharding=("dp", "tp"))
                    b = fluid.layers.data(name="b", shape=[16],
                                          dtype="float32",
                                          sharding=("dp", None))
                    fluid.layers.elementwise_add(a, b)
                else:
                    x = fluid.layers.data(name="x", shape=[16],
                                          dtype="float32")
                    fluid.layers.fc(input=x, size=32)
            except ValueError as e:
                raised = str(e)
        results[kind] = (raised, None if raised else _diag_keys(main),
                         main, startup)
    (jr, jd, jmain, jstart), (tr, td, tmain, tstart) = \
        results["jax"], results["torch"]
    assert tr == jr
    assert td == jd
    if fixture in ("contradiction", "bare_string"):
        assert tr is not None
    if fixture == "contraction":
        assert any("contradictory specs for one contraction" in k[4]
                   for k in td)
        # and the transpiler refuses the program at build time
        for fluid, main, startup in ((jfluid, jmain, jstart),
                                     (tfluid, tmain, tstart)):
            with pytest.raises(ValueError, match="inconsistent"):
                fluid.ShardingTranspiler().transpile(
                    program=main, startup_program=startup,
                    mesh={"dp": 4, "tp": 2})
    if fixture == "unannotated":
        assert td == []
    tfw.reset_unique_names()


def test_megatron_placement_of_the_lm():
    """megatron_placement finds the same names in either package's LM:
    q, k, v and the FFN's first fc column-split with their biases, the
    attention output and the FFN's second fc row-split; the embeddings
    and the head whole."""
    jmain = _NS["lm"](jfluid, jfw, jtr)[0]
    tmain = _NS["lm"](tfluid, tfw, __import__(
        "paddle_tpu_torch.models.transformer", fromlist=["x"]))[0]
    specs = megatron_placement(tmain)
    assert specs == megatron_placement(jmain)
    w = sorted(n for n in specs if n.endswith(".w_0"))
    assert len(w) == 6 * _NS["L"]
    assert sum(s == ("tp", None) for s in specs.values()) == 2 * _NS["L"]
    assert not any(n.startswith(("embedding", "create_parameter"))
                   for n in specs)
    assert f"fc_{6 * _NS['L']}.w_0" not in specs
    tfw.reset_unique_names()
