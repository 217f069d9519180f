"""The port's data-parallel path against the JAX package, on the CPU.

ParallelExecutor's bucketed overlap step: its build-time analysis
(`overlap_info` and the reasons it stands down) must equal the JAX
package's; trained through `ShardingTranspiler` at dp 1 it must match
the JAX ParallelExecutor (losses and parameters within 1e-5 relative:
float32 on both sides, other libraries' summation order) and the port's
own serial Executor bit for bit (same ops, same order; a bucket's
concatenation and split move values without arithmetic); the fused
bucket update must equal the per-op `sgd` chain bit for bit (the same
product and difference).  A two-rank gloo run checks the all-reduce:
both ranks hold the same bits, within 1e-6 of serial (a mean of two
half-batch gradients against one full-batch gradient).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu.core.framework as jfw
from paddle_tpu.core.flags import get_flag as jget_flag
from paddle_tpu.core.flags import set_flags as jset_flags
from paddle_tpu.models import transformer as jtr

import paddle_tpu_torch as tfluid
import paddle_tpu_torch.core.framework as tfw
from paddle_tpu_torch import CPUPlace
from paddle_tpu_torch.core import executor as texecutor
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.core.scope import Scope, scope_to_numpy
from paddle_tpu_torch.models import transformer as ttr
from paddle_tpu_torch.parallel.mesh import Mesh, PartitionSpec, make_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FEATS, CLS, HIDDEN, BATCH = 16, 4, 32, 16
RTOL = 1e-5


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


def _opt(fluid, kind):
    if kind == "sgd":
        return fluid.SGD(learning_rate=0.1)
    if kind == "momentum":
        return fluid.Momentum(learning_rate=0.1, momentum=0.9)
    return None


def _mlp(fluid, fw, kind="sgd", loss_op="mean"):
    """tests/test_serving_kernels.py's `_mlp`; `loss_op` "reduce_sum"
    gives a loss not produced by `mean`, kind None no optimizer."""
    fw.reset_unique_names()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[FEATS], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="int64")
        h = fluid.layers.fc(input=x, size=HIDDEN, act="relu")
        logits = fluid.layers.fc(input=h, size=CLS)
        cost = fluid.layers.softmax_with_cross_entropy(logits, y)
        loss = getattr(fluid.layers, loss_op)(cost)
        if kind is not None:
            _opt(fluid, kind).minimize(loss)
    params = [p.name for p in main.global_block().all_parameters()]
    return main, startup, loss, params, ["x", "y"]


def _lm(fluid, fw, tr):
    fw.reset_unique_names()
    main, startup = fluid.Program(), fluid.Program()
    seq, vocab = 8, 23
    with fluid.program_guard(main, startup):
        ids = fluid.layers.data(name="ids", shape=[seq], dtype="int64")
        lbl = fluid.layers.data(name="lbl", shape=[seq, 1], dtype="int64")
        logits = tr.transformer_lm(ids, vocab, d_model=32, n_heads=2,
                                   n_layers=2, max_len=seq,
                                   return_logits=True)
        loss = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(
            fluid.layers.reshape(logits, shape=[-1, vocab]),
            fluid.layers.reshape(lbl, shape=[-1, 1])))
        fluid.SGD(learning_rate=0.1).minimize(loss)
    params = [p.name for p in main.global_block().all_parameters()]
    return main, startup, loss, params, ["ids", "lbl"]


def _batches(steps=4):
    r = np.random.RandomState(5)
    return [{"x": r.rand(BATCH, FEATS).astype(np.float32),
             "y": r.randint(0, CLS, (BATCH, 1)).astype(np.int64)}
            for _ in range(steps)]


def _jax_pe(main, startup, feeds, loss, overlap="auto"):
    t = jfluid.ShardingTranspiler()
    t.transpile(program=main, startup_program=startup, mesh={"dp": 1},
                overlap=overlap, shard_optimizer_states=False)
    return t.build_executor(feeds, [loss])


def _port_pe(main, startup, feeds, loss, overlap="auto", **kw):
    t = tfluid.ShardingTranspiler()
    t.transpile(program=main, startup_program=startup, mesh={"dp": 1},
                overlap=overlap, **kw)
    return t.build_executor(feeds, [loss], place=CPUPlace())


class _Flags:
    """The same flag values in both packages for the block."""

    def __init__(self, **flags):
        self.flags = flags

    def __enter__(self):
        self.prev = {k: jget_flag(k) for k in self.flags}
        jset_flags(self.flags)
        tflags.set_flags(self.flags)

    def __exit__(self, *exc):
        jset_flags(self.prev)
        tflags.reset_flags()


def _port_info(info):
    """The JAX package's overlap_info in the port's vocabulary: a plain
    update is "plain:<reason>" where the JAX package says
    "xla:<reason>"."""
    out = dict(info)
    if str(out.get("update", "")).startswith("xla:"):
        out["update"] = "plain:" + out["update"][4:]
    return out


_INFO_CASES = [
    ("mlp_sgd", {}), ("mlp_sgd_on", {"serving_kernels": "on"}),
    ("mlp_momentum_on", {"serving_kernels": "on"}),
    ("sum_loss", {}), ("no_optimizer", {}), ("lm", {}),
    ("lm_cap0", {"overlap_bucket_bytes": 0}),
    ("lm_cap4k", {"overlap_bucket_bytes": 4096}),
]


@pytest.mark.parametrize("case,flags", _INFO_CASES,
                         ids=[c for c, _ in _INFO_CASES])
def test_overlap_info_matches_jax(case, flags):
    def build(fluid, fw, tr):
        if case.startswith("lm"):
            return _lm(fluid, fw, tr)
        kind = ("momentum" if "momentum" in case else
                None if case == "no_optimizer" else "sgd")
        return _mlp(fluid, fw, kind,
                    "reduce_sum" if case == "sum_loss" else "mean")

    with _Flags(**flags):
        jm, js, jl, _, feeds = build(jfluid, jfw, jtr)
        jpe = _jax_pe(jm, js, feeds, jl)
        want = _port_info(jpe.overlap_info)
        jpe.close()
        tm, ts, tl, _, _ = build(tfluid, tfw, ttr)
        tpe = _port_pe(tm, ts, feeds, tl)
        got = dict(tpe.overlap_info)
        tpe.close()
    assert got == want
    if case == "mlp_sgd_on":
        assert got["update"] == "fused"
    if case in ("sum_loss", "no_optimizer"):
        assert got["mode"] == "off"
    if case == "lm_cap0":
        assert got["buckets"] == got["grads"]


def test_bucketed_overlap_raises_like_jax_when_inapplicable():
    jm, js, jl, _, feeds = _mlp(jfluid, jfw, "sgd", "reduce_sum")
    with pytest.raises(ValueError) as jerr:
        _jax_pe(jm, js, feeds, jl, overlap="bucketed")
    tm, ts, tl, _, _ = _mlp(tfluid, tfw, "sgd", "reduce_sum")
    with pytest.raises(ValueError) as terr:
        _port_pe(tm, ts, feeds, tl, overlap="bucketed")
    assert str(terr.value) == str(jerr.value)
    assert "mean op" in str(terr.value)


def _train(pe, params, batches):
    losses = [float(np.asarray(pe.run(b)[0]).ravel()[0]) for b in batches]
    return losses, {n: np.asarray(pe.state(n)) for n in params}


def test_pe_matches_the_jax_pe():
    """dp 1, 4 SGD steps from the JAX startup's parameters."""
    jm, js, jl, params, feeds = _mlp(jfluid, jfw, "sgd")
    jpe = _jax_pe(jm, js, feeds, jl, overlap="bucketed")
    init = {n: np.asarray(jpe.state(n)) for n in params}
    jloss, jparams = _train(jpe, params, _batches())
    tm, ts, tl, tparams, _ = _mlp(tfluid, tfw, "sgd")
    assert tparams == params
    tpe = _port_pe(tm, ts, feeds, tl, overlap="bucketed")
    for n, v in init.items():
        tpe.set_state(n, v)
    tloss, tp = _train(tpe, params, _batches())
    assert tpe.overlap_info == _port_info(jpe.overlap_info)
    np.testing.assert_allclose(tloss, jloss, rtol=RTOL, atol=0)
    for n in params:
        np.testing.assert_allclose(tp[n], jparams[n], rtol=RTOL, atol=1e-7,
                                   err_msg=n)


@pytest.mark.parametrize("kind,overlap", [("sgd", "bucketed"),
                                          ("momentum", "bucketed"),
                                          ("sgd", "off")])
def test_pe_is_the_serial_executor_bit_for_bit(kind, overlap):
    main, startup, loss, params, feeds = _mlp(tfluid, tfw, kind)
    pe = _port_pe(main, startup, feeds, loss, overlap=overlap)
    ploss, pparams = _train(pe, params, _batches())
    exe = tfluid.Executor(CPUPlace())
    exe.run(startup)
    sloss = [float(exe.run(main, feed=b, fetch_list=[loss])[0][0])
             for b in _batches()]
    assert ploss == sloss
    sparams = scope_to_numpy(tfluid.global_scope(), params)
    for n in params:
        np.testing.assert_array_equal(pparams[n], sparams[n], err_msg=n)


def test_fused_update_is_the_per_op_chain_bit_for_bit():
    """serving_kernels "on" plans the fused bucket update (its plain
    version on the CPU), "off" the per-op sgd chain."""
    out = {}
    for mode in ("on", "off"):
        tflags.set_flags({"serving_kernels": mode,
                          "overlap_bucket_bytes": 1024})
        main, startup, loss, params, feeds = _mlp(tfluid, tfw, "sgd")
        pe = _port_pe(main, startup, feeds, loss, overlap="bucketed")
        out[mode] = (*_train(pe, params, _batches()), dict(pe.overlap_info))
    assert out["on"][2]["update"] == "fused"
    assert out["off"][2]["update"] == "plain:disarmed"
    assert out["on"][2]["buckets"] > 1
    assert out["on"][0] == out["off"][0]
    for n in out["off"][1]:
        np.testing.assert_array_equal(out["on"][1][n], out["off"][1][n],
                                      err_msg=n)


def test_flag_change_replans_at_the_next_run():
    main, startup, loss, params, feeds = _mlp(tfluid, tfw, "sgd")
    pe = _port_pe(main, startup, feeds, loss, overlap="bucketed")
    assert pe.overlap_info["update"] == "plain:disarmed"
    tflags.set_flags({"serving_kernels": "on", "overlap_bucket_bytes": 0})
    pe.run(_batches(1)[0])
    assert pe.overlap_info["update"] == "fused"
    assert pe.overlap_info["buckets"] == pe.overlap_info["grads"] == 4


def test_the_update_chains_shape_is_the_executors_verdict():
    """Momentum is not a chain of plain sgd ops: the executor declines
    the fused update itself — "plain:disarmed" with the tier off, a
    counted "op_mix" fallback when armed, reclaimed on close — and the
    kernel's supports judges only what it takes (dtype, size)."""
    from paddle_tpu_torch.kernels import registry as kreg
    from paddle_tpu_torch.kernels.fused_update import fused_update_supports

    main, startup, loss, params, feeds = _mlp(tfluid, tfw, "momentum")
    pe = _port_pe(main, startup, feeds, loss, overlap="bucketed")
    assert pe.overlap_info["update"] == "plain:disarmed"
    label = {"kernel": "fused_bucket_update", "reason": "op_mix"}
    tflags.set_flags({"serving_kernels": "on"})
    pe.run(_batches(1)[0])
    assert pe.overlap_info["update"] == "plain:op_mix"
    assert label in [lb for lb, _ in kreg._M_FALLBACKS.samples()]
    pe.close()
    assert label not in [lb for lb, _ in kreg._M_FALLBACKS.samples()]
    assert fused_update_supports(numel=4, dtype="float32") is None
    assert fused_update_supports(numel=4, dtype="bfloat16") == "dtype"
    assert fused_update_supports(numel=0) == "empty_bucket"


_WORKER = r"""
import sys
import numpy as np
import torch.distributed as dist
import paddle_tpu_torch as fluid
import paddle_tpu_torch.core.framework as fw

rank, store_path, out_path = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", store=dist.FileStore(store_path, 2),
                        rank=rank, world_size=2)
try:
    fw.reset_unique_names()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[16], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="int64")
        h = fluid.layers.fc(input=x, size=32, act="relu")
        logits = fluid.layers.fc(input=h, size=4)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, y))
        fluid.SGD(learning_rate=0.1).minimize(loss)
    t = fluid.ShardingTranspiler()
    t.transpile(program=main, startup_program=startup, mesh={"dp": 2},
                overlap="bucketed", shard_optimizer_states=False)
    pe = t.build_executor(["x", "y"], [loss], place=fluid.CPUPlace())
    r = np.random.RandomState(5)
    losses = []
    for _ in range(4):
        feed = {"x": r.rand(16, 16).astype(np.float32),
                "y": r.randint(0, 4, (16, 1)).astype(np.int64)}
        losses.append(pe.run(feed)[0][0])
    params = {p.name: pe.state(p.name)
              for p in main.global_block().all_parameters()}
    np.savez(out_path, losses=np.array(losses), **params,
             calls=np.array([pe.collective_calls["grad_all_reduce"],
                             pe.overlap_info["buckets"]]))
finally:
    dist.destroy_process_group()
"""


def test_two_gloo_ranks_hold_the_same_parameters(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    store = str(tmp_path / "store")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), store,
         str(tmp_path / f"rank{r}.npz")], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    for p in procs:
        out, _ = p.communicate(timeout=120)
        assert p.returncode == 0, out[-3000:]
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2)]
    assert ranks[0]["calls"][0] == 4 * ranks[0]["calls"][1]
    main, startup, loss, params, feeds = _mlp(tfluid, tfw, "sgd")
    exe = tfluid.Executor(CPUPlace())
    exe.run(startup)
    sloss = [float(exe.run(main, feed=b, fetch_list=[loss])[0][0])
             for b in _batches()]
    sparams = scope_to_numpy(tfluid.global_scope(), params)
    np.testing.assert_array_equal(ranks[0]["losses"], ranks[1]["losses"])
    np.testing.assert_allclose(ranks[0]["losses"], sloss, rtol=1e-6)
    for n in params:
        np.testing.assert_array_equal(ranks[0][n], ranks[1][n], err_msg=n)
        np.testing.assert_allclose(ranks[0][n], sparams[n], rtol=0,
                                   atol=1e-6, err_msg=n)


# -- what is not ported raises ---------------------------------------------

def test_not_ported_strategies_raise():
    main, startup, loss, params, feeds = _mlp(tfluid, tfw, "sgd")
    kw = dict(startup_program=startup, place=CPUPlace())
    cases = [
        (dict(mesh={"dp": 1}, param_shardings={
            params[0]: PartitionSpec(None, "tp")}), "A8"),
        (dict(mesh={"dp": 1, "tp": 1}), "A8"),
        (dict(mesh=Mesh({"dp": 2}, group=object()), overlap="bucketed",
              shard_optimizer_states=True), "A8"),
        (dict(mesh=Mesh({"dp": 2}, group=object()), overlap="off"), "A8"),
    ]
    for extra, item in cases:
        with pytest.raises(NotImplementedError, match=item):
            tfluid.ParallelExecutor(main, feeds, [loss], **kw, **extra)
    pe = tfluid.ParallelExecutor(main, feeds, [loss], mesh={"dp": 1},
                                 shard_optimizer_states=True, **kw)
    with pytest.raises(NotImplementedError, match="A8"):
        pe.compiled_collectives(_batches(1)[0])
    with pytest.raises(NotImplementedError, match="A11"):
        tfluid.DistributeTranspiler().transpile(
            program=main, startup_program=startup,
            pservers="127.0.0.1:6174", params_grads=[])
    t = tfluid.ShardingTranspiler()
    t.transpile(program=main, startup_program=startup,
                mesh={"dp": 1, "pp": 2})
    with pytest.raises(NotImplementedError, match="A9"):
        t.build_executor(feeds, [loss], place=CPUPlace())


def test_meshes_and_places():
    mesh = make_mesh({"dp": 1})
    assert mesh.group is None and mesh.shape == {"dp": 1} and mesh.rank == 0
    with pytest.raises(ValueError, match="init_distributed"):
        make_mesh({"dp": 2})


def test_pe_without_cuda_raises(monkeypatch):
    """No silent CPU: the default place is CUDAPlace(0)."""
    main, startup, loss, _, feeds = _mlp(tfluid, tfw, "sgd")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfluid.ParallelExecutor(main, feeds, [loss], mesh={"dp": 1},
                                startup_program=startup)
    t = tfluid.ShardingTranspiler()
    t.transpile(program=main, startup_program=startup, mesh={"dp": 1})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t.build_executor(feeds, [loss])


def test_get_places_without_cuda_raises(monkeypatch):
    """get_places() lists CUDA devices only: with none it raises as
    CUDAPlace.torch_device() does, and never returns the CPU."""
    from paddle_tpu_torch.parallel.mesh import get_places

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_places()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_places(1)
