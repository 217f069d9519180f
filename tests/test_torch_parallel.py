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
import json
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


# -- the in-place fused plan: parameters as views of one flat buffer ------

def _fused_pe(cap=1024):
    """The MLP through the fused bucket update (its plain version on the
    CPU), several buckets."""
    tflags.set_flags({"serving_kernels": "on", "overlap_bucket_bytes": cap})
    main, startup, loss, params, feeds = _mlp(tfluid, tfw, "sgd")
    pe = _port_pe(main, startup, feeds, loss, overlap="bucketed")
    assert pe.overlap_info["update"] == "fused"
    return pe, params


def _bucket_layout(pe):
    """[(flat buffer, [(param, offset)])] of the fused plan."""
    out = []
    for entries, _, _, flat, _ in pe._plan[2]:
        off, members = 0, []
        for p, _, shape in entries:
            members.append((p, off))
            off += int(np.prod(shape))
        assert off == flat.numel()
        out.append((flat, members))
    return out


def test_fused_params_are_views_of_their_buckets_flat_buffer():
    pe, params = _fused_pe()
    layout = _bucket_layout(pe)
    assert len(layout) == pe.overlap_info["buckets"] > 1
    assert sorted(p for _, m in layout for p, _ in m) == sorted(params)
    for _ in range(2):
        for flat, members in layout:
            for p, off in members:
                v = pe._states[p]
                assert v.untyped_storage().data_ptr() == \
                    flat.untyped_storage().data_ptr()
                assert v.storage_offset() == flat.storage_offset() + off
        pe.run(_batches(1)[0])
    # the step updated the buffers in place: the same buffers, moved
    assert [f for f, _ in _bucket_layout(pe)] == [f for f, _ in layout]


def test_state_hands_out_copies_and_set_state_writes_the_buffer():
    pe, params = _fused_pe()
    name = params[0]
    before = pe.state(name, return_numpy=False)
    snapshot = before.clone()
    before.add_(1.0)            # a copy: the executor's value is untouched
    np.testing.assert_array_equal(pe.state(name), snapshot.numpy())
    as_numpy = pe.state(name)
    pe.run(_batches(1)[0])      # nor does the step change the copies
    assert torch.equal(before, snapshot + 1.0)
    np.testing.assert_array_equal(as_numpy, snapshot.numpy())
    assert not np.array_equal(pe.state(name), snapshot.numpy())

    flat, members = next((f, m) for f, m in _bucket_layout(pe)
                         if any(p == name for p, _ in m))
    view = pe._states[name]
    value = np.arange(view.numel(), dtype=np.float32).reshape(view.shape)
    pe.set_state(name, value)
    assert pe._states[name] is view                 # still the view
    off = dict(members)[name]
    np.testing.assert_array_equal(
        flat[off:off + view.numel()].reshape(view.shape).numpy(), value)
    with pytest.raises(ValueError, match="shape"):
        pe.set_state(name, value.reshape(-1)[:-1])


def test_a_fetched_parameter_keeps_its_value_from_before_the_update():
    """The analysis admits only per-row or batch-mean fetches, and no
    parameter is one; a fetch that is a live view of a bucket (from a
    lowering that returns a view of its input) is cloned before the
    in-place update all the same.  This drives that guard with a
    parameter in the fetch list."""
    pe, params = _fused_pe()
    name = params[0]
    pe._overlap_cfg["fetch_kinds"][name] = "batch"
    pe.fetch_names.append(name)
    want = pe.state(name)
    loss, got = pe.run(_batches(1)[0])
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(pe.state(name), want)
    _, got = pe.run(_batches(1)[0], return_numpy=False)
    assert got.untyped_storage().data_ptr() not in pe._flat_storages


def test_rebucketing_keeps_the_values_and_the_chain_bits():
    """A flag change re-buckets at the next run: the new flat buffers
    start from the current values, and the steps stay the per-op sgd
    chain bit for bit."""
    batches = _batches(4)
    pe, params = _fused_pe(cap=1024)
    for b in batches[:2]:
        pe.run(b)
    mid = {n: pe.state(n) for n in params}
    old = [f for f, _ in _bucket_layout(pe)]
    tflags.set_flags({"overlap_bucket_bytes": 0})
    pe._refresh_plan()
    assert pe.overlap_info["buckets"] == pe.overlap_info["grads"] == 4
    assert len(old) != pe.overlap_info["buckets"]
    for n in params:
        np.testing.assert_array_equal(pe.state(n), mid[n], err_msg=n)
    fused = [pe.run(b)[0] for b in batches[2:]]

    tflags.set_flags({"serving_kernels": "off"})
    main, startup, loss, _, feeds = _mlp(tfluid, tfw, "sgd")
    chain = _port_pe(main, startup, feeds, loss, overlap="bucketed")
    assert chain.overlap_info["update"] == "plain:disarmed"
    for b in batches[:2]:
        chain.run(b)
    assert [chain.run(b)[0] for b in batches[2:]] == fused
    for n in params:
        np.testing.assert_array_equal(pe.state(n), chain.state(n),
                                      err_msg=n)


def test_a_replaced_parameter_state_is_written_back_into_its_bucket():
    """A step with the fused plan set aside (the per-op chain, as a
    caller that swaps the update runs it) replaces the parameter states
    with new tensors; the next fused step copies them back into the flat
    buffers and updates them there, so no update is lost: the steps stay
    the per-op chain bit for bit."""
    batches = _batches(3)
    pe, params = _fused_pe()
    plan = pe._plan
    pe._plan = (plan[0], plan[1], None)
    first = pe.run(batches[0])[0]
    assert not any(pe._in_bucket(pe._states[n]) for n in params)
    pe._plan = plan
    fused = [first] + [pe.run(b)[0] for b in batches[1:]]
    assert all(pe._in_bucket(pe._states[n]) for n in params)

    tflags.set_flags({"serving_kernels": "off"})
    main, startup, loss, _, feeds = _mlp(tfluid, tfw, "sgd")
    chain = _port_pe(main, startup, feeds, loss, overlap="bucketed")
    assert chain.overlap_info["update"] == "plain:disarmed"
    assert [chain.run(b)[0] for b in batches] == fused
    for n in params:
        np.testing.assert_array_equal(pe.state(n), chain.state(n),
                                      err_msg=n)


def test_in_place_fused_pe_matches_the_jax_pe():
    """As test_pe_matches_the_jax_pe, with the fused bucket update armed
    in both packages (several buckets)."""
    with _Flags(serving_kernels="on", overlap_bucket_bytes=1024):
        jm, js, jl, params, feeds = _mlp(jfluid, jfw, "sgd")
        jpe = _jax_pe(jm, js, feeds, jl, overlap="bucketed")
        init = {n: np.asarray(jpe.state(n)) for n in params}
        jloss, jparams = _train(jpe, params, _batches())
        tm, ts, tl, _, _ = _mlp(tfluid, tfw, "sgd")
        tpe = _port_pe(tm, ts, feeds, tl, overlap="bucketed")
        for n, v in init.items():
            tpe.set_state(n, v)
        tloss, tp = _train(tpe, params, _batches())
        assert tpe.overlap_info == _port_info(jpe.overlap_info)
        assert tpe.overlap_info["update"] == "fused"
    np.testing.assert_allclose(tloss, jloss, rtol=RTOL, atol=0)
    for n in params:
        np.testing.assert_allclose(tp[n], jparams[n], rtol=RTOL, atol=1e-7,
                                   err_msg=n)


@pytest.mark.parametrize("numel", [1, 5, 1031])
def test_plain_fused_update_in_place_is_the_out_of_place_bits(numel):
    from paddle_tpu_torch.kernels.fused_update import (
        fused_bucket_sgd_, fused_bucket_sgd_reference)

    r = np.random.RandomState(numel)
    p = torch.from_numpy(r.standard_normal(numel).astype(np.float32))
    g = torch.from_numpy(r.standard_normal(numel).astype(np.float32))
    lr = torch.tensor([0.0123])
    want = fused_bucket_sgd_reference(p, g, lr)
    chain = p - lr * g          # the sgd op's two roundings
    q = p.clone()
    assert fused_bucket_sgd_(q, g, lr) is q
    assert torch.equal(q, want) and torch.equal(want, chain)


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




_ORDER_PROBE = r"""
import json
import paddle_tpu_torch as fluid
import paddle_tpu_torch.core.framework as fw

fw.reset_unique_names()
main, startup = fluid.Program(), fluid.Program()
with fluid.program_guard(main, startup):
    x = fluid.layers.data(name="x", shape=[4], dtype="float32")
    h = x
    for _ in range(3):
        h = fluid.layers.layer_norm(fluid.layers.fc(input=h, size=4))
        h = fluid.layers.batch_norm(input=fluid.layers.fc(input=h, size=4))
    loss = fluid.layers.mean(h)
    fluid.SGD(learning_rate=0.1).minimize(loss)
pe = fluid.ParallelExecutor(main, ["x"], [loss], mesh={"dp": 1},
                            startup_program=startup,
                            place=fluid.CPUPlace())
cfg, _, _ = pe._analyze_overlap(main, main.global_block())
print(json.dumps([g for g, _, _ in cfg["grad_meta"]]))
"""


def test_bucket_order_does_not_depend_on_the_hash_seed():
    """layer_norm_grad and batch_norm_grad each make two parameter
    gradients at once.  Their order in the buckets once fell to a set's
    iteration order, which Python's per-process hash seed decides, so
    two ranks could lay a bucket out differently and sum one rank's
    Scale@GRAD with another's Bias@GRAD; now it is the op's output
    order, the same in every process."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    orders = []
    for seed in ("1", "2"):
        res = subprocess.run([sys.executable, "-c", _ORDER_PROBE], cwd=ROOT,
                             env={**env, "PYTHONHASHSEED": seed},
                             capture_output=True, text=True, timeout=120)
        assert res.returncode == 0, res.stderr[-3000:]
        orders.append(json.loads(res.stdout.strip().splitlines()[-1]))
    assert orders[0] == orders[1]
    pairs = [i for i, g in enumerate(orders[0])
             if g.endswith("scale_0@GRAD")]
    assert len(pairs) == 6 and all(
        orders[0][i + 1].endswith(("offset_0@GRAD", "shift_0@GRAD"))
        for i in pairs), orders[0]

# -- the GSPMD step's two forms across gloo ranks ---------------------------

# every program, built and fed the same way on each rank; rank 0 also runs
# the serial Executor over the global batch from the same startup
_GSPMD_WORKER = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist
import paddle_tpu_torch as fluid
import paddle_tpu_torch.core.framework as fw
from paddle_tpu_torch import models
from paddle_tpu_torch.core.scope import Scope

rank, world = int(sys.argv[1]), int(sys.argv[2])
store_path, out_path = sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                        rank=rank, world_size=world)
BATCH, STEPS = 8, 3


def images(dtype):
    def build():
        img = fluid.layers.data(name="img", shape=[3, 8, 8], dtype=dtype)
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        return img, label

    def feed(r):
        x = torch.from_numpy(r.rand(BATCH, 3, 8, 8).astype(np.float32))
        return {"img": x.to(getattr(torch, dtype)),
                "label": r.randint(0, 4, (BATCH, 1)).astype(np.int64)}
    return build, feed


def resnet(dtype):
    build, feed = images(dtype)

    def net():
        img, label = build()
        pred = models.resnet_cifar10(img, class_dim=4, depth=8)
        loss = fluid.layers.mean(fluid.layers.cross_entropy(pred, label))
        fluid.Momentum(learning_rate=0.1, momentum=0.9).minimize(loss)
        return loss, ["img", "label"]
    return net, feed


def vgg_bn_drop():
    build, feed = images("float32")

    def net():
        img, label = build()
        conv = fluid.nets.img_conv_group(
            input=img, pool_size=2, pool_stride=2, conv_num_filter=[8, 8],
            conv_filter_size=3, conv_act="relu", conv_with_batchnorm=True,
            conv_batchnorm_drop_rate=[0.3, 0.0], pool_type="max")
        drop = fluid.layers.dropout(x=conv, dropout_prob=0.5)
        fc1 = fluid.layers.fc(input=drop, size=16)
        bn = fluid.layers.batch_norm(input=fc1, act="relu")
        drop2 = fluid.layers.dropout(x=bn, dropout_prob=0.5)
        pred = fluid.layers.fc(input=drop2, size=4, act="softmax")
        loss = fluid.layers.mean(fluid.layers.cross_entropy(pred, label))
        fluid.Momentum(learning_rate=0.1, momentum=0.9).minimize(loss)
        return loss, ["img", "label"]
    return net, feed


def bn_layer():
    # one BN layer between two fcs: the first fc's update reads dX, the
    # BN's scale and bias their own gradients
    def net():
        x = fluid.layers.data(name="x", shape=[5], dtype="float32")
        h = fluid.layers.fc(input=x, size=6)
        y = fluid.layers.fc(input=fluid.layers.batch_norm(input=h), size=1)
        loss = fluid.layers.mean(fluid.layers.square(y))
        fluid.SGD(learning_rate=0.1).minimize(loss)
        return loss, ["x"]
    return net, lambda r: {"x": r.standard_normal((BATCH, 5))
                           .astype(np.float32) * 3 + 1}


def sum_loss():
    def net():
        x = fluid.layers.data(name="x", shape=[6], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="int64")
        h = fluid.layers.fc(input=x, size=8, act="relu")
        cost = fluid.layers.softmax_with_cross_entropy(
            fluid.layers.fc(input=h, size=3), y)
        loss = fluid.layers.reduce_sum(cost)
        fluid.SGD(learning_rate=0.05).minimize(loss)
        return loss, ["x", "y"]
    return net, lambda r: {"x": r.rand(BATCH, 6).astype(np.float32),
                           "y": r.randint(0, 3, (BATCH, 1)).astype(np.int64)}


def crf():
    # book/07's tagger at test width (tests/book/test_label_semantic_roles)
    def net():
        word = fluid.layers.data(name="word", shape=[1], dtype="int64",
                                 lod_level=1)
        target = fluid.layers.data(name="target", shape=[1], dtype="int64",
                                   lod_level=1)
        emb = fluid.layers.embedding(input=word, size=[30, 8])
        hidden = fluid.layers.fc(input=emb, size=8, act="tanh")
        lstm, _ = fluid.layers.dynamic_lstm(
            input=fluid.layers.fc(input=hidden, size=32), size=32)
        feature = fluid.layers.fc(input=[hidden, lstm], size=5)
        cost = fluid.layers.linear_chain_crf(input=feature, label=target,
                                             param_attr={"name": "crfw"})
        loss = fluid.layers.mean(cost)
        fluid.SGD(learning_rate=0.05).minimize(loss)
        return loss, ["word", "target"]

    def feed(r):
        lens = r.randint(1, 7, BATCH)
        n = int(lens.sum())
        return {k: fluid.create_lod_tensor(
            r.randint(0, hi, (n, 1)).astype(np.int64), [list(lens)])
            for k, hi in (("word", 30), ("target", 5))}
    return net, feed


def parallel_do():
    # tests/test_parallel_do.py:14-37's network, trained
    def net():
        x = fluid.layers.data(name="x", shape=[8], dtype="float32")
        pd = fluid.layers.ParallelDo(fluid.layers.get_places()[:1] * 2)
        with pd.do():
            h = fluid.layers.fc(input=pd.read_input(x), size=16, act="tanh")
            pd.write_output(fluid.layers.fc(input=h, size=4))
        loss = fluid.layers.mean(pd())
        fluid.SGD(learning_rate=0.1).minimize(loss)
        return loss, ["x"]
    return net, lambda r: {"x": r.rand(BATCH, 8).astype(np.float32)}


PROGRAMS = {"resnet_f32": resnet("float32"), "resnet_bf16": resnet("bfloat16"),
            "vgg_bn_drop": vgg_bn_drop(), "bn_layer": bn_layer(),
            "sum_loss": sum_loss(), "crf": crf(),
            "parallel_do": parallel_do()}


def host(v):
    v = v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
    return v.float().numpy() if v.dtype == torch.bfloat16 else v.numpy()


out, meta = {}, {}
try:
    for name, (net, make_feed) in PROGRAMS.items():
        for arm in ("pe", "transpiler") if name == "resnet_f32" else ("pe",):
            fw.reset_unique_names()
            main, startup = fluid.Program(), fluid.Program()
            with fluid.program_guard(main, startup):
                loss, feed_names = net()
            r = np.random.RandomState(11)
            feeds = [make_feed(r) for _ in range(STEPS)]
            persist = sorted(v.name for v in main.list_vars()
                             if v.persistable)
            if arm == "pe":
                pe = fluid.ParallelExecutor(
                    main, feed_names, [loss], mesh={"dp": world},
                    startup_program=startup, place=fluid.CPUPlace())
            else:
                t = fluid.ShardingTranspiler()
                t.transpile(program=main, startup_program=startup,
                            mesh={"dp": world}, overlap="auto",
                            shard_optimizer_states=False)
                pe = t.build_executor(feed_names, [loss],
                                      place=fluid.CPUPlace())
            key = f"{name}.{arm}"

            def record(tag, value_of):
                for n in persist:
                    if n in pe._states:
                        out[f"{key}.{tag}.{n}"] = host(value_of(n))

            losses = []
            for step, f in enumerate(feeds):
                losses.append(host(pe.run(f)[0]).reshape(-1)[0])
                if step == 0:
                    record("state0", lambda n: pe.state(
                        n, return_numpy=False))
            out[f"{key}.loss"] = np.array(losses)
            record("state", lambda n: pe.state(n, return_numpy=False))
            meta[key] = {"form": pe.gspmd_form,
                         "overlap_info": pe.overlap_info,
                         "gspmd_info": pe.gspmd_info,
                         "calls": pe.collective_calls,
                         "bn": sum(op.type == "batch_norm"
                                   for op in main.global_block().ops)}
            if rank or arm != "pe":
                continue
            scope = Scope()
            fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope)
            exe = fluid.Executor(fluid.CPUPlace())
            losses = []
            for step, f in enumerate(feeds):
                losses.append(host(exe.run(main, feed=f, fetch_list=[loss],
                                           scope=scope)[0]).reshape(-1)[0])
                for n in persist:
                    if step == 0 and f"{key}.state0.{n}" in out:
                        out[f"{name}.serial.state0.{n}"] = host(
                            scope.find_var(n))
            out[f"{name}.serial.loss"] = np.array(losses)
            for n in persist:
                if f"{key}.state.{n}" in out:
                    out[f"{name}.serial.state.{n}"] = host(scope.find_var(n))
finally:
    dist.destroy_process_group()
np.savez(out_path, **out)
with open(out_path + ".json", "w") as f:
    json.dump(meta, f)
"""

_FORMS = {"resnet_f32": "sync_bn", "resnet_bf16": "sync_bn",
          "vgg_bn_drop": "sync_bn", "bn_layer": "sync_bn",
          "sum_loss": "replicated", "crf": "replicated",
          "parallel_do": "replicated"}
# float32: losses within 1e-6 relative, every state (parameters,
# velocities, running statistics) within 1e-5 after the 3 steps (a mean
# of per-rank gradients and statistics summed in another order than
# serial's).  bf16: a rank rounds its own partial gradient sums to bf16
# before the bucket all-reduce sums them, where serial rounds the global
# sum once; so the first step's states are held within GSPMD_BF16_ULPS
# bf16 ulps of each tensor's largest magnitude and its loss within one
# ulp.  The later steps start from parameters that differ in their last
# bits, and a bf16 ReLU or max-pool flip then moves a gradient by far
# more than a rounding (after 3 steps the velocities differ by up to 119
# ulps of their largest magnitude at dp 2, where reversing the serial
# batch's rows moves none by more than 0.0012 relative): they are held
# only to be bit-equal across ranks and finite
GSPMD_LOSS_RTOL, GSPMD_STATE_ATOL, GSPMD_BF16_ULPS = 1e-6, 1e-5, 2


@pytest.fixture(scope="module", params=[2, 4], ids=["dp2", "dp4"])
def gspmd_runs(request, tmp_path_factory):
    """One spawn of `world` gloo ranks running every program -> (world,
    [each rank's arrays], [each rank's forms and collective counts])."""
    world = request.param
    tmp = tmp_path_factory.mktemp(f"gspmd{world}")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _GSPMD_WORKER, str(r), str(world),
         str(tmp / "store"), str(tmp / f"rank{r}.npz")], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    for p in procs:
        out, _ = p.communicate(timeout=240)
        assert p.returncode == 0, out[-3000:]
    arrays = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(world)]
    metas = []
    for r in range(world):
        with open(tmp / f"rank{r}.npz.json") as f:
            metas.append(json.load(f))
    return world, arrays, metas


def _bf16_ulps(got, want):
    """max |got - want| in bf16 ulps of max |want|."""
    top = max(float(np.abs(want).max(initial=0.0)), 1e-30)
    return float(np.abs(got - want).max(initial=0.0)
                 / np.exp2(np.floor(np.log2(top)) - 7))


_GSPMD_CASES = sorted(_FORMS) + ["resnet_f32.transpiler"]


@pytest.mark.parametrize("case", _GSPMD_CASES)
def test_gspmd_step_is_the_serial_step(gspmd_runs, case):
    """Every rank's losses, parameters, optimizer states and batch-norm
    running statistics bit-equal across ranks and, after 3 steps, equal
    to the serial Executor's over the global batch within the limits."""
    world, arrays, _ = gspmd_runs
    name = case.split(".")[0]
    key = case if "." in case else f"{case}.pe"
    ref = arrays[0]
    names = sorted(k[len(key) + 1:] for k in ref if k.startswith(key + "."))
    assert "loss" in names and len(names) > 2, names
    for n in names:
        for r in range(1, world):
            np.testing.assert_array_equal(arrays[r][f"{key}.{n}"],
                                          ref[f"{key}.{n}"],
                                          err_msg=f"rank {r} {n}")
        got, want = ref[f"{key}.{n}"], ref[f"{name}.serial.{n}"]
        if name == "resnet_bf16" and n.startswith("state0."):
            assert _bf16_ulps(got, want) <= GSPMD_BF16_ULPS, n
        elif name == "resnet_bf16":
            assert np.all(np.isfinite(got)), n
            if n == "loss":
                assert _bf16_ulps(got[:1], want[:1]) <= 1, (got, want)
        elif n == "loss":
            np.testing.assert_allclose(got, want, rtol=GSPMD_LOSS_RTOL)
        else:
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=GSPMD_STATE_ATOL, err_msg=n)
    assert ref[f"{key}.loss"][-1] != ref[f"{key}.loss"][0]


@pytest.mark.parametrize("case", _GSPMD_CASES)
def test_gspmd_form_and_its_collectives(gspmd_runs, case):
    """The form each program takes, the JAX package's overlap report,
    and the all-reduces a step: in the sync-BN form one a bucket, one a
    fetched mean, and per training-mode batch_norm two (float32: sum,
    then the centred sum) or one (bf16: both sums) in the forward and
    one in the backward; none in the replicated form."""
    world, _, metas = gspmd_runs
    name = case.split(".")[0]
    key = case if "." in case else f"{case}.pe"
    for meta in metas:
        m = meta[key]
        assert m["form"] == _FORMS[name]
        assert m["overlap_info"]["mode"] == "off"
        calls, steps = m["calls"], 3
        if m["form"] == "replicated":
            assert set(calls.values()) == {0}, calls
            assert m["gspmd_info"]["reason"]
            continue
        assert m["overlap_info"]["reason"] == (
            "training-mode batch_norm couples rows across the dp shards"
            if key.endswith("transpiler") else "overlap='off' requested")
        fwd = 1 if name == "resnet_bf16" else 2
        assert calls == {
            "grad_all_reduce": steps * m["gspmd_info"]["buckets"],
            "fetch_all_reduce": steps, "fetch_all_gather": 0,
            "stat_all_reduce": steps * m["bn"] * (fwd + 1)}, calls
    assert len(metas) == world

def _form_program(bn, sparse):
    """An embedding (is_sparse or not) and an fc, with a training-mode
    batch_norm between them or not, under a mean loss and SGD."""
    tfw.reset_unique_names()
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        ids = tfluid.layers.data(name="ids", shape=[1], dtype="int64")
        h = tfluid.layers.embedding(input=ids, size=[16, 4],
                                    is_sparse=sparse)
        if bn:
            h = tfluid.layers.batch_norm(input=h)
        loss = tfluid.layers.mean(tfluid.layers.fc(input=h, size=1))
        tfluid.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, loss


_BN = "training-mode batch_norm couples rows across the dp shards"
_SPARSE = "sparse embedding gradient: a SelectedRows is not bucketed"


@pytest.mark.parametrize("bn,sparse,overlap,form,reason,blocker", [
    (False, True, "auto", None, None, None),
    (False, True, "off", "replicated", "overlap='off' requested",
     _SPARSE),
    (True, False, "auto", "sync_bn", _BN, None),
    (True, True, "auto", "replicated", _BN, _SPARSE),
])
def test_gspmd_form_choice(bn, sparse, overlap, form, reason, blocker):
    """One analysis decides both steps: the overlap step refuses with the
    JAX package's first reason (batch_norm's, where it comes before any
    other blocker), and the GSPMD step's sync-BN form refuses only what
    it cannot carry, a sparse embedding gradient.  The form is chosen
    when the executor is made, so an unused group object serves."""
    main, startup, loss = _form_program(bn, sparse)
    pe = tfluid.ParallelExecutor(main, ["ids"], [loss],
                                 mesh=Mesh({"dp": 2}, group=object()),
                                 overlap=overlap, startup_program=startup,
                                 place=CPUPlace())
    assert pe.gspmd_form == form
    if reason is None:
        assert pe.overlap_info["mode"] == "bucketed"
    else:
        assert pe.overlap_info == {"mode": "off", "reason": reason}
    assert pe.gspmd_info.get("reason") == blocker


# -- what is not ported raises ---------------------------------------------

def test_not_ported_strategies_raise():
    main, startup, loss, params, feeds = _mlp(tfluid, tfw, "sgd")
    # A11's pserver mode is ported: as in the JAX package, a pserver
    # list with no params_grads transpiles and leaves the program as
    # it was, and each endpoint's pserver program is one
    # listen_and_serv op (tests/test_torch_pserver.py runs the mode)
    jmain, jstartup, _, _, _ = _mlp(jfluid, jfw, "sgd")
    for fluid, prog, start in ((jfluid, jmain, jstartup),
                               (tfluid, main, startup)):
        before = [op.type for op in prog.global_block().ops]
        t = fluid.DistributeTranspiler()
        t.transpile(program=prog, startup_program=start,
                    pservers="127.0.0.1:6174", params_grads=[])
        assert t._mode == "pserver"
        assert [op.type for op in t.get_trainer_program()
                .global_block().ops] == before
        assert [op.type for op in t.get_pserver_program("127.0.0.1:6174")
                .global_block().ops] == ["listen_and_serv"]
    # A9 is ported: as in the JAX package, ParallelExecutor runs an
    # unannotated program replicated over an axis no placement names
    # (no model axis, no sharded form) ...
    for axis in ("pp", "sp", "ep"):
        pe = tfluid.ParallelExecutor(
            main, feeds, [loss], mesh=Mesh({"dp": 1, axis: 2},
                                           group=object()),
            startup_program=startup, place=CPUPlace())
        assert pe._model_axes == [] and pe.gspmd_form != "sharded"
    # ... and build_executor gives a staged program over 'pp' to
    # PipelineExecutor (the unannotated one stays with ParallelExecutor)
    t = tfluid.ShardingTranspiler()
    t.transpile(program=main, startup_program=startup,
                mesh={"dp": 1, "pp": 2})
    assert not t._uses_pipeline()
    import paddle_tpu_torch.parallel.pipeline_program as pipeline_program
    from paddle_tpu_torch.models.transformer import transformer_lm

    tfw.reset_unique_names()
    staged, staged_startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(staged, staged_startup):
        ids = tfluid.layers.data(name="ids", shape=[8], dtype="int64")
        lab = tfluid.layers.data(name="lab", shape=[8, 1], dtype="int64")
        lg = transformer_lm(ids, 8, d_model=8, n_heads=2, n_layers=2,
                            max_len=8, return_logits=True,
                            pipeline_stages=2)
        staged_loss = tfluid.layers.mean(
            tfluid.layers.softmax_with_cross_entropy(
                tfluid.layers.reshape(lg, shape=[-1, 8]),
                tfluid.layers.reshape(lab, shape=[-1, 1])))
        tfluid.SGD(learning_rate=0.1).minimize(staged_loss)
    made = []

    class Recorded:
        def __init__(self, *args, **kw):
            made.append(kw)

    t = tfluid.ShardingTranspiler()
    t.transpile(program=staged, startup_program=staged_startup,
                mesh={"dp": 1, "pp": 2})
    real = pipeline_program.PipelineExecutor
    pipeline_program.PipelineExecutor = Recorded
    try:
        pe = t.build_executor(["ids", "lab"], [staged_loss],
                              place=CPUPlace())
    finally:
        pipeline_program.PipelineExecutor = real
    assert isinstance(pe, Recorded) and made[0]["mesh"] == {"dp": 1, "pp": 2}


@pytest.mark.parametrize("case", ["tp_axis_missing", "tp_axis_of_one",
                                  "zero_bucketed", "compiled_collectives",
                                  "bucketed_with_placements",
                                  "sub_block_refused"])
def test_the_a8b_strategies_build_and_run(case):
    """What raised before tensor parallelism and ZeRO-1 were ported: a
    placement over an axis the mesh lacks raises as the JAX package
    does; a mesh with a 'tp' axis of one, a placement over it and ZeRO-1
    run as the serial Executor; the bucketed overlap step takes ZeRO-1
    (the JAX package's placements); a mesh of one issues no collective;
    overlap='bucketed' refuses explicit placements with the JAX
    package's reason; a tensor-parallel program with a sub-block op is
    refused (its inner ops would read local blocks whole)."""
    main, startup, loss, params, feeds = _mlp(tfluid, tfw, "momentum")
    kw = dict(startup_program=startup, place=CPUPlace())
    if case == "sub_block_refused":
        # a recompute segment's ops would read the local blocks whole
        tfw.reset_unique_names()
        main, startup = tfluid.Program(), tfluid.Program()
        with tfluid.program_guard(main, startup):
            x = tfluid.layers.data(name="x", shape=[FEATS], dtype="float32")
            h = tfluid.layers.recompute(
                lambda: tfluid.layers.fc(input=x, size=HIDDEN, act="relu"))
            loss = tfluid.layers.mean(tfluid.layers.fc(input=h, size=1))
            tfluid.SGD(learning_rate=0.1).minimize(loss)
        with pytest.raises(NotImplementedError, match="sub-block ops"):
            tfluid.ParallelExecutor(
                main, ["x"], [loss], mesh=Mesh({"dp": 1, "tp": 2},
                                               group=object()),
                param_shardings={"fc_0.w_0": PartitionSpec(None, "tp")},
                startup_program=startup, place=CPUPlace())
        return
    if case == "bucketed_with_placements":
        # the JAX package's refusal: its overlap step would gather them
        jmain, jstartup, jloss, _, _ = _mlp(jfluid, jfw, "momentum")
        msgs = []
        for fluid, m, st, ls, P, extra in (
                (jfluid, jmain, jstartup, jloss,
                 jfluid.parallel.PartitionSpec, {}),
                (tfluid, main, startup, loss, PartitionSpec,
                 {"place": CPUPlace()})):
            with pytest.raises(ValueError, match="param_shardings") as e:
                fluid.ParallelExecutor(
                    m, feeds, [ls], mesh={"dp": 1, "tp": 1},
                    startup_program=st, overlap="bucketed",
                    param_shardings={params[0]: P(None, "tp")}, **extra)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
        return
    if case == "tp_axis_missing":
        with pytest.raises(ValueError, match="not found in mesh"):
            tfluid.ParallelExecutor(main, feeds, [loss], mesh={"dp": 1},
                                    param_shardings={params[0]: PartitionSpec(
                                        None, "tp")}, **kw)
        return
    if case == "zero_bucketed":
        pe = tfluid.ParallelExecutor(
            main, feeds, [loss], mesh={"dp": 1}, overlap="bucketed",
            shard_optimizer_states=True, **kw)
        assert pe.overlap_info["mode"] == "bucketed"
        accs = sorted(n for n in pe.state_specs if n.endswith("_acc"))
        # the JAX package's placements; one rank keeps every row
        assert accs and all(pe.state_specs[n] == PartitionSpec("dp")
                            for n in accs), pe.state_specs
        assert not pe._zero_states
    else:
        pe = tfluid.ParallelExecutor(
            main, feeds, [loss], mesh={"dp": 1, "tp": 1},
            param_shardings={params[0]: PartitionSpec(None, "tp")},
            shard_optimizer_states=True, **kw)
        assert pe.state_specs[params[0]] == PartitionSpec(None, "tp")
    batches = _batches(3)
    if case == "compiled_collectives":
        assert pe.compiled_collectives(batches[0]) == {}
    exe = tfluid.Executor(CPUPlace())
    scope = Scope()
    exe.run(startup, scope=scope)
    for n in pe._states:
        scope.set_var(n, torch.from_numpy(pe.state(n)))
    for b in batches:
        got = pe.run(b)[0]
        want = exe.run(main, feed=b, fetch_list=[loss], scope=scope)[0]
        np.testing.assert_array_equal(got, want)
    for n in params:
        np.testing.assert_array_equal(pe.state(n), scope.find_var(n).numpy())


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
