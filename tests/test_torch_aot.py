"""The port's AOT artifact (io.export_aot_model / load_aot_model) held to
the JAX package's, on the CPU.

The JAX package exports a StableHLO module with jax.export; the port
exports a torch.export program of the same pruned inference block, its
parameters passed in as arguments from a side-car snapshot, its
hand-written kernels recorded as the ops `paddle_tpu_torch::
flash_attention_fwd` and `paddle_tpu_torch::moe_gate_route` (on the CPU
the ops run their plain versions).  The same parameters go into both
packages; the reloaded artifacts' outputs agree within 1e-5 (float32
sums in another order).  A bf16 ResNet's weights round-trip bit for bit,
and a program the artifact cannot carry (a host op, a LoD feed) raises
at export, naming what it cannot carry.
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu.core.framework as jfw
from paddle_tpu import io as jio

import paddle_tpu_torch as tfluid
import paddle_tpu_torch.core.framework as tfw
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.core import executor as texecutor
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.core.scope import Scope, scope_from_numpy
from paddle_tpu_torch.kernels.flash_attention import (
    flash_attention, flash_attention_fwd_op, flash_attention_fwd_reference)
from paddle_tpu_torch.kernels.moe_dispatch import (moe_gate_route_op,
                                                   moe_gate_route_reference)
from paddle_tpu_torch.models.moe import build_moe_lm
from paddle_tpu_torch.models.transformer import transformer_lm

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmark"))
import run_moe  # noqa: E402  (the JAX package's MoE LM builder)

CPU = tfluid.CPUPlace()
FLASH_OP = "paddle_tpu_torch.flash_attention_fwd.default"
ROUTE_OP = "paddle_tpu_torch.moe_gate_route.default"


@pytest.fixture(autouse=True)
def _fresh_port_state():
    old_scope = texecutor.switch_scope(Scope())
    tfw.reset_unique_names()
    jfw.reset_unique_names()
    tflags.reset_flags()
    yield
    texecutor.switch_scope(old_scope)
    tflags.reset_flags()


def _targets(call):
    return [str(n.target) for n in call.exported_program.graph.nodes
            if n.op == "call_function"]


def _jax_params(jm, js):
    """Run the JAX startup -> (its executor, scope, {persistable: array})."""
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    jexe.run(js, scope=jscope)
    vals = {}
    for v in jm.list_vars():
        if v.persistable and jscope.find_var(v.name) is not None:
            vals[v.name] = np.asarray(jscope.find_var(v.name))
    return jexe, jscope, vals


def _both(jm, js, tm, ts):
    """The JAX startup's parameters in both packages -> (jexe, jscope,
    texe, tscope)."""
    jexe, jscope, vals = _jax_params(jm, js)
    texe, tscope = tfluid.Executor(CPU), Scope()
    texe.run(ts, scope=tscope)
    scope_from_numpy(vals, CPU, tscope)
    return jexe, jscope, texe, tscope


def _fc_net(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        h = fluid.layers.fc(input=x, size=8, act="relu")
        pred = fluid.layers.fc(input=h, size=3, act="softmax")
    return main, startup, pred


def test_aot_export_round_trip(tmp_path):
    """tests/test_aot_export.py's round trip in both packages, the same
    parameters: the reloaded artifacts agree with each other and with the
    live program, and the scope's later changes do not reach them."""
    jm, js, jpred = _fc_net(jfluid)
    tm, ts, tpred = _fc_net(tfluid)
    jexe, jscope, texe, tscope = _both(jm, js, tm, ts)
    xv = np.random.RandomState(0).rand(5, 4).astype(np.float32)
    live, = texe.run(tm, feed={"x": xv}, fetch_list=[tpred], scope=tscope)
    spec = {"x": ([5, 4], "float32")}
    jio.export_aot_model(str(tmp_path / "jax"), spec, [jpred], jexe,
                         main_program=jm, scope=jscope)
    path = tio.export_aot_model(str(tmp_path / "port"), spec, [tpred], texe,
                                main_program=tm, scope=tscope)
    assert path.endswith("__aot_torch_export__")
    jcall, _, _ = jio.load_aot_model(str(tmp_path / "jax"))
    call, feed_specs, fetch_names = tio.load_aot_model(str(tmp_path /
                                                           "port"), CPU)
    assert fetch_names == [tpred.name]
    assert feed_specs == {"x": [[5, 4], "float32"]}
    out, = call({"x": xv})
    assert out.device.type == "cpu" and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(jcall({"x": xv})[0]),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(out.numpy(), live, rtol=0, atol=1e-6)
    # params are arguments snapshotted at export: zeroing the scope does
    # NOT change the artifact
    for n in tscope.local_names():
        v = tscope.find_var(n)
        if isinstance(v, torch.Tensor) and v.is_floating_point():
            tscope.set_var(n, torch.zeros_like(v))
    out2, = call({"x": torch.from_numpy(xv)})
    assert torch.equal(out2, out)
    with open(path + ".json") as f:
        meta = json.load(f)
    assert meta["param_names"] == sorted(
        p.name for p in tm.global_block().all_parameters())
    assert meta["device"] == "cpu"


def _logits_of(main):
    """The LM head's logits: the input of the reshape feeding the cross
    entropy."""
    blk = main.global_block()
    sce, = [op for op in blk.ops if op.type == "softmax_with_cross_entropy"]
    reshape, = [op for op in blk.ops
                if sce.input("Logits")[0] in op.output_names()]
    return reshape.input("X")[0]


LM = dict(vocab=50, d_model=32, n_heads=2, n_layers=2, seq=16, batch=2)
MOE = dict(batch=2, seq=8, vocab=31, d_model=32, n_heads=2, n_layers=2,
           experts=4, top_k=2, capacity_factor=1.25)


def _lm(fluid, fw, lm_builder):
    fw.reset_unique_names()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        ids = fluid.layers.data(name="ids", shape=[LM["seq"]],
                                dtype="int64")
        logits = lm_builder(ids, LM["vocab"], d_model=LM["d_model"],
                            n_heads=LM["n_heads"], n_layers=LM["n_layers"],
                            max_len=64, return_logits=True)
    return main, startup, logits.name


def _models(kind):
    """-> (jax main, startup, logits name, port ..., feed, feed spec,
    the op's name, the op's nodes)."""
    if kind == "lm":
        from paddle_tpu.models.transformer import transformer_lm as j_lm

        jm, js, jn = _lm(jfluid, jfw, j_lm)
        tm, ts, tn = _lm(tfluid, tfw, transformer_lm)
        shape, vocab, op, nodes = ([LM["batch"], LM["seq"]], LM["vocab"],
                                   FLASH_OP, LM["n_layers"])
    else:
        jfw.reset_unique_names()
        jm, js, _ = run_moe.build_moe_lm(**MOE)
        tfw.reset_unique_names()
        tm, ts, _ = build_moe_lm(**MOE)
        jn, tn = _logits_of(jm), _logits_of(tm)
        shape, vocab, op, nodes = ([MOE["batch"], MOE["seq"]],
                                   MOE["vocab"], ROUTE_OP, MOE["n_layers"])
    ids = np.random.RandomState(4).randint(0, vocab, shape).astype(np.int64)
    return jm, js, jn, tm, ts, tn, {"ids": ids}, \
        {"ids": (shape, "int64")}, op, nodes


@pytest.mark.parametrize("kind", ["lm", "moe"])
def test_lm_artifact_holds_the_kernel_ops_and_matches_jax(kind, tmp_path):
    """A small LM (its attention the flash op) and a small MoE LM (its
    routing the route op, its attention the flash op): the exported
    graph holds one op node a layer, and the reloaded artifact's logits
    agree with the JAX package's within 1e-5."""
    jm, js, jn, tm, ts, tn, feed, spec, op, nodes = _models(kind)
    jexe, jscope, texe, tscope = _both(jm, js, tm, ts)
    jio.export_aot_model(str(tmp_path / "jax"), spec,
                         [jm.global_block().var(jn)], jexe, main_program=jm,
                         scope=jscope)
    tio.export_aot_model(str(tmp_path / "port"), spec,
                         [tm.global_block().var(tn)], texe, main_program=tm,
                         scope=tscope)
    jcall, _, _ = jio.load_aot_model(str(tmp_path / "jax"))
    call, _, _ = tio.load_aot_model(str(tmp_path / "port"), CPU)
    targets = _targets(call)
    assert targets.count(op) == nodes
    if kind == "moe":
        assert targets.count(FLASH_OP) == nodes
    assert not [t for t in targets if "scaled_dot_product" in t
                or "logsumexp" in t]
    got = call(feed)[0].numpy()
    want = np.asarray(jcall(feed)[0])
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # and the port's own Executor on the pruned program
    live = texe.run(tio.get_inference_program([tn], tm), feed=feed,
                    fetch_list=[tn], scope=tscope)[0]
    np.testing.assert_allclose(got, live, rtol=0, atol=1e-6)


def test_bf16_resnet_weights_round_trip_bit_for_bit(tmp_path):
    """numpy has no bf16: the side-car keeps each bf16 parameter's bits
    (as int16) and its dtype in the meta; the reloaded artifact's logits
    equal the Executor's bit for bit (the same CPU ops)."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        img = tfluid.layers.data(name="img", shape=[3, 16, 16],
                                 dtype="bfloat16")
        probs = tfluid.models.resnet_imagenet(img, class_dim=10, depth=18)
    soft, = [op for op in main.global_block().ops if op.type == "softmax"
             and op.output("Out") == [probs.name]]
    logits = main.global_block().var(soft.input("X")[0])
    exe, scope = tfluid.Executor(CPU), Scope()
    exe.run(startup, scope=scope)
    x = torch.from_numpy(np.random.RandomState(2).rand(2, 3, 16, 16).astype(
        np.float32)).bfloat16()
    want, = exe.run(tio.get_inference_program([logits], main),
                    feed={"img": x}, fetch_list=[logits], scope=scope,
                    return_numpy=False)
    d = str(tmp_path / "r")
    path = tio.export_aot_model(d, {"img": ([2, 3, 16, 16], "bfloat16")},
                                [logits], exe, main_program=main,
                                scope=scope)
    with open(path + ".json") as f:
        meta = json.load(f)
    assert set(meta["param_dtypes"].values()) == {"bfloat16"}
    with np.load(path + ".params.npz") as z:
        for n in meta["param_names"]:
            back = tio._param_from_bits(z[n], meta["param_dtypes"][n])
            v = scope.find_var(n)
            assert back.dtype == v.dtype == torch.bfloat16, n
            assert torch.equal(back.view(torch.int16), v.view(torch.int16))
    call, _, _ = tio.load_aot_model(d, CPU)
    got = call({"img": x})[0]
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


def test_a_host_op_raises_at_export_naming_it(tmp_path):
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="x", shape=[4], dtype="float32")
        h = tfluid.layers.fc(input=x, size=3)
        out = tfluid.layers.Print(h)
    exe = tfluid.Executor(CPU)
    exe.run(startup)
    with pytest.raises(ValueError, match="'print'.*host"):
        tio.export_aot_model(str(tmp_path), {"x": ([2, 4], "float32")},
                             [out], exe, main_program=main)
    assert not os.path.exists(os.path.join(str(tmp_path),
                                           tio.AOT_FILENAME))


def test_a_lod_feed_raises_at_export(tmp_path):
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="x", shape=[4], dtype="float32",
                               lod_level=1)
        out = tfluid.layers.fc(input=x, size=3)
    exe = tfluid.Executor(CPU)
    exe.run(startup)
    with pytest.raises(ValueError, match="'x' has lod_level 1"):
        tio.export_aot_model(str(tmp_path), {"x": ([6, 4], "float32")},
                             [out], exe, main_program=main)


def test_export_needs_the_parameters_and_load_checks_feeds(tmp_path):
    main, startup, pred = _fc_net(tfluid)
    exe = tfluid.Executor(CPU)
    with pytest.raises(RuntimeError, match="startup"):
        tio.export_aot_model(str(tmp_path), {"x": ([2, 4], "float32")},
                             [pred], exe, main_program=main, scope=Scope())
    scope = Scope()
    exe.run(startup, scope=scope)
    tio.export_aot_model(str(tmp_path), {"x": ([2, 4], "float32")}, [pred],
                         exe, main_program=main, scope=scope)
    call, _, _ = tio.load_aot_model(str(tmp_path), CPU)
    with pytest.raises(KeyError, match="missing feeds"):
        call({})
    with pytest.raises(ValueError, match=r"exported at \(2, 4\)"):
        call({"x": np.zeros((3, 4), np.float32)})


def test_load_defaults_to_the_card(tmp_path):
    main, startup, pred = _fc_net(tfluid)
    exe, scope = tfluid.Executor(CPU), Scope()
    exe.run(startup, scope=scope)
    tio.export_aot_model(str(tmp_path), {"x": ([2, 4], "float32")}, [pred],
                         exe, main_program=main, scope=scope)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tio.load_aot_model(str(tmp_path))


# -- the kernels as ops -------------------------------------------------------

def _qkv(seed=0, shape=(2, 8, 2, 16), dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g).to(dtype) for _ in range(3)]


@pytest.mark.parametrize("causal", [False, True])
def test_flash_op_is_the_plain_version_on_the_cpu(causal):
    q, k, v = _qkv()
    o, lse = flash_attention_fwd_op(q, k, v, causal, 0.25)
    want_o, want_lse = flash_attention_fwd_reference(q, k, v, causal, 0.25)
    assert torch.equal(o, want_o) and torch.equal(lse, want_lse)
    assert o.is_contiguous()
    torch.library.opcheck(flash_attention_fwd_op, (q, k, v, causal, 0.25),
                          test_utils=("test_schema", "test_faketensor"))


def test_flash_op_fake_gives_shapes_only():
    q, k, v = (t.to("meta") for t in _qkv(dtype=torch.bfloat16))
    o, lse = flash_attention_fwd_op(q, k, v, True, 0.25)
    assert o.shape == q.shape and o.dtype == torch.bfloat16
    assert lse.shape == (2, 2, 8) and lse.dtype == torch.float32


def test_route_op_is_the_plain_version_on_the_cpu():
    r = np.random.RandomState(0)
    x = torch.from_numpy(r.standard_normal((24, 16)).astype(np.float32))
    gw = torch.from_numpy((r.standard_normal((16, 4)) * 0.5).astype(
        np.float32))
    got = moe_gate_route_op(x, gw, 4, 8, 2)
    want = moe_gate_route_reference(x, gw, 4, 8, 2)
    assert len(got) == 5
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    torch.library.opcheck(moe_gate_route_op, (x, gw, 4, 8, 2),
                          test_utils=("test_schema", "test_faketensor"))
    meta = moe_gate_route_op(x.to("meta"), gw.to("meta"), 4, 8, 2)
    assert [tuple(t.shape) for t in meta] == [(4, 8, 16), (4, 8), (1, 1),
                                              (2, 24), (4, 8)]


def test_eager_calls_keep_the_direct_route():
    """Outside an export the attention runs its plain version directly
    on the CPU (autograd intact); while exporting it is the op."""
    q, k, v = (t.requires_grad_() for t in _qkv())
    out = flash_attention(q, k, v, causal=True)
    out.sum().backward()
    assert q.grad is not None

    class M(torch.nn.Module):
        def forward(self, q, k, v):
            return flash_attention(q, k, v, causal=True)

    q, k, v = _qkv(1)
    ep = torch.export.export(M(), (q, k, v), strict=False)
    targets = [str(n.target) for n in ep.graph.nodes
               if n.op == "call_function"]
    assert targets.count(FLASH_OP) == 1
    assert torch.equal(ep.module()(q, k, v),
                       flash_attention_fwd_reference(q, k, v, True)[0])
