"""The port's static cost model (paddle_tpu_torch.analysis.cost_model)
against the JAX package's, on the CPU.

Parity, on Programs built by both packages under reset unique names:

  * `estimate_op` / `estimate_program` at batch 4 over a 2-layer LM, a
    small ResNet, the seq2seq translator, book 08's DynamicRNN translator
    and DeepFM with `is_sparse=True`: every op's FLOPs and estimator
    class equal; its bytes equal except 4 bytes an element on each
    int64 id/label var the JAX package's shape inference types int32
    (x64 off there, Paddle's int64 kept here) — that difference is
    computed per op and asserted exactly, not absorbed by a tolerance;
  * `estimate_peak_hbm` and `estimate_comm` on the JAX package's sharded
    and data-parallel fixtures (tests/test_cost_model.py): equal;
  * the serving-kernel rows and `analyze_generation_spec`: equal FLOPs
    and bytes, the backend labelled "cuda" (the hand-written kernel) or
    "plain" (the gather composition) where the JAX package says
    "pallas" or "xla".

Then the chip table (`DEVICE_SPECS`: the NVIDIA rows chip_smoke.py
reads), the batch-folding resolver, the golden per-op costs, the static
floors the Trainer and `server_from_model_dir` publish, and `cli
analyze`.
"""
import importlib.util
import json
import os
import types

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu.core.framework as jfw
from paddle_tpu.analysis import cost_model as jcm

import paddle_tpu_torch as tfluid
import paddle_tpu_torch.core.framework as tfw
from paddle_tpu_torch import analysis
from paddle_tpu_torch.analysis import cost_model as tcm
from paddle_tpu_torch.core import executor as texecutor
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.core.scope import Scope

from test_torch_analysis import (fx_book08_dynamic_rnn, fx_deepfm_sparse,
                                 fx_lm, fx_resnet, fx_seq2seq)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 4


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


# ---------------------------------------------------------------------------
# parity over the main-path programs
# ---------------------------------------------------------------------------

PROGRAMS = {"lm": fx_lm, "resnet": fx_resnet, "seq2seq": fx_seq2seq,
            "book08_dynamic_rnn": fx_book08_dynamic_rnn,
            "deepfm_sparse": fx_deepfm_sparse}


def _int64_bytes(op, tblock, jblock):
    """4 bytes an element on every var `op` binds that is int64 in the
    port and int32 in the JAX package (the int64 rule), at BATCH."""
    resolve = tcm._make_resolver(tblock, BATCH)
    extra = 0.0
    for names in list(op.inputs.values()) + list(op.outputs.values()):
        for n in names:
            tv, jv = _lookup(tblock, n), _lookup(jblock, n)
            if (tv is None or jv is None or tv.dtype != "int64"
                    or jv.dtype != "int32"):
                continue
            shape, _ = resolve(n)
            extra += 4.0 * float(np.prod(shape, dtype=np.float64))
    return extra


def _lookup(block, name):
    try:
        return block.var(name)
    except KeyError:
        return None


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_estimates_match_the_jax_package(name):
    jp, kw = PROGRAMS[name](jfluid, jfw)
    tp, _ = PROGRAMS[name](tfluid, tfw)
    je = jcm.estimate_program(jp, batch_size=BATCH, **kw)
    te = tcm.estimate_program(tp, batch_size=BATCH, **kw)
    assert len(je.rows) == len(te.rows)
    assert je.unknown_types == te.unknown_types
    n_int64 = 0
    for (jb, ji, jt, jc), (tb, ti, tt, tc) in zip(je.rows, te.rows):
        assert (jb, ji, jt) == (tb, ti, tt)
        assert (tc.kind, tc.flops) == (jc.kind, jc.flops), (ti, tt)
        moves = tc.known and tc.kind not in ("free", "host", "control")
        extra = _int64_bytes(tp.blocks[tb].ops[ti], tp.blocks[tb],
                             jp.blocks[jb]) if moves else 0.0
        assert tc.bytes - jc.bytes == extra, (ti, tt, tc, jc)
        n_int64 += extra > 0
        # estimate_op alone agrees with the program walk
        assert tcm.estimate_op(tp.blocks[tb].ops[ti], tp.blocks[tb],
                               BATCH) == tc
    assert te.total_flops == je.total_flops > 0
    if name in ("lm", "seq2seq"):
        # the reshaped int64 label is the only such var: the cross
        # entropy and its gradient read it (its reshape moves no bytes)
        assert n_int64 == 2
    assert te.device == "H100" and je.device != te.device


def test_the_batch_folding_resolver_keeps_its_sentinel():
    """A reshape folding the batch into another dim keeps `8191 * k`
    concrete on the var; the resolver maps it back to `batch * k` in
    both packages (else the LM's cross entropy would be costed at
    8191/batch times its rows)."""
    from paddle_tpu_torch.core.shape_inference import _SENTINEL

    assert _SENTINEL == 8191
    for fluid, fw, cm in ((jfluid, jfw, jcm), (tfluid, tfw, tcm)):
        fw.reset_unique_names()
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.layers.data(name="x", shape=[64, 1], dtype="float32")
            y = fluid.layers.reshape(x, shape=[-1, 1])
        assert y.shape == (8191 * 64, 1)
        resolve = cm._make_resolver(main.global_block(), 8)
        assert resolve(y.name)[0] == (8 * 64, 1)


def test_peak_and_comm_on_the_sharded_fixtures_match():
    def dp_mlp(fluid, fw):
        fw.reset_unique_names()
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.layers.data(name="x", shape=[16], dtype="float32")
            y = fluid.layers.data(name="y", shape=[1], dtype="int64")
            h = fluid.layers.fc(input=x, size=32, act="relu")
            h2 = fluid.layers.fc(input=h, size=32, act="relu")
            p = fluid.layers.fc(input=h2, size=4, act="softmax")
            loss = fluid.layers.mean(
                fluid.layers.cross_entropy(input=p, label=y))
            fluid.SGD(learning_rate=0.1).minimize(loss)
        main.mesh_axes = {"dp": 8}
        return main, [loss.name]

    def row_parallel(fluid, fw):
        fw.reset_unique_names()
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.layers.data(name="x", shape=[16], dtype="float32")
            h = fluid.layers.fc(input=x, size=32, bias_attr=False)
            h.sharding = fw.normalize_sharding((None, "tp"))
            fluid.layers.fc(input=h, size=8, bias_attr=False)
        main.mesh_axes = {"dp": 2, "tp": 2}
        return main, None

    def reshard(fluid, fw):
        fw.reset_unique_names()
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.layers.data(name="x", shape=[16], dtype="float32")
            h = fluid.layers.fc(input=x, size=32, bias_attr=False)
            h.sharding = fw.normalize_sharding((None, "tp"))
            fluid.layers.softmax_with_cross_entropy(
                h, fluid.layers.data(name="lbl", shape=[1], dtype="int64"))
        main.mesh_axes = {"tp": 2}
        return main, None

    seen = {}
    for build in (dp_mlp, row_parallel, reshard):
        (jp, jf), (tp, tf) = build(jfluid, jfw), build(tfluid, tfw)
        for batch in (4, 32):
            jc = jcm.estimate_comm(jp, batch_size=batch, fetch_names=jf)
            tc = tcm.estimate_comm(tp, batch_size=batch, fetch_names=tf)
            assert tc.rows == jc.rows and tc.rows, build.__name__
            assert tcm.estimate_peak_hbm(tp, batch_size=batch,
                                         fetch_names=tf) \
                == jcm.estimate_peak_hbm(jp, batch_size=batch,
                                         fetch_names=jf)
        seen[build.__name__] = tc.by_axis()
    assert seen["row_parallel"]["tp"]["all_reduce"] == 32 * 8 * 4
    assert seen["reshard"]["tp"]["reshard"] == 32 * 32 * 4
    w = (16 * 32 + 32 + 32 * 32 + 32 + 32 * 4 + 4) * 4
    assert seen["dp_mlp"]["dp"]["all_reduce"] == w + 4


SPEC = {"vocab_size": 500, "d_model": 128, "n_heads": 4, "n_layers": 2,
        "block_size": 16, "max_blocks_per_seq": 8, "slots": 4,
        "spec_k": 3}


@pytest.mark.parametrize("kv_dtype", ["fp32", "bf16", "int8"])
def test_serving_kernel_rows_match_the_jax_package(kv_dtype):
    rename = {"cuda": "pallas", "plain": "xla"}
    for name, kw in (
            ("paged_attention_gather", {"slots": 4, "context": 64}),
            ("paged_attention_decode", {"slots": 4, "context": 64,
                                        "window": 4}),
            ("moe_gate_dispatch", {"tokens": 256, "num_experts": 8,
                                   "top_k": 2}),
            ("fused_bucket_update", {"numel": 1 << 20, "n_params": 12})):
        j = jcm.serving_kernel_cost(name, SPEC, kv_dtype=kv_dtype, **kw)
        t = tcm.serving_kernel_cost(name, SPEC, kv_dtype=kv_dtype, **kw)
        assert {k: v for k, v in t.items() if k != "backend"} == \
            {k: v for k, v in j.items() if k != "backend"}
        assert t.get("backend") in (None, "cuda")
        assert rename.get(t.get("backend")) == j.get("backend")
    for backend in ("cuda", "plain"):
        kw = dict(slots=4, context=64, kv_dtype=kv_dtype, window=4)
        t = tcm.serving_kernel_cost("paged_decode_step", SPEC,
                                    backend=backend, device="H100", **kw)
        j = jcm.serving_kernel_cost("paged_decode_step", SPEC,
                                    backend=rename[backend], **kw)
        assert t["backend"] == backend
        for k in ("flops", "bytes", "param_bytes", "flops_per_token"):
            assert t[k] == j[k], k
    # on the CPU both resolve the plain composition: the same rows
    t = analysis.analyze_generation_spec(SPEC, kv_dtype=kv_dtype)
    j = jcm.analyze_generation_spec(SPEC, kv_dtype=kv_dtype)
    assert [r["backend"] for r in t["kernels"][:2]] == ["plain", "plain"]
    assert [r.get("backend") for r in j["kernels"][:2]] == ["xla", "xla"]
    assert [(r["kernel"], r["flops"], r["bytes"]) for r in t["kernels"]] \
        == [(r["kernel"], r["flops"], r["bytes"]) for r in j["kernels"]]
    assert t["bytes_per_block"] == j["bytes_per_block"]


def test_decode_backend_resolves_cuda_where_the_kernel_would_run(
        monkeypatch):
    """`_resolve_decode_backend` asks the port's kernel registry and
    paged_attention_supports on the platform torch reports: with the
    tier armed on a card ("cuda"), the spec's geometry runs the kernel;
    a head width the kernel lacks falls back to the plain composition."""
    import torch

    from paddle_tpu_torch.kernels import registry as kreg

    assert tcm._resolve_decode_backend(SPEC, "fp32") == (
        "cuda" if torch.cuda.is_available() else "plain")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert kreg.kernels_armed("cuda")
    assert tcm._resolve_decode_backend(SPEC, "int8") == "cuda"
    rep = analysis.analyze_generation_spec(SPEC)
    assert [r["kernel"] for r in rep["kernels"]] == [
        "paged_decode_step", "paged_decode_step_window(W=4)",
        "paged_attention_decode", "paged_attention_gather"]
    assert rep["kernels"][0]["backend"] == "cuda"
    assert tcm._resolve_decode_backend(dict(SPEC, n_heads=5),
                                       "fp32") == "plain"


# ---------------------------------------------------------------------------
# the chip table: the card's, not the TPU's
# ---------------------------------------------------------------------------


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_for_tests", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_table_is_the_cards():
    assert tcm.DEVICE_SPECS == {"H100": (989e12, 3.35e12),
                                "H100 PCIe": (756e12, 2.0e12),
                                "H100 NVL": (835e12, 3.9e12),
                                "H200": (989e12, 4.8e12)}
    assert tcm.DEFAULT_DEVICE == "H100"
    assert tcm.ridge_point() == tcm.ridge_point("H100") == 989e12 / 3.35e12
    names = {"NVIDIA H100 80GB HBM3": "H100", "NVIDIA H100 PCIe": "H100 PCIe",
             "NVIDIA H100 NVL": "H100 NVL", "NVIDIA H200": "H200"}
    assert sorted(names.values()) == sorted(tcm.DEVICE_SPECS)
    for card, key in names.items():
        assert tcm.device_for_card(card) == key
    with pytest.raises(KeyError):
        tcm.device_for_card("NVIDIA A100-SXM4-80GB")
    # chip_smoke.py reads the same rows: bandwidth and bf16 peak from the
    # table, fp32 and TF32 from its own columns
    import torch

    cs = _chip_smoke()
    for card, key in names.items():
        bw, peaks = cs.card_peaks(card)
        assert (peaks[torch.bfloat16], bw) == tcm.DEVICE_SPECS[key]
        assert peaks[torch.float32] > 0 and peaks["tf32"] > 0
    assert tcm.roofline_seconds(989e12, 0) == 1.0
    assert tcm.roofline_seconds(0, 3.35e12) == 1.0


# ---------------------------------------------------------------------------
# golden per-op costs (tests/test_cost_model.py's, on the port)
# ---------------------------------------------------------------------------


def test_golden_dense_op_costs():
    p = tfluid.Program()
    b = p.global_block()
    b.create_var(name="x", shape=[-1, 64], dtype="float32")
    b.create_var(name="w", shape=[64, 128], dtype="float32")
    op = b.append_op("mul", {"X": ["x"], "Y": ["w"]}, {"Out": ["o"]})
    c = analysis.estimate_op(op, b, batch_size=32)
    assert c.kind == "matmul" and c.flops == 2 * 32 * 64 * 128
    assert c.bytes == (32 * 64 + 64 * 128 + 32 * 128) * 4
    assert analysis.estimate_op(op, b, batch_size=8).flops == 2 * 8 * 64 * 128
    B, S, H, Dh = 2, 128, 4, 16
    for n in ("q", "k", "v"):
        b.create_var(name=n, shape=[B, S, H, Dh], dtype="float32")
    op = b.append_op("flash_attention", {"Q": ["q"], "K": ["k"], "V": ["v"]},
                     {"Out": ["a"]}, {"causal": True})
    c = analysis.estimate_op(op, b)
    assert c.kind == "attention" and c.flops == 4 * B * H * S * S * Dh * 0.5
    assert c.bytes == 4 * B * S * H * Dh * 4        # qkv + out, not S x S
    # the five tagged registrations carry their class on the OpInfo
    from paddle_tpu_torch.core import registry

    assert {t: registry.get_op_info(t).cost_kind for t in (
        "mul", "matmul", "conv2d", "flash_attention", "moe_ffn")} == {
        "mul": "matmul", "matmul": "matmul", "conv2d": "conv",
        "flash_attention": "attention", "moe_ffn": "moe"}


def test_grad_costs_and_unknown_ops():
    from paddle_tpu_torch.core.registry import register_op, register_op_cost

    tfw.reset_unique_names()
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="x", shape=[64], dtype="float32")
        y = tfluid.layers.data(name="y", shape=[1], dtype="float32")
        h = tfluid.layers.dropout(tfluid.layers.fc(input=x, size=16,
                                                   bias_attr=False),
                                  dropout_prob=0.5)
        loss = tfluid.layers.mean(tfluid.layers.square_error_cost(
            tfluid.layers.fc(input=h, size=1), y))
        tfluid.SGD(learning_rate=0.1).minimize(loss)
    b = main.global_block()
    mul, grad = [analysis.estimate_op(op, b, batch_size=32)
                 for op in b.ops if op.type in ("mul", "mul_grad")][::3]
    assert mul.flops == 2 * 32 * 64 * 16
    assert grad.flops == 2 * mul.flops and grad.kind == "matmul"
    # dropout_grad is its own registration: it inherits the class
    assert not analysis.estimate_program(main).unknown_types

    @register_op("torch_cost_model_test_op", inputs=("X",), outputs=("Out",))
    def _lower(ctx, ins, attrs):  # pragma: no cover - never executed
        return {"Out": ins["X"][0]}

    p = tfluid.Program()
    pb = p.global_block()
    pb.create_var(name="x", shape=[4, 4], dtype="float32")
    pb.append_op("torch_cost_model_test_op", {"X": ["x"]}, {"Out": ["o"]})
    est = analysis.estimate_program(p)
    assert est.unknown_types == {"torch_cost_model_test_op": 1}
    assert any("no cost metadata" in d.message
               for d in p.verify(level=None, passes=["cost-model"]))
    register_op_cost("torch_cost_model_test_op", kind="elementwise")
    assert not analysis.estimate_program(p).unknown_types


def test_peak_hbm_liveness():
    p = tfluid.Program()
    b = p.global_block()
    b.create_var(name="x", shape=[1024], dtype="float32")
    prev = "x"
    for i in range(6):
        b.append_op("relu", {"X": [prev]}, {"Out": [f"t{i}"]})
        prev = f"t{i}"
    peak = analysis.estimate_peak_hbm(p, feed_names=["x"])
    buf = 1024 * 4
    assert peak["peak_temp_bytes"] == 2 * buf
    assert peak["no_free_peak_bytes"] == 7 * buf
    held = analysis.estimate_peak_hbm(p, feed_names=["x"],
                                      fetch_names=["t0"])
    assert held["peak_temp_bytes"] == 3 * buf


# ---------------------------------------------------------------------------
# the static floors and the CLI
# ---------------------------------------------------------------------------


def test_static_floors_publish_with_metrics_on():
    from paddle_tpu_torch.observability import attribution, metrics
    from paddle_tpu_torch.serving.generation import (
        _publish_static_decode_floor)
    from paddle_tpu_torch.trainer import Trainer

    main, _ = fx_lm(tfluid, tfw)
    was = metrics.enabled()
    try:
        metrics.set_enabled(False)      # gated: nothing published
        Trainer._publish_static_floor(types.SimpleNamespace(
            main_program=main))
        metrics.set_enabled(True)
        Trainer._publish_static_floor(types.SimpleNamespace(
            main_program=main))
        est = tcm.estimate_program(main)
        got = attribution._static_family("trainer").labels(
            phase="compute").value
        assert got == tcm.roofline_seconds(est.total_flops,
                                           est.total_bytes) > 0
        for label, backend in (("cuda", "cuda"), ("plain:no_cuda",
                                                  "plain")):
            server = types.SimpleNamespace(
                _slots=4, _decoder=types.SimpleNamespace(
                    kernels={"paged_attention_decode": label}))
            _publish_static_decode_floor(SPEC, server)
            row = tcm.serving_kernel_cost(
                "paged_decode_step", SPEC, slots=4, context=64,
                kv_dtype="fp32", backend=backend)
            assert attribution._static_family("generation").labels(
                phase="decode").value == tcm.roofline_seconds(
                    row["flops"], row["bytes"])
    finally:
        metrics.set_enabled(was)


CONFIG = '''
import paddle_tpu_torch as fluid


def build():
    x = fluid.layers.data(name="x", shape=[13], dtype="float32")
    y = fluid.layers.data(name="y", shape=[1], dtype="float32")
    pred = fluid.layers.fc(input=x, size=8, act="relu")
    pred = fluid.layers.fc(input=pred, size=1)
    loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
    return {"loss": loss}
'''


def test_cli_analyze_json_budget_and_generation_dir(tmp_path, capsys):
    from paddle_tpu_torch.cli import cmd_analyze, main as cli_main

    cfg = tmp_path / "cfg.py"
    cfg.write_text(CONFIG)
    assert cmd_analyze([str(cfg), "--json", "--batch", "16",
                        "--device", "H100 PCIe"]) == 0
    doc = json.loads(capsys.readouterr().out)
    roof = doc["programs"][0]["roofline"]
    assert roof["device"] == "H100 PCIe" and roof["batch_size"] == 16
    assert roof["ridge_flop_per_byte"] == round(756e12 / 2.0e12, 1)
    budget = tmp_path / "budgets.json"
    budget.write_text(json.dumps({"models": {"cfg.py": {
        "max_flops_g": 1e-9, "max_unknown_ops": 0}}}))
    assert cmd_analyze([str(cfg), "--budget", str(budget)]) == 1
    assert "BUDGET VIOLATION" in capsys.readouterr().out
    gen = tmp_path / "gen"
    gen.mkdir()
    (gen / "generation.json").write_text(json.dumps(SPEC))
    with pytest.raises(SystemExit) as ei:
        cli_main(["analyze", str(gen), "--json"])
    assert ei.value.code == 0
    rep = json.loads(capsys.readouterr().out)["programs"][0]["report"]
    assert rep["model"]["d_model"] == 128
    with pytest.raises(SystemExit):
        cmd_analyze([str(cfg), "--device", "TPU v5 lite"])
