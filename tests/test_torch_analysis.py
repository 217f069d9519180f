"""The port's static program verifier (paddle_tpu_torch.analysis) against
the JAX package's, on the CPU.

Every seeded-bad fixture of tests/test_analysis.py and five realistic
Programs (a 2-layer LM, a small ResNet, the seq2seq translator, book 08's
DynamicRNN translator and DeepFM with `is_sparse=True`) are built in
both packages under reset unique names; each diagnostic's
`(pass_id, severity, block_idx, op_idx, op_type)` must be equal.

The one expected difference: a fixture using an op type the port does
not register yet (the distributed send/recv ops, tests/test_torch_op_test.py
NOT_PORTED) adds one `op-arity` "not registered" error per such op, and —
as such an op has no `host` flag in the port — the cost model's finding
moves too.  Each such fixture pins its exact difference in EXTRA /
MISSING below; the collective fixtures give the JAX package's findings.

Then the hooks: `Program.verify`, the pre-flight in `Executor.run`,
`ParallelExecutor` and `io.load_inference_model` under
PADDLE_TPU_VERIFY=warn|error, the debugger's annotations, `cli verify`,
and `from paddle_tpu_torch.core.resilience import *`.
"""
import json
import os
import warnings

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu.core.framework as jfw
from paddle_tpu.models import ctr as jctr
from paddle_tpu.models import transformer as jtr
from paddle_tpu import models as jmodels

import paddle_tpu_torch as tfluid
import paddle_tpu_torch.core.framework as tfw
from paddle_tpu_torch import CPUPlace, analysis
from paddle_tpu_torch import models as tmodels
from paddle_tpu_torch.analysis import ProgramVerificationError
from paddle_tpu_torch.core import executor as texecutor
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.core.scope import Scope
from paddle_tpu_torch.models import ctr as tctr
from paddle_tpu_torch.models import transformer as ttr

from test_torch_book_mt import _train_program as _book08_program

CPU = CPUPlace()


@pytest.fixture(autouse=True)
def _fresh_port_state():
    """The port's unique names, default programs, global scope and flags
    per test (the suite's conftest resets only the JAX package)."""
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


def _key(diags):
    return [(d.pass_id, d.severity, d.block_idx, d.op_idx, d.op_type)
            for d in diags]


def find(diags, pass_id, severity=None):
    return [d for d in diags if d.pass_id == pass_id
            and (severity is None or d.severity == severity)]


# ---------------------------------------------------------------------------
# the fixtures, built by either package: fn(fluid, fw) -> (program, kwargs)
# ---------------------------------------------------------------------------


def _fresh(fluid):
    p = fluid.Program()
    return p, p.global_block()


def fx_dangling_input(fluid, fw):
    p, b = _fresh(fluid)
    b.create_var(name="x", shape=[2, 2], dtype="float32")
    b.append_op("relu", {"X": ["never_created"]}, {"Out": ["y"]})
    return p, {}


def _read_before_producer(fluid):
    p, b = _fresh(fluid)
    b.create_var(name="x", shape=[2, 2], dtype="float32")
    b.append_op("relu", {"X": ["late"]}, {"Out": ["y"]})
    b.append_op("relu", {"X": ["x"]}, {"Out": ["late"]})
    return p


def fx_read_before_producer(fluid, fw):
    return _read_before_producer(fluid), {}


def fx_read_before_producer_fed(fluid, fw):
    return _read_before_producer(fluid), {"feed_names": ["late"]}


def fx_undeclared_slot(fluid, fw):
    p, b = _fresh(fluid)
    b.create_var(name="x", shape=[2, 2], dtype="float32")
    b.append_op("relu", {"Bogus": ["x"]}, {"Out": ["y"]})
    return p, {}


def fx_unregistered_op(fluid, fw):
    p, b = _fresh(fluid)
    b.append_op("no_such_op_exists", {}, {"Out": ["y"]})
    return p, {}


def fx_non_duplicable_multi_bind(fluid, fw):
    p, b = _fresh(fluid)
    for n in ("a", "b"):
        b.create_var(name=n, shape=[2], dtype="float32")
    b.append_op("relu", {"X": ["a", "b"]}, {"Out": ["y"]})
    return p, {}


def fx_duplicable_sum(fluid, fw):
    p, b = _fresh(fluid)
    for n in ("a", "b"):
        b.create_var(name=n, shape=[2], dtype="float32")
    b.append_op("sum", {"X": ["a", "b"]}, {"Out": ["s"]})
    return p, {}


def fx_shape_inference_failure(fluid, fw):
    p, b = _fresh(fluid)
    b.create_var(name="x", shape=[2, 3], dtype="float32")
    b.create_var(name="y", shape=[7, 5], dtype="float32")
    b.append_op("mul", {"X": ["x"], "Y": ["y"]}, {"Out": ["z"]})
    return p, {}


def fx_dtype_conflict(fluid, fw):
    p, b = _fresh(fluid)
    b.create_var(name="x", shape=[2, 2], dtype="float32")
    b.append_op("relu", {"X": ["x"]}, {"Out": ["shared"]})
    b.append_op("cast", {"X": ["x"]}, {"Out": ["shared"]},
                {"out_dtype": "int32"})
    return p, {}


def _dead_op(fluid):
    p, b = _fresh(fluid)
    b.create_var(name="x", shape=[2, 2], dtype="float32")
    b.append_op("tanh", {"X": ["x"]}, {"Out": ["unused"]})
    b.append_op("relu", {"X": ["x"]}, {"Out": ["y"]})
    return p


def fx_dead_op_fetched(fluid, fw):
    return _dead_op(fluid), {"fetch_names": ["y"]}


def fx_dead_op_no_fetch(fluid, fw):
    return _dead_op(fluid), {}


def fx_var_shadowing(fluid, fw):
    p, b = _fresh(fluid)
    b.create_var(name="v", shape=[4, 4], dtype="float32")
    sub = p.create_block()
    sub.vars["v"] = fw.Variable(sub, "v", shape=[8], dtype="int64")
    return p, {}


def fx_invalid_sub_block(fluid, fw):
    p, b = _fresh(fluid)
    b.create_var(name="x", shape=[2], dtype="float32")
    b.append_op("conditional_block", {"X": ["x"]}, {"Out": ["o"]},
                {"sub_block": {"__block__": 99}})
    return p, {}


def fx_corrupt_parent_idx(fluid, fw):
    p, b = _fresh(fluid)
    b.create_var(name="x", shape=[2], dtype="float32")
    sub = p.create_block()
    sub.parent_idx = 99
    sub.vars["x"] = fw.Variable(sub, "x", shape=[5], dtype="int64")
    return p, {}


def fx_collective_default_ring(fluid, fw):
    p, b = _fresh(fluid)
    b.create_var(name="g", shape=[4], dtype="float32")
    b.append_op("c_allreduce_sum", {"X": ["g"]}, {"Out": ["g2"]})
    return p, {}


def fx_collective_empty_ring(fluid, fw):
    p, b = _fresh(fluid)
    b.create_var(name="g", shape=[4], dtype="float32")
    b.append_op("c_allreduce_sum", {"X": ["g"]}, {"Out": ["g2"]},
                {"ring_id": ""})
    return p, {}


def fx_send_without_endpoints(fluid, fw):
    p, b = _fresh(fluid)
    b.create_var(name="g", shape=[2], dtype="float32")
    b.append_op("send", {"X": ["g"]}, {"Out": ["p0"]},
                {"endpoints": [], "epmap": []})
    return p, {}


def fx_epmap_arity(fluid, fw):
    p, b = _fresh(fluid)
    for n in ("g1", "g2"):
        b.create_var(name=n, shape=[2], dtype="float32")
    b.append_op("send", {"X": ["g1", "g2"]}, {"Out": ["p"]},
                {"endpoints": ["h:1"], "epmap": ["h:1", "h:1", "h:1"]})
    return p, {}


def fx_pipeline_stage_decreases(fluid, fw):
    p, b = _fresh(fluid)
    b.create_var(name="x", shape=[2], dtype="float32")
    b.append_op("relu", {"X": ["x"]}, {"Out": ["a"]},
                {"pipeline_stage": 1})
    b.append_op("relu", {"X": ["a"]}, {"Out": ["b"]},
                {"pipeline_stage": 0})
    return p, {}


def fx_pipeline_grad_reverse(fluid, fw):
    p, b = _fresh(fluid)
    b.create_var(name="x", shape=[2], dtype="float32")
    b.append_op("relu", {"X": ["x"]}, {"Out": ["a"]},
                {"pipeline_stage": 0})
    b.append_op("relu", {"X": ["a"]}, {"Out": ["b"]},
                {"pipeline_stage": 1})
    b.append_op("relu_grad", {"X": ["a"], "Out": ["b"],
                              "Out@GRAD": ["b@GRAD"]},
                {"X@GRAD": ["a@GRAD"]}, {"pipeline_stage": 1})
    b.append_op("relu_grad", {"X": ["x"], "Out": ["a"],
                              "Out@GRAD": ["a@GRAD"]},
                {"X@GRAD": ["x@GRAD"]}, {"pipeline_stage": 0})
    return p, {}


def fx_inplace_undeclared(fluid, fw):
    p, b = _fresh(fluid)
    b.create_var(name="x", shape=[2, 2], dtype="float32")
    b.append_op("relu", {"X": ["x"]}, {"Out": ["x"]})
    b.append_op("tanh", {"X": ["x"]}, {"Out": ["y"]})
    return p, {}


def fx_inplace_declared(fluid, fw):
    p, b = _fresh(fluid)
    b.create_var(name="c", shape=[1], dtype="float32")
    b.append_op("increment", {"X": ["c"]}, {"Out": ["c"]}, {"step": 1.0})
    b.append_op("scale", {"X": ["c"]}, {"Out": ["d"]})
    return p, {}


def fx_collective_ordering_mismatch(fluid, fw):
    p, b = _fresh(fluid)
    b.create_var(name="x", shape=[4, 4], dtype="float32")
    with fluid.pipeline_stage(0):
        b.append_op("c_allreduce_sum", {"X": ["x"]}, {"Out": ["a0"]},
                    {"ring_id": "dp"})
        b.append_op("c_allreduce_max", {"X": ["x"]}, {"Out": ["a1"]},
                    {"ring_id": "dp"})
    with fluid.pipeline_stage(1):
        b.append_op("c_allreduce_max", {"X": ["x"]}, {"Out": ["b0"]},
                    {"ring_id": "dp"})
        b.append_op("c_allreduce_sum", {"X": ["x"]}, {"Out": ["b1"]},
                    {"ring_id": "dp"})
    return p, {}


def fx_donated_fetch(fluid, fw):
    fw.reset_unique_names()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32",
                              donate=True)
        fluid.layers.relu(x)
    return main, {"fetch_names": ["x"]}


# -- the realistic programs (tiny widths) ------------------------------------

V, D, H, L, SEQ = 29, 32, 2, 2, 16
SV, TV, SRC, TGT = 23, 29, 12, 10
VOCABS, DENSE = [7, 11, 5], 3


def _pkg(fluid):
    if fluid is jfluid:
        return jtr, jmodels, jctr
    return ttr, tmodels, tctr


def fx_lm(fluid, fw):
    tr, _, _ = _pkg(fluid)
    fw.reset_unique_names()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        ids = fluid.layers.data(name="ids", shape=[SEQ], dtype="int64")
        lbl = fluid.layers.data(name="lbl", shape=[SEQ, 1], dtype="int64")
        logits = tr.transformer_lm(ids, V, d_model=D, n_heads=H,
                                   n_layers=L, max_len=SEQ,
                                   return_logits=True)
        loss = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(
            fluid.layers.reshape(logits, shape=[-1, V]),
            fluid.layers.reshape(lbl, shape=[-1, 1])))
        fluid.Momentum(learning_rate=0.01, momentum=0.9).minimize(loss)
    return main, {"feed_names": ["ids", "lbl"], "fetch_names": [loss.name]}


def fx_resnet(fluid, fw):
    _, models, _ = _pkg(fluid)
    fw.reset_unique_names()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        img = fluid.layers.data(name="img", shape=[3, 16, 16],
                                dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        pred = models.resnet_cifar10(img, class_dim=4, depth=8)
        loss = fluid.layers.mean(fluid.layers.cross_entropy(input=pred,
                                                            label=label))
        fluid.layers.accuracy(input=pred, label=label)
        fluid.Momentum(learning_rate=0.01, momentum=0.9).minimize(loss)
    return main, {"feed_names": ["img", "label"],
                  "fetch_names": [loss.name]}


def fx_seq2seq(fluid, fw):
    tr, _, _ = _pkg(fluid)
    fw.reset_unique_names()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        src = fluid.layers.data(name="src", shape=[SRC], dtype="int64")
        tgt = fluid.layers.data(name="tgt", shape=[TGT], dtype="int64")
        lbl = fluid.layers.data(name="lbl", shape=[TGT, 1], dtype="int64")
        logits = tr.transformer_translate(
            src, tgt, SV, TV, d_model=D, n_heads=H, n_layers=L,
            max_len=max(SRC, TGT), return_logits=True)
        loss = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(
            fluid.layers.reshape(logits, shape=[-1, TV]),
            fluid.layers.reshape(lbl, shape=[-1, 1])))
        fluid.Adam(learning_rate=1e-4).minimize(loss)
    return main, {"feed_names": ["src", "tgt", "lbl"],
                  "fetch_names": [loss.name]}


def fx_book08_dynamic_rnn(fluid, fw):
    main, _, loss, _ = _book08_program(fluid, fw, attention=False)
    return main, {"fetch_names": [loss.name]}


def fx_deepfm_sparse(fluid, fw):
    _, _, ctr = _pkg(fluid)
    fw.reset_unique_names()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        sparse_in = [fluid.layers.data(name=f"slot{i}", shape=[1],
                                       dtype="int64")
                     for i in range(len(VOCABS))]
        dense_in = fluid.layers.data(name="dense", shape=[DENSE],
                                     dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="float32")
        _, logit = ctr.deepfm(sparse_in, VOCABS, dense_input=dense_in,
                              embed_dim=4, hidden_sizes=(16, 8),
                              is_sparse=True)
        loss = fluid.layers.mean(
            fluid.layers.sigmoid_cross_entropy_with_logits(logit, label))
        fluid.Adam(learning_rate=0.02).minimize(loss)
    return main, {"fetch_names": [loss.name]}


FIXTURES = {name[3:]: fn for name, fn in dict(globals()).items()
            if name.startswith("fx_")}

_UNREG = "op-arity", "error"
# The port's differences, pinned: fixture -> diagnostics the port adds
# (EXTRA) and the JAX package's it lacks (MISSING), as (pass_id,
# severity, block_idx, op_idx, op_type).  None: every op type is
# registered in both packages (A11's send too, which both cost at zero
# as a host op), so every fixture gives the JAX package's own findings.
# The c_* collectives' fixtures give its findings as well (a
# shape-inference warning outside a mesh, where both packages'
# lowerings raise on the unbound axis; the dead-op info;
# distributed-lint on the ring).
EXTRA = {}
MISSING = {}


def _both(name):
    fn = FIXTURES[name]
    jp, jkw = fn(jfluid, jfw)
    tp, tkw = fn(tfluid, tfw)
    return (_key(jp.verify(level=None, **jkw)),
            _key(tp.verify(level=None, **tkw)))


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_diagnostics_match_the_jax_package(name):
    want, got = _both(name)
    for d in MISSING.get(name, ()):
        want.remove(d)
    want = want + EXTRA.get(name, [])
    assert sorted(got, key=repr) == sorted(want, key=repr), name
    if name in ("lm", "resnet", "seq2seq", "book08_dynamic_rnn",
                "deepfm_sparse"):
        # the main-path programs verify clean at level=error
        assert not [k for k in got if k[1] == "error"], got


def test_every_not_ported_fixture_differs_only_as_pinned():
    """No op type is left unported (NOT_PORTED is empty), so no fixture
    differs: the send fixtures give the JAX package's diagnostics, with
    no op-arity "not registered" error for their `send`."""
    from test_torch_op_test import NOT_PORTED

    assert not NOT_PORTED and not EXTRA and not MISSING
    for name in ("send_without_endpoints", "epmap_arity"):
        p, _ = FIXTURES[name](tfluid, tfw)
        assert [op.type for op in p.global_block().ops] == ["send"]
        want, got = _both(name)
        assert got == want
        assert not [k for k in got if k[:2] == _UNREG]


# ---------------------------------------------------------------------------
# the port's surface, as tests/test_analysis.py holds the JAX package's
# ---------------------------------------------------------------------------


def _broken(fluid=tfluid):
    p, b = _fresh(fluid)
    b.append_op("relu", {"X": ["nope"]}, {"Out": ["y"]})
    return p


def test_shape_inference_pass_runs_the_ports_inference():
    p, _ = fx_shape_inference_failure(tfluid, tfw)
    d, = find(p.verify(level=None), "shape-inference", "warning")
    assert "shape inference failed" in d.message and d.op_type == "mul"
    p, _ = fx_dtype_conflict(tfluid, tfw)
    assert any("already declared" in d.message and "'shared'" in d.message
               for d in find(p.verify(level=None), "shape-inference"))
    # verification never mutates the program
    p, b = _fresh(tfluid)
    b.create_var(name="x", shape=[2, 2], dtype="float32")
    b.append_op("relu", {"X": ["x"]}, {"Out": ["y"]})
    before = (b.vars["y"].shape, b.vars["y"].dtype)
    p.verify(level=None)
    assert (b.vars["y"].shape, b.vars["y"].dtype) == before


def test_verify_levels_pass_filter_and_custom_pass():
    p = _broken()
    with pytest.raises(ProgramVerificationError) as ei:
        p.verify(level="error")
    assert any(d.pass_id == "def-before-use" for d in ei.value.diagnostics)
    assert find(p.verify(level=None), "def-before-use", "error")
    ds = p.verify(level=None, passes=["dead-op"])
    assert ds and all(d.pass_id == "dead-op" for d in ds)
    with pytest.raises(KeyError):
        p.verify(level=None, passes=["no-such-pass"])
    assert [x.id for x in analysis.registered_passes()] == [
        "def-before-use", "op-arity", "shape-inference", "dead-op",
        "var-shadowing", "control-flow", "distributed-lint",
        "sharding-consistency", "collective-safety", "donation-safety",
        "inplace-alias", "cost-model", "comm-volume"]

    @analysis.register_pass("test-no-tanh")
    def no_tanh(ctx):
        for block, idx, op in ctx.iter_ops():
            if op.type == "tanh":
                yield ctx.diag("error", "tanh is banned here", block,
                               idx, op)

    try:
        p, b = _fresh(tfluid)
        b.create_var(name="x", shape=[2], dtype="float32")
        b.append_op("tanh", {"X": ["x"]}, {"Out": ["y"]})
        d, = find(p.verify(level=None, passes=["test-no-tanh"]),
                  "test-no-tanh")
        assert d.severity == "error" and d.op_idx == 0
    finally:
        analysis.registry._PASSES.pop("test-no-tanh", None)


def _fc_program():
    tfw.reset_unique_names()
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="x", shape=[3], dtype="float32")
        tfluid.layers.tanh(x)                       # dead op -> warning
        y = tfluid.layers.relu(tfluid.layers.fc(input=x, size=2))
    return main, startup, y


def test_executor_preflight_error_raises_before_any_op():
    tflags.set_flags({"verify": "error"})
    exe = tfluid.Executor(CPU)
    with pytest.raises(ProgramVerificationError):
        exe.run(_broken(), feed={}, fetch_list=[])
    # off (the default): the same program fails only at the missing var
    tflags.set_flags({"verify": "off"})
    with pytest.raises(Exception) as ei:
        exe.run(_broken(), feed={}, fetch_list=[])
    assert not isinstance(ei.value, ProgramVerificationError)


def test_executor_preflight_warn_warns_once_and_runs():
    main, startup, y = _fc_program()
    exe = tfluid.Executor(CPU)
    exe.run(startup)
    tflags.set_flags({"verify": "warn"})
    feed = {"x": np.ones((2, 3), np.float32)}
    with pytest.warns(RuntimeWarning, match="program verification"):
        out, = exe.run(main, feed=feed, fetch_list=[y])
    assert out.shape == (2, 2)
    with warnings.catch_warnings():
        warnings.simplefilter("error")      # cached per (program, version)
        exe.run(main, feed=feed, fetch_list=[y])
    # a run with no fetch_list is "fetch context unknown": no dead-op
    # warning for the program's leaf output
    main2, startup2, _ = _fc_program()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        exe.run(startup2)
    assert not [x for x in w if "program verification" in str(x.message)]


def test_parallel_executor_preflight():
    from paddle_tpu_torch.parallel import ParallelExecutor

    tflags.set_flags({"verify": "error"})
    with pytest.raises(ProgramVerificationError):
        ParallelExecutor(_broken(), [], [], mesh={"dp": 1}, place=CPU)


def test_load_inference_model_preflight(tmp_path):
    from paddle_tpu_torch import io as tio

    main, startup, y = _fc_program()
    exe = tfluid.Executor(CPU)
    exe.run(startup)
    tio.save_inference_model(str(tmp_path / "ok"), ["x"], [y], exe,
                             main_program=main)
    bad = tmp_path / "bad"
    bad.mkdir()
    with open(bad / "__model__", "w") as f:
        json.dump({"program": _broken().to_dict(), "feed_var_names": [],
                   "fetch_var_names": ["y"]}, f)
    tflags.set_flags({"verify": "error"})
    prog, feeds, _ = tio.load_inference_model(str(tmp_path / "ok"), exe,
                                              scope=Scope())
    assert feeds == ["x"]
    with pytest.raises(ProgramVerificationError):
        tio.load_inference_model(str(bad), exe, scope=Scope())
    tflags.set_flags({"verify": "warn"})
    with pytest.warns(RuntimeWarning, match="def-before-use"):
        prog, _, fetches = tio.load_inference_model(str(bad), exe,
                                                    scope=Scope())
    assert fetches == ["y"]


def test_debugger_annotates_flagged_ops():
    from paddle_tpu import debugger as jdebugger
    from paddle_tpu_torch import debugger

    p = _broken()
    ds = p.verify(level=None)
    code = debugger.program_to_code(p, diagnostics=ds, skip_vars=True)
    assert "// !! [error] def-before-use" in code
    assert code == jdebugger.program_to_code(
        _broken(jfluid), diagnostics=_broken(jfluid).verify(level=None),
        skip_vars=True)
    dot = debugger.draw_block_graphviz(p.global_block(), diagnostics=ds)
    assert "salmon" in dot and "def-before-use" in dot
    assert "// !!" in debugger.program_to_code(p, verify=True)


def test_cli_verify_model_dir(tmp_path, capsys):
    from paddle_tpu_torch import io as tio
    from paddle_tpu_torch.cli import cmd_verify, main as cli_main

    main, startup, y = _fc_program()
    exe = tfluid.Executor(CPU)
    exe.run(startup)
    ok = tmp_path / "ok_model"
    tio.save_inference_model(str(ok), ["x"], [y], exe, main_program=main)
    assert cmd_verify([str(ok)]) == 0
    assert "all clean" in capsys.readouterr().out
    bad = tmp_path / "bad_model"
    bad.mkdir()
    with open(bad / "__model__", "w") as f:
        json.dump({"program": _broken().to_dict(), "feed_var_names": [],
                   "fetch_var_names": ["y"]}, f)
    assert cmd_verify([str(bad)]) == 1
    assert "def-before-use" in capsys.readouterr().out
    with pytest.raises(SystemExit) as ei:       # the module entry point
        cli_main(["verify", str(bad), "--json"])
    assert ei.value.code == 1
    doc = json.loads(capsys.readouterr().out)
    assert doc["failed"] and doc["programs"][0]["diagnostics"][0][
        "pass"] == "def-before-use"


def test_resilience_star_import_and_fault_hook():
    ns = {}
    exec("from paddle_tpu_torch.core.resilience import *", ns)
    assert ns["sched_fault_armed"]("stream.yield-under-lock") is False
    from paddle_tpu_torch.analysis import schedcheck

    with schedcheck.arm_fault("stream.yield-under-lock"):
        assert ns["sched_fault_armed"]("stream.yield-under-lock")
