"""The profiler's device half in the port (torch.profiler), against the
JAX package's named scopes (tests/test_named_scopes.py's 2 cases, and
the profiler parts of tests/test_reader_profiler.py).

On the CPU: a block's exported graph carries every op's scope
"<type>:<first output>" (the same scopes the JAX package's lowered IR
names), `profile_compiled_ops` digests a torch.profiler capture into the
reference's sorted table (aten ops' self time under their op scopes),
the interpreter records one host event an op and the compiled mode one
a block, per-op ranges exist only while the device half is on, and a
replayed CUDA graph's kernels take their scopes from an eager re-run by
launch order (modelled here on a hand-made trace; on the card by
tests/test_torch_cuda.py).
"""
import json
import os

import numpy as np
import torch

import paddle_tpu as jfluid
import paddle_tpu.core.framework as jfw
import paddle_tpu_torch as tfluid
import paddle_tpu_torch.core.framework as tfw
from paddle_tpu_torch import profiler
from paddle_tpu_torch.core import execution
from paddle_tpu_torch.core.executor import program_to_fn


def _fc_program(fluid, fw, width=4, hidden=8):
    fw.reset_unique_names()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[width], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        h = fluid.layers.fc(input=x, size=hidden, act="relu")
        pred = fluid.layers.fc(input=h, size=1)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
        fluid.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, loss


def _port_fn(width=4, hidden=8, batch=2):
    main, startup, loss = _fc_program(tfluid, tfw, width, hidden)
    fn = program_to_fn(main, ["x", "y"], [loss.name],
                       place=tfluid.CPUPlace())
    scope = tfluid.Scope()
    tfluid.Executor(tfluid.CPUPlace()).run(startup, scope=scope)
    states = {n: scope.find_var(n) for n in fn.state_in_names}
    r = np.random.RandomState(0)
    feeds = {"x": torch.from_numpy(r.rand(batch, width).astype(np.float32)),
             "y": torch.from_numpy(r.rand(batch, 1).astype(np.float32))}
    return main, fn, feeds, states


def test_compiled_block_carries_op_scopes():
    """test_named_scopes.py's first case: forward, grad and optimizer ops
    are all attributed in the exported training function, with the
    scopes the JAX package's lowered IR carries for the same ops."""
    import jax
    from paddle_tpu.core.executor import program_to_fn as jprogram_to_fn
    from paddle_tpu.profiler import lowered_ir_text as jlowered_ir_text

    main, fn, feeds, states = _port_fn()
    ir = profiler.lowered_ir_text(fn, feeds, states)
    for marker in ("mul:", "relu:", "mean:", "sgd:", "mul_grad:"):
        assert marker in ir, f"scope {marker!r} missing from the graph"
    # an ExportedProgram prints the same
    ep = profiler.export_program_fn(fn, feeds, states)
    assert profiler.lowered_ir_text(ep) == ir
    scopes = {execution.op_scope_name(op) for op in main.global_block().ops}
    assert {ln.split("# scope: ")[1] for ln in ir.splitlines()
            if "# scope: " in ln} <= scopes

    jmain, jstartup, jloss = _fc_program(jfluid, jfw)
    jfn = jprogram_to_fn(jmain, ["x", "y"], [jloss.name])
    jscope = jfluid.Scope()
    jfluid.Executor(jfluid.CPUPlace()).run(jstartup, scope=jscope)
    jstates = {n: np.asarray(jscope.find_var(n)) for n in jfn.state_in_names}
    jir = jlowered_ir_text(jax.jit(jfn).lower(
        {k: v.numpy() for k, v in feeds.items()}, jstates,
        jax.random.key(0)))
    marked = [execution.op_scope_name(op) for op in main.global_block().ops
              if op.type in ("mul", "relu", "mean", "sgd", "mul_grad")]
    assert len(marked) == 10
    for scope in marked:
        assert scope in ir and scope in jir, scope


def test_profile_compiled_ops_table():
    """test_named_scopes.py's second case, on the CPU: rows sorted by
    total, min <= ave <= max, the matmul rows under fc scopes; the
    table's header names kernels."""
    _, fn, feeds, states = _port_fn(width=64, hidden=128, batch=256)
    fn(feeds, states)  # warm
    rows = profiler.profile_compiled_ops(lambda: fn(feeds, states),
                                         steps=3, print_table=False)
    assert rows, "no op events captured"
    assert rows == sorted(rows, key=lambda r: -r["total"])
    for r in rows:
        assert r["calls"] >= 1 and r["total"] > 0
        assert r["min"] <= r["ave"] <= r["max"]
        assert set(r) == {"name", "scope", "calls", "total", "min", "max",
                          "ave"}
    assert any("fc_" in r["scope"] for r in rows), rows
    mm = [r for r in rows if r["name"] == "aten::mm"]
    assert mm and all(r["scope"].startswith(("mul:", "mul_grad:"))
                      for r in mm)
    table = profiler.format_op_table(rows)
    assert table.splitlines()[0].startswith("Kernel")
    assert "XLA op" not in table


def _tiny_program():
    tfw.reset_unique_names()
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="x", shape=[4], dtype="float32")
        h = tfluid.layers.fc(input=x, size=3, act="relu")
        loss = tfluid.layers.mean(h)
    return main, startup, loss


def test_interpreter_records_per_op_events():
    """test_reader_profiler.py's per-op host events: the interpreter
    records one event an op, named by its type."""
    main, startup, loss = _tiny_program()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=tfluid.Scope())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    feed = {"x": np.ones((2, 4), np.float32)}
    with profiler.profiler("CPU", print_table=False):
        exe.run(main, feed=feed, fetch_list=[loss], compiled=False,
                scope=scope)
        rows = profiler.profiler_summary()
    names = {r["name"] for r in rows}
    assert {"mul", "mean", "relu"} <= names
    assert all(r["calls"] == 1 for r in rows if r["name"] != "elementwise_add")


def test_compiled_records_block_event():
    """test_reader_profiler.py's block event: the compiled mode records
    one `compiled_block` event a run (the JAX package's `xla_block`)."""
    main, startup, loss = _tiny_program()
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    feed = {"x": np.ones((2, 4), np.float32)}
    with profiler.profiler("All", print_table=False):
        for _ in range(2):
            exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        rows = profiler.profiler_summary()
    assert [r["calls"] for r in rows if r["name"] == "compiled_block"] == [2]
    assert not any(r["name"] == "mul" for r in rows)


def test_op_ranges_only_while_the_device_half_is_on(tmp_path):
    """With the device half off an op runs with no range (a plain
    torch.profiler capture shows no per-op annotation); under
    xla_profiler every op of the run is a range in the written trace."""
    from torch.profiler import ProfilerActivity, profile

    main, startup, loss = _tiny_program()
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    feed = {"x": np.ones((2, 4), np.float32)}

    def annotations(path):
        with open(path) as f:
            return {e["name"] for e in json.load(f)["traceEvents"]
                    if e.get("cat") == "user_annotation"}

    assert execution.current_op_scopes() is None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    plain = str(tmp_path / "plain.json")
    prof.export_chrome_trace(plain)
    assert not any(":" in n and n.split(":")[0] in ("mul", "relu", "mean")
                   for n in annotations(plain))

    with profiler.xla_profiler(str(tmp_path / "trace")) as d:
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    assert d == str(tmp_path / "trace")
    got = annotations(os.path.join(d, "trace.json"))
    want = {execution.op_scope_name(op) for op in main.global_block().ops}
    assert want <= got
    assert execution.current_op_scopes() is None
    with profiler.cuda_profiler() as d2:
        pass
    assert os.path.exists(os.path.join(d2, "trace.json"))


def _ev(cat, name, ts, dur, tid=1, corr=None):
    return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": tid,
            "ts": ts, "dur": dur, "args": {} if corr is None
            else {"correlation": corr}}


def test_replayed_kernels_take_the_rerun_scopes_by_launch_order():
    """The replay attribution on a hand-made trace: a graph launch inside
    the range naming entry 5 runs kernels A, B, A, A and a captured copy;
    the entry's re-run launched A under s1, B under s2, A under s3 and a
    DtoD copy under s3.  The n-th A of the launch takes the n-th A's
    scope, the extra A an empty one, the copy the copy's; an eager launch
    inside a per-op range takes that range's scope, and so does one from
    another thread during it; a launch outside any op gets an empty
    one."""
    profiler._scope_names.update({"s1", "s2", "s3", "eager:y"})
    events = [
        _ev("user_annotation", "graph_replay:5", 0, 100),
        _ev("cuda_runtime", "cudaGraphLaunch", 10, 5, corr=7),
        _ev("kernel", "A", 20, 1, tid=9, corr=7),
        _ev("kernel", "B", 22, 2, tid=9, corr=7),
        _ev("kernel", "A", 25, 3, tid=9, corr=7),
        _ev("kernel", "A", 29, 4, tid=9, corr=7),
        _ev("user_annotation", "eager:y", 200, 50),
        _ev("cuda_runtime", "cudaLaunchKernel", 210, 5, corr=8),
        _ev("kernel", "C", 220, 5, tid=9, corr=8),
        _ev("cuda_runtime", "cudaMemcpyAsync", 300, 5, corr=9),
        _ev("kernel", "D", 310, 6, tid=9, corr=9),
    ]
    # a copy captured into the graph runs as a memcpy kernel; a launch
    # from another thread (the autograd worker) inside eager:y's time
    events += [_ev("kernel", "memcpy128", 30, 1, tid=9, corr=7),
               _ev("cuda_runtime", "cudaLaunchKernel", 230, 5, tid=2,
                   corr=10),
               _ev("kernel", "E", 240, 2, tid=9, corr=10)]
    reference = {5: {"A": ["s1", "s3"], "B": ["s2"], "memcpy": ["s3"]}}
    got = profiler._attribute(events, reference)
    assert got == [("A", "s1", 1e-6), ("B", "s2", 2e-6), ("A", "s3", 3e-6),
                   ("A", "", 4e-6), ("memcpy128", "s3", 1e-6),
                   ("C", "eager:y", 5e-6), ("E", "eager:y", 2e-6),
                   ("D", "", 6e-6)]
    rerun = [_ev("user_annotation", "s1", 0, 10),
             _ev("cuda_runtime", "cudaLaunchKernel", 1, 1, corr=1),
             _ev("user_annotation", "s2", 10, 10),
             _ev("cuda_runtime", "cudaLaunchKernel", 11, 1, corr=2),
             _ev("user_annotation", "s3", 20, 10),
             _ev("cuda_runtime", "cudaLaunchKernel", 21, 1, corr=3),
             _ev("kernel", "A", 2, 1, tid=9, corr=1),
             _ev("kernel", "B", 12, 1, tid=9, corr=2),
             _ev("kernel", "A", 22, 1, tid=9, corr=3),
             _ev("cuda_runtime", "cudaMemcpyAsync", 25, 1, corr=4),
             _ev("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 26, 1,
                 tid=9, corr=4)]
    assert profiler._sequences(rerun) == reference[5]
