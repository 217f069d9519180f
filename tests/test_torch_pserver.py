"""The port's send/recv/listen_and_serv pserver runtime against the JAX
package's, on the CPU.

  * wire bytes: serialize_var, serialize_batch_parts and _frame_bytes
    give the JAX package's bytes for float32, int64, LoD and
    SelectedRows values; the JAX package's bfloat16 and int32-row
    values decode in the port (and the port's in the JAX package);
  * across packages over real sockets: a port VariableClient against a
    JAX VariableServer and a JAX client against a port server — send,
    barrier, get, the batch verbs and the per-var fallback against
    enable_batch=False;
  * the transpiler: for tests/test_pserver.py's fit_a_line, both
    packages transpile to the same trainer ops and send attributes and
    the same pserver programs; 12 rounds over 2 pservers from the JAX
    startup's parameters give the JAX cluster's losses and parameters
    (float32 tolerance), the port trainer taking its start from the
    pservers through its startup program's recv ops;
  * sparse: deepfm (is_sparse=True) at tests/test_ctr.py's width over 2
    pservers with 2 trainer threads (fan-in 2), 3 rounds, against the
    JAX cluster;
  * async mode with the Adam epilogue, snapshots and restart (a JAX
    pserver's snapshot restores into a port pserver), the elastic verbs
    at the pserver level, FLIGHT, and the telemetry announce.
Servers run in threads of the test process, as the JAX package's tests
run them.
"""
import socket
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu.core.framework as jfw
import paddle_tpu_torch as fluid
import paddle_tpu_torch.core.framework as tfw
from paddle_tpu.core import lod as jlod
from paddle_tpu.ops.distributed import reset_clients as jreset
from paddle_tpu.parallel import comm as jcomm
from paddle_tpu.parallel import pserver as jps
from paddle_tpu_torch.core.lod import LoDTensor, SelectedRows
from paddle_tpu_torch.ops.distributed import reset_clients as treset
from paddle_tpu_torch.parallel import comm as tcomm
from paddle_tpu_torch.parallel import pserver as ps

RTOL, ATOL = 1e-5, 1e-6
PKGS = {"jax": (jfluid, jfw, jps, jcomm, jreset),
        "port": (fluid, tfw, ps, tcomm, treset)}


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _wrap(pkg, a):
    return torch.from_numpy(np.array(a)) if pkg is fluid else np.array(a)


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.detach().float().numpy() if v.dtype == torch.bfloat16 \
            else v.detach().numpy()
    return np.asarray(v)


def _wait_ports(eps):
    for ep in eps:
        host, port = ep.rsplit(":", 1)
        deadline = time.time() + 10
        while time.time() < deadline:
            try:
                socket.create_connection((host, int(port)),
                                         timeout=0.2).close()
                break
            except OSError:
                time.sleep(0.02)


# ---------------------------------------------------------------------------
# wire bytes
# ---------------------------------------------------------------------------


def _values(kind):
    r = np.random.RandomState(5)
    if kind == "float32":
        a = r.rand(3, 4).astype(np.float32)
        return a, torch.from_numpy(a.copy())
    if kind == "int64":
        a = r.randint(-9, 9, (5,)).astype(np.int64)
        return a, torch.from_numpy(a.copy())
    if kind == "lod":
        a = r.rand(3, 2).astype(np.float32)
        return (jlod.LoDTensor(a, [(0, 1, 3)]),
                LoDTensor(torch.from_numpy(a.copy()), [(0, 1, 3)]))
    rows = np.array([4, 1, 4], np.int64)
    val = r.rand(3, 8).astype(np.float32)
    return (jlod.SelectedRows(rows, val, 16),
            SelectedRows(torch.from_numpy(rows), torch.from_numpy(val), 16))


@pytest.mark.parametrize("kind", ["float32", "int64", "lod",
                                  "selected_rows"])
def test_wire_bytes_are_the_jax_packages(kind):
    jv, tv = _values(kind)
    assert ps.serialize_var(tv) == jps.serialize_var(jv)
    assert ps._join_parts(ps.serialize_batch_parts([("v", tv), ("w", tv)])) \
        == jps._join_parts(jps.serialize_batch_parts([("v", jv), ("w", jv)]))
    payload = ps.serialize_var(tv)
    assert ps._frame_bytes("SEND", "v", payload) == \
        jps._frame_bytes("SEND", "v", payload)
    # and each decodes the other's
    back = ps.deserialize_var(jps.serialize_var(jv))
    jback = jps.deserialize_var(ps.serialize_var(tv))
    if kind == "selected_rows":
        assert back.rows.dtype == torch.int64 and back.height == 16
        assert back.rows.tolist() == [4, 1, 4]
        np.testing.assert_array_equal(back.value.numpy(), jv.value)
        np.testing.assert_array_equal(jback.value, jv.value)
    elif kind == "lod":
        assert back.lod == ((0, 1, 3),) and tuple(jback.lod) == ((0, 1, 3),)
        np.testing.assert_array_equal(back.data.numpy(), jv.data)
    else:
        np.testing.assert_array_equal(back.numpy(), jv)
        np.testing.assert_array_equal(jback, jv)


def test_bf16_and_int32_rows_decode_across_packages():
    import ml_dtypes

    r = np.random.RandomState(2)
    a = r.randn(4, 6).astype(ml_dtypes.bfloat16)
    t = ps.deserialize_var(jps.serialize_var(a))
    assert t.dtype == torch.bfloat16
    assert t.view(torch.int16).numpy().tobytes() == a.tobytes()
    back = jps.deserialize_var(ps.serialize_var(t))
    assert back.dtype == a.dtype and back.tobytes() == a.tobytes()
    assert ps.serialize_var(t) == jps.serialize_var(a)
    # the JAX package's int32 rows decode to the port's int64
    sr = jlod.SelectedRows(np.array([3, 0, 3], np.int32),
                           r.rand(3, 2).astype(np.float32), 5)
    got = ps.deserialize_var(jps.serialize_var(sr))
    assert got.rows.dtype == torch.int64 and got.rows.tolist() == [3, 0, 3]
    np.testing.assert_array_equal(got.value.numpy(), sr.value)


# ---------------------------------------------------------------------------
# across packages over real sockets
# ---------------------------------------------------------------------------


def _sgd_server(pkg, params, fan_in=1, enable_batch=True, sync=True,
                lr=0.1, snapshot_dir=None, snapshot_every=0,
                elastic=False):
    """VariableServer of `pkg` over an sgd-per-param optimize program."""
    mod = ps if pkg is fluid else jps
    scope = pkg.Scope()
    prog = pkg.Program()
    with pkg.program_guard(prog, pkg.Program()):
        blk = prog.global_block()
        blk.create_var(name="lr", shape=[1], dtype="float32",
                       persistable=True)
        for n, v in params.items():
            blk.create_var(name=n, shape=list(v.shape), dtype="float32",
                           persistable=True)
            blk.create_var(name=n + "@GRAD", shape=list(v.shape),
                           dtype="float32", persistable=True)
            blk.append_op("sgd", {"Param": [n], "Grad": [n + "@GRAD"],
                                  "LearningRate": ["lr"]},
                          {"ParamOut": [n]}, {})
    scope.set_var("lr", _wrap(pkg, np.asarray([lr], np.float32)))
    for n, v in params.items():
        scope.set_var(n, _wrap(pkg, v))
    srv = mod.VariableServer(prog, scope, pkg.Executor(pkg.CPUPlace()),
                             fan_in=fan_in, sync=sync,
                             enable_batch=enable_batch,
                             snapshot_dir=snapshot_dir,
                             snapshot_every=snapshot_every, elastic=elastic)
    return srv, f"127.0.0.1:{srv.serve(0)}"


@pytest.mark.parametrize("enable_batch", [True, False],
                         ids=["batch", "legacy"])
@pytest.mark.parametrize("client,server", [("port", "jax"),
                                           ("jax", "port")])
def test_client_and_server_across_packages(client, server, enable_batch):
    cpkg, spkg = PKGS[client][0], PKGS[server][0]
    cmod = PKGS[client][2]
    params = {f"w{i}": np.full(6, float(i + 1), np.float32)
              for i in range(3)}
    srv, ep = _sgd_server(spkg, params, enable_batch=enable_batch)
    c = cmod.VariableClient(ep, client_id="t0")
    try:
        # per-var verbs: send, barrier, get
        for n in params:
            c.send_var(n + "@GRAD", _wrap(cpkg, np.full(6, 1.0, np.float32)))
        c.send_batch_barrier()
        np.testing.assert_allclose(_np(c.get_var("w0")), 0.9, rtol=1e-6)
        # the batch verbs, or the per-var fallback against a legacy
        # server
        c.send_vars([(n + "@GRAD", _wrap(cpkg, np.full(6, 2.0, np.float32)))
                     for n in params])
        assert c._batch_supported is enable_batch
        c.send_batch_barrier()
        got = c.get_vars(list(params))
        want = {n: v - 0.1 * 1.0 - 0.1 * 2.0 for n, v in params.items()}
        for n, v in zip(params, got):
            np.testing.assert_allclose(_np(v), want[n], rtol=1e-6)
    finally:
        c.close()
        srv.stop()


def test_variable_server_two_trainers():
    """fan_in=2: grads from two trainers are summed before the optimize
    program runs (listen_and_serv_op.cc:140-153 semantics)."""
    srv, ep = _sgd_server(fluid, {"w": np.ones(4, np.float32)}, fan_in=2)
    g = [np.full(4, 1.0, np.float32), np.full(4, 3.0, np.float32)]
    results = {}

    def trainer(i):
        c = ps.VariableClient(ep, client_id=f"t{i}")
        c.send_var("w@GRAD", torch.from_numpy(g[i]))
        c.send_batch_barrier()
        results[i] = c.get_var("w").numpy()
        c.close()

    ts = [threading.Thread(target=trainer, args=(i,)) for i in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    srv.stop()
    assert len(results) == 2
    for got in results.values():
        np.testing.assert_allclose(got, 1 - 0.1 * (g[0] + g[1]), rtol=1e-6)


def test_listen_and_serv_op_with_send():
    """Full op/layer path: a ListenAndServ program served from a thread
    (in an Executor(CPUPlace()) of its own), layers.Send from the main
    thread (reference test_recv_op.py)."""
    port = _free_port()
    scope = fluid.Scope()
    scope.set_var("w_served", torch.full((4,), 2.0))
    scope.set_var("lr_served", torch.tensor([0.5]))
    serv_main, serv_start = fluid.Program(), fluid.Program()
    with fluid.program_guard(serv_main, serv_start):
        serv = fluid.layers.ListenAndServ(f"127.0.0.1:{port}", fan_in=1)
        with serv.do():
            blk = serv_main.current_block
            for n, shape in (("w_served", [4]), ("w_served@GRAD", [4]),
                             ("lr_served", [1])):
                blk.create_var(name=n, shape=shape, dtype="float32",
                               persistable=True)
            blk.append_op("sgd", {"Param": ["w_served"],
                                  "Grad": ["w_served@GRAD"],
                                  "LearningRate": ["lr_served"]},
                          {"ParamOut": ["w_served"]}, {})
    th = threading.Thread(
        target=lambda: fluid.Executor(fluid.CPUPlace()).run(
            serv_main, scope=scope), daemon=True)
    th.start()
    _wait_ports([f"127.0.0.1:{port}"])
    cli_main, cli_start = fluid.Program(), fluid.Program()
    with fluid.program_guard(cli_main, cli_start):
        gvar = fluid.layers.data(name="w_served@GRAD", shape=[4],
                                 dtype="float32", append_batch_size=False)
        wvar = cli_main.global_block().create_var(
            name="w_served", shape=[4], dtype="float32")
        fluid.layers.Send(f"127.0.0.1:{port}", [gvar], [wvar])
    out, = fluid.Executor(fluid.CPUPlace()).run(
        cli_main, feed={"w_served@GRAD": np.ones(4, np.float32)},
        fetch_list=[wvar], scope=fluid.Scope())
    np.testing.assert_allclose(out, np.full(4, 1.5), rtol=1e-6)
    ps.VariableClient(f"127.0.0.1:{port}").stop_server()
    th.join(timeout=10)
    assert not th.is_alive()
    treset()


# ---------------------------------------------------------------------------
# the transpiler, and training against the JAX cluster
# ---------------------------------------------------------------------------


def _fit_a_line(pkg, fw):
    fw.reset_unique_names()
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = pkg.layers.data(name="x", shape=[4], dtype="float32")
        y = pkg.layers.data(name="y", shape=[1], dtype="float32")
        h = pkg.layers.fc(input=x, size=8, act="relu")
        pred = pkg.layers.fc(input=h, size=1, act=None)
        loss = pkg.layers.mean(
            pkg.layers.square_error_cost(input=pred, label=y))
        opt_ops, pg = pkg.SGD(learning_rate=0.05).minimize(loss)
    return main, startup, loss, opt_ops, pg


def _transpile(pkg, built, eps, trainers=1):
    main, startup, _, opt_ops, pg = built
    t = pkg.DistributeTranspiler()
    with pkg.program_guard(main, startup):
        t.transpile(optimize_ops=opt_ops, params_grads=pg,
                    trainers=trainers, pservers=",".join(eps))
    return t


def _ops(block):
    return [(op.type, {k: list(v) for k, v in op.inputs.items()},
             {k: list(v) for k, v in op.outputs.items()},
             {k: v for k, v in op.attrs.items() if k != "sub_block"})
            for op in block.ops]


def test_transpiled_programs_are_the_jax_packages():
    eps = ["127.0.0.1:7164", "127.0.0.1:7165"]
    jt = _transpile(jfluid, _fit_a_line(jfluid, jfw), eps)
    jstartup_ops = [op.type for op in
                    jt.get_startup_program(eps[0]).global_block().ops]
    built = _fit_a_line(fluid, tfw)
    tt = _transpile(fluid, built, eps)
    assert _ops(tt.get_trainer_program().global_block()) == \
        _ops(jt.get_trainer_program().global_block())
    for ep in eps:
        jp, tp = jt.get_pserver_program(ep), tt.get_pserver_program(ep)
        assert len(jp.blocks) == len(tp.blocks) == 2
        for jb, tb in zip(jp.blocks, tp.blocks):
            assert _ops(tb) == _ops(jb)
            assert sorted(tb.vars) == sorted(jb.vars)
        assert [op.type for op in tt.get_startup_program(ep)
                .global_block().ops] == jstartup_ops
    # the trainer's startup: the JAX package's, then one recv a pserver
    recvs = built[1].global_block().ops[len(jstartup_ops):]
    assert [(op.type, op.attrs["endpoint"]) for op in recvs] == \
        [("recv", ep) for ep in eps]


def _start_cluster(pkg, t, eps, init):
    """One listen_and_serv thread an endpoint, each pserver's scope made
    by the pserver startup program, then given `init`."""
    threads = []
    for ep in eps:
        pscope = pkg.Scope()
        pkg.Executor(pkg.CPUPlace()).run(t.get_startup_program(ep),
                                         scope=pscope)
        for n, v in init.items():
            pscope.set_var(n, _wrap(pkg, v))
        prog = t.get_pserver_program(ep)
        th = threading.Thread(
            target=lambda p=prog, s=pscope: pkg.Executor(
                pkg.CPUPlace()).run(p, scope=s), daemon=True)
        th.start()
        threads.append(th)
    _wait_ports(eps)
    return threads


def _stop_cluster(name, eps, threads):
    _, _, mod, _, reset = PKGS[name]
    for ep in eps:
        mod.VariableClient(ep).stop_server()
    for th in threads:
        th.join(timeout=10)
    reset()


def _params_of(mod, eps, t):
    out = {}
    for ep in eps:
        c = mod.VariableClient(ep)
        names = [p.name for p, _ in t._pairs_by_ep[ep]]
        out.update(zip(names, (_np(v) for v in c.get_vars(names))))
        c.close()
    return out


def test_fit_a_line_trains_as_the_jax_cluster():
    rng = np.random.RandomState(0)
    xs = rng.rand(32, 4).astype(np.float32)
    ys = (xs @ np.array([[1.0], [2.0], [3.0], [4.0]], np.float32))
    results = {}
    init = None
    for name in ("jax", "port"):
        pkg, fw, mod, _, _ = PKGS[name]
        built = _fit_a_line(pkg, fw)
        main, startup, loss, _, pg = built
        if init is None:    # the JAX startup's parameters
            jscope = pkg.Scope()
            pkg.Executor(pkg.CPUPlace()).run(startup, scope=jscope)
            init = {p.name: np.array(jscope.find_var(p.name))
                    for p, _ in pg}
        eps = [f"127.0.0.1:{_free_port()}" for _ in range(2)]
        t = _transpile(pkg, built, eps)
        threads = _start_cluster(pkg, t, eps, init)
        scope = pkg.Scope()
        exe = pkg.Executor(pkg.CPUPlace())
        exe.run(startup, scope=scope)
        if name == "jax":
            for n, v in init.items():
                scope.set_var(n, v)
        else:   # the startup's recv ops pulled the pservers' params
            for n, v in init.items():
                np.testing.assert_array_equal(
                    scope.find_var(n).numpy(), v)
        losses = []
        for _ in range(12):
            lv, = exe.run(t.get_trainer_program(),
                          feed={"x": xs, "y": ys}, fetch_list=[loss],
                          scope=scope)
            losses.append(float(np.asarray(lv).reshape(-1)[0]))
        results[name] = (losses, _params_of(mod, eps, t),
                         {n: _np(scope.find_var(n)) for n in init})
        _stop_cluster(name, eps, threads)
    (jl, jp, jscope_p), (tl, tp, tscope_p) = results["jax"], results["port"]
    assert tl[-1] < 0.5 * tl[0], tl
    np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=ATOL)
    assert sorted(tp) == sorted(jp)
    for n in jp:
        np.testing.assert_allclose(tp[n], jp[n], rtol=RTOL, atol=ATOL)
        # the trainer's scope holds what it pulled last
        np.testing.assert_array_equal(tscope_p[n], tp[n])


VOCABS = [7, 11, 5]
DENSE = 4


def _deepfm(pkg, fw):
    fw.reset_unique_names()
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        sparse_in = [pkg.layers.data(name=f"slot{i}", shape=[1],
                                     dtype="int64")
                     for i in range(len(VOCABS))]
        dense_in = pkg.layers.data(name="dense", shape=[DENSE],
                                   dtype="float32")
        label = pkg.layers.data(name="label", shape=[1], dtype="float32")
        _, logit = pkg.models.ctr.deepfm(
            sparse_in, VOCABS, dense_input=dense_in, embed_dim=4,
            hidden_sizes=(16, 8), is_sparse=True)
        loss = pkg.layers.mean(
            pkg.layers.sigmoid_cross_entropy_with_logits(logit, label))
        opt_ops, pg = pkg.Adam(learning_rate=0.02).minimize(loss)
    return main, startup, loss, opt_ops, pg


def _ctr_batch(rng, n):
    ids = [rng.randint(0, v, (n, 1)).astype(np.int64) for v in VOCABS]
    dense = rng.rand(n, DENSE).astype(np.float32)
    p = 0.15 + 0.6 * ((ids[0] % 2) == (ids[1] % 2)) + 0.2 * (
        dense[:, :1] > 0.5)
    feed = {f"slot{i}": ids[i] for i in range(len(VOCABS))}
    feed["dense"] = dense
    feed["label"] = (rng.rand(n, 1) < p).astype(np.float32)
    return feed


def test_sparse_deepfm_two_trainers_as_the_jax_cluster(monkeypatch):
    """2 pservers, 2 trainer threads (each with its own connection pool,
    as two processes would have), 3 rounds of SelectedRows and dense
    grads through the fused send op, against the JAX cluster."""
    results = {}
    init = None
    for name in ("jax", "port"):
        pkg, fw, mod, comm, reset = PKGS[name]
        import paddle_tpu.models.ctr  # noqa: F401
        import paddle_tpu_torch.models.ctr  # noqa: F401
        built = _deepfm(pkg, fw)
        main, startup, loss, _, pg = built
        if init is None:
            jscope = pkg.Scope()
            pkg.Executor(pkg.CPUPlace()).run(startup, scope=jscope)
            init = {v.name: np.array(jscope.find_var(v.name))
                    for v in main.list_vars() if v.persistable
                    and jscope.has_var(v.name)
                    and jscope.find_var(v.name) is not None}
        eps = [f"127.0.0.1:{_free_port()}" for _ in range(2)]
        t = _transpile(pkg, built, eps, trainers=2)
        threads = _start_cluster(pkg, t, eps, init)
        local = threading.local()
        monkeypatch.setattr(comm, "comm_pool", lambda: local.pool)
        losses, errors = {}, []

        def trainer(tid, pkg=pkg, startup=startup, t=t, loss=loss,
                    comm=comm):
            try:
                local.pool = comm.CommPool()
                scope = pkg.Scope()
                exe = pkg.Executor(pkg.CPUPlace())
                exe.run(startup, scope=scope)
                if pkg is jfluid:
                    for n, v in init.items():
                        scope.set_var(n, v)
                rng = np.random.RandomState(100 + tid)
                out = []
                for _ in range(3):
                    lv, = exe.run(t.get_trainer_program(),
                                  feed=_ctr_batch(rng, 64),
                                  fetch_list=[loss], scope=scope)
                    out.append(float(np.asarray(lv).reshape(-1)[0]))
                losses[tid] = out
                local.pool.close()
            except BaseException as e:  # surfaced below
                errors.append(e)

        ts = [threading.Thread(target=trainer, args=(i,)) for i in range(2)]
        for th in ts:
            th.start()
        for th in ts:
            th.join(timeout=120)
        monkeypatch.undo()
        assert not errors, errors
        results[name] = (losses, _params_of(mod, eps, t))
        _stop_cluster(name, eps, threads)
    (jl, jp), (tl, tp) = results["jax"], results["port"]
    for tid in range(2):
        np.testing.assert_allclose(tl[tid], jl[tid], rtol=1e-4, atol=ATOL)
    assert sorted(tp) == sorted(jp)
    for n in jp:
        np.testing.assert_allclose(tp[n], jp[n], rtol=1e-4, atol=ATOL)


# ---------------------------------------------------------------------------
# async mode, snapshots, elastic verbs
# ---------------------------------------------------------------------------


def test_variable_server_async_mode():
    scope = fluid.Scope()
    scope.set_var("w", torch.ones(4))
    scope.set_var("v", torch.ones(3))
    scope.set_var("pserver_lr", torch.tensor([0.1]))
    prog = fluid.Program()
    with fluid.program_guard(prog, fluid.Program()):
        blk = prog.global_block()
        for pn, gn, n in (("w", "w@GRAD", 4), ("v", "v@GRAD", 3)):
            blk.create_var(name=pn, shape=[n], dtype="float32",
                           persistable=True)
            blk.create_var(name=gn, shape=[n], dtype="float32",
                           persistable=True)
            blk.append_op("sgd", {"Param": [pn], "Grad": [gn],
                                  "LearningRate": ["pserver_lr"]},
                          {"ParamOut": [pn]}, {})
        blk.create_var(name="pserver_lr", shape=[1], dtype="float32",
                       persistable=True)
    server = ps.VariableServer(prog, scope, fluid.Executor(fluid.CPUPlace()),
                               fan_in=99, sync=False)
    c = ps.VariableClient(f"127.0.0.1:{server.serve(0)}", client_id="t0")
    c.send_var("w@GRAD", torch.full((4,), 1.0))
    c.send_var("w@GRAD", torch.full((4,), 1.0))
    c.send_var("v@GRAD", torch.full((3,), 2.0))
    w, v = c.get_var("w").numpy(), c.get_var("v").numpy()
    c.close()
    server.stop()
    np.testing.assert_allclose(w, 1.0 - 0.1 * 2.0, rtol=1e-6)
    np.testing.assert_allclose(v, 1.0 - 0.1 * 2.0, rtol=1e-6)


def test_variable_server_async_adam_epilogue_as_the_jax_package():
    """The epilogue (Adam's beta-pow scales, reachable from no grad)
    runs once per full sweep of distinct grads; the port's server ends
    where the JAX package's does."""
    got = {}
    for name in ("jax", "port"):
        pkg, fw, mod, _, _ = PKGS[name]
        fw.reset_unique_names()
        scope = pkg.Scope()
        prog, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(prog, startup):
            w = pkg.layers.create_parameter(
                [4], "float32", name="aw",
                default_initializer=pkg.initializer.Constant(1.0))
            g = prog.global_block().create_var(
                name="aw@GRAD", shape=[4], dtype="float32",
                persistable=True)
            g.stop_gradient = True
            pkg.Adam(learning_rate=0.1).create_optimization_pass(
                [(w, g)], w)
        exe = pkg.Executor(pkg.CPUPlace())
        exe.run(startup, scope=scope)
        b2name = [n for n in scope.local_names() if "beta2_pow" in n][0]
        b2_0 = float(_np(scope.find_var(b2name)).reshape(-1)[0])
        server = mod.VariableServer(prog, scope, exe, sync=False)
        c = mod.VariableClient(f"127.0.0.1:{server.serve(0)}",
                               client_id="t0")
        for _ in range(3):
            c.send_var("aw@GRAD", _wrap(pkg, np.full(4, 0.5, np.float32)))
        got[name] = _np(c.get_var("aw"))
        c.close()
        server.stop()
        b2_3 = float(_np(scope.find_var(b2name)).reshape(-1)[0])
        np.testing.assert_allclose(b2_3, b2_0 * 0.999 ** 3, rtol=1e-5)
    assert not np.allclose(got["port"], 1.0)
    np.testing.assert_allclose(got["port"], got["jax"], rtol=RTOL,
                               atol=ATOL)


def test_variable_server_async_rejects_multi_grad_op():
    scope = fluid.Scope()
    prog = fluid.Program()
    with fluid.program_guard(prog, fluid.Program()):
        blk = prog.global_block()
        for n in ("mw", "g1", "g2", "gsum", "mlr"):
            blk.create_var(name=n, shape=[4] if n != "mlr" else [1],
                           dtype="float32", persistable=True)
        blk.append_op("sum", {"X": ["g1", "g2"]}, {"Out": ["gsum"]}, {})
        for gname in ("gsum", "g1", "g2"):
            blk.append_op("sgd", {"Param": ["mw"], "Grad": [gname],
                                  "LearningRate": ["mlr"]},
                          {"ParamOut": ["mw"]}, {})
    with pytest.raises(ValueError, match="multi-grad"):
        ps.VariableServer(prog, scope, fluid.Executor(fluid.CPUPlace()),
                          sync=False)


def test_shard_snapshot_restart_and_a_jax_snapshot_restores(tmp_path):
    """The server snapshots its own shard every `snapshot_every` rounds;
    a replacement pointed at the same directory resumes there — from a
    port snapshot, and from one a JAX pserver wrote."""
    for writer in ("port", "jax"):
        snap = str(tmp_path / f"shard_{writer}")
        wpkg = PKGS[writer][0]
        srv, ep = _sgd_server(wpkg, {"w": np.ones(4, np.float32)},
                              snapshot_dir=snap, snapshot_every=2)
        c = PKGS[writer][2].VariableClient(ep, client_id="t0")
        for _ in range(4):     # 4 rounds -> 2 snapshots
            c.send_var("w@GRAD", _wrap(wpkg, np.ones(4, np.float32)))
            c.send_batch_barrier()
        w4 = _np(c.get_var("w"))
        np.testing.assert_allclose(w4, 1.0 - 4 * 0.1, rtol=1e-6)
        c.close()
        srv.stop()         # the "crash"
        srv2, ep2 = _sgd_server(fluid, {"w": np.ones(4, np.float32)},
                                snapshot_dir=snap, snapshot_every=2)
        assert srv2._round == 4
        restored = srv2.scope.find_var("w")
        assert restored.dtype == torch.float32
        np.testing.assert_allclose(restored.numpy(), w4, rtol=1e-6)
        c2 = ps.VariableClient(ep2, client_id="t0")
        c2.send_var("w@GRAD", torch.ones(4))
        c2.send_batch_barrier()
        np.testing.assert_allclose(c2.get_var("w").numpy(),
                                   1.0 - 5 * 0.1, rtol=1e-6)
        c2.close()
        srv2.stop()


def test_fence_holds_rounds_until_commit_which_sets_fan_in():
    """An elastic server: between FENCE and COMMIT no optimize runs (a
    barrier arriving mid-transition holds), COMMIT releases it without
    applying the pre-view grads, and COMMIT's fan_in rules the next
    round."""
    w0 = np.full(4, 2.0, np.float32)
    srv, ep = _sgd_server(fluid, {"w": w0}, fan_in=2, elastic=True)
    c = ps.VariableClient(ep, client_id="survivor")
    ctl = ps.VariableClient(ep, client_id="ctl")
    try:
        ctl.fence(epoch=1)
        state = {"done": False}

        def round_():
            c.send_vars([("w@GRAD", torch.ones(4))])
            c.send_batch_barrier()
            state["done"] = True

        th = threading.Thread(target=round_, daemon=True)
        th.start()
        time.sleep(0.3)
        assert not state["done"]   # fenced, and waiting for a peer
        ctl.commit(epoch=1, fan_in=1)
        th.join(timeout=10)
        assert state["done"]
        np.testing.assert_allclose(c.get_vars(["w"])[0].numpy(), w0,
                                   rtol=1e-6)    # the round was lost
        c.send_vars([("w@GRAD", torch.ones(4))])
        c.send_batch_barrier()     # fan_in 1 now: one barrier optimizes
        np.testing.assert_allclose(c.get_vars(["w"])[0].numpy(), w0 - 0.1,
                                   rtol=1e-6)
    finally:
        c.close()
        ctl.close()
        srv.stop()


@pytest.mark.parametrize("server", ["port", "jax"])
def test_put_drop_have_verbs(server):
    spkg = PKGS[server][0]
    srv, ep = _sgd_server(spkg, {"w": np.full(4, 2.0, np.float32)})
    c = ps.VariableClient(ep, client_id="t0")
    try:
        moved = c.put_vars([("fresh", torch.arange(4, dtype=torch.float32))])
        assert moved == 16
        assert c.get_vars(["fresh"])[0].tolist() == [0.0, 1.0, 2.0, 3.0]
        assert c.have_vars(["fresh", "w", "nope"]) == {"fresh", "w"}
        c.send_vars([("w@GRAD", torch.ones(4))])  # makes a grad slot
        c.drop_vars(["w"])
        assert not srv.scope.has_var("w")
        assert not any(n.startswith("w@GRAD.trainer_")
                       for n in srv.scope.local_names())
        with pytest.raises(RuntimeError):
            c.get_vars(["w"])
    finally:
        c.close()
        srv.stop()


def test_flight_record_and_the_telemetry_announce(monkeypatch):
    srv, ep = _sgd_server(fluid, {"w": np.ones(2, np.float32)})
    c = ps.VariableClient(ep)
    try:
        rec = c.get_flight_record()
        assert "armed" in rec and rec["reason"] == "wire"
    finally:
        c.close()
        srv.stop()
    # with PADDLE_TPU_TELEMETRY_REGISTRY set, serving announces the
    # process as a "pserver" member that a collector discovers
    from paddle_tpu_torch.cloud.registry import Registry
    from paddle_tpu_torch.observability import collector

    reg = Registry()
    monkeypatch.setenv("PADDLE_TPU_TELEMETRY_REGISTRY",
                       f"127.0.0.1:{reg.serve(0)}")
    monkeypatch.setattr(collector, "_ENV_TRIED", False)
    monkeypatch.setattr(collector, "_ENV_ANNOUNCEMENT", None)
    srv = ps.VariableServer(None, fluid.Scope(), None)
    coll = None
    try:
        srv.serve(0)
        ann = collector._ENV_ANNOUNCEMENT
        assert ann is not None and ann.kind == "pserver"
        coll = collector.TelemetryCollector(registry=reg)
        coll.scrape_once()
        assert [m["kind"] for m in coll.members()] == ["pserver"]
    finally:
        srv.stop()
        if coll is not None:
            coll.close()
        if collector._ENV_ANNOUNCEMENT is not None:
            collector._ENV_ANNOUNCEMENT.close()
        reg.close()
