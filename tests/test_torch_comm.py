"""The port's fused, pipelined pserver communication (parallel/comm.py
and the SEND_BATCH/GET_BATCH wire verbs of parallel/pserver.py), on the
CPU, as tests/test_comm.py holds the JAX package's.

Wire-compat matrix pinned here:
  * per-var frames and payloads are the JAX package's bytes;
  * old client <-> new server: the per-var verbs are still served;
  * new client <-> old server: ERR "unknown verb" drops the client to
    per-var frames, permanently for that endpoint;
  * batch <-> batch leaves byte-identical final params vs the per-var
    baseline path.
Instead of tests/test_comm.py's load-sensitive speed ratio, the frames
a round takes, by verb, and the buckets the packer closes are pinned.
Servers run in threads of the test process.
"""
import json
import struct
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as fluid
from paddle_tpu.parallel import pserver as jps
from paddle_tpu_torch.parallel import comm, distributed_spliter
from paddle_tpu_torch.parallel import pserver as ps
from paddle_tpu_torch.parallel.pserver import (
    VariableClient,
    _frame_bytes,
    _join_parts,
    deserialize_batch,
    deserialize_var,
    serialize_batch_parts,
    serialize_var,
)


def _t(a):
    return torch.from_numpy(np.array(a))


def _server(params, fan_in=1, sync=True, enable_batch=True, lr=0.1,
            pkg=fluid):
    """VariableServer of package `pkg` over an sgd-per-param optimize
    program.  `params`: {name: init ndarray}; grads are `<name>@GRAD`."""
    wrap = _t if pkg is fluid else np.array
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
            blk.append_op("sgd",
                          {"Param": [n], "Grad": [n + "@GRAD"],
                           "LearningRate": ["lr"]},
                          {"ParamOut": [n]}, {})
    scope.set_var("lr", wrap(np.asarray([lr], np.float32)))
    for n, v in params.items():
        scope.set_var(n, wrap(v))
    server_cls = (ps if pkg is fluid else jps).VariableServer
    srv = server_cls(prog, scope, pkg.Executor(pkg.CPUPlace()),
                     fan_in=fan_in, sync=sync, enable_batch=enable_batch)
    port = srv.serve(0)
    return srv, f"127.0.0.1:{port}"


# ---------------------------------------------------------------------------
# wire format: frames pinned byte-for-byte
# ---------------------------------------------------------------------------


def test_legacy_frame_and_payload_bytes_pinned():
    x = torch.arange(4, dtype=torch.float32)
    vhead = json.dumps({"dtype": "float32", "shape": [4],
                        "lod": None}).encode()
    payload = serialize_var(x)
    assert payload == (struct.pack("<I", len(vhead)) + vhead +
                       x.numpy().tobytes())
    fhead = json.dumps({"verb": "SEND", "name": "w"}).encode()
    assert _frame_bytes("SEND", "w", payload) == (
        struct.pack("<I", len(fhead)) + struct.pack("<I", len(payload)) +
        fhead + payload)
    assert _frame_bytes("SEND", "w", payload) == jps._frame_bytes(
        "SEND", "w", jps.serialize_var(np.arange(4, dtype=np.float32)))


def test_batch_payload_roundtrip_all_kinds():
    from paddle_tpu_torch.core.lod import LoDTensor, SelectedRows

    x = torch.from_numpy(np.random.RandomState(0).rand(3, 4)
                         .astype(np.float32))
    lt = LoDTensor(x.clone(), [(0, 1, 3)])
    sr = SelectedRows(torch.tensor([4, 1]), x[:2].clone(), height=16)
    items = [("a", x), ("lt", lt), ("sr", sr)]
    blob = bytearray(_join_parts(serialize_batch_parts(items)))
    pairs = deserialize_batch(blob)
    assert [n for n, _ in pairs] == ["a", "lt", "sr"]
    torch.testing.assert_close(pairs[0][1], x, rtol=0, atol=0)
    torch.testing.assert_close(pairs[1][1].data, x, rtol=0, atol=0)
    assert tuple(pairs[1][1].lod) == ((0, 1, 3),)
    assert pairs[2][1].rows.tolist() == [4, 1]
    assert pairs[2][1].rows.dtype == torch.int64
    assert pairs[2][1].height == 16


def test_deserialize_var_copy_semantics():
    """copy=False returns a view of the caller-owned buffer (the batch
    path slices one frame buffer); the default still copies."""
    x = torch.arange(4, dtype=torch.float32)
    buf = bytearray(serialize_var(x))
    view = deserialize_var(buf, copy=False)
    owned = deserialize_var(bytes(buf), copy=True)
    buf[-4:] = struct.pack("<f", 99.0)
    assert float(view[-1]) == 99.0
    assert float(owned[-1]) == 3.0


# ---------------------------------------------------------------------------
# compat matrix over real sockets
# ---------------------------------------------------------------------------


def test_batch_client_batch_server_round():
    params = {f"w{i}": np.full(8, float(i + 1), np.float32)
              for i in range(6)}
    srv, ep = _server(params)
    c = VariableClient(ep, client_id="t0")
    grads = {n + "@GRAD": _t(np.full(8, 0.5, np.float32)) for n in params}
    # tiny cap -> several buckets in one send_vars call
    c.send_vars(list(grads.items()), bucket_bytes=2 * 8 * 4)
    c.send_batch_barrier()
    got = c.get_vars(list(params))
    assert c._batch_supported is True
    # 6 grads of 32 B under a 64 B cap: 3 SEND_BATCH frames, one
    # barrier, one GET_BATCH (with the HELLO of the connect)
    assert c.frames == {"SEND_BATCH": 3, "BARRIER": 1, "GET_BATCH": 1}
    for n, v in zip(params, got):
        np.testing.assert_allclose(v.numpy(), params[n] - 0.1 * 0.5,
                                   rtol=1e-6)
    c.close()
    srv.stop()


def test_old_client_new_server_legacy_verbs():
    params = {"w": np.ones(4, np.float32)}
    srv, ep = _server(params)
    c = VariableClient(ep, client_id="t0")
    c.send_var("w@GRAD", _t(np.full(4, 2.0, np.float32)))
    c.send_batch_barrier()
    got = c.get_var("w")
    np.testing.assert_allclose(got.numpy(), 1.0 - 0.1 * 2.0, rtol=1e-6)
    c.close()
    srv.stop()


def test_new_client_old_server_falls_back_per_var():
    params = {f"w{i}": np.ones(4, np.float32) for i in range(5)}
    srv, ep = _server(params, enable_batch=False)
    c = VariableClient(ep, client_id="t0")
    grads = [(n + "@GRAD", _t(np.full(4, 1.0, np.float32)))
             for n in params]
    c.send_vars(grads)
    assert c._batch_supported is False
    c.send_batch_barrier()
    got = c.get_vars(list(params))
    for v in got:
        np.testing.assert_allclose(v.numpy(), 0.9, rtol=1e-6)
    # the one rejected probe, then per-var frames only
    assert c.frames == {"SEND_BATCH": 1, "SEND": 5, "BARRIER": 1,
                        "GET": 5}
    c.close()
    srv.stop()


def test_get_vars_falls_back_when_only_gets_probe():
    params = {"a": np.full(4, 3.0, np.float32),
              "b": np.full(4, 5.0, np.float32)}
    srv, ep = _server(params, enable_batch=False)
    c = VariableClient(ep, client_id="t0")
    got = c.get_vars(["a", "b"])
    assert c._batch_supported is False
    np.testing.assert_allclose(got[0].numpy(), 3.0)
    np.testing.assert_allclose(got[1].numpy(), 5.0)
    c.close()
    srv.stop()


def test_batch_vs_pervar_final_params_byte_identical():
    """The fused path is a pure transport change: N rounds through
    arrival-order buckets + concurrent endpoints leave EXACTLY the bytes
    the per-var serial baseline leaves."""
    names = [f"p{i}" for i in range(8)]
    rng = np.random.RandomState(3)
    init = {n: rng.rand(16).astype(np.float32) for n in names}
    rounds = [{n: rng.rand(16).astype(np.float32) for n in names}
              for _ in range(3)]

    def final_params(bucketed):
        servers, eps = [], []
        for half in (names[:4], names[4:]):
            srv, ep = _server({n: init[n] for n in half})
            servers.append(srv)
            eps.append(ep)
        owner = {n: eps[0] if n in names[:4] else eps[1] for n in names}
        try:
            if bucketed:
                pool = comm.CommPool()
                for grads in rounds:
                    pool.send_round(
                        [(owner[n], n + "@GRAD", _t(grads[n]))
                         for n in names],
                        [(owner[n], n) for n in names])
                vals = pool.send_round([], [(owner[n], n) for n in names])
                out = {n: v.numpy().tobytes() for n, v in zip(names, vals)}
                pool.close()
            else:
                clients = {ep: VariableClient(ep, client_id="t0")
                           for ep in eps}
                for grads in rounds:
                    for n in names:
                        clients[owner[n]].send_var(n + "@GRAD",
                                                   _t(grads[n]))
                    for ep in eps:
                        clients[ep].send_batch_barrier()
                    for n in names:
                        clients[owner[n]].get_var(n)
                out = {n: clients[owner[n]].get_var(n).numpy().tobytes()
                       for n in names}
                for c in clients.values():
                    c.close()
            return out
        finally:
            for s in servers:
                s.stop()

    assert final_params(bucketed=True) == final_params(bucketed=False)


def test_get_batch_too_large_falls_back_per_var(monkeypatch):
    params = {"a": np.full(64, 3.0, np.float32),
              "b": np.full(64, 5.0, np.float32)}
    srv, ep = _server(params)
    c = VariableClient(ep, client_id="t0")
    # between one per-var reply (~350 B) and the 2-var batch reply
    # (~750 B): the batch overflows, singles still fit the frame cap
    monkeypatch.setattr(ps, "_MAX_PAYLOAD", 600)
    got = c.get_vars(["a", "b"])
    assert c._batch_supported is not False  # endpoint still batch-able
    np.testing.assert_allclose(got[0].numpy(), 3.0)
    np.testing.assert_allclose(got[1].numpy(), 5.0)
    c.close()
    srv.stop()


def test_send_batch_async_server_applies_each_once():
    params = {"w": np.ones(4, np.float32), "v": np.ones(3, np.float32)}
    srv, ep = _server(params, fan_in=99, sync=False)
    c = VariableClient(ep, client_id="t0")
    c.send_vars([("w@GRAD", _t(np.full(4, 1.0, np.float32))),
                 ("v@GRAD", _t(np.full(3, 2.0, np.float32)))])
    w, v = c.get_vars(["w", "v"])
    np.testing.assert_allclose(w.numpy(), 1.0 - 0.1 * 1.0, rtol=1e-6)
    np.testing.assert_allclose(v.numpy(), 1.0 - 0.1 * 2.0, rtol=1e-6)
    c.close()
    srv.stop()


def test_commpool_preserves_interleaved_get_order():
    srv_a, ep_a = _server({"a0": np.full(2, 1.0, np.float32),
                           "a1": np.full(2, 2.0, np.float32)})
    srv_b, ep_b = _server({"b0": np.full(2, 3.0, np.float32)})
    pool = comm.CommPool()
    try:
        vals = pool.send_round(
            [], [(ep_a, "a0"), (ep_b, "b0"), (ep_a, "a1")])
        assert [float(v[0]) for v in vals] == [1.0, 3.0, 2.0]
    finally:
        pool.close()
        srv_a.stop()
        srv_b.stop()


def test_send_op_multi_endpoint_epmap():
    """Full layer/op path: one fused send op routing two grads to two
    different pservers via epmap; the pulled params land in the tensors
    the scope held (the next step reads them where it read the old)."""
    from paddle_tpu_torch.ops.distributed import reset_clients

    srv_a, ep_a = _server({"wa": np.full(4, 2.0, np.float32)}, lr=0.5)
    srv_b, ep_b = _server({"wb": np.full(4, 4.0, np.float32)}, lr=0.5)
    try:
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            ga = fluid.layers.data(name="wa@GRAD", shape=[4],
                                   dtype="float32", append_batch_size=False)
            gb = fluid.layers.data(name="wb@GRAD", shape=[4],
                                   dtype="float32", append_batch_size=False)
            blk = main.global_block()
            wa = blk.create_var(name="wa", shape=[4], dtype="float32")
            wb = blk.create_var(name="wb", shape=[4], dtype="float32")
            # out_epmap omitted: it follows epmap
            fluid.layers.Send([ep_a, ep_b], [ga, gb], [wa, wb],
                              epmap=[ep_a, ep_b])
        scope = fluid.Scope()
        held = torch.zeros(4)
        scope.set_var("wa", held)
        exe = fluid.Executor(fluid.CPUPlace())
        oa, ob = exe.run(
            main, feed={"wa@GRAD": np.ones(4, np.float32),
                        "wb@GRAD": np.full(4, 2.0, np.float32)},
            fetch_list=[wa, wb], scope=scope)
        np.testing.assert_allclose(oa, 2.0 - 0.5 * 1.0, rtol=1e-6)
        np.testing.assert_allclose(ob, 4.0 - 0.5 * 2.0, rtol=1e-6)
        assert scope.find_var("wa") is held
        np.testing.assert_allclose(held.numpy(), 1.5, rtol=1e-6)
    finally:
        reset_clients()
        srv_a.stop()
        srv_b.stop()


# ---------------------------------------------------------------------------
# placement + transpiler + lint
# ---------------------------------------------------------------------------


class _V:
    def __init__(self, name, shape, dtype="float32"):
        self.name = name
        self.shape = shape
        self.dtype = dtype


def test_balanced_split_weights_bytes_not_counts():
    from paddle_tpu.parallel import distributed_spliter as jsplit

    vs = []
    for i in range(4):
        vs.append(_V(f"w{i}", [256, 256]))
        vs.append(_V(f"b{i}", [256], "bfloat16" if i % 2 else "float32"))
    eps = ["a:1", "b:2"]
    for policy in ("round_robin", "hash_name", "balanced_split"):
        assert getattr(distributed_spliter, policy)(vs, eps) == \
            getattr(jsplit, policy)(vs, eps), policy
    assert distributed_spliter.placement_map(vs, eps) == \
        jsplit.placement_map(vs, eps)
    rr = distributed_spliter.round_robin(vs, eps)
    assert set(ep for v, ep in zip(vs, rr) if v.name[0] == "w") == {"a:1"}
    got = distributed_spliter.balanced_split(vs, eps)
    assert {ep for v, ep in zip(vs, got) if v.name[0] == "w"} == set(eps)


def test_transpiler_emits_one_fused_send():
    eps = ["127.0.0.1:7001", "127.0.0.1:7002"]
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        pred = fluid.layers.fc(input=x, size=8, act=None)
        pred = fluid.layers.fc(input=pred, size=1, act=None)
        loss = fluid.layers.mean(
            fluid.layers.square_error_cost(input=pred, label=y))
        opt_ops, pg = fluid.SGD(learning_rate=0.1).minimize(loss)
    t = fluid.DistributeTranspiler()
    with fluid.program_guard(main, startup):
        t.transpile(optimize_ops=opt_ops, params_grads=pg, trainers=1,
                    pservers=",".join(eps))
    sends = [op for op in main.global_block().ops if op.type == "send"]
    assert len(sends) == 1
    op = sends[0]
    assert op.attrs["endpoints"] == eps
    assert len(op.attrs["epmap"]) == len(op.input("X")) == len(pg)
    assert op.attrs["epmap"] == op.attrs["out_epmap"]
    assert set(op.attrs["epmap"]) <= set(eps)
    diags = [d for d in main.verify(level=None)
             if d.pass_id == "distributed-lint"
             and d.severity in ("error", "warning")]
    assert not diags, diags
    # the trainer's startup pulls each pserver's params once; the
    # pservers' startup does not
    recvs = [op for op in startup.global_block().ops if op.type == "recv"]
    assert sorted(op.attrs["endpoint"] for op in recvs) == sorted(eps)
    assert sorted(n for op in recvs for n in op.output("Out")) == \
        sorted(p.name for p, _ in pg)
    assert "recv" not in [op.type for op in t.get_startup_program(eps[0])
                          .global_block().ops]


def test_lint_send_arity_and_mixed_sends_as_the_jax_package():
    for pkg in (jfluid, fluid):
        p = pkg.Program()
        b = p.global_block()
        b.append_op("send", {"X": ["g"]}, {"Out": ["p0", "p1"]},
                    {"endpoints": ["h:1"], "epmap": ["h:1"],
                     "out_epmap": ["h:1"]})
        ds = [d for d in p.verify(level=None)
              if d.pass_id == "distributed-lint" and d.severity == "error"]
        assert any("out_epmap" in d.message for d in ds), pkg
        p = pkg.Program()
        b = p.global_block()
        b.append_op("send", {"X": ["g0"]}, {"Out": ["p0"]},
                    {"endpoints": ["h:1"], "epmap": ["h:1"]})
        b.append_op("send", {"X": ["g1"]}, {"Out": ["p1"]},
                    {"endpoints": ["h:1"], "epmap": []})
        ds = [d for d in p.verify(level=None)
              if d.pass_id == "distributed-lint"
              and d.severity == "warning" and "mixes bucketed" in d.message]
        assert len(ds) == 1, pkg


# ---------------------------------------------------------------------------
# fan-in, frame counts, the cluster that waits for its slice
# ---------------------------------------------------------------------------


def test_two_trainer_fan_in_with_batched_sends():
    params = {"w": np.ones(4, np.float32)}
    srv, ep = _server(params, fan_in=2)
    g = [np.full(4, 1.0, np.float32), np.full(4, 3.0, np.float32)]
    results = {}

    def trainer(tid):
        c = VariableClient(ep, client_id=f"t{tid}")
        c.send_vars([("w@GRAD", _t(g[tid]))])
        c.send_batch_barrier()
        results[tid] = c.get_vars(["w"])[0].numpy()
        c.close()

    ts = [threading.Thread(target=trainer, args=(i,)) for i in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    srv.stop()
    assert len(results) == 2, "a trainer hung in the fan-in round"
    for got in results.values():
        np.testing.assert_allclose(got, 1.0 - 0.1 * (g[0] + g[1]),
                                   rtol=1e-6)


@pytest.mark.parametrize("cap", [0, 256, 1 << 20])
def test_round_frames_and_buckets_pinned(cap):
    """2 pservers x 32 grads of 64 B, one CommPool round: the frames each
    endpoint takes, by verb, under the bucket cap (0 = per-var)."""
    names = [f"g{i}" for i in range(32)]
    servers, eps = [], []
    for half in (names[:16], names[16:]):
        srv, ep = _server({n: np.zeros(16, np.float32) for n in half})
        servers.append(srv)
        eps.append(ep)
    owner = {n: eps[i // 16] for i, n in enumerate(names)}
    pool = comm.CommPool()
    try:
        pool.send_round([(owner[n], n + "@GRAD", _t(np.ones(16, np.float32)))
                         for n in names], [(owner[n], n) for n in names],
                        bucket_bytes=cap)
        frames = [pool.client(ep).frames for ep in eps]
    finally:
        pool.close()
        for s in servers:
            s.stop()
    if cap == 0:
        want = {"SEND": 16, "BARRIER": 1, "GET": 16}
    elif cap == 256:
        # a grad's 64 raw bytes count against the cap (its head does
        # not): 4 vars fill a 256 B bucket -> 16 / 4 frames
        want = {"SEND_BATCH": 4, "BARRIER": 1, "GET_BATCH": 1}
    else:
        want = {"SEND_BATCH": 1, "BARRIER": 1, "GET_BATCH": 1}
    assert frames == [want, want]


def test_the_elastic_cluster_waits_for_a11s_second_slice(monkeypatch):
    """A11's second slice is here: set_cluster and a
    PADDLE_TPU_CONTROLLER environment arm a ClusterClient subscription
    (tests/test_torch_elastic.py drives it) instead of raising."""
    from paddle_tpu_torch.cloud.cluster import ClusterClient

    comm.reset_cluster()
    assert comm.get_cluster() is None
    assert comm.set_cluster(None) is None
    c = comm.set_cluster("127.0.0.1:1")
    assert isinstance(c, ClusterClient) and comm.get_cluster() is c
    with pytest.raises(TypeError):
        comm.set_cluster(object())
    comm.reset_cluster()
    monkeypatch.setenv("PADDLE_TPU_CONTROLLER", "127.0.0.1:1")
    c = comm.get_cluster()
    assert isinstance(c, ClusterClient) and c._addr == ("127.0.0.1", 1)
    monkeypatch.delenv("PADDLE_TPU_CONTROLLER")
    comm.reset_cluster()
    assert comm.get_cluster() is None
