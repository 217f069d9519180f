"""The port's cloud services (paddle_tpu_torch/cloud: the task-dispatch
master, the TTL-lease registry, cloud_reader) and its launcher
(paddle_tpu_torch/launch.py), on the CPU, against the JAX package's.

  * the master: the cases of tests/test_cloud_master.py — the same
    dispatch script gives the JAX master's tasks and counts, over TCP a
    port client drives a JAX master and a JAX client a port one, a JAX
    master's snapshot recovers into a port master;
  * cloud_reader yields the JAX package's records for the same chunks,
    two readers of one master share the pass;
  * the registry: the cases of tests/test_registry.py that need no
    elastic cluster (lowest free index, TTL expiry, WAIT, the TCP client
    and lease keep-alive across packages, a pserver's failover through
    the registry), and resolve_pserver_cluster for both roles;
  * the launcher: a 2-pserver, 2-trainer fit_a_line job as real
    subprocesses (marked slow, as tests/test_launcher.py is: four fresh
    interpreters importing torch take tens of seconds).
"""
import os
import subprocess
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu.cloud.master as jmaster
import paddle_tpu.cloud.registry as jregistry
import paddle_tpu.reader as jreader
import paddle_tpu_torch as fluid
import paddle_tpu_torch.reader as treader
from paddle_tpu_torch.cloud import (Lease, Master, MasterClient, Registry,
                                    RegistryClient, resolve_pserver_cluster,
                                    task_record_reader)
from paddle_tpu_torch.parallel import pserver as ps

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MASTERS = {"jax": (jmaster.Master, jmaster.MasterClient),
           "port": (Master, MasterClient)}


# ---------------------------------------------------------------------------
# the master
# ---------------------------------------------------------------------------


def _dispatch_script(m):
    """tests/test_cloud_master.py's in-process cases on master `m`
    (failure_max=2) -> what each step answered."""
    out = []
    m.set_dataset([f"chunk{i}" for i in range(7)], chunks_per_task=3)
    m.set_dataset(["ignored"])          # idempotent: already set
    out.append(m.counts())
    tid, chunks = m.get_task()
    out.append((tid, chunks, m.counts()["pending"]))
    out.append((m.task_finished(tid), m.task_finished(tid)))  # double ack
    tid, chunks = m.get_task()
    for _ in range(3):                  # failures 1, 2, then discard
        out.append((tid, m.task_failed(tid)))
        got = m.get_task()
        if got is None:
            break
        tid, chunks = got
        out.append(chunks)
    out.append(m.counts())
    while (got := m.get_task()) is not None and m.counts()["pass"] == 0:
        m.task_finished(got[0])
        out.append(got[1])
    out.append(m.counts())
    return out


def test_master_dispatch_is_the_jax_masters():
    assert _dispatch_script(Master(failure_max=2, timeout_s=60)) == \
        _dispatch_script(jmaster.Master(failure_max=2, timeout_s=60))


def test_master_timeout_requeue():
    m = Master(failure_max=5, timeout_s=0.1)
    m.set_dataset(["a", "b"])
    t1 = m.get_task()
    assert m.counts()["pending"] == 1
    time.sleep(0.15)
    assert m.counts()["pending"] == 0 and m.counts()["todo"] == 2
    ids = set()
    while (got := m.get_task()) is not None:
        ids.add(got[0])
    assert t1[0] in ids


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_master_snapshot_recovers_into_the_port(tmp_path, writer):
    snap = str(tmp_path / "master.snap")
    m = MASTERS[writer][0](failure_max=3, timeout_s=60, snapshot_path=snap)
    m.set_dataset(["a", "b", "c"])
    tid, _ = m.get_task()
    m.task_finished(tid)
    m.get_task()                        # left pending: re-dispatched
    del m
    m2 = Master(failure_max=3, timeout_s=60, snapshot_path=snap)
    assert m2.has_dataset
    c = m2.counts()
    assert (c["done"], c["todo"], c["pending"]) == (1, 2, 0)


@pytest.mark.parametrize("client,server", [("port", "jax"), ("jax", "port"),
                                           ("port", "port")])
def test_master_over_tcp_across_packages(client, server):
    m = MASTERS[server][0](failure_max=3, timeout_s=60)
    port = m.serve(0)
    cl = MASTERS[client][1](f"127.0.0.1:{port}")
    try:
        assert cl.set_dataset([f"c{i}" for i in range(4)], 2)
        assert cl.info()["todo"] == 2
        tid, chunks = cl.get_task()
        assert chunks == ["c0", "c1"]
        assert cl.task_finished(tid)
        tid2, _ = cl.get_task()
        assert cl.task_failed(tid2)
        info = cl.info()
        assert info["done"] == 1 and info["todo"] == 1
    finally:
        cl.close()
        m.stop()


def test_task_record_reader_two_readers_share_a_pass():
    m = Master(failure_max=3, timeout_s=60)
    port = m.serve(0)
    m.set_dataset([str(i) for i in range(6)])
    got, errors = [], []

    def reader():
        cl = MasterClient(f"127.0.0.1:{port}")
        try:
            for r in task_record_reader(
                    cl, lambda c: range(int(c) * 10, int(c) * 10 + 3))():
                got.append(r)
        except BaseException as e:
            errors.append(e)
        finally:
            cl.close()

    ts = [threading.Thread(target=reader) for _ in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    m.stop()
    assert not errors
    # every record at least once; the pass rollover racing the second
    # reader's last poll may serve a few twice (the reference's master
    # behaves the same way)
    assert set(got) == {r for i in range(6)
                        for r in range(i * 10, i * 10 + 3)}
    # in-process: the reader against the Master object itself
    m2 = Master()
    m2.set_dataset(["x", "y"])
    assert sorted(task_record_reader(m2, lambda c: [c + "0", c + "1"])()) \
        == ["x0", "x1", "y0", "y1"]


def test_cloud_reader_yields_the_jax_packages_records(tmp_path):
    chunks = []
    for c in range(4):
        path = str(tmp_path / f"part{c}.rec")
        treader.creator.write_recordio(
            path, [(c, i, np.full(2, c + i, np.float32)) for i in range(3)])
        chunks.append(path)
    pattern = str(tmp_path / "part*.rec")
    out = {}
    for name, creator in (("jax", jreader.creator),
                          ("port", treader.creator)):
        m = MASTERS[name][0](timeout_s=30.0)
        r = creator.cloud_reader(pattern, f"127.0.0.1:{m.serve(0)}")
        out[name] = [(a, b, v.tolist()) for a, b, v in r()]
        r.master_client.close()
        m.stop()
    assert out["port"] == out["jax"]
    assert len(out["port"]) == 12


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------


def test_register_lowest_free_index_and_desired_limit():
    reg = Registry()
    try:
        reg.set_desired("ps", 2)
        i0, l0 = reg.register("ps", "h:1", ttl_s=5)
        i1, l1 = reg.register("ps", "h:2", ttl_s=5)
        assert (i0, i1) == (0, 1)
        with pytest.raises(RuntimeError, match="no free"):
            reg.register("ps", "h:3", ttl_s=5)
        assert reg.list("ps") == {0: "h:1", 1: "h:2"}
        assert reg.deregister("ps", 0, l0)
        assert reg.register("ps", "h:3", ttl_s=5)[0] == 0
        assert reg.heartbeat("ps", 1, l1)
        assert not reg.heartbeat("ps", 1, l1 + 999)   # wrong lease
    finally:
        reg.close()


def test_ttl_expiry_and_wait_ready():
    reg = Registry()
    try:
        assert not reg.wait_ready("ps", 1, timeout_s=0.1)
        idx, lease = reg.register("ps", "h:1", ttl_s=0.2)
        assert reg.wait_ready("ps", 1, timeout_s=0.1)
        time.sleep(0.35)
        assert reg.list("ps") == {}                 # lease expired
        assert not reg.heartbeat("ps", idx, lease)  # definitive GONE
        assert reg.register("ps", "h:2", ttl_s=5)[0] == 0
    finally:
        reg.close()


@pytest.mark.parametrize("client,server", [("port", "jax"),
                                           ("jax", "port")])
def test_tcp_client_and_lease_keepalive_across_packages(client, server):
    reg = (Registry if server == "port" else jregistry.Registry)()
    port = reg.serve(0)
    cmod = {"port": (RegistryClient, Lease),
            "jax": (jregistry.RegistryClient, jregistry.Lease)}[client]
    try:
        c = cmod[0](f"127.0.0.1:{port}")
        c.set_desired("ps", 4)
        lease = cmod[1](c, "ps", "h:9", ttl_s=0.3)
        assert lease.index == 0
        time.sleep(0.7)            # several TTLs: the heartbeats hold it
        assert not lease.lost
        assert c.list("ps") == {0: "h:9"}
        assert c.wait_ready("ps", 1, timeout_s=0.2)
        lease.release()
        assert c.list("ps") == {}
    finally:
        reg.close()


def _sgd_server(w):
    scope = fluid.Scope()
    scope.set_var("fw", torch.from_numpy(w.copy()))
    scope.set_var("flr", torch.tensor([0.1]))
    prog = fluid.Program()
    with fluid.program_guard(prog, fluid.Program()):
        blk = prog.global_block()
        for n, shape in (("fw", [4]), ("fw@GRAD", [4]), ("flr", [1])):
            blk.create_var(name=n, shape=shape, dtype="float32",
                           persistable=True)
        blk.append_op("sgd", {"Param": ["fw"], "Grad": ["fw@GRAD"],
                              "LearningRate": ["flr"]},
                      {"ParamOut": ["fw"]}, {})
    return ps.VariableServer(prog, scope, fluid.Executor(fluid.CPUPlace()))


def test_pserver_failover_via_registry():
    reg = Registry()
    rc = RegistryClient(f"127.0.0.1:{reg.serve(0)}")
    rc.set_desired("pserver", 1)
    s0 = _sgd_server(np.ones(4, np.float32))
    s1 = None
    try:
        s0.serve(0)
        s0.register_with(rc, ttl_s=0.3)
        assert rc.wait_ready("pserver", 1, timeout_s=2)
        addr = rc.list("pserver")[0]
        c = ps.VariableClient(addr, client_id="t0")
        c.send_var("fw@GRAD", torch.ones(4))
        c.send_batch_barrier()
        w1 = c.get_var("fw").numpy().copy()
        np.testing.assert_allclose(w1, 0.9, rtol=1e-6)
        c.close()
        s0._lease._stop.set()       # dies: no deregister, no heartbeat
        s0.stop()
        time.sleep(0.45)            # > TTL: the slot frees
        assert rc.list("pserver") == {}
        assert not rc.wait_ready("pserver", 1, timeout_s=0.1)
        s1 = _sgd_server(w1)        # the replacement claims index 0
        s1.serve(0)
        assert s1.register_with(rc, ttl_s=0.3).index == 0
        addr2 = rc.list("pserver")[0]
        assert addr2 != addr
        c2 = ps.VariableClient(addr2, client_id="t0")
        c2.send_var("fw@GRAD", torch.ones(4))
        c2.send_batch_barrier()
        np.testing.assert_allclose(c2.get_var("fw").numpy(), 0.8, rtol=1e-6)
        c2.close()
    finally:
        s0.stop()
        if s1 is not None:
            s1.stop()
        reg.close()


def test_resolve_pserver_cluster_for_both_roles(monkeypatch):
    reg = Registry()
    rport = reg.serve(0)
    reg.set_desired("pserver", 1)
    try:
        monkeypatch.delenv("PADDLE_TPU_REGISTRY", raising=False)
        monkeypatch.setenv("PSERVERS", "h:1,h:2")
        monkeypatch.setenv("SERVER_ENDPOINT", "h:2")
        assert resolve_pserver_cluster() == ("h:1,h:2", "h:2", None)
        monkeypatch.setenv("PADDLE_TPU_REGISTRY", f"127.0.0.1:{rport}")
        monkeypatch.setenv("PADDLE_TPU_NUM_PSERVERS", "1")
        monkeypatch.setenv("TRAINING_ROLE", "PSERVER")
        eps, mine, lease = resolve_pserver_cluster(
            ttl_s=1.0, timeout_s=5.0, exit_on_lost=False)
        assert eps == mine and lease.index == 0
        assert int(mine.rsplit(":", 1)[1]) in ps._prebound
        monkeypatch.setenv("TRAINING_ROLE", "TRAINER")
        assert resolve_pserver_cluster(timeout_s=5.0) == (eps, None, None)
        lease.release()
        ps.discard_prebound(mine)
    finally:
        reg.close()


# ---------------------------------------------------------------------------
# the launcher, with real subprocesses
# ---------------------------------------------------------------------------

_FIT_A_LINE = r'''
import os
import sys

import numpy as np

import paddle_tpu_torch as fluid
from paddle_tpu_torch.cloud.registry import resolve_pserver_cluster


def main():
    role = os.environ["TRAINING_ROLE"]
    trainers = int(os.environ["PADDLE_INIT_NUM_GRADIENT_SERVERS"])
    pservers, my_ep, _ = resolve_pserver_cluster()
    main_prog, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main_prog, startup):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        pred = fluid.layers.fc(input=x, size=1)
        loss = fluid.layers.mean(
            fluid.layers.square_error_cost(input=pred, label=y))
        opt_ops, pg = fluid.SGD(learning_rate=0.05).minimize(loss)
    t = fluid.DistributeTranspiler()
    with fluid.program_guard(main_prog, startup):
        t.transpile(optimize_ops=opt_ops, params_grads=pg,
                    trainers=trainers, pservers=pservers)
    exe = fluid.Executor(fluid.CPUPlace())
    if role == "PSERVER":
        exe.run(t.get_startup_program(my_ep))
        exe.run(t.get_pserver_program(my_ep))   # serves until stopped
        return 0
    exe.run(startup)
    rng = np.random.RandomState(int(os.environ["PADDLE_INIT_TRAINER_ID"]))
    losses = []
    for _ in range(20):
        xs = rng.rand(16, 4).astype(np.float32)
        ys = xs @ np.array([[1.0], [2.0], [3.0], [4.0]], np.float32)
        lv, = exe.run(t.get_trainer_program(), feed={"x": xs, "y": ys},
                      fetch_list=[loss])
        losses.append(float(np.asarray(lv).reshape(-1)[0]))
    print("LOSSES", losses[0], losses[-1])
    return 0 if losses[-1] < 0.5 * losses[0] else 1


sys.exit(main())
'''


@pytest.mark.slow
@pytest.mark.parametrize("mode", ["static", "registry"])
def test_launch_fit_a_line_cluster(tmp_path, monkeypatch, mode):
    """2 pservers + 2 trainers as real processes (the port's launcher,
    static endpoints or registry discovery): every trainer's loss falls
    by half."""
    from paddle_tpu_torch.launch import (launch_pserver_cluster,
                                         launch_registry_cluster)

    script = tmp_path / "fit_a_line.py"
    script.write_text(_FIT_A_LINE)
    monkeypatch.setenv("PYTHONPATH", REPO)
    reg = None
    if mode == "static":
        procs = launch_pserver_cluster(str(script), [], 2, 2,
                                       stdout=subprocess.PIPE, text=True)
    else:
        reg, procs = launch_registry_cluster(str(script), [], 2, 2)
    try:
        rcs = [p.wait(timeout=300) for role, p in procs
               if role == "trainer"]
        assert rcs == [0, 0]
        if reg is not None:
            eps = reg.list("pserver")
            assert len(eps) == 2 and len(set(eps.values())) == 2
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.terminate()
        for _, p in procs:
            try:
                p.wait(timeout=20)
            except subprocess.TimeoutExpired:
                p.kill()
        if reg is not None:
            reg.close()
