"""The port's elastic cluster (cloud/cluster.py, the FENCE / COMMIT /
PUT_BATCH / DROP / HAVE / STATE verbs, comm.elastic_round) against the
JAX package's, on the CPU: the counterparts of tests/test_elastic.py.

Fast tier: the view protocol (JSON byte-identical across packages),
membership-driven rebalancing (bootstrap consolidation, join, snapshot
and trainer-held recovery, total loss), the two-phase fence, the fused
send op routed by the view, Trainer.train(cluster=), injected
view-change and migration faults; across packages, a port trainer and
port pservers under a JAX controller and the reverse, each held to an
all-JAX cluster after every round.  The port's repairs: a parameter's
Adam state travels with it (join and snapshot restore equal the serial
Adam steps), and a replayed round is applied exactly once.

Chaos + slow tier (`-m "slow and chaos"`): real SIGKILLs of pserver
subprocesses, a join mid-run, and the 2 x 2 acceptance run that kills a
pserver and a trainer, checked against the port's
observability.metrics registry.

Servers run in threads of the test process (the slow tier's in
subprocesses); only the lease meant to expire has a short TTL, every
wait its own deadline.
"""
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as fluid
from paddle_tpu.cloud import cluster as jcluster
from paddle_tpu.parallel import comm as jcomm
from paddle_tpu.parallel import pserver as jps
from paddle_tpu_torch.cloud.cluster import (
    ClusterClient,
    ClusterController,
    ClusterView,
)
from paddle_tpu_torch.cloud.registry import Lease, RegistryClient
from paddle_tpu_torch.core.resilience import RetryPolicy, fault_injector
from paddle_tpu_torch.observability import metrics as obs_metrics
from paddle_tpu_torch.parallel import comm
from paddle_tpu_torch.parallel.distributed_spliter import (
    VarDesc,
    balanced_split,
    placement_map,
)
from paddle_tpu_torch.parallel.pserver import VariableClient, VariableServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a lease that must NOT expire mid-test (on a loaded host a starved
# heartbeat thread can outlive a 0.4 s lease and revoke a survivor)
SURVIVOR_TTL = 5.0


@pytest.fixture(autouse=True)
def _elastic_teardown():
    yield
    comm.reset_cluster()
    comm.reset_comm_pool()
    jcomm.reset_cluster()
    jcomm.reset_comm_pool()
    fault_injector().clear()


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _np(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def _opt_program(pkg, params, opt):
    """The optimize block of `opt` ("sgd" at lr 0.1, or "adam" at 1e-2)
    over `params` ({name: shape}), as the transpiler hands a pserver
    its block: the optimizer's ops (Adam's epilogue scales included)
    over persistable params, grads and states -> (program, startup)."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        blk = main.global_block()
        pg = []
        for n, shape in sorted(params.items()):
            p = blk.create_parameter(n, list(shape), "float32")
            startup.global_block().create_parameter(n, list(shape),
                                                    "float32")
            g = blk.create_var(name=n + "@GRAD", shape=list(shape),
                               dtype="float32", persistable=True)
            pg.append((p, g))
        o = (pkg.SGD(learning_rate=0.1) if opt == "sgd"
             else pkg.Adam(learning_rate=1e-2))
        o.create_optimization_pass(pg, pg[0][0], startup)
    return main, startup


def _server(params, fan_in=1, snapshot_dir=None, snapshot_every=0,
            init=None, opt="sgd", pkg=fluid):
    """Elastic VariableServer (`pkg`'s) over `opt`'s optimize block.
    `params`: {name: init ndarray} (grads are `<name>@GRAD`); `init`
    overrides the values installed."""
    prog, startup = _opt_program(pkg, {n: v.shape for n, v in
                                       params.items()}, opt)
    scope = pkg.Scope()
    exe = pkg.Executor(pkg.CPUPlace())
    exe.run(startup, scope=scope)
    wrap = _t if pkg is fluid else (lambda a: np.array(a, np.float32))
    for n, v in (init if init is not None else params).items():
        scope.set_var(n, wrap(v))
    server_cls = VariableServer if pkg is fluid else jps.VariableServer
    srv = server_cls(prog, scope, exe, fan_in=fan_in, sync=True,
                     elastic=True, snapshot_dir=snapshot_dir,
                     snapshot_every=snapshot_every)
    port = srv.serve(0)
    return srv, f"127.0.0.1:{port}"


def _controller(params, cls=ClusterController, **kw):
    """Controller with its own registry, var descs pre-defined."""
    kw.setdefault("poll_s", 0.05)
    kw.setdefault("push_timeout_s", 0.5)
    ctl = cls(**kw)
    ctl.serve(0)
    ctl.start()
    ctl.define([VarDesc(n, tuple(v.shape), "float32")
                for n, v in sorted(params.items())])
    return ctl


def _lease(ctl, kind, ep, ttl_s=SURVIVOR_TTL):
    return Lease(RegistryClient(ctl.registry_addr), kind, ep, ttl_s=ttl_s)


def _crash(srv, lease):
    """SIGKILL semantics in-process: sockets die, heartbeats stop, no
    deregister (the lease expires by its TTL)."""
    srv.stop()
    lease._stop.set()


def _wait(pred, timeout_s=15.0, what="condition"):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


def _get(ep, names):
    c = VariableClient(ep, client_id="probe")
    try:
        return [_np(v) for v in c.get_vars(names)]
    finally:
        c.close()


PARAMS4 = {f"w{i}": np.full(8, float(i + 1), np.float32)
           for i in range(4)}


def _round(view, grads, names=None, pull=True):
    names = sorted(grads) if names is None else names
    sends = [(n, n + "@GRAD", _t(grads[n]), view.placement[n])
             for n in sorted(grads)]
    gets = [(n, n, view.placement[n]) for n in names] if pull else []
    outs = comm.elastic_round(sends, gets)
    return {n: _np(o) for n, o in zip(names, outs)}


HALF = {n: np.full(8, 0.5, np.float32) for n in PARAMS4}


# ---------------------------------------------------------------------------
# views + placement
# ---------------------------------------------------------------------------


def test_cluster_view_json_roundtrip_is_the_jax_packages():
    kw = dict(epoch=7, status="rebalancing", pservers={0: "a:1", 2: "c:3"},
              trainers={1: "t:9"}, placement={"w": "a:1"}, fan_in=2,
              needed=["w"], registry="r:5")
    v, jv = ClusterView(**kw), jcluster.ClusterView(**kw)
    assert v.to_json() == jv.to_json()      # byte-identical
    w = ClusterView.from_json(jv.to_json())
    assert (w.epoch, w.status, w.pservers, w.trainers, w.placement,
            w.fan_in, w.needed, w.registry) == (
        7, "rebalancing", {0: "a:1", 2: "c:3"}, {1: "t:9"},
        {"w": "a:1"}, 2, ["w"], "r:5")
    assert w.endpoints == ["a:1", "c:3"]  # slot order, not dict order
    assert jcluster.ClusterView.from_json(v.to_json()).to_json() == \
        v.to_json()


def test_placement_map_is_deterministic_total_and_the_jax_packages():
    from paddle_tpu.parallel import distributed_spliter as jspl

    descs = [VarDesc(f"v{i}", (i + 1, 4), "float32") for i in range(9)]
    eps = ["h:1", "h:2", "h:3"]
    p1 = placement_map(descs, eps)
    assert p1 == placement_map(list(descs), list(eps))
    assert set(p1) == {d.name for d in descs}
    assert set(p1.values()) <= set(eps)
    assert p1 == dict(zip([d.name for d in descs],
                          balanced_split(descs, eps)))
    assert p1 == jspl.placement_map(
        [jspl.VarDesc(*d) for d in descs], eps)


# ---------------------------------------------------------------------------
# membership-driven rebalancing (in-process, fast)
# ---------------------------------------------------------------------------


def test_bootstrap_copies_consolidate_onto_placed_owners():
    srv1, ep1 = _server(PARAMS4)            # holds ALL bootstrap copies
    srv2, ep2 = _server(PARAMS4, init={})   # holds NONE
    ctl = _controller(PARAMS4, min_pservers=2)
    try:
        l1, l2 = _lease(ctl, "pserver", ep1), _lease(ctl, "pserver", ep2)
        v = ctl.wait_view(1, timeout_s=15)
        assert v is not None and len(v.pservers) == 2
        assert set(v.placement.values()) == {ep1, ep2}
        for name, ep in v.placement.items():
            np.testing.assert_array_equal(_get(ep, [name])[0],
                                          PARAMS4[name])
        # the port drops a confirmed bootstrap copy from its non-owner
        # on the first placement (the JAX package keeps it)
        for name, ep in v.placement.items():
            other = srv2 if ep == ep1 else srv1
            assert not other.scope.has_var(name), name
        l1.release()
        l2.release()
    finally:
        srv1.stop()
        srv2.stop()
        ctl.close()


def test_lost_previously_placed_shard_recovers_on_next_change():
    srv1, ep1 = _server(PARAMS4)
    ctl = _controller(PARAMS4, min_pservers=1)
    srv2 = None
    try:
        l1 = _lease(ctl, "pserver", ep1)
        v1 = ctl.wait_view(1, timeout_s=10)
        assert v1 is not None and v1.endpoints == [ep1]
        srv1.scope.erase("w0")      # drift behind the controller's back
        srv2, ep2 = _server(PARAMS4, init={})
        l2 = _lease(ctl, "pserver", ep2)
        v2 = ctl.wait_view(v1.epoch + 1, timeout_s=15)
        assert v2 is not None and len(v2.pservers) == 2
        for name, ep in v2.placement.items():
            expect = (np.zeros(8, np.float32) if name == "w0"
                      else PARAMS4[name])
            np.testing.assert_array_equal(_get(ep, [name])[0], expect)
        l1.release()
        l2.release()
    finally:
        srv1.stop()
        if srv2 is not None:
            srv2.stop()
        ctl.close()


def test_join_rebalances_and_migrates_shards():
    was = obs_metrics.enabled()
    obs_metrics.set_enabled(True)
    srv1, ep1 = _server(PARAMS4)
    ctl = _controller(PARAMS4, min_pservers=1)
    srv2 = None
    try:
        l1 = _lease(ctl, "pserver", ep1)
        v1 = ctl.wait_view(1, timeout_s=10)
        assert v1 is not None and v1.endpoints == [ep1]
        comm.set_cluster(ClusterClient(ctl.addr))
        outs = _round(v1, HALF)
        for n in PARAMS4:
            np.testing.assert_allclose(outs[n], PARAMS4[n] - 0.05,
                                       rtol=1e-6)
        # a joiner with ZERO values: only migration gives it the
        # trained ones
        srv2, ep2 = _server(PARAMS4, init={n: np.zeros(8, np.float32)
                                           for n in PARAMS4})
        l2 = _lease(ctl, "pserver", ep2)
        v2 = ctl.wait_view(v1.epoch + 1, timeout_s=10)
        assert v2 is not None
        assert sorted(v2.endpoints) == sorted([ep1, ep2])
        assert set(v2.placement.values()) == {ep1, ep2}
        outs = comm.elastic_round([], [(n, n, v2.placement[n])
                                       for n in PARAMS4])
        for n, o in zip(PARAMS4, outs):
            np.testing.assert_allclose(_np(o), PARAMS4[n] - 0.05,
                                       rtol=1e-6)
        snap = obs_metrics.registry().snapshot()
        for series in ("paddle_tpu_cluster_view_epoch",
                       "paddle_tpu_cluster_membership_changes_total",
                       "paddle_tpu_cluster_rebalances_total",
                       "paddle_tpu_cluster_rebalance_seconds",
                       "paddle_tpu_cluster_shard_migration_bytes_total"):
            assert series in snap, series
        rec = ctl.transitions[-1]
        assert rec["kind"] == "rebalance" and rec["vars"] >= 1
        assert rec["bytes"] > 0
        l1.release()
        l2.release()
    finally:
        obs_metrics.set_enabled(was)
        srv1.stop()
        if srv2 is not None:
            srv2.stop()
        ctl.close()


def test_dead_pserver_shards_restore_from_snapshot(tmp_path):
    snap = {0: str(tmp_path / "ps0"), 1: str(tmp_path / "ps1")}
    srv1, ep1 = _server(PARAMS4, snapshot_dir=snap[0], snapshot_every=1)
    srv2, ep2 = _server(PARAMS4, snapshot_dir=snap[1], snapshot_every=1)
    ctl = _controller(PARAMS4, min_pservers=2, snapshot_dirs=snap)
    try:
        l1 = _lease(ctl, "pserver", ep1)            # must NOT expire
        l2 = _lease(ctl, "pserver", ep2, ttl_s=0.4)
        assert l1.index == 0 and l2.index == 1    # snapshot_dirs keys
        v1 = ctl.wait_view(1, timeout_s=10)
        assert v1 is not None and len(v1.pservers) == 2
        comm.set_cluster(ClusterClient(ctl.addr))
        _round(v1, HALF)                # round 1 -> snapshots written
        assert {e for e in v1.placement.values()} == {ep1, ep2}
        _crash(srv2, l2)
        v2 = ctl.wait_view(v1.epoch + 1, timeout_s=15)
        assert v2 is not None and v2.endpoints == [ep1]
        assert ctl.transitions[-1]["restored"] >= 1
        outs = comm.elastic_round([], [(n, n, v2.placement[n])
                                       for n in PARAMS4])
        for n, o in zip(PARAMS4, outs):
            np.testing.assert_allclose(_np(o), PARAMS4[n] - 0.05,
                                       rtol=1e-6)
        l1.release()
    finally:
        srv1.stop()
        ctl.close()


def test_total_pserver_loss_then_replacement_restores(tmp_path):
    snap = {0: str(tmp_path / "ps0")}
    srv1, ep1 = _server(PARAMS4, snapshot_dir=snap[0], snapshot_every=1)
    ctl = _controller(PARAMS4, min_pservers=1, snapshot_dirs=snap)
    srv2 = None
    try:
        l1 = _lease(ctl, "pserver", ep1, ttl_s=0.4)
        assert l1.index == 0
        v1 = ctl.wait_view(1, timeout_s=10)
        assert v1 is not None and v1.endpoints == [ep1]
        comm.set_cluster(ClusterClient(ctl.addr))
        _round(v1, HALF, pull=False)    # round 1 -> snapshot written
        _crash(srv1, l1)
        _wait(lambda: (ctl.view().status == "rebalancing"
                       and not ctl.view().pservers),
              timeout_s=15, what="all-dead stall view")
        assert ctl.view().placement  # last known placement rides along
        srv2, ep2 = _server(PARAMS4, init={n: np.zeros(8, np.float32)
                                           for n in PARAMS4})
        l2 = _lease(ctl, "pserver", ep2)
        _wait(lambda: (ctl.view().status == "stable"
                       and ctl.view().endpoints == [ep2]),
              timeout_s=15, what="post-replacement stable view")
        v2 = ctl.view()
        outs = comm.elastic_round([], [(n, n, v2.placement[n])
                                       for n in PARAMS4])
        for n, o in zip(PARAMS4, outs):
            np.testing.assert_allclose(_np(o), PARAMS4[n] - 0.05,
                                       rtol=1e-6)
        l2.release()
    finally:
        srv1.stop()
        if srv2 is not None:
            srv2.stop()
        ctl.close()


def test_trainer_only_change_commits_without_fence():
    srv, ep = _server(PARAMS4)
    ctl = _controller(PARAMS4, min_pservers=1)
    try:
        lp = _lease(ctl, "pserver", ep)
        v1 = ctl.wait_view(1, timeout_s=10)
        assert v1 is not None and v1.endpoints == [ep]

        def boom(*a, **k):
            raise AssertionError(
                "full fence/migrate path taken for trainer-only churn")

        ctl._migrate = boom
        lt1 = _lease(ctl, "trainer", "t:1")
        v2 = ctl.wait_view(v1.epoch + 1, timeout_s=10)
        assert v2 is not None and v2.fan_in == 1
        assert v2.placement == v1.placement
        _wait(lambda: srv.fan_in == 1, what="fan_in commit")
        lt2 = _lease(ctl, "trainer", "t:2")
        v3 = ctl.wait_view(v2.epoch + 1, timeout_s=10)
        assert v3 is not None and v3.fan_in == 2
        _wait(lambda: srv.fan_in == 2, what="fan_in grows on join")
        lt1.release()  # clean leave: slot freed immediately
        v4 = ctl.wait_view(v3.epoch + 1, timeout_s=10)
        assert v4 is not None and v4.fan_in == 1
        _wait(lambda: srv.fan_in == 1, what="fan_in shrinks on leave")
        assert [t["kind"] for t in ctl.transitions[-3:]] == \
            ["trainer-only"] * 3
        lt2.release()
        lp.release()
    finally:
        srv.stop()
        ctl.close()


def test_snapshotless_death_recovers_from_trainer_copy():
    srv1, ep1 = _server(PARAMS4)
    srv2, ep2 = _server(PARAMS4)
    ctl = _controller(PARAMS4, min_pservers=2, push_timeout_s=5.0)
    try:
        l1 = _lease(ctl, "pserver", ep1)
        l2 = _lease(ctl, "pserver", ep2, ttl_s=0.4)
        v1 = ctl.wait_view(1, timeout_s=10)
        assert v1 is not None and len(v1.pservers) == 2
        cc = ClusterClient(ctl.addr)
        comm.set_cluster(cc)
        _round(v1, HALF)
        held = {n: PARAMS4[n] - 0.05 for n in PARAMS4}
        cc.set_param_provider(lambda name: held.get(name))
        _crash(srv2, l2)

        def stable_single():
            v = cc.ready_view(timeout_s=20)
            return v.epoch > v1.epoch and v.endpoints == [ep1]

        _wait(stable_single, timeout_s=20, what="post-crash stable view")
        v2 = cc.ready_view(timeout_s=10)
        outs = comm.elastic_round([], [(n, n, v2.placement[n])
                                       for n in PARAMS4])
        for n, o in zip(PARAMS4, outs):
            np.testing.assert_allclose(_np(o), held[n], rtol=1e-6)
        l1.release()
    finally:
        srv1.stop()
        ctl.close()


def test_ensure_param_provider_reads_the_scope_on_the_host():
    ctl = _controller(PARAMS4)
    try:
        comm.set_cluster(ClusterClient(ctl.addr))
        scope = fluid.Scope()
        scope.set_var("w0", _t(PARAMS4["w0"]))
        comm.ensure_param_provider(scope)
        got = comm.get_cluster()._provider("w0")
        assert isinstance(got, np.ndarray)
        np.testing.assert_array_equal(got, PARAMS4["w0"])
        assert comm.get_cluster()._provider("absent") is None
    finally:
        ctl.close()


def test_elastic_round_replays_against_a_fresh_view_exactly_once():
    """A round whose endpoint died replays against the next stable view;
    the survivor's shard, whose barrier said "applied", takes the
    round's update once (the JAX package takes it once or twice)."""
    was = obs_metrics.enabled()
    obs_metrics.set_enabled(True)
    srv1, ep1 = _server(PARAMS4)
    srv2, ep2 = _server(PARAMS4)
    ctl = _controller(PARAMS4, min_pservers=2, push_timeout_s=10.0)
    try:
        l1 = _lease(ctl, "pserver", ep1)
        l2 = _lease(ctl, "pserver", ep2, ttl_s=0.4)
        v1 = ctl.wait_view(1, timeout_s=10)
        assert v1 is not None and len(v1.pservers) == 2
        cc = ClusterClient(ctl.addr)
        comm.set_cluster(cc)
        cc.set_param_provider(lambda name: PARAMS4.get(name))
        retries = obs_metrics.registry().get(
            "paddle_tpu_comm_round_retries_total")
        before = retries.value if retries is not None else 0.0
        _crash(srv2, l2)
        outs = _round(v1, HALF)
        for n in PARAMS4:
            np.testing.assert_allclose(outs[n], PARAMS4[n] - 0.05,
                                       rtol=1e-6, err_msg=n)
        assert cc.ready_view(timeout_s=5).endpoints == [ep1]
        retries = obs_metrics.registry().get(
            "paddle_tpu_comm_round_retries_total")
        assert retries.value > before
        l1.release()
    finally:
        obs_metrics.set_enabled(was)
        srv1.stop()
        ctl.close()


# ---------------------------------------------------------------------------
# two-phase view-change fence and the migration verbs (pserver level)
# ---------------------------------------------------------------------------


def test_fence_blocks_rounds_until_commit():
    params = {"w": np.full(4, 2.0, np.float32)}
    srv, ep = _server(params)
    c = VariableClient(ep, client_id="t0")
    try:
        c.fence(epoch=1)
        state = {"done": None}

        def round_():
            c2 = VariableClient(ep, client_id="t0")
            c2.send_vars([("w@GRAD", _t(np.ones(4)))])
            state["done"] = c2.send_batch_barrier()
            c2.close()

        t = threading.Thread(target=round_, daemon=True)
        t.start()
        time.sleep(0.4)
        assert state["done"] is None  # fenced: the barrier is held
        c.commit(epoch=1, fan_in=1)
        t.join(timeout=10)
        # released without the round (its grads were pre-view state)
        assert state["done"] == "released"
        np.testing.assert_allclose(_np(c.get_vars(["w"])[0]),
                                   params["w"], rtol=1e-6)
        # the next round is applied, and says so
        c.send_vars([("w@GRAD", _t(np.ones(4)))])
        assert c.send_batch_barrier() == "applied"
    finally:
        c.close()
        srv.stop()


def test_commit_shrinks_fan_in_and_releases_waiters():
    params = {"w": np.full(4, 2.0, np.float32)}
    srv, ep = _server(params, fan_in=2)
    c = VariableClient(ep, client_id="survivor")
    try:
        state = {"done": None}

        def round_():
            c.send_vars([("w@GRAD", _t(np.ones(4)))])
            state["done"] = c.send_batch_barrier()

        t = threading.Thread(target=round_, daemon=True)
        t.start()
        time.sleep(0.4)
        assert state["done"] is None  # waiting for the dead peer
        ctl_c = VariableClient(ep, client_id="ctl")
        ctl_c.fence(epoch=2)
        ctl_c.commit(epoch=2, fan_in=1)
        ctl_c.close()
        t.join(timeout=10)
        assert state["done"] == "released"
        np.testing.assert_allclose(_np(c.get_vars(["w"])[0]),
                                   params["w"], rtol=1e-6)  # round lost
        c.send_vars([("w@GRAD", _t(np.ones(4)))])
        assert c.send_batch_barrier() == "applied"
        np.testing.assert_allclose(_np(c.get_vars(["w"])[0]),
                                   params["w"] - 0.1, rtol=1e-6)
    finally:
        c.close()
        srv.stop()


def test_put_drop_and_state_verbs():
    """PUT_BATCH installs canonical values; DROP erases the var, its
    stale per-trainer grad slots and the state kept beside it; STATE
    names that state (an Adam parameter's moments and its own beta
    powers)."""
    params = {"w": np.full(4, 2.0, np.float32),
              "u": np.full(4, 1.0, np.float32)}
    srv, ep = _server(params, opt="adam")
    c = VariableClient(ep, client_id="t0")
    try:
        assert c.put_vars([("fresh", _t(np.arange(4)))]) > 0
        np.testing.assert_array_equal(_np(c.get_vars(["fresh"])[0]),
                                      np.arange(4, dtype=np.float32))
        state = c.state_of(["w", "u", "fresh"])
        assert state["fresh"] == []
        w_state = state["w"]
        assert any("moment1" in n for n in w_state)
        assert any("moment2" in n for n in w_state)
        assert sum(n.endswith("@w") for n in w_state) == 2  # beta pows
        c.send_vars([("w@GRAD", _t(np.ones(4))),
                     ("u@GRAD", _t(np.ones(4)))])
        assert c.send_batch_barrier() == "applied"
        assert all(srv.scope.has_var(n) for n in w_state)
        c.send_vars([("w@GRAD", _t(np.ones(4)))])   # a stale slot
        c.drop_vars(["w"])
        assert not srv.scope.has_var("w")
        assert not any(srv.scope.has_var(n) for n in w_state)
        assert not any(n.startswith("w@GRAD.trainer_")
                       for n in srv.scope.local_names())
        assert all(srv.scope.has_var(n) for n in state["u"])
        with pytest.raises(RuntimeError):
            c.get_vars(["w"])
        # the JAX package's server does not speak STATE
        jsrv, jep = _server(params, pkg=jfluid)
        jc = VariableClient(jep, client_id="t1")
        try:
            with pytest.raises(RuntimeError, match="unknown verb"):
                jc.state_of(["w"])
        finally:
            jc.close()
            jsrv.stop()
    finally:
        c.close()
        srv.stop()


def test_a_grad_for_a_parameter_not_held_refuses_the_round_whole():
    """A trainer routed by a view older than a migration sends a grad
    for a parameter this server no longer holds: the round is refused
    before any slice runs (the held parameter is not half updated), the
    barrier raises, and the next round is applied."""
    params = {"a": np.full(4, 2.0, np.float32),
              "z": np.full(4, 4.0, np.float32)}
    srv, ep = _server(params, opt="adam")
    c = VariableClient(ep, client_id="t0")
    try:
        c.drop_vars(["z"])              # migrated away
        c.send_vars([("a@GRAD", _t(np.ones(4))),
                     ("z@GRAD", _t(np.ones(4)))])
        with pytest.raises(RuntimeError, match="does not hold"):
            c.send_batch_barrier()
        np.testing.assert_array_equal(_np(c.get_vars(["a"])[0]),
                                      params["a"])
        c.send_vars([("a@GRAD", _t(np.ones(4)))])
        assert c.send_batch_barrier() == "applied"
        assert not np.array_equal(_np(c.get_vars(["a"])[0]), params["a"])
    finally:
        c.close()
        srv.stop()


def test_a_stopped_server_answers_nothing_and_a_controller_closes_fast():
    """stop() shuts the live connections too (a killed server answers
    nothing), and a controller's close() does not wait out its accept
    thread."""
    srv, ep = _server(PARAMS4)
    c = VariableClient(ep, client_id="t0", connect_timeout=0.3,
                       retry_policy=RetryPolicy(max_attempts=1,
                                                base_delay=0.01,
                                                max_delay=0.01,
                                                deadline=0.5))
    try:
        assert c.have_vars(["w0"]) == {"w0"}
        srv.stop()
        with pytest.raises((OSError, ConnectionError)):
            c.have_vars(["w0"])
    finally:
        c.close()
    ctl = _controller(PARAMS4)
    t0 = time.monotonic()
    ctl.close()
    assert time.monotonic() - t0 < 3.0


def test_snapshot_is_hashed_while_written(tmp_path):
    """A pserver snapshot's npz is written through a stream that takes
    its md5 on the way (no read-back): the digest is io._md5_of_dir's,
    and np.load gives back every array, 0-d and bool ones too; the
    snapshot restores into a fresh server."""
    from paddle_tpu_torch import io as tio
    from paddle_tpu_torch.parallel.checkpoint import (
        PSERVER_SHARD_FILENAME, latest_pserver_shard)
    from paddle_tpu_torch.parallel.pserver import _savez_hashed

    rng = np.random.RandomState(4)
    arrays = {"w": rng.rand(3, 5).astype(np.float32),
              "ids": np.arange(7, dtype=np.int64),
              "step": np.float32(3.0).reshape(()),
              "mask": rng.rand(2, 2) > 0.5}
    d = tmp_path / "cp"
    d.mkdir()
    with open(d / PSERVER_SHARD_FILENAME, "wb") as f:
        digest = _savez_hashed(f, PSERVER_SHARD_FILENAME, arrays)
    assert digest == tio._md5_of_dir(str(d))
    with np.load(d / PSERVER_SHARD_FILENAME) as z:
        for k, v in arrays.items():
            assert z[k].dtype == v.dtype and z[k].shape == v.shape, k
            np.testing.assert_array_equal(z[k], v)
    srv, ep = _server(PARAMS4, snapshot_dir=str(tmp_path / "snap"),
                      snapshot_every=1)
    try:
        c = VariableClient(ep, client_id="t0")
        c.send_vars([(n + "@GRAD", _t(HALF[n])) for n in PARAMS4])
        assert c.send_batch_barrier() == "applied"
        c.close()
        data, rnd, _ = latest_pserver_shard(str(tmp_path / "snap"))
        assert rnd == 1
        for n in PARAMS4:
            np.testing.assert_allclose(data[n], PARAMS4[n] - 0.05,
                                       rtol=1e-6)
    finally:
        srv.stop()


def test_fused_send_op_routes_through_view_placement():
    params = {"wa": np.full(4, 2.0, np.float32),
              "wb": np.full(4, 4.0, np.float32)}
    srv1, ep1 = _server(params)
    srv2, ep2 = _server(params)
    ctl = _controller(params, min_pservers=2)
    try:
        l1, l2 = _lease(ctl, "pserver", ep1), _lease(ctl, "pserver", ep2)
        v = ctl.wait_view(1, timeout_s=10)
        assert v is not None and set(v.placement.values()) == {ep1, ep2}
        comm.set_cluster(ClusterClient(ctl.addr))
        # deliberately WRONG static epmap
        other = {ep1: ep2, ep2: ep1}
        stale = [other[v.placement["wa"]], other[v.placement["wb"]]]
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            ga = fluid.layers.data(name="wa@GRAD", shape=[4],
                                   dtype="float32", append_batch_size=False)
            gb = fluid.layers.data(name="wb@GRAD", shape=[4],
                                   dtype="float32", append_batch_size=False)
            blk = main.global_block()
            wa = blk.create_var(name="wa", shape=[4], dtype="float32")
            wb = blk.create_var(name="wb", shape=[4], dtype="float32")
            fluid.layers.Send([ep1, ep2], [ga, gb], [wa, wb],
                              epmap=stale, out_epmap=stale)
        exe = fluid.Executor(fluid.CPUPlace())
        oa, ob = exe.run(
            main, feed={"wa@GRAD": np.ones(4, np.float32),
                        "wb@GRAD": np.full(4, 2.0, np.float32)},
            fetch_list=[wa, wb], scope=fluid.Scope())
        np.testing.assert_allclose(_np(oa), 2.0 - 0.1, rtol=1e-6)
        np.testing.assert_allclose(_np(ob), 4.0 - 0.2, rtol=1e-6)
        l1.release()
        l2.release()
    finally:
        srv1.stop()
        srv2.stop()
        ctl.close()


def test_trainer_train_cluster_joins_and_releases():
    params = {"w": np.full(4, 2.0, np.float32)}
    srv, ep = _server(params)
    ctl = _controller(params, min_pservers=1, track_trainers=True)
    try:
        lp = _lease(ctl, "pserver", ep)
        assert ctl.wait_view(1, timeout_s=10) is not None
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.layers.data(name="x", shape=[4], dtype="float32")
            y = fluid.layers.data(name="y", shape=[1], dtype="float32")
            pred = fluid.layers.fc(input=x, size=1)
            loss = fluid.layers.mean(
                fluid.layers.square_error_cost(input=pred, label=y))
        from paddle_tpu_torch.trainer import EndIteration, Trainer

        t = Trainer(loss, optimizer=fluid.SGD(0.1), feed_list=[x, y],
                    main_program=main, startup_program=startup,
                    place=fluid.CPUPlace())
        rng = np.random.RandomState(0)
        batch = [(rng.rand(4).astype(np.float32),
                  rng.rand(1).astype(np.float32)) for _ in range(4)]
        seen = []

        def handler(event):
            if isinstance(event, EndIteration):
                seen.append(dict(ctl._reg.list("trainer")))

        t.train(1, lambda: iter([batch]), event_handler=handler,
                cluster=ctl.addr)
        assert seen and all(seen), (
            f"trainer lease never visible during training: {seen}")
        _wait(lambda: ctl._reg.list("trainer") == {}, timeout_s=10,
              what="trainer slot release")
        assert comm.get_cluster() is None
        lp.release()
    finally:
        srv.stop()
        ctl.close()


# ---------------------------------------------------------------------------
# FaultInjector-driven view-change chaos (fast)
# ---------------------------------------------------------------------------


def test_view_change_survives_injected_rebalance_fault():
    fault_injector().inject("cluster.rebalance", "error", nth=1,
                            exc=RuntimeError("injected rebalance crash"))
    srv1, ep1 = _server(PARAMS4)
    ctl = _controller(PARAMS4, min_pservers=1)
    try:
        l1 = _lease(ctl, "pserver", ep1)
        v = ctl.wait_view(1, timeout_s=15)
        assert v is not None and v.endpoints == [ep1]
        l1.release()
    finally:
        fault_injector().clear()
        srv1.stop()
        ctl.close()


def test_shard_migration_survives_injected_migrate_fault():
    srv1, ep1 = _server(PARAMS4)
    ctl = _controller(PARAMS4, min_pservers=1)
    srv2 = None
    try:
        l1 = _lease(ctl, "pserver", ep1)
        v1 = ctl.wait_view(1, timeout_s=10)
        assert v1 is not None
        fault_injector().inject("cluster.migrate", "error", nth=1,
                                exc=RuntimeError("injected migrate crash"))
        srv2, ep2 = _server(PARAMS4, init={n: np.zeros(8, np.float32)
                                           for n in PARAMS4})
        l2 = _lease(ctl, "pserver", ep2)
        v2 = ctl.wait_view(v1.epoch + 1, timeout_s=15)
        assert v2 is not None and len(v2.pservers) == 2
        comm.set_cluster(ClusterClient(ctl.addr))
        outs = comm.elastic_round([], [(n, n, v2.placement[n])
                                       for n in PARAMS4])
        for n, o in zip(PARAMS4, outs):
            np.testing.assert_allclose(_np(o), PARAMS4[n], rtol=1e-6)
        l1.release()
        l2.release()
    finally:
        fault_injector().clear()
        srv1.stop()
        if srv2 is not None:
            srv2.stop()
        ctl.close()


# ---------------------------------------------------------------------------
# the slice as a whole: chip_smoke's s2s_elastic arm at a small size
# ---------------------------------------------------------------------------


def _tiny_build():
    from paddle_tpu_torch.core import framework as fw

    fw.reset_unique_names()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[16], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        h = fluid.layers.fc(input=x, size=32, act="relu")
        h = fluid.layers.fc(input=h, size=24, act="relu")
        pred = fluid.layers.fc(input=h, size=1)
        loss = fluid.layers.mean(
            fluid.layers.square_error_cost(input=pred, label=y))
        opt_ops, pg = fluid.Adam(learning_rate=1e-2).minimize(loss)
    return main, startup, loss, opt_ops, pg


def _tiny_feeds(n=6):
    rng = np.random.RandomState(11)
    return [{"x": rng.randn(8, 16).astype(np.float32),
             "y": rng.randn(8, 1).astype(np.float32)} for _ in range(n)]


def _tiny_serial(init, feeds):
    """The untranspiled Program on the serial Executor from `init` ->
    (losses, [{param: value} after each step])."""
    main, startup, loss, _, pg = _tiny_build()
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    for n, v in init.items():
        scope.find_var(n).copy_(v)
    losses, snaps = [], []
    for feed in feeds:
        out, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        losses.append(float(np.asarray(out).reshape(-1)[0]))
        snaps.append({p.name: scope.find_var(p.name).clone()
                      for p, _ in pg})
    return losses, snaps


def _tiny_elastic(tmp_path):
    import chip_smoke as cs

    feeds = _tiny_feeds()
    rec = cs._el_run(_tiny_build, feeds, fluid.CPUPlace(),
                     cs._ElasticThreads(_tiny_build, str(tmp_path)),
                     on_card=False)
    losses, snaps = _tiny_serial(rec["init"], feeds)
    return cs._el_verdict(rec, snaps, losses), rec


def test_s2s_elastic_arm_through_a_kill_and_a_join_is_serial(tmp_path):
    """chip_smoke's elastic arm at a small size on the CPU: Adam through
    Trainer.train(cluster=), pserver 1 killed at round 3's send (round 3
    replayed against the next view, its shards and their Adam state
    restored from the round-2 snapshot), a pserver joining before round
    5 (PUT_BATCH migration with the state): every round bit-equal to the
    serial Executor's, and the verdict passes."""
    (failed, per_round), rec = _tiny_elastic(tmp_path)
    assert failed == [], failed
    assert [r["not_bit_equal"] for r in per_round] == [0] * 6, per_round
    assert rec["kill"]["restored_round"] == 2
    assert rec["kill"]["restored_state_vars"] > 0
    assert rec["join"]["migrated_state_vars"] > 0
    assert rec["views"][-1] > rec["views"][0]


def test_the_elastic_arm_under_a_collector_lists_and_reclaims_members(
        tmp_path, monkeypatch):
    """chip_smoke's elastic run under its telemetry at a small size:
    the trainer (this process, at Trainer.train) and each pserver (at its
    lease) announce to the collector; the killed pserver's series are
    reclaimed within its bound, the joiner is listed after its lease,
    and the verdict passes (and refuses a joiner listed before it)."""
    import chip_smoke as cs
    from paddle_tpu_torch.observability import collector

    monkeypatch.setattr(collector, "_ENV_TRIED", False)
    monkeypatch.setattr(collector, "_ENV_ANNOUNCEMENT", None)
    monkeypatch.delenv("PADDLE_TPU_TELEMETRY_REGISTRY", raising=False)
    tel = cs._ElTelemetry()
    try:
        rec = cs._el_run(_tiny_build, _tiny_feeds(), fluid.CPUPlace(),
                         cs._ElasticThreads(_tiny_build, str(tmp_path)),
                         on_card=False, telemetry=tel)
    finally:
        tel.close()
    assert "PADDLE_TPU_TELEMETRY_REGISTRY" not in os.environ
    failed, out = cs._el_telemetry_verdict(rec["telemetry"])
    assert failed == [], failed
    assert out["kill_to_reclaimed_s"] <= out["bound_s"]
    members = rec["telemetry"]["members"]
    assert sorted(r["kind"] for r in members.values()) == [
        "pserver", "pserver", "pserver", "trainer"]
    early = dict(rec["telemetry"], members=dict(
        members, pserver2=dict(members["pserver2"], listed_s=0.0)))
    assert any("joiner" in f for f in cs._el_telemetry_verdict(early)[0])


def test_parameters_moved_without_their_adam_state_are_refused(
        tmp_path, monkeypatch):
    """The repair the arm rests on: moved the JAX package's way, a
    parameter alone (its pservers not asked for STATE), its Adam
    moments and step count stay behind and the kill's and the join's
    rounds leave the serial steps."""
    monkeypatch.setattr(ClusterController, "_state_of",
                        lambda self, names, eps: {})
    (failed, per_round), _ = _tiny_elastic(tmp_path)
    assert any("not bit-equal" in f for f in failed), failed


def test_s2s_elastic_verdict_refuses_a_skipped_migration(tmp_path,
                                                         monkeypatch):
    """A controller that skips one shard in the join's migration (the
    joiner keeps its own stale copy) is refused."""
    real = ClusterController._copy
    skipped = []

    def skip_one(self, src_ep, dst_ep, names, moved):
        if not skipped:
            skipped.append(names[0])
            names = names[1:]
        if names:
            real(self, src_ep, dst_ep, names, moved)

    monkeypatch.setattr(ClusterController, "_copy", skip_one)
    (failed, per_round), _ = _tiny_elastic(tmp_path)
    assert skipped
    assert any("not bit-equal" in f for f in failed), failed


def test_s2s_elastic_verdict_refuses_a_stale_snapshot(tmp_path,
                                                      monkeypatch):
    """A controller that restores the killed pserver's snapshot one
    round stale is refused."""
    from paddle_tpu_torch import io as tio
    from paddle_tpu_torch.parallel import checkpoint

    real = checkpoint.latest_pserver_shard

    def one_round_stale(snapshot_dir):
        if not (os.path.isdir(snapshot_dir)
                and len(tio._checkpoints_by_time(snapshot_dir)) > 1):
            return real(snapshot_dir)
        older = tio._checkpoints_by_time(snapshot_dir)[-2]
        cp_dir = os.path.join(snapshot_dir, older[1])
        with np.load(os.path.join(cp_dir,
                                  checkpoint.PSERVER_SHARD_FILENAME)) as z:
            data = {n: z[n] for n in z.files}
        meta = older[2]
        return data, int(meta["trainer_args"]["round"]), meta

    monkeypatch.setattr(checkpoint, "latest_pserver_shard", one_round_stale)
    (failed, per_round), _ = _tiny_elastic(tmp_path)
    assert any("not bit-equal" in f for f in failed), failed
    assert any("kill restore" in f for f in failed), failed


# ---------------------------------------------------------------------------
# across packages: a port cluster under a JAX controller and the reverse
# ---------------------------------------------------------------------------


def _cross_scenario(ctl_pkg, member_pkg, root):
    """Two pservers (a snapshot a round), a trainer; round 1 and 2, the
    second pserver crashed (TTL expiry, restored from its snapshot),
    round 3, a blank pserver joining, round 4 -> the parameters pulled
    after each round.  The controller is `ctl_pkg`'s, the pservers, the
    registry leases and the trainer's comm `member_pkg`'s."""
    from paddle_tpu.cloud import registry as jreg

    port_members = member_pkg == "port"
    pkg = fluid if port_members else jfluid
    lease_cls, reg_cls = ((Lease, RegistryClient) if port_members
                          else (jreg.Lease, jreg.RegistryClient))
    mcomm = comm if port_members else jcomm
    client_cls = ClusterClient if port_members else jcluster.ClusterClient
    ctl_cls = ClusterController if ctl_pkg == "port" else \
        jcluster.ClusterController
    snap = {i: os.path.join(root, f"{ctl_pkg}-{member_pkg}-ps{i}")
            for i in range(3)}
    ctl = _controller(PARAMS4, cls=ctl_cls, min_pservers=2,
                      snapshot_dirs=snap)
    servers, leases, out = [], [], []
    try:
        for i in range(2):
            srv, ep = _server(PARAMS4, snapshot_dir=snap[i],
                              snapshot_every=1, pkg=pkg)
            servers.append(srv)
            leases.append(lease_cls(reg_cls(ctl.registry_addr), "pserver",
                                    ep, ttl_s=0.4 if i else SURVIVOR_TTL))
            _wait(lambda: len(ctl._reg.list("pserver")) == i + 1,
                  what="registration")
        v = ctl.wait_view(1, timeout_s=15)
        assert v is not None and len(v.pservers) == 2
        cc = client_cls(ctl.addr)
        mcomm.set_cluster(cc)
        wrap = _t if port_members else (lambda a: np.array(a, np.float32))

        def round_(r):
            view = cc.view()
            assert view.status == "stable"
            sends = [(n, n + "@GRAD",
                      wrap(np.full(8, 0.1 * r * (k + 1), np.float32)),
                      view.placement[n])
                     for k, n in enumerate(sorted(PARAMS4))]
            gets = [(n, n, view.placement[n]) for n in sorted(PARAMS4)]
            outs = mcomm.elastic_round(sends, gets)
            out.append({n: _np(o) for n, o in zip(sorted(PARAMS4), outs)})

        round_(1)
        round_(2)
        servers[1].stop()
        leases[1]._stop.set()           # SIGKILL semantics
        v2 = ctl.wait_view(v.epoch + 1, timeout_s=15)
        assert v2 is not None and len(v2.pservers) == 1
        round_(3)
        srv, ep = _server(PARAMS4, init={n: np.zeros(8, np.float32)
                                         for n in PARAMS4}, pkg=pkg)
        servers.append(srv)
        leases.append(lease_cls(reg_cls(ctl.registry_addr), "pserver", ep,
                                ttl_s=SURVIVOR_TTL))
        v3 = ctl.wait_view(v2.epoch + 1, timeout_s=15)
        assert v3 is not None and len(v3.pservers) == 2
        assert set(v3.placement.values()) == set(v3.endpoints)
        round_(4)
        for i in (0, 2):
            leases[i].release()
        return out
    finally:
        mcomm.reset_cluster()
        mcomm.reset_comm_pool()
        for srv in servers:
            srv.stop()
        if ctl_cls is not ClusterController:
            # the JAX controller's close() joins its accept thread, which
            # a bare close() of the socket does not wake: shut it first
            import socket

            try:
                ctl._sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        ctl.close()


@pytest.fixture(scope="module")
def jax_cluster_rounds(tmp_path_factory):
    return _cross_scenario("jax", "jax",
                           str(tmp_path_factory.mktemp("jax_cluster")))


@pytest.mark.parametrize("ctl_pkg,member_pkg", [("jax", "port"),
                                                ("port", "jax")])
def test_cluster_across_packages_is_the_jax_clusters(
        ctl_pkg, member_pkg, tmp_path, jax_cluster_rounds):
    """A port trainer and port pservers under a JAX ClusterController,
    and a JAX trainer and JAX pservers under the port's: the parameters
    after every round (through a snapshot restore and a join) are the
    all-JAX cluster's."""
    want = jax_cluster_rounds
    got = _cross_scenario(ctl_pkg, member_pkg, str(tmp_path))
    assert len(got) == len(want) == 4
    for r, (g, w) in enumerate(zip(got, want), 1):
        for n in sorted(PARAMS4):
            np.testing.assert_allclose(g[n], w[n], rtol=1e-6, atol=0,
                                       err_msg=f"round {r} {n}")


# ---------------------------------------------------------------------------
# SIGKILL chaos scenarios (subprocess clusters; -m "slow and chaos")
# ---------------------------------------------------------------------------

_PSERVER_CHILD = r"""
import json, os, sys, time
sys.path.insert(0, {repo!r})
import numpy as np
import torch
import paddle_tpu_torch as fluid
from paddle_tpu_torch.cloud.registry import Lease, RegistryClient
from paddle_tpu_torch.parallel.pserver import VariableServer

reg_addr, snap_dir = sys.argv[1], sys.argv[2]
blocks = json.loads(sys.argv[3])  # {{name: dim}}
lr = float(sys.argv[4])
scope = fluid.Scope()
prog = fluid.Program()
with fluid.program_guard(prog, fluid.Program()):
    blk = prog.global_block()
    blk.create_var(name="lr", shape=[1], dtype="float32",
                   persistable=True)
    for n, d in sorted(blocks.items()):
        blk.create_var(name=n, shape=[d], dtype="float32",
                       persistable=True)
        blk.create_var(name=n + "@GRAD", shape=[d], dtype="float32",
                       persistable=True)
        blk.append_op("sgd", {{"Param": [n], "Grad": [n + "@GRAD"],
                              "LearningRate": ["lr"]}},
                      {{"ParamOut": [n]}}, {{}})
scope.set_var("lr", torch.tensor([lr], dtype=torch.float32))
for n, d in blocks.items():
    scope.set_var(n, torch.zeros(d, dtype=torch.float32))
srv = VariableServer(prog, scope, fluid.Executor(fluid.CPUPlace()),
                     fan_in=1, sync=True, elastic=True,
                     snapshot_dir=snap_dir or None, snapshot_every=1)
port = srv.serve(0)
lease = Lease(RegistryClient(reg_addr), "pserver",
              "127.0.0.1:%d" % port, ttl_s=1.0)
print("READY", port, flush=True)
while True:
    time.sleep(0.2)
"""

_TRAINER_CHILD = r"""
import json, os, signal, sys, time
sys.path.insert(0, {repo!r})
import numpy as np
import torch
from paddle_tpu_torch.cloud.cluster import ClusterClient
from paddle_tpu_torch.parallel import comm
from paddle_tpu_torch.parallel.distributed_spliter import VarDesc

ctl_addr = sys.argv[1]
idx, n_trainers = int(sys.argv[2]), int(sys.argv[3])
steps, kill_at = int(sys.argv[4]), int(sys.argv[5])
out_path, progress_path = sys.argv[6], sys.argv[7]
blocks = json.loads(sys.argv[8])  # {{name: dim}}

cc = ClusterClient(ctl_addr)
comm.set_cluster(cc)
names = sorted(blocks)
dims = [blocks[n] for n in names]
cc.define([VarDesc(n, (d,), "float32") for n, d in zip(names, dims)])
lease = cc.join("trainer", addr="trainer-%d" % idx, ttl_s=1.0)

deadline = time.monotonic() + 60
while True:  # start only at full strength so round 1 uses fan_in=N
    view = cc.ready_view(timeout_s=60)
    if len(view.trainers) >= n_trainers:
        break
    if time.monotonic() > deadline:
        raise SystemExit("membership never completed: %r" % (view,))
    time.sleep(0.1)

D = sum(dims)
rng = np.random.RandomState(7)  # SAME data in every run and trainer
X_all = rng.randn(64, D).astype(np.float32)
w_true = rng.randn(D).astype(np.float32)
y_all = X_all @ w_true
X, y = X_all[idx::n_trainers], y_all[idx::n_trainers]

held = {{}}
cc.set_param_provider(lambda name: held.get(name))

view = cc.ready_view(timeout_s=60)
vals = comm.elastic_round(
    [], [(n, n, view.placement.get(n, "")) for n in names])
w = np.concatenate([np.asarray(v).ravel() for v in vals])
for step in range(1, steps + 1):
    if kill_at and step == kill_at:
        os.kill(os.getpid(), signal.SIGKILL)  # a real crash, no cleanup
    err = X @ w - y
    g = (2.0 / len(X)) * (X.T @ err)
    view = cc.ready_view(timeout_s=120)
    sends, gets, off = [], [], 0
    for n, d in zip(names, dims):
        sends.append((n, n + "@GRAD",
                      torch.from_numpy(np.ascontiguousarray(
                          g[off:off + d], np.float32)),
                      view.placement.get(n, "")))
        gets.append((n, n, view.placement.get(n, "")))
        off += d
    outs = comm.elastic_round(sends, gets)
    w = np.concatenate([np.asarray(v).ravel() for v in outs])
    off = 0
    for n, d in zip(names, dims):
        held[n] = np.ascontiguousarray(w[off:off + d], np.float32)
        off += d
    with open(progress_path, "w") as f:
        f.write(str(step))
    time.sleep(0.02)  # keep kills genuinely mid-training

loss_full = float(np.mean((X_all @ w - y_all) ** 2))
with open(out_path, "w") as f:
    json.dump({{"loss": loss_full, "w": [float(t) for t in w]}}, f)
lease.release()
print("DONE", loss_full, flush=True)
"""

_READER_CHILD = r"""
import json, os, signal, sys
sys.path.insert(0, {repo!r})
from paddle_tpu_torch.cloud.master import MasterClient, task_record_reader

addr, out_path, kill_first = sys.argv[1], sys.argv[2], sys.argv[3]
c = MasterClient(addr)
if kill_first == "1":
    got = c.get_task()   # lease a task and die holding it
    assert got is not None
    print("GOT", got[0], flush=True)
    os.kill(os.getpid(), signal.SIGKILL)
records = list(task_record_reader(c, lambda chunk: [chunk],
                                  poll_interval=0.05)())
with open(out_path, "w") as f:
    json.dump(records, f)
print("DONE", flush=True)
"""

_BLOCKS = {f"b{i}": 2 for i in range(4)}  # 4 param blocks, D=8


def _spawn(script_text, args, tmp_path, name):
    script = tmp_path / f"{name}.py"
    if not script.exists():
        script.write_text(script_text.format(repo=REPO))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.Popen(
        [sys.executable, str(script)] + [str(a) for a in args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env)


def _wait_ready(proc, what, timeout_s=120):
    line = ""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if line.startswith(("READY", "GOT")):
            return line.split()
        if proc.poll() is not None:
            break
    raise AssertionError(
        f"{what} never came up (rc={proc.poll()}): "
        f"{line!r}\n{proc.stderr.read() if proc.stderr else ''}")


def _progress(path):
    try:
        return int(open(path).read().strip() or 0)
    except (OSError, ValueError):
        return 0


def _reap(*procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait(timeout=30)


def _linreg():
    names = sorted(_BLOCKS)
    dims = [_BLOCKS[n] for n in names]
    D = sum(dims)
    rng = np.random.RandomState(7)
    X = rng.randn(64, D).astype(np.float32)
    w_true = rng.randn(D).astype(np.float32)
    return names, dims, X, X @ w_true


def _train_steps(cc, names, dims, X, y, steps, before_step=None):
    w = np.zeros(sum(dims), np.float32)
    for step in range(steps):
        if before_step is not None:
            before_step(step)
        err = X @ w - y
        g = (2.0 / len(X)) * (X.T @ err)
        view = cc.ready_view(timeout_s=60)
        sends, gets, off = [], [], 0
        for n, d in zip(names, dims):
            sends.append((n, n + "@GRAD",
                          _t(np.ascontiguousarray(g[off:off + d])),
                          view.placement.get(n, "")))
            gets.append((n, n, view.placement.get(n, "")))
            off += d
        outs = comm.elastic_round(sends, gets)
        w = np.concatenate([_np(o).ravel() for o in outs])
    return w


@pytest.mark.chaos
@pytest.mark.slow
class TestSigkillScenarios:
    def test_sigkill_pserver_mid_training(self, tmp_path):
        snap = {0: str(tmp_path / "ps0"), 1: str(tmp_path / "ps1")}
        ctl = _controller({n: np.zeros(d, np.float32)
                           for n, d in _BLOCKS.items()},
                          min_pservers=2, snapshot_dirs=snap,
                          push_timeout_s=2.0)
        ps = []
        try:
            for i in range(2):
                ps.append(_spawn(_PSERVER_CHILD,
                                 [ctl.registry_addr, snap[i],
                                  json.dumps(_BLOCKS), 0.05],
                                 tmp_path, "pserver_child"))
                _wait_ready(ps[i], f"pserver {i}")
                _wait(lambda: len(ctl._reg.list("pserver")) == i + 1,
                      what="registration")
            v1 = ctl.wait_view(1, timeout_s=30)
            assert v1 is not None and len(v1.pservers) == 2
            cc = ClusterClient(ctl.addr)
            comm.set_cluster(cc)
            names, dims, X, y = _linreg()

            def kill(step):
                if step == 10:
                    ps[1].kill()  # SIGKILL, lease expires by TTL

            w = _train_steps(cc, names, dims, X, y, 80, kill)
            final = cc.ready_view(timeout_s=10)
            assert final.endpoints != v1.endpoints  # really rebalanced
            loss = float(np.mean((X @ w - y) ** 2))
            assert loss < 0.05, f"did not converge through the kill: {loss}"
        finally:
            _reap(*ps)
            ctl.close()

    def test_sigkill_trainer_master_reclaims_task(self, tmp_path):
        from paddle_tpu_torch.cloud.master import Master

        m = Master(failure_max=3, timeout_s=1.0)
        chunks = [f"chunk-{i}" for i in range(8)]
        m.set_dataset(chunks, 1)
        port = m.serve(0)
        addr = f"127.0.0.1:{port}"
        out = tmp_path / "survivor.json"
        victim = _spawn(_READER_CHILD, [addr, tmp_path / "v.json", 1],
                        tmp_path, "reader_child")
        try:
            _wait_ready(victim, "victim reader")
            victim.wait(timeout=30)
            assert victim.returncode == -9
            assert m.counts()["pending"] == 1
            survivor = _spawn(_READER_CHILD, [addr, out, 0],
                              tmp_path, "reader_child")
            rc = survivor.wait(timeout=120)
            assert rc == 0, survivor.stderr.read()
            got = json.loads(out.read_text())
            assert sorted(got) == sorted(chunks)  # all EXACTLY once
            counts = m.reclaim_expired()
            assert counts["pending"] == 0 and counts["todo"] == 0
            assert counts["done"] == len(chunks)
            assert counts["discarded"] == 0
        finally:
            _reap(victim)
            m.stop()

    def test_pserver_join_mid_run(self, tmp_path):
        ctl = _controller({n: np.zeros(d, np.float32)
                           for n, d in _BLOCKS.items()},
                          min_pservers=1, push_timeout_s=2.0)
        p0 = _spawn(_PSERVER_CHILD,
                    [ctl.registry_addr, "", json.dumps(_BLOCKS), 0.05],
                    tmp_path, "pserver_child")
        procs = [p0]
        try:
            _wait_ready(p0, "pserver 0")
            v1 = ctl.wait_view(1, timeout_s=30)
            assert v1 is not None and len(v1.pservers) == 1
            cc = ClusterClient(ctl.addr)
            comm.set_cluster(cc)
            names, dims, X, y = _linreg()

            def join(step):
                if step == 10:
                    p1 = _spawn(_PSERVER_CHILD,
                                [ctl.registry_addr, "",
                                 json.dumps(_BLOCKS), 0.05],
                                tmp_path, "pserver_child")
                    procs.append(p1)
                    _wait_ready(p1, "joining pserver")

            w = _train_steps(cc, names, dims, X, y, 80, join)
            final = cc.ready_view(timeout_s=10)
            assert len(final.pservers) == 2, "join never landed"
            assert len(set(final.placement.values())) == 2  # re-split
            loss = float(np.mean((X @ w - y) ** 2))
            assert loss < 0.05, f"did not converge through the join: {loss}"
        finally:
            _reap(*procs)
            ctl.close()


@pytest.mark.chaos
@pytest.mark.slow
def test_chaos_acceptance_kill_one_pserver_and_one_trainer(tmp_path):
    """A 2-pserver x 2-trainer cluster loses one pserver AND one trainer
    to SIGKILL mid-training; the surviving processes finish without
    restart and match the undisturbed run's quality, with the view and
    rebalance series in the port's observability.metrics registry."""
    names, dims, X_all, y_all = _linreg()

    def run_cluster(tag, kill):
        snap = {i: str(tmp_path / f"{tag}-ps{i}") for i in range(2)}
        ctl = _controller({n: np.zeros(d, np.float32)
                           for n, d in _BLOCKS.items()},
                          min_pservers=2, snapshot_dirs=snap,
                          push_timeout_s=2.0)
        ps, tr = [], []
        try:
            for i in range(2):
                p = _spawn(_PSERVER_CHILD,
                           [ctl.registry_addr, snap[i],
                            json.dumps(_BLOCKS), 0.05],
                           tmp_path, "pserver_child")
                ps.append(p)
                _wait_ready(p, f"{tag} pserver {i}")
                _wait(lambda: len(ctl._reg.list("pserver")) == i + 1,
                      what="registration")
            assert ctl.wait_view(1, timeout_s=30) is not None
            outs = [tmp_path / f"{tag}-t{i}.json" for i in range(2)]
            progress = [tmp_path / f"{tag}-t{i}.progress"
                        for i in range(2)]
            for i in range(2):
                kill_at = 30 if (kill and i == 1) else 0
                tr.append(_spawn(
                    _TRAINER_CHILD,
                    [ctl.addr, i, 2, 120, kill_at, outs[i],
                     progress[i], json.dumps(_BLOCKS)],
                    tmp_path, "trainer_child"))
            if kill:
                _wait(lambda: _progress(progress[0]) >= 10,
                      timeout_s=120, what="training to reach step 10")
                ps[1].kill()
            rc = tr[0].wait(timeout=300)
            assert rc == 0, f"{tag} trainer 0 died: {tr[0].stderr.read()}"
            if kill:
                tr[1].wait(timeout=60)
                assert tr[1].returncode == -9  # genuinely SIGKILLed
            else:
                assert tr[1].wait(timeout=300) == 0
            result = json.loads(outs[0].read_text())
            w = np.asarray(result["w"], np.float32)
            return float(np.mean((X_all @ w - y_all) ** 2))
        finally:
            _reap(*(ps + tr))
            ctl.close()

    was = obs_metrics.enabled()
    obs_metrics.set_enabled(True)
    try:
        undisturbed = run_cluster("calm", kill=False)
        disturbed = run_cluster("chaos", kill=True)
        assert disturbed < max(undisturbed + 0.05, 0.05), (
            f"chaos run lost quality: {disturbed} vs {undisturbed}")
        snap = obs_metrics.registry().snapshot()
        for series in ("paddle_tpu_cluster_view_epoch",
                       "paddle_tpu_cluster_rebalances_total",
                       "paddle_tpu_cluster_membership_changes_total"):
            assert series in snap, series
    finally:
        obs_metrics.set_enabled(was)
