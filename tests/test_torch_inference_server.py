"""The port's `InferenceServer` (paddle_tpu_torch/serving/batching.py)
against the JAX package's, on the CPU: tests/test_serving.py's cases in
the port, and the outputs of both servers on the same pruned Program
and the same weights (the JAX startup's, copied into the port) within
float32 tolerance (2e-5 relative, the JAX test's own bound against its
Executor).

Pins the serving contract: per-request results equal direct execution
(dynamic batching must not change numerics), concurrent submits
aggregate into fewer dispatches, padding to a bucket never leaks, the
deadline shed path updates the queue-depth gauge, a bad request shape
raises, a full queue raises ServerSaturated and close() fails what is
still queued.
"""
import time

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu.core.framework as jfw
from paddle_tpu.io import prune as jprune
from paddle_tpu.serving import InferenceServer as JServer

import paddle_tpu_torch as tfluid
import paddle_tpu_torch.core.framework as tfw
from paddle_tpu_torch import CPUPlace
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.core.scope import Scope, scope_from_numpy
from paddle_tpu_torch.io import prune as tprune
from paddle_tpu_torch.serving import (InferenceServer, RequestDeadlineExceeded,
                                      ServerSaturated, batching)

CPU = CPUPlace()


@pytest.fixture(autouse=True)
def _fresh_port_state():
    tfw.reset_unique_names()
    tflags.reset_flags()
    yield
    tflags.reset_flags()


def _build_cnn(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        img = fluid.layers.data(name="img", shape=[3, 16, 16],
                                dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        conv = fluid.layers.conv2d(input=img, num_filters=4,
                                   filter_size=3, act="relu")
        bn = fluid.layers.batch_norm(input=conv)
        pool = fluid.layers.pool2d(input=bn, pool_size=2, pool_stride=2)
        predict = fluid.layers.fc(input=pool, size=10, act="softmax")
        cost = fluid.layers.mean(
            fluid.layers.cross_entropy(input=predict, label=label))
        fluid.SGD(learning_rate=0.1).minimize(cost)
    return main, startup, predict


def _port_server_program():
    tfw.reset_unique_names()
    main, startup, predict = _build_cnn(tfluid)
    scope = Scope()
    exe = tfluid.Executor(CPU)
    exe.run(startup, scope=scope)
    return exe, scope, tprune(main, [predict], for_test=True), predict


def test_server_matches_direct_and_aggregates():
    exe, scope, infer_prog, predict = _port_server_program()
    imgs = np.random.RandomState(0).rand(13, 3, 16, 16).astype(np.float32)
    direct, = exe.run(infer_prog, feed={"img": imgs}, fetch_list=[predict],
                      scope=scope)
    server = InferenceServer(infer_prog, "img", predict, scope, place=CPU,
                             buckets=(1, 2, 4, 8), window_ms=5.0)
    try:
        futs = [server.submit(imgs[i]) for i in range(13)]
        outs = np.concatenate([np.asarray(f.result()) for f in futs])
        np.testing.assert_allclose(outs, direct, rtol=2e-5, atol=1e-6)
        stats = server.stats()
        assert stats["requests"] == 13
        assert stats["dispatches"] < 13, stats
        # one eager run a bucket at construction, and every dispatch
        # after it ran the same function
        assert server.graph_stats()["eager_runs"] == 4 + stats["dispatches"]
    finally:
        server.close()


def test_outputs_equal_the_jax_server():
    """Both servers on the same pruned Program and weights: equal
    outputs request by request."""
    jfw.reset_unique_names()
    jmain, jstartup, jpredict = _build_cnn(jfluid)
    jscope = jfluid.Scope()
    jfluid.Executor(jfluid.CPUPlace()).run(jstartup, scope=jscope)
    jinfer = jprune(jmain, [jpredict], for_test=True)
    weights = {v.name: np.asarray(jscope.find_var(v.name))
               for v in jmain.list_vars()
               if v.persistable and jscope.find_var(v.name) is not None}
    _, _, tinfer, tpredict = _port_server_program()
    tscope = scope_from_numpy(weights, CPU)
    imgs = np.random.RandomState(1).rand(7, 3, 16, 16).astype(np.float32)
    jsrv = JServer(jinfer, "img", jpredict, jscope, place=jfluid.CPUPlace(),
                   buckets=(1, 2, 4, 8), window_ms=5.0)
    tsrv = InferenceServer(tinfer, "img", tpredict, tscope, place=CPU,
                           buckets=(1, 2, 4, 8), window_ms=5.0)
    try:
        want = [np.asarray(f.result()) for f in
                [jsrv.submit(imgs[i]) for i in range(7)]]
        got = [np.asarray(f.result()) for f in
               [tsrv.submit(imgs[i]) for i in range(7)]]
    finally:
        jsrv.close()
        tsrv.close()
    for g, w in zip(got, want):
        assert g.shape == w.shape == (1, 10)
        np.testing.assert_allclose(g, w, rtol=2e-5, atol=1e-6)


def test_serving_package_exports():
    import paddle_tpu_torch.serving as serving
    from paddle_tpu_torch.serving.batching import InferenceServer as Impl

    assert serving.InferenceServer is Impl
    assert issubclass(ServerSaturated, RuntimeError)
    assert issubclass(RequestDeadlineExceeded, TimeoutError)


def test_queue_depth_gauge_updates_on_deadline_shed():
    from paddle_tpu_torch.core.resilience import fault_injector
    from paddle_tpu_torch.observability import metrics as obs_metrics

    _, scope, infer_prog, predict = _port_server_program()
    was = obs_metrics.enabled()
    obs_metrics.set_enabled(True)
    inj = fault_injector()
    inj.clear()
    # stall the FIRST dispatch so requests with tiny deadlines pile up
    # behind it and all expire in the queue
    inj.inject("serving.dispatch", "delay", delay_s=0.8, nth=1, count=1)
    server = InferenceServer(infer_prog, "img", predict, scope, place=CPU,
                             buckets=(1,), window_ms=0.1, max_queue=16)
    x = np.zeros((3, 16, 16), np.float32)
    try:
        f1 = server.submit(x)
        time.sleep(0.2)       # the worker holds f1 inside the stall
        doomed = [server.submit(x, deadline_ms=1.0) for _ in range(3)]
        gauge = batching._M_QDEPTH.labels(server=server._sid)
        assert gauge.value >= 3
        for fut in doomed:
            with pytest.raises(RequestDeadlineExceeded):
                fut.result(timeout=30)
        assert np.asarray(f1.result(timeout=30)).shape == (1, 10)
        deadline = time.monotonic() + 5
        while gauge.value != 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert gauge.value == 0, gauge.value
        assert server.stats()["deadline_expired"] == 3
    finally:
        inj.clear()
        server.close()
        obs_metrics.set_enabled(was)


def test_single_request_shape_check_saturation_and_close():
    from paddle_tpu_torch.core.resilience import fault_injector

    _, scope, infer_prog, predict = _port_server_program()
    server = InferenceServer(infer_prog, "img", predict, scope, place=CPU,
                             buckets=(1, 4))
    try:
        out = server.infer(np.zeros((3, 16, 16), np.float32))
        assert out.shape == (1, 10)
        with pytest.raises(ValueError, match="request shape"):
            server.submit(np.zeros((3, 8, 8), np.float32))
    finally:
        server.close()
    with pytest.raises(RuntimeError, match="closed"):
        server.submit(np.zeros((3, 16, 16), np.float32))

    inj = fault_injector()
    inj.clear()
    inj.inject("serving.dispatch", "delay", delay_s=0.5, nth=1, count=1)
    server = InferenceServer(infer_prog, "img", predict, scope, place=CPU,
                             buckets=(1,), window_ms=0.1, max_queue=2)
    try:
        first = server.submit(np.zeros((3, 16, 16), np.float32))
        time.sleep(0.2)        # the worker holds it inside the stall
        queued = [server.submit(np.zeros((3, 16, 16), np.float32))
                  for _ in range(2)]
        with pytest.raises(ServerSaturated):
            server.submit(np.zeros((3, 16, 16), np.float32))
        assert server.stats()["shed"] == 1
    finally:
        inj.clear()
        server.close()
    assert first.result(timeout=30).shape == (1, 10)
    # close() fails (or the worker finished) every queued future
    for f in queued:
        try:
            assert f.result(timeout=30).shape == (1, 10)
        except RuntimeError as e:
            assert "closed" in str(e)
