"""The port's CSP surface (paddle_tpu_torch/concurrency.py):
make_channel / channel_send / channel_recv / channel_close / go over the
port's native channels, each case of tests/test_concurrency.py held on
the port, the same programs giving the JAX package's results.
"""
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid

import paddle_tpu_torch as tfluid

PACKAGES = {"port": tfluid, "jax": jfluid}


def test_the_surface_is_exported_like_the_jax_packages():
    names = ("make_channel", "channel_send", "channel_recv",
             "channel_close", "go", "Go")
    for n in names:
        assert callable(getattr(tfluid, n)), n
    from paddle_tpu_torch import concurrency

    assert concurrency.__all__ == jfluid.concurrency.__all__


def test_buffered_channel_fifo_and_close():
    fluid = tfluid
    ch = fluid.make_channel(dtype=int, capacity=3)
    assert fluid.channel_send(ch, 1)
    assert fluid.channel_send(ch, 2)
    assert fluid.channel_send(ch, 3)
    assert len(ch) == 3
    assert fluid.channel_recv(ch) == 1
    assert fluid.channel_recv(ch) == 2
    fluid.channel_close(ch)
    assert fluid.channel_recv(ch) == 3   # drain after close
    assert fluid.channel_recv(ch) is None  # closed + drained
    assert not fluid.channel_send(ch, 4)   # send on closed fails


def test_unbuffered_channel_rendezvous():
    fluid = tfluid
    ch = fluid.make_channel(dtype=str)
    state = {"sent": False}

    def sender():
        fluid.channel_send(ch, "hello")
        state["sent"] = True

    t = threading.Thread(target=sender, daemon=True)
    t.start()
    time.sleep(0.1)
    assert not state["sent"]  # blocked until a receiver arrives
    assert fluid.channel_recv(ch) == "hello"
    t.join(timeout=10)
    assert state["sent"]
    fluid.channel_close(ch)


def test_channel_type_check_and_arrays():
    fluid = tfluid
    ch = fluid.make_channel(dtype=int, capacity=1)
    with pytest.raises(TypeError):
        fluid.channel_send(ch, "nope")
    anych = fluid.make_channel(capacity=2)
    x = np.arange(6).reshape(2, 3)
    fluid.channel_send(anych, x)
    np.testing.assert_array_equal(fluid.channel_recv(anych), x)
    t = torch.arange(6, dtype=torch.bfloat16).reshape(2, 3)
    fluid.channel_send(anych, t)
    got = fluid.channel_recv(anych)
    assert got.dtype == torch.bfloat16 and torch.equal(got, t)


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_go_daisy_chain(pkg):
    """Paddle's CSP demo (notest_csp.py:19-33) at n=100: a chain of
    goroutines each adding 1; leftmost receives n+1, in both packages."""
    fluid = PACKAGES[pkg]
    n = 100
    leftmost = fluid.make_channel(dtype=int)
    left = leftmost
    with fluid.go() as g:
        for _ in range(n):
            right = fluid.make_channel(dtype=int)
            g(lambda l=left, r=right: fluid.channel_send(
                l, 1 + fluid.channel_recv(r)))
            left = right
        g(lambda r=left: fluid.channel_send(r, 1))
    got = fluid.channel_recv(leftmost)
    g.wait(timeout=30)
    assert got == n + 1, got


def test_go_exception_surfaces_on_wait():
    h = tfluid.Go().spawn(lambda: (_ for _ in ()).throw(ValueError("boom")))
    with pytest.raises(ValueError, match="boom"):
        h.wait(timeout=10)


def test_wait_inside_the_go_block_raises():
    with pytest.raises(RuntimeError, match="inside the `with go"):
        with tfluid.go() as g:
            g(lambda: None)
            g.wait()


def test_go_block_runs_a_program_and_sends_its_result():
    """A goroutine runs an Executor on the CPU and sends the fetch
    through a channel: the value the main thread computes."""
    from paddle_tpu_torch.core.scope import Scope

    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="x", shape=[4], dtype="float32")
        y = tfluid.layers.fc(input=x, size=3)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), Scope()
    exe.run(startup, scope=scope)
    xv = np.random.RandomState(1).rand(2, 4).astype(np.float32)
    ch = tfluid.make_channel(capacity=1)
    with tfluid.go() as g:
        g(lambda: tfluid.channel_send(ch, exe.run(
            main, feed={"x": xv}, fetch_list=[y], scope=scope)[0]))
    got = tfluid.channel_recv(ch)
    g.wait(timeout=60)
    want = exe.run(main, feed={"x": xv}, fetch_list=[y], scope=scope)[0]
    np.testing.assert_array_equal(got, want)
