"""The port's reader ops (paddle_tpu_torch/ops/reader.py) against the JAX
package's, on the CPU: the chain of tests/test_parity_ops.py:218-243
(create_random_data_generator -> create_shuffle_reader ->
create_batch_reader -> read) gives the JAX package's values bit for bit,
batch after batch, and `read` raises EOFError at the end of a finite
reader and starts over after `reset`.  The readers are host values in
the scope: the Executor passes them through in every mode."""
import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu.core import executor as jexecutor
from paddle_tpu.ops import io_ops as jio

import paddle_tpu_torch as tfluid
import paddle_tpu_torch.core.framework as tfw
from paddle_tpu_torch.core import executor as texecutor
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.core.scope import Scope
from paddle_tpu_torch.ops import reader as treader


@pytest.fixture(autouse=True)
def _fresh_port_state():
    old_scope = texecutor.switch_scope(Scope())
    old_jscope = jexecutor.switch_scope(jfluid.Scope())
    tfw.reset_unique_names()
    tflags.reset_flags()
    yield
    texecutor.switch_scope(old_scope)
    jexecutor.switch_scope(old_jscope)
    tflags.reset_flags()


def _chain(fluid, shapes, buffer_size, batch_size, seed=0, persist=False):
    """The reader chain in a Program; with `persist` the readers are made
    by a startup program and kept in the scope, and main only reads ->
    (main, startup, the read outputs)."""
    main, startup = fluid.Program(), fluid.Program()
    make = startup if persist else main
    blk, mblk = make.global_block(), main.global_block()
    names = ["raw_reader", "shuf_reader", "batch_reader"]
    for n in names:
        blk.create_var(name=n, persistable=persist)
        if persist:
            mblk.create_var(name=n, persistable=True)
    outs = [mblk.create_var(name=f"sample{i}", dtype="float32")
            for i in range(len(shapes))]
    blk.append_op("create_random_data_generator", {}, {"Out": [names[0]]},
                  {"shape_concat": [d for s in shapes for d in s],
                   "ranks": [len(s) for s in shapes],
                   "lod_levels": [0] * len(shapes), "min": -1.0,
                   "max": 2.0, "seed": seed})
    blk.append_op("create_shuffle_reader", {"UnderlyingReader": [names[0]]},
                  {"Out": [names[1]]}, {"buffer_size": buffer_size})
    blk.append_op("create_batch_reader", {"UnderlyingReader": [names[1]]},
                  {"Out": [names[2]]}, {"batch_size": batch_size})
    mblk.append_op("read", {"Reader": [names[2]]},
                   {"Out": [o.name for o in outs]}, {})
    return main, startup, outs


def test_the_parity_chain_matches_jax():
    """tests/test_parity_ops.py:218-243's chain: the first batch."""
    got = []
    for fluid in (tfluid, jfluid):
        main, _, outs = _chain(fluid, [(2, 3)], 8, 4)
        got.append(fluid.Executor(fluid.CPUPlace()).run(main,
                                                        fetch_list=outs)[0])
    assert np.asarray(got[0]).shape == (4, 2, 3)
    np.testing.assert_array_equal(got[0], got[1])


@pytest.mark.parametrize("compiled", [True, False])
def test_a_kept_chain_reads_batch_after_batch_like_jax(compiled):
    """Readers made once by a startup program, read by main run after run
    (two slots, a shuffle buffer that does not divide the batches), in
    the default mode and in the interpreter: every batch equal to the
    JAX package's."""
    shapes = [(3, 4), (1,)]
    runs = {}
    for name, fluid in (("port", tfluid), ("jax", jfluid)):
        main, startup, outs = _chain(fluid, shapes, 6, 4, seed=5,
                                     persist=True)
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup)
        kw = {} if name == "jax" else {"compiled": compiled}
        runs[name] = [exe.run(main, fetch_list=outs, **kw)
                      for _ in range(5)]
    for t, j in zip(runs["port"], runs["jax"]):
        assert [a.shape for a in t] == [(4, 3, 4), (4, 1)]
        for a, b in zip(t, j):
            np.testing.assert_array_equal(a, b)


def test_read_raises_at_the_end_and_reset_starts_over():
    """A finite reader under the batch reader: batches of 4, 4 and 2
    items, then EOFError from `read`; after reset the same batches
    again.  The classes' draws equal the JAX package's classes'."""
    class Finite:
        def __init__(self, items):
            self.items, self.at = items, 0

        def read_next(self):
            if self.at == len(self.items):
                return None
            self.at += 1
            return [self.items[self.at - 1]]

        def reset(self):
            self.at = 0

    items = [np.full((2,), i, np.float32) for i in range(10)]
    readers = {"port": treader.BatchReader(treader.ShuffleReader(
        Finite(items), 4, seed=1), 4),
        "jax": jio._BatchReader(jio._ShuffleReader(Finite(items), 4,
                                                   seed=1), 4)}
    main, startup = tfluid.Program(), tfluid.Program()
    blk = main.global_block()
    blk.create_var(name="r", persistable=True)
    out = blk.create_var(name="x", dtype="float32")
    blk.append_op("read", {"Reader": ["r"]}, {"Out": [out.name]}, {})
    exe = tfluid.Executor(tfluid.CPUPlace())
    tfluid.global_scope().set_var("r", readers["port"])

    def epoch():
        got = [exe.run(main, fetch_list=[out])[0] for _ in range(3)]
        with pytest.raises(EOFError):
            exe.run(main, fetch_list=[out])
        return got

    first = epoch()
    assert [g.shape[0] for g in first] == [4, 4, 2]
    want = [readers["jax"].read_next()[0] for _ in range(3)]
    assert readers["jax"].read_next() is None
    for a, b in zip(first, want):
        np.testing.assert_array_equal(a, b)
    readers["port"].reset()
    readers["jax"].reset()
    again = epoch()
    for a, b in zip(again, [readers["jax"].read_next()[0]
                            for _ in range(3)]):
        np.testing.assert_array_equal(a, b)
    assert sorted(np.concatenate(again)[:, 0]) == list(range(10))


def test_the_random_reader_draws_the_jax_packages_values():
    t = treader.RandomDataReader([(3, 2), (4,)], -0.5, 0.5, seed=9)
    j = jio._RandomDataReader([(3, 2), (4,)], -0.5, 0.5, seed=9)
    for _ in range(3):
        for a, b in zip(t.read_next(), j.read_next()):
            assert a.dtype == np.float32
            np.testing.assert_array_equal(a, b)
