"""The port's training conveniences against the JAX package, on the CPU:
the Trainer (events, prefetch, LazyFetch, checkpoints and the
kill-and-resume), its reader pipeline, the reader decorators and
creators, the evaluators, the profiler's host events and the flight
recorder.

The Trainer is held to itself the way tests/test_async_feed.py and
tests/test_resilience.py hold the JAX package's: a run killed at an
iteration by the `trainer.iteration` fault site and resumed in a fresh
scope ends bit for bit where an uninterrupted run ends (the step count,
every loss, every persistable), and so does a load of an earlier
snapshot into the same scope and Executor; the prefetching loop's
parameters equal the serial loop's.  The decorators give the JAX
package's samples in its order for the same seeds; the evaluators'
`eval()` equals the JAX package's over three mini-batches.
"""
import json
import os
import random

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu.core.framework as jfw
import paddle_tpu.reader as jreader
from paddle_tpu import evaluator as jevaluator
from paddle_tpu.core import executor as jexecutor
from paddle_tpu.core.lod import LoDTensor as JLoDTensor

import paddle_tpu_torch as tfluid
import paddle_tpu_torch.core.framework as tfw
import paddle_tpu_torch.reader as treader
from paddle_tpu_torch import evaluator as tevaluator
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import profiler
from paddle_tpu_torch import trainer as trainer_mod
from paddle_tpu_torch.core import executor as texecutor
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.core.lod import LoDTensor
from paddle_tpu_torch.core.resilience import fault_injector
from paddle_tpu_torch.core.scope import Scope
from paddle_tpu_torch.observability import flightrecorder

CPU = tfluid.CPUPlace()


@pytest.fixture(autouse=True)
def _fresh_port_state():
    old_main = tfw.switch_main_program(tfw.Program())
    old_startup = tfw.switch_startup_program(tfw.Program())
    old_scope = texecutor.switch_scope(Scope())
    old_jscope = jexecutor.switch_scope(jfluid.Scope())
    tfw.reset_unique_names()
    jfw.reset_unique_names()
    tflags.reset_flags()
    fault_injector().clear()
    yield
    tfw.switch_main_program(old_main)
    tfw.switch_startup_program(old_startup)
    texecutor.switch_scope(old_scope)
    jexecutor.switch_scope(old_jscope)
    tflags.reset_flags()
    fault_injector().clear()


# -- the Trainer -------------------------------------------------------------

def _mlp():
    tfw.reset_unique_names()
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="x", shape=[4], dtype="float32")
        y = tfluid.layers.data(name="y", shape=[1], dtype="float32")
        h = tfluid.layers.fc(input=x, size=8, act="relu")
        pred = tfluid.layers.fc(input=h, size=1)
        loss = tfluid.layers.mean(tfluid.layers.square_error_cost(
            input=pred, label=y))
        tfluid.Adam(learning_rate=0.01).minimize(loss)
    return main, startup, x, y, pred, loss


def _batches(n_batches=4, batch_size=3):
    r = np.random.RandomState(0)
    data = [(r.rand(4).astype(np.float32), r.rand(1).astype(np.float32))
            for _ in range(n_batches * batch_size)]

    def reader():
        for i in range(0, len(data), batch_size):
            yield data[i:i + batch_size]

    return reader


def _persistables(main, scope):
    return {v.name: scope.find_var(v.name).clone()
            for v in main.list_vars() if v.persistable}


def _assert_bit_equal(got, want):
    assert set(got) == set(want)
    for n in want:
        assert got[n].dtype == want[n].dtype and torch.equal(got[n],
                                                             want[n]), n


def _trainer(main, startup, x, y, loss, scope):
    texecutor.switch_scope(scope)
    return trainer_mod.Trainer(loss, feed_list=[x, y], main_program=main,
                               startup_program=startup, place=CPU)


def _losses():
    got = []

    def handler(e):
        if isinstance(e, trainer_mod.EndIteration):
            got.append((e.pass_id, e.batch_id, float(e.cost)))
    return got, handler


def test_killed_trainer_resumes_bit_for_bit(tmp_path):
    """Uninterrupted 3 passes x 4 batches against a run killed at its 6th
    iteration (a snapshot every 2: the newest at step 4) and resumed in
    a fresh scope: the step count, the losses of steps 5-12 and every
    persistable (parameters, both Adam moments, the beta-pow
    accumulators, the learning rate) are bit-equal."""
    main, startup, x, y, _, loss = _mlp()
    ref_scope = Scope()
    t_ref = _trainer(main, startup, x, y, loss, ref_scope)
    ref_losses, handler = _losses()
    t_ref.train(3, _batches(), event_handler=handler)
    assert t_ref.step == 12
    want = _persistables(main, ref_scope)

    fault_injector().inject("trainer.iteration", "error", nth=6,
                            exc=RuntimeError("killed"))
    t_crash = _trainer(main, startup, x, y, loss, Scope())
    with pytest.raises(RuntimeError, match="killed"):
        t_crash.train(3, _batches(), resume_from=str(tmp_path),
                      checkpoint_every_n_passes=0,
                      checkpoint_every_n_iters=2)
    fault_injector().clear()
    assert t_crash.step == 5

    scope = Scope()
    t_res = _trainer(main, startup, x, y, loss, scope)
    got_losses, handler = _losses()
    t_res.train(3, _batches(), resume_from=str(tmp_path),
                checkpoint_every_n_passes=0, checkpoint_every_n_iters=2,
                event_handler=handler)
    assert t_res.step == 12
    assert got_losses == ref_losses[4:]
    _assert_bit_equal(_persistables(main, scope), want)


def test_loading_a_snapshot_into_the_live_scope_replays_the_same_steps(
        tmp_path):
    """The in-process variant: after 4 steps, load step 2's snapshot
    into the same scope through the same Executor and run steps 3-4
    again: the losses and persistables equal the first time's."""
    main, startup, x, y, _, loss = _mlp()
    scope = Scope()
    t = _trainer(main, startup, x, y, loss, scope)
    losses, handler = _losses()
    seen = {}

    def keep(e):
        handler(e)
        if isinstance(e, trainer_mod.EndIteration) and t.step == 4:
            seen.update(_persistables(main, scope))

    t.train(1, _batches(), checkpoint_dir=str(tmp_path),
            checkpoint_every_n_passes=0, checkpoint_every_n_iters=2,
            event_handler=keep)
    snaps = {}
    for name in os.listdir(str(tmp_path)):
        meta = os.path.join(str(tmp_path), name, tio.META_FILENAME)
        if os.path.exists(meta):
            snaps[json.load(open(meta))["trainer_args"]["step"]] = name
    tio.load_persistables(t.exe, os.path.join(str(tmp_path), snaps[2]),
                          main)
    feeder = t._feeder()
    again = []
    for batch in list(_batches()())[2:4]:
        out = t.exe.run(main, feed=feeder.feed(batch), fetch_list=[loss])
        again.append(float(out[0].reshape(-1)[0]))
    assert again == [c for _, _, c in losses[2:4]]
    _assert_bit_equal(_persistables(main, scope), seen)


def test_resume_at_a_pass_boundary_replays_no_pass(tmp_path):
    main, startup, x, y, _, loss = _mlp()
    fault_injector().inject("trainer.iteration", "error", nth=5,
                            exc=RuntimeError("killed"))
    t = _trainer(main, startup, x, y, loss, Scope())
    with pytest.raises(RuntimeError):
        t.train(2, _batches(), resume_from=str(tmp_path),
                checkpoint_every_n_passes=0, checkpoint_every_n_iters=4)
    fault_injector().clear()
    events = []
    t2 = _trainer(main, startup, x, y, loss, Scope())
    t2.train(2, _batches(), resume_from=str(tmp_path),
             checkpoint_every_n_passes=0, checkpoint_every_n_iters=4,
             event_handler=events.append)
    assert t2.step == 8
    assert [e.pass_id for e in events
            if isinstance(e, trainer_mod.BeginPass)] == [1]
    assert [e.pass_id for e in events
            if isinstance(e, trainer_mod.EndPass)] == [1]


@pytest.mark.parametrize("prefetch,sync_every_n", [(2, 1), (2, 3), (0, 3)])
def test_async_loop_equals_the_serial_loop(prefetch, sync_every_n):
    """prefetch and LazyFetch costs run the same ops in the same order:
    the same losses and parameters, bit for bit; the pipeline's profiler
    events are recorded."""
    main, startup, x, y, _, loss = _mlp()
    ref_scope = Scope()
    t = _trainer(main, startup, x, y, loss, ref_scope)
    ref, handler = _losses()
    t.train(2, _batches(), event_handler=handler)
    want = _persistables(main, ref_scope)

    scope = Scope()
    t2 = _trainer(main, startup, x, y, loss, scope)
    got, handler = _losses()
    costs = []
    with profiler.profiler("All", print_table=False):
        t2.train(2, _batches(), prefetch=prefetch,
                 sync_every_n=sync_every_n,
                 event_handler=lambda e: (handler(e), costs.append(
                     getattr(e, "cost", None))))
        totals = profiler.event_totals()
    assert got == ref
    _assert_bit_equal(_persistables(main, scope), want)
    lazy = [c for c in costs if isinstance(c, trainer_mod.LazyFetch)]
    assert bool(lazy) == (sync_every_n > 1)
    assert "feed.pack" in totals
    if prefetch:
        assert {"pipeline.h2d", "pipeline.wait"} <= set(totals)


def test_trainer_events_test_and_infer():
    main, startup, x, y, pred, loss = _mlp()
    t = _trainer(main, startup, x, y, loss, Scope())
    kinds = []
    t.train(1, _batches(n_batches=2),
            event_handler=lambda e: kinds.append(type(e).__name__))
    assert kinds == ["BeginPass", "BeginIteration", "EndIteration",
                     "BeginIteration", "EndIteration", "EndPass"]
    assert np.isfinite(t.test(_batches(n_batches=2))[0])
    feed = {"x": np.ones((2, 4), np.float32)}
    a = trainer_mod.infer(pred, feed, place=CPU)
    b = t.exe.run(tio.get_inference_program([pred], main), feed=feed,
                  fetch_list=[pred])[0]
    np.testing.assert_array_equal(a, b)


def test_unported_trainer_surfaces_raise_naming_their_items(monkeypatch):
    main, startup, x, y, pred, loss = _mlp()
    t = _trainer(main, startup, x, y, loss, Scope())
    # cluster= is ported (tests/test_torch_elastic.py): an unreachable
    # controller fails the call, and the subscription is put back
    from paddle_tpu_torch.parallel import comm

    monkeypatch.setenv("PADDLE_TPU_CLUSTER_RETRY_MAX_ATTEMPTS", "1")
    with pytest.raises(OSError):
        t.train(1, _batches(), cluster="127.0.0.1:1")
    assert comm.get_cluster() is None
    # the telemetry announcement is ported: train() announces the
    # process as a "trainer" member in the registry the env names
    from paddle_tpu_torch.cloud.registry import Registry
    from paddle_tpu_torch.observability import collector

    reg = Registry()
    monkeypatch.setenv("PADDLE_TPU_TELEMETRY_REGISTRY",
                       f"127.0.0.1:{reg.serve(0)}")
    monkeypatch.setattr(collector, "_ENV_TRIED", False)
    monkeypatch.setattr(collector, "_ENV_ANNOUNCEMENT", None)
    try:
        t.train(1, _batches())
        ann = collector._ENV_ANNOUNCEMENT
        assert ann is not None and ann.kind == "trainer"
        listed = list(reg.list(collector.TELEMETRY_KIND).values())
        assert [a.split("|")[0] for a in listed] == ["trainer"]
    finally:
        if collector._ENV_ANNOUNCEMENT is not None:
            collector._ENV_ANNOUNCEMENT.close()
        reg.close()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            trainer_mod.Trainer(loss, feed_list=[x, y], main_program=main,
                                startup_program=startup)
        with pytest.raises(RuntimeError, match="CUDA"):
            trainer_mod.infer(pred, {"x": np.ones((1, 4), np.float32)})


def test_lazy_fetch_materializes_on_read():
    c = trainer_mod.LazyFetch(torch.tensor([2.5]))
    assert repr(c) == "LazyFetch(<in flight>)"
    assert c + 1 == 3.5 and float(c) == 2.5 and f"{c}" == "2.5"
    assert c.value() is not None and c > 2 and abs(-c) == 2.5


def test_flight_recorder_notes_steps_and_dumps_on_a_fault(tmp_path):
    main, startup, x, y, _, loss = _mlp()
    rec = flightrecorder.install(dir=str(tmp_path), flush_s=60)
    try:
        fault_injector().inject("trainer.iteration", "error", nth=3,
                                exc=RuntimeError("killed"))
        t = _trainer(main, startup, x, y, loss, Scope())
        with pytest.raises(RuntimeError):
            t.train(1, _batches())
        dump = rec.dump_dict()
        steps = [e["data"]["step"] for e in dump["events"]
                 if e["kind"] == "trainer.step"]
        assert steps == [1, 2]
        assert any(e["kind"] == "fault" and e["data"]["site"]
                   == "trainer.iteration" for e in dump["events"])
        assert os.path.exists(rec.default_path())
    finally:
        flightrecorder.uninstall()


# -- readers -----------------------------------------------------------------

def _source(n=23):
    return lambda: iter([(i, i * 0.5) for i in range(n)])


def _run(reader, seed=5):
    random.seed(seed)
    return list(reader())


DECORATED = {
    "batch": lambda R: R.batch(_source(), 4),
    "batch_drop_last": lambda R: R.batch(_source(), 4, drop_last=True),
    "shuffle_batch": lambda R: R.batch(R.shuffle(_source(), 7), 5),
    "chain_firstn": lambda R: R.firstn(R.chain(_source(5), _source(4)), 7),
    "compose": lambda R: R.compose(_source(6), lambda: iter(range(6))),
    "map": lambda R: R.map_readers(lambda a, b: a[0] + b, _source(5),
                                   lambda: iter(range(5))),
    "buffered": lambda R: R.buffered(_source(), 3),
    "xmap_ordered": lambda R: R.xmap_readers(lambda s: s[0] * 2, _source(),
                                             3, 4, order=True),
    "cache": lambda R: R.cache(_source(6)),
    "bucket_by_length": lambda R: R.bucket_by_length(
        lambda: iter([([1] * (i % 7 + 1), i) for i in range(20)]), 3,
        [2, 4, 8]),
    "np_array": lambda R: R.creator.np_array(np.arange(12).reshape(4, 3)),
}


@pytest.mark.parametrize("name", sorted(DECORATED))
def test_decorators_give_the_jax_packages_samples_in_order(name):
    got, want = _run(DECORATED[name](treader)), _run(DECORATED[name](
        jreader))
    assert len(got) == len(want) and all(
        np.array_equal(np.asarray(a, dtype=object), np.asarray(
            b, dtype=object)) for a, b in zip(got, want)), (got, want)


def test_creators_read_the_jax_packages_files(tmp_path):
    rec = str(tmp_path / "a.recordio")
    jreader.creator.write_recordio(rec, [(1, "x"), (2, "y")])
    assert list(treader.creator.recordio(rec)()) == [(1, "x"), (2, "y")]
    treader.creator.write_recordio(rec, [[3.0]])
    assert list(jreader.creator.recordio(rec)()) == [[3.0]]
    txt = tmp_path / "t.txt"
    txt.write_text("a\nb\n")
    assert list(treader.creator.text_file(str(txt))()) == ["a", "b"]
    p = treader.PipeReader(f"cat {txt}")
    assert list(p.get_line()) == ["a", "b"]
    p.close()


def test_unported_readers_raise_naming_their_items(tmp_path):
    """native_pipeline (A10b) is ported and yields the JAX package's
    batches; cloud_reader (A11) is ported: over a master it yields the
    records the JAX package's cloud_reader yields from the same chunks.
    Nothing raises any more."""
    samples = lambda: ((np.array([i], np.float32),  # noqa: E731
                        np.array([2 * i], np.int64)) for i in range(23))
    slots = [((1,), "float32"), ((1,), "int64")]
    got = list(treader.native_pipeline(samples, slots, 5, shuffle_buf=8,
                                       seed=3)())
    want = list(jreader.native_pipeline(samples, slots, 5, shuffle_buf=8,
                                        seed=3)())
    assert [len(b[0]) for b in got] == [5, 5, 5, 5, 3]
    assert all(a.tobytes() == b.tobytes()
               for g, w in zip(got, want) for a, b in zip(g, w))
    from paddle_tpu.cloud.master import Master as JMaster
    from paddle_tpu_torch.cloud.master import Master as TMaster

    chunks = []
    for c in range(3):
        path = str(tmp_path / f"chunk{c}.rec")
        jreader.creator.write_recordio(path, [(c, i) for i in range(4)])
        chunks.append(path)
    records = {}
    for name, master_cls, creator in (
            ("jax", JMaster, jreader.creator),
            ("port", TMaster, treader.creator)):
        master = master_cls(timeout_s=30.0)
        port = master.serve(0)
        r = creator.cloud_reader(",".join(chunks), f"127.0.0.1:{port}")
        records[name] = [tuple(x) for x in r()]
        r.master_client.close()
        master.stop()
    assert records["port"] == records["jax"]
    assert sorted(records["port"]) == [(c, i) for c in range(3)
                                       for i in range(4)]


def _failing(after):
    def reader():
        for i in range(after):
            yield i
        raise ValueError("reader broke")
    return reader


@pytest.mark.parametrize("wrap,whole", [
    (lambda r: treader.buffered(r, 2), True),
    (lambda r: treader.xmap_readers(lambda v: v, r, 2, 2, order=True),
     False),
    (lambda r: treader.prefetch_feeder(r, None, CPU, depth=2), True),
], ids=["buffered", "xmap", "prefetch"])
def test_worker_exceptions_reraise_in_the_consumer(wrap, whole):
    """The worker's exception reaches the consumer after the queued good
    items (all of them through a queue; xmap's workers race the error
    past some)."""
    got = []
    with pytest.raises(ValueError, match="reader broke"):
        for v in wrap(_failing(3))():
            got.append(int(v))
    assert got == [0, 1, 2] if whole else got == [0, 1, 2][:len(got)]


def test_prefetch_stages_feeds_on_the_place_and_closes_its_worker():
    main, startup, x, y, _, loss = _mlp()
    feeder = tfluid.DataFeeder(feed_list=[x, y], place=CPU)
    feeds = treader.prefetch_feeder(_batches(), feeder, CPU, depth=2)()
    first = next(feeds)
    assert set(first) == {"x", "y"}
    assert isinstance(first["x"], torch.Tensor) and first["x"].device.type \
        == "cpu"
    it = feeds._it
    feeds.close()
    assert not it.thread.is_alive()
    lod = LoDTensor(np.ones((3, 2), np.float32), [[0, 1, 3]])
    staged = treader.stage_to_device(lod, torch.device("cpu"))
    assert isinstance(staged, LoDTensor) and staged.lod == lod.lod


# -- evaluators --------------------------------------------------------------

def _accuracy_program(fluid, ev):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        p = fluid.layers.data(name="p", shape=[5], dtype="float32")
        lab = fluid.layers.data(name="lab", shape=[1], dtype="int64")
        acc = ev.Accuracy(input=p, label=lab, k=2)
    return main, startup, acc


def _chunk_program(fluid, ev):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        i = fluid.layers.data(name="i", shape=[1], dtype="int64",
                              lod_level=1)
        lab = fluid.layers.data(name="l", shape=[1], dtype="int64",
                                lod_level=1)
        ce = ev.ChunkEvaluator(input=i, label=lab, chunk_scheme="IOB",
                               num_chunk_types=2)
    return main, startup, ce


def _eval_both(build, feeds):
    out = []
    for fluid, fw, ev, exe in (
            (jfluid, jfw, jevaluator, jfluid.Executor(jfluid.CPUPlace())),
            (tfluid, tfw, tevaluator, tfluid.Executor(CPU))):
        fw.reset_unique_names()
        main, startup, e = build(fluid, ev)
        exe.run(startup)
        for feed in feeds(fluid):
            exe.run(main, feed=feed, fetch_list=e.metrics)
        out.append(np.asarray(e.eval(exe)))
        e.reset(exe)
        out.append(np.asarray(e.eval(exe)) if ev is tevaluator else None)
    return out


def test_accuracy_evaluator_equals_the_jax_package():
    def feeds(fluid):
        rr = np.random.RandomState(4)
        return [{"p": rr.rand(6, 5).astype(np.float32),
                 "lab": rr.randint(0, 5, (6, 1)).astype(np.int64)}
                for _ in range(3)]

    j, _, t, reset = _eval_both(_accuracy_program, feeds)
    np.testing.assert_array_equal(t, j)
    assert 0 < float(j.reshape(-1)[0]) < 1
    assert np.isnan(reset).all()   # 0 / 0 after reset


def test_chunk_evaluator_equals_the_jax_package():
    lods = [[0, 5, 8], [0, 3, 8], [0, 8]]
    r = np.random.RandomState(6)
    batches = [(r.randint(0, 5, (8, 1)).astype(np.int64),
                r.randint(0, 5, (8, 1)).astype(np.int64), lod)
               for lod in lods]

    def feeds(fluid):
        lt = JLoDTensor if fluid is jfluid else LoDTensor
        return [{"i": lt(a, [lod]), "l": lt(b, [lod])}
                for a, b, lod in batches]

    j, _, t, reset = _eval_both(_chunk_program, feeds)
    np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(reset, [0, 0, 0])
