"""Event-driven trainer over Program + Executor (counterpart of
paddle_tpu/trainer.py).

Reference: python/paddle/v2/trainer.py (SGD.train :137-216, test :218)
and v2/event.py (BeginPass/EndPass/BeginIteration/EndIteration).  The
Trainer and `infer` run on CUDAPlace(0) unless given a place (the JAX
package's default to the CPU); without a card they raise.

With metrics on, `train` publishes the compute phase's static roofline
floor (the cost model's estimate of the main Program on the card's
chip-table row) for the calibration detector, as the JAX package does.

`train(cluster=...)` joins an elastic cluster (cloud/cluster.py) for
the loop.  With PADDLE_TPU_TELEMETRY_REGISTRY set, `train` announces the
process as a "trainer" member to the fleet telemetry collector
(`observability.collector.maybe_announce`).
"""
from __future__ import annotations

import time
from typing import Callable, Optional, Sequence

import numpy as np

from .core.executor import Executor, _to_numpy
from .core.flags import get_flag
from .core.framework import (
    Program,
    default_main_program,
    default_startup_program,
)
from .data_feeder import DataFeeder
from .observability import attribution as obs_attr
from .observability import flightrecorder
from .observability import metrics as obs_metrics
from .observability import tracing as obs_tracing
from .observability.collector import maybe_announce

# train-loop telemetry (docs/observability.md): gated by
# PADDLE_TPU_METRICS, so the serial loop's semantics and cost are
# untouched when off
_M_STEPS = obs_metrics.counter(
    "paddle_tpu_trainer_steps_total", "training steps completed")
_M_EXAMPLES = obs_metrics.counter(
    "paddle_tpu_trainer_examples_total",
    "examples consumed (leading dim of the first feed value)")
_M_STEP_SECONDS = obs_metrics.histogram(
    "paddle_tpu_trainer_step_seconds",
    "train-loop iteration wall latency (feed ready -> dispatch done)")
_M_COST = obs_metrics.gauge(
    "paddle_tpu_trainer_last_cost", "most recently materialized cost")
_M_FETCH_SYNC = obs_metrics.histogram(
    "paddle_tpu_trainer_fetch_sync_seconds",
    "blocking device->host fetch-sync stalls (LazyFetch reads)")


def _feed_batch_size(feed) -> int:
    """Leading dim of the first feed value (0 when indeterminable)."""
    if isinstance(feed, dict) and feed:
        v = next(iter(feed.values()))
        v = getattr(v, "data", v)  # LoDTensor wrapper
        shape = getattr(v, "shape", None)
        if shape:
            return int(shape[0])
    return 0

__all__ = [
    "infer",
    "BeginPass",
    "EndPass",
    "BeginIteration",
    "EndIteration",
    "LazyFetch",
    "Trainer",
]


class LazyFetch:
    """Handle for a fetched value that may still be in flight on device.

    `Executor.run(..., return_numpy=True)` forces a blocking device->host
    copy of every fetch — with async dispatch that serializes the loop on
    the device.  A LazyFetch wraps the raw device value instead; the copy
    happens only when someone actually reads it (`float()`,
    `np.asarray(...)`, `.numpy()`), so step N+1 can dispatch while step N
    is still computing.  Reading is idempotent (the materialized host
    value is cached)."""

    __slots__ = ("_device_value", "_host_value")

    def __init__(self, device_value):
        self._device_value = device_value
        self._host_value = None

    def value(self):
        """The raw value, no sync: device-resident until materialized,
        the cached host copy afterwards."""
        if self._host_value is not None:
            return self._host_value
        return self._device_value

    def numpy(self):
        """Materialize on host (blocks until the computation delivers).
        Releases the device buffer: a pass worth of retained cost
        handles must not pin one live device array per step."""
        if self._host_value is None:
            from . import profiler

            with profiler.record_event("pipeline.fetch_sync"):
                t0 = time.perf_counter()
                self._host_value = _to_numpy(self._device_value)
                _M_FETCH_SYNC.observe(time.perf_counter() - t0)
            self._device_value = None
        return self._host_value

    def __float__(self):
        return float(np.asarray(self.numpy()).reshape(-1)[0])

    def __array__(self, dtype=None):
        arr = np.asarray(self.numpy())
        return arr.astype(dtype) if dtype is not None else arr

    def __format__(self, spec):
        # format(x, "") must equal str(x): plain f-string interpolation
        # of event.cost is a read, and reads materialize
        return format(float(self), spec)

    def __repr__(self):
        if self._host_value is not None:
            return f"LazyFetch({self._host_value!r})"
        return "LazyFetch(<in flight>)"

    # float-like protocol: existing EndIteration handlers do arithmetic,
    # comparisons and printing on event.cost — each such read IS the
    # materialization point (Python never falls back to __float__ for
    # operators, so these must be explicit)
    @staticmethod
    def _f(other):
        return float(other) if isinstance(other, LazyFetch) else other

    def __str__(self):
        return str(float(self))

    def __bool__(self):
        return bool(float(self))

    def __hash__(self):
        return hash(float(self))

    def __eq__(self, other):
        return float(self) == self._f(other)

    def __lt__(self, other):
        return float(self) < self._f(other)

    def __le__(self, other):
        return float(self) <= self._f(other)

    def __gt__(self, other):
        return float(self) > self._f(other)

    def __ge__(self, other):
        return float(self) >= self._f(other)

    def __add__(self, other):
        return float(self) + self._f(other)

    __radd__ = __add__

    def __sub__(self, other):
        return float(self) - self._f(other)

    def __rsub__(self, other):
        return self._f(other) - float(self)

    def __mul__(self, other):
        return float(self) * self._f(other)

    __rmul__ = __mul__

    def __truediv__(self, other):
        return float(self) / self._f(other)

    def __rtruediv__(self, other):
        return self._f(other) / float(self)

    def __neg__(self):
        return -float(self)

    def __abs__(self):
        return abs(float(self))


class BeginPass:
    def __init__(self, pass_id):
        self.pass_id = pass_id


class EndPass:
    def __init__(self, pass_id, metrics=None):
        self.pass_id = pass_id
        self.metrics = metrics


class BeginIteration:
    def __init__(self, pass_id, batch_id):
        self.pass_id = pass_id
        self.batch_id = batch_id


class EndIteration:
    def __init__(self, pass_id, batch_id, cost, metrics=None):
        self.pass_id = pass_id
        self.batch_id = batch_id
        self.cost = cost
        self.metrics = metrics


class Trainer:
    """Pass/batch loop with event callbacks (reference v2 SGD.train shape,
    fluid executor underneath)."""

    def __init__(self, loss, optimizer=None, place=None, feed_list=None,
                 main_program: Optional[Program] = None,
                 startup_program: Optional[Program] = None,
                 fetch_list: Optional[Sequence] = None):
        self.loss = loss
        self.main_program = main_program or default_main_program()
        self.startup_program = startup_program or default_startup_program()
        self.feed_list = feed_list
        self.fetch_list = list(fetch_list or [])
        if optimizer is not None and not self._has_optimize_ops():
            optimizer.minimize(loss, startup_program=self.startup_program)
        self.exe = Executor(place)
        self.place = self.exe.place
        self._started = False

    def _has_optimize_ops(self):
        opt_types = {"sgd", "momentum", "adam", "adamax", "adagrad",
                     "adadelta", "decayed_adagrad", "ftrl", "rmsprop"}
        return any(op.type in opt_types
                   for op in self.main_program.global_block().ops)

    def _feeder(self):
        if self.feed_list is None:
            raise ValueError("Trainer needs feed_list to build a DataFeeder")
        return DataFeeder(feed_list=self.feed_list, place=self.place)

    def start(self):
        if not self._started:
            self.exe.run(self.startup_program)
            self._started = True

    def train(self, num_passes: int, reader: Callable,
              event_handler: Optional[Callable] = None,
              feeder: Optional[DataFeeder] = None,
              checkpoint_dir: Optional[str] = None,
              checkpoint_every_n_passes: int = 1,
              checkpoint_max_keep: int = 3,
              checkpoint_every_n_iters: int = 0,
              resume_from: Optional[str] = None,
              prefetch: Optional[int] = None,
              sync_every_n: Optional[int] = None,
              cluster=None):
        """reader: batch reader (yields lists of samples per batch).

        With `checkpoint_dir`, resumes from the newest valid snapshot there
        (params + optimizer state + the pass/batch/step cursor travel in
        the snapshot meta) and saves a snapshot every
        `checkpoint_every_n_passes` (<= 0 disables saving) —
        the trainer-side analogue of the Go pserver's periodic checkpoint
        (go/pserver/service.go:120-203) and the book_distribute scripts'
        per-pass save.

        Auto-resume mode: `checkpoint_every_n_iters > 0` additionally
        snapshots every N iterations, and `resume_from=dir` restores
        params + the global step from the newest valid snapshot there and
        CONTINUES THE PASS it died in (already-trained batches of that
        pass are fast-forwarded, relying on the deterministic reader) —
        so a trainer killed at iteration k and restarted under a
        supervisor finishes with the same step count and params as an
        uninterrupted run.  `resume_from` doubles as the save target when
        `checkpoint_dir` is not given.  The running step count is exposed
        as `self.step`.

        Async hot path: `prefetch=N` (default flag `prefetch_depth`, env
        PADDLE_TPU_PREFETCH_DEPTH) runs reader + feed packing + the
        host-to-device copy on a background thread N batches ahead
        (reader/pipeline.py);
        `sync_every_n=K` (default flag `sync_every_n`, env
        PADDLE_TPU_SYNC_EVERY_N) > 1 threads the cost through
        `EndIteration` as a `LazyFetch` that materializes only when the
        callback reads it (or every K steps, bounding the in-flight
        dispatch queue), so step N+1 dispatches while step N computes.
        Both default off/1: the default loop is bit-for-bit the serial
        one, and the async loop runs the SAME ops in the SAME order, so
        final parameters are bit-identical (test-enforced,
        tests/test_torch_trainer.py).

        Elastic clusters: `cluster=` (a cloud.cluster.ClusterClient,
        an in-process ClusterController, or a controller address
        string) arms the process-wide view subscription, registers this
        trainer as a TTL-leased cluster member for the duration of the
        loop, and publishes the program's send-op param descs to the
        controller (idempotent — first definition wins).  The program's
        send/recv rounds then resolve endpoints through the
        controller's current view and survive pserver membership
        changes without a restart; the lease, released on clean exit
        (or expired by TTL on a crash), is what lets the controller
        shrink fan-in and the master reclaim this trainer's task
        chunks.  The subscription is armed before the startup program
        runs, so its recv ops pull from the view's owners."""
        from . import io
        from .core.resilience import fault_injector
        from .reader.pipeline import prefetch_feeder

        lease = None
        prev_cluster = client = None
        armed = False
        try:
            if cluster is not None:
                from .parallel.comm import get_cluster, set_cluster

                # the subscription is process-global: remember what was
                # armed before (usually nothing) and restore it on
                # exit, so a later train()/executor run in this process
                # does not route rounds through a controller that may
                # be gone.  Arming INSIDE the try: if define()/join()
                # fail against an unreachable controller, the finally
                # still restores the prior subscription
                prev_cluster = get_cluster()
                client = set_cluster(cluster)
                armed = True
                descs = self._send_param_descs()
                if descs:
                    client.define(descs)
                lease = client.join("trainer")
            self.start()
            return self._train_loop(
                num_passes, reader, event_handler, feeder,
                checkpoint_dir, checkpoint_every_n_passes,
                checkpoint_max_keep, checkpoint_every_n_iters,
                resume_from, prefetch, sync_every_n, io, fault_injector,
                prefetch_feeder)
        finally:
            if lease is not None:
                lease.release()
            if armed:
                from .parallel.comm import set_cluster

                set_cluster(prev_cluster)
                if client is not cluster and client is not prev_cluster:
                    # we built this ClusterClient from an address /
                    # controller the caller passed; callers who pass a
                    # client keep ownership of theirs
                    try:
                        client.close()
                    except Exception:
                        pass

    def _send_param_descs(self):
        """VarDescs of the params this program's send ops place (the
        fused send's Out list), for ClusterClient.define — shapes come
        from the program vars so the controller's balanced_split can
        weigh bytes."""
        from .parallel.distributed_spliter import VarDesc

        blk = self.main_program.global_block()
        descs = []
        for op in blk.ops:
            if op.type != "send":
                continue
            for name in op.output("Out"):
                v = blk.vars.get(name)
                descs.append(VarDesc(
                    name, tuple(getattr(v, "shape", None) or ()),
                    str(getattr(v, "dtype", "float32"))))
        return descs

    def _train_loop(self, num_passes, reader, event_handler, feeder,
                    checkpoint_dir, checkpoint_every_n_passes,
                    checkpoint_max_keep, checkpoint_every_n_iters,
                    resume_from, prefetch, sync_every_n, io,
                    fault_injector, prefetch_feeder):
        event_handler = event_handler or (lambda e: None)
        feeder = feeder or self._feeder()
        fetches = [self.loss] + self.fetch_list
        maybe_announce("trainer")
        if prefetch is None:
            prefetch = int(get_flag("prefetch_depth"))
        if sync_every_n is None:
            sync_every_n = int(get_flag("sync_every_n"))
        sync_every_n = max(int(sync_every_n), 1)
        lazy = sync_every_n > 1
        def make_feeds(rd):
            if prefetch > 0:
                # feed_pack/h2d attribution happens on the prefetch
                # worker (reader/pipeline.py)
                return prefetch_feeder(rd, feeder, self.place,
                                       depth=prefetch)()

            def packed():
                for b in rd():
                    with obs_attr.phase("trainer", "feed_pack"):
                        feed = feeder.feed(b)
                    yield feed
            return packed()
        self._publish_static_floor()
        if resume_from is not None and checkpoint_dir is None:
            checkpoint_dir = resume_from
        first_pass, skip_batches = 0, 0
        self.step = int(getattr(self, "step", 0))
        load_dir = resume_from if resume_from is not None else checkpoint_dir
        if load_dir is not None:
            meta = io.load_checkpoint(self.exe, load_dir,
                                      main_program=self.main_program)
            if meta is not None:
                args = meta["trainer_args"]
                first_pass = int(args.get("next_pass_id", 0))
                skip_batches = int(args.get("next_batch_id", 0))
                self.step = int(args.get("step", self.step))

        def _save(next_pass_id, next_batch_id):
            io.save_checkpoint(
                self.exe, checkpoint_dir,
                main_program=self.main_program,
                trainer_args={"next_pass_id": next_pass_id,
                              "next_batch_id": next_batch_id,
                              "step": self.step},
                max_keep=checkpoint_max_keep)

        _no_batch = object()
        for pass_id in range(first_pass, num_passes):
            # in a resumed pass, BeginPass fires only once a batch
            # actually trains: a snapshot taken at the pass's final batch
            # would otherwise replay the whole pass as skips and emit a
            # duplicate BeginPass/EndPass pair (the latter with NaN cost)
            n_skip = skip_batches
            skip_batches = 0
            resuming = n_skip > 0
            trained = False
            if not resuming:
                event_handler(BeginPass(pass_id))
            pass_costs = []
            if resuming:
                # resumed mid-pass: the snapshot already carries the
                # effect of the skipped batches; replay the RAW reader
                # past them (no feed packing, no H2D — restart latency
                # must not scale with feed-pack cost of the prefix)
                def pass_reader(_n=n_skip):
                    it = iter(reader())
                    for _ in range(_n):
                        if next(it, _no_batch) is _no_batch:
                            return
                    yield from it
            else:
                pass_reader = reader
            feeds = make_feeds(pass_reader)
            try:
                for batch_id, feed in enumerate(feeds, start=n_skip):
                    if resuming and not trained:
                        event_handler(BeginPass(pass_id))
                    trained = True
                    # chaos hook: auto-resume tests kill the trainer here
                    fault_injector().fire("trainer.iteration")
                    event_handler(BeginIteration(pass_id, batch_id))
                    t_step = time.perf_counter()
                    with obs_tracing.span("trainer.step",
                                          pass_id=pass_id,
                                          batch_id=batch_id):
                        with obs_attr.phase("trainer", "compute"):
                            outs = self.exe.run(
                                self.main_program, feed=feed,
                                fetch_list=fetches,
                                return_numpy=not lazy)
                    if lazy:
                        cost = LazyFetch(outs[0])
                        # metrics stay raw device tensors (a LazyFetch
                        # would collapse a vector metric to [0] under
                        # arithmetic); LazyFetch is for the scalar cost
                        metrics = list(outs[1:])
                    else:
                        cost = float(np.asarray(outs[0]).reshape(-1)[0])
                        metrics = outs[1:]
                    pass_costs.append(cost)
                    self.step += 1
                    if flightrecorder.armed():
                        # the post-mortem ring wants the step cadence
                        # (cost may still be device-lazy — not forced)
                        flightrecorder.note(
                            "trainer.step", step=self.step,
                            pass_id=pass_id, batch_id=batch_id)
                    if obs_metrics.enabled():
                        _M_STEPS.inc()
                        _M_STEP_SECONDS.observe(
                            time.perf_counter() - t_step)
                        bs = _feed_batch_size(feed)
                        if bs:
                            _M_EXAMPLES.inc(bs)
                        if not lazy:
                            _M_COST.set(cost)
                    if lazy and self.step % sync_every_n == 0:
                        # periodic fence: bounds the in-flight dispatch
                        # queue, surfaces device errors at a bounded
                        # distance from their step, and releases the
                        # window's cost device buffers (numpy() drops
                        # the handle) so a long pass doesn't pin one
                        # live device array per trained step
                        for c in pass_costs[-sync_every_n:]:
                            if isinstance(c, LazyFetch):
                                c.numpy()
                        if obs_metrics.enabled() and pass_costs:
                            _M_COST.set(float(pass_costs[-1]))
                    event_handler(EndIteration(pass_id, batch_id, cost,
                                               metrics=metrics))
                    if checkpoint_dir is not None \
                            and checkpoint_every_n_iters > 0 \
                            and self.step % checkpoint_every_n_iters == 0:
                        _save(pass_id, batch_id + 1)
            finally:
                # a prefetching iterator owns a worker thread: an
                # exception mid-pass must not leak it blocked on the queue
                if hasattr(feeds, "close"):
                    feeds.close()
            if resuming and not trained:
                # the snapshot was taken AT the pass boundary: this pass
                # is already complete, so no events and no redundant
                # checkpoint for it — move straight to the next pass
                continue
            event_handler(EndPass(pass_id, metrics={
                "avg_cost": float(np.mean([float(c) for c in pass_costs]))
                if pass_costs else float("nan")}))
            if checkpoint_dir is not None and checkpoint_every_n_passes > 0 \
                    and (pass_id + 1) % checkpoint_every_n_passes == 0:
                _save(pass_id + 1, 0)

    def _publish_static_floor(self):
        """Static roofline floor for the compute phase on the card's
        chip-table row (analysis.cost_model), for the collector's
        calibration-drift detector (docs/observability.md "Time
        attribution").  Best-effort and gated: never slows or breaks an
        uninstrumented run."""
        if not obs_metrics.enabled():
            return
        try:
            from .analysis.cost_model import (estimate_program,
                                              roofline_seconds)
            est = estimate_program(self.main_program)
            obs_attr.publish_static_floor("trainer", {
                "compute": roofline_seconds(est.total_flops,
                                            est.total_bytes),
            })
        except Exception:
            pass

    def test(self, reader: Callable, feeder: Optional[DataFeeder] = None,
             fetch_list: Optional[Sequence] = None):
        """Average fetched values over a reader using the inference clone
        of the program (is_test behavior for dropout/batch_norm)."""
        self.start()
        feeder = feeder or self._feeder()
        fetches = list(fetch_list or [self.loss] + self.fetch_list)
        test_prog = self.main_program.clone(for_test=True)
        totals, n = None, 0
        for batch in reader():
            outs = self.exe.run(test_prog, feed=feeder.feed(batch),
                                fetch_list=fetches)
            vals = [float(np.asarray(o).reshape(-1)[0]) for o in outs]
            totals = vals if totals is None else [
                a + b for a, b in zip(totals, vals)]
            n += 1
        return [t / max(n, 1) for t in (totals or [])]

    def save_params(self, dirname):
        from . import io

        self.start()
        io.save_persistables(self.exe, dirname,
                             main_program=self.main_program)

    def save_inference_model(self, dirname, feeded_var_names, target_vars):
        from . import io

        self.start()
        io.save_inference_model(dirname, feeded_var_names, target_vars,
                                self.exe, main_program=self.main_program)


def infer(output, feed, program=None, scope=None, place=None,
          return_numpy=True):
    """One-shot inference on trained parameters (reference
    python/paddle/v2/inference.py `paddle.infer(output_layer=..., input=...)`
    — here parameters come from the scope instead of a Parameters pack),
    on `place` (CUDAPlace(0) when None).

        probs = fluid.trainer.infer(predict_var, {"img": batch})
    """
    from .io import get_inference_program

    outputs = output if isinstance(output, (list, tuple)) else [output]
    if program is None and hasattr(outputs[0], "block"):
        # default to the program that OWNS the output var (the ambient
        # default program is usually not the one built under program_guard)
        program = outputs[0].block.program
    prog = get_inference_program(outputs, program)
    exe = Executor(place)
    res = exe.run(prog, feed=feed,
                  fetch_list=[o.name if hasattr(o, "name") else str(o)
                              for o in outputs],
                  scope=scope, return_numpy=return_numpy)
    return res[0] if not isinstance(output, (list, tuple)) else res
