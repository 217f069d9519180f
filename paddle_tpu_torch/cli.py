"""`python -m paddle_tpu_torch.cli` — the legacy trainer command line, its
job half (counterpart of paddle_tpu/cli.py).

Reference: paddle/trainer/TrainerMain.cpp:24-60 (`paddle train
--config=... --job=train|test|checkgrad|time`, plus ParamUtil save dirs
/ --start_pass resume) and paddle/scripts (`paddle train` wrapper).  The
`merge` job is the MergeModel utility (trainer/MergeModel.cpp): fold
config + trained parameters into one deployable inference file.

Config contract (the JAX package's, with this package as `fluid`):

    # config.py
    import paddle_tpu_torch as fluid

    def build():
        x = fluid.layers.data(name="x", shape=[13], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        pred = fluid.layers.fc(input=x, size=1)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
        def reader():          # yields feed dicts
            while True:
                yield {"x": ..., "y": ...}
        return {
            "loss": loss,                         # required
            "reader": reader,                     # required for train/test/time
            "optimizer": fluid.SGD(0.01),         # default SGD(0.01)
            "test_reader": reader,                # default: reader
            "infer_targets": [pred],              # required for --job=merge
            "feed_order": ["x", "y"],             # required for --job=merge
        }

`build()` is called inside a fresh `program_guard`, with the unique-name
counters reset (so its parameters get a fresh process's names however
many jobs run in one process), and every job runs in a scope of its
own.  The device is CUDAPlace(0) unless `--use_gpu 0` (Paddle's flag;
`--use_tpu`, the JAX package's, is its alias) asks for the CPU; without
a card the default raises.  The saved parameter files are the JAX
package's byte for byte, so a model trained by either CLI is tested,
resumed or merged by the other.

`main(argv)` returns the job's result (costs, times, gradients, the
executor and scope it ran), for callers that run the CLI in-process.

The subcommands exit with their status (0 clean): the static analysis
— `verify TARGET...` (the Program verifier over a saved model dir or a
config's programs), `analyze TARGET...` (the cost model's roofline on a
card of `--device`, the peak-memory and comm estimates, the budget gate;
generation model dirs too) and `concurrency [PATHS...] [--sched]` (the
AST lint over paddle_tpu_torch/ and the schedule checker's protocol
models); the telemetry tools — `metrics` (render or diff JSON
snapshots), `trace` (a config under tracing), `top` (the live fleet
table), `slo` (the SLO gate), `why` (per-phase time attribution) and
`trace-of` (a latency exemplar joined to its trace); and the serving
fleet — `serve` (one replica of a saved generation model) and
`autoscale` (a router plus an autoscaler of `serve` replicas).
"""
from __future__ import annotations

import argparse
import importlib.util
import os
import sys
import time

import numpy as np

def _load_config(path):
    spec = importlib.util.spec_from_file_location("paddle_cli_config",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if not hasattr(mod, "build"):
        raise SystemExit(f"config {path!r} must define build()")
    return mod


def _build(mod):
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core.framework import reset_unique_names

    reset_unique_names()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        cfg = mod.build()
    if "loss" not in cfg:
        raise SystemExit("build() must return a dict with 'loss'")
    cfg["main"], cfg["startup"] = main, startup
    return cfg


def _place(use_gpu):
    """CUDAPlace(0) (the Executor raises without a card) unless the
    caller asks for the CPU."""
    import paddle_tpu_torch as fluid

    return fluid.CUDAPlace(0) if use_gpu else fluid.CPUPlace()


def _executor(args):
    import paddle_tpu_torch as fluid

    return fluid.Executor(_place(args.use_gpu))


def _run_startup_or_load(exe, cfg, args):
    import paddle_tpu_torch as fluid

    exe.run(cfg["startup"])
    if args.init_model_path:
        fluid.io.load_persistables(exe, args.init_model_path,
                                   main_program=cfg["main"])


def _scalar(out) -> float:
    return float(np.asarray(out).reshape(-1)[0])


def job_train(cfg, args):
    import paddle_tpu_torch as fluid

    loss = cfg["loss"]
    opt = cfg.get("optimizer") or fluid.SGD(learning_rate=0.01)
    with fluid.program_guard(cfg["main"], cfg["startup"]):
        opt.minimize(loss)
    exe = _executor(args)
    _run_startup_or_load(exe, cfg, args)
    reader = cfg["reader"]
    passes = []
    for pass_id in range(args.num_passes):
        costs = []
        for batch_id, feed in enumerate(reader()):
            if args.batches_per_pass and batch_id >= args.batches_per_pass:
                break
            out, = exe.run(cfg["main"], feed=feed, fetch_list=[loss])
            costs.append(_scalar(out))
            if args.log_period and batch_id % args.log_period == 0:
                print(f"pass {pass_id} batch {batch_id} "
                      f"cost {costs[-1]:.6f}")
        print(f"pass {pass_id} done, avg cost "
              f"{np.mean(costs) if costs else float('nan'):.6f}")
        passes.append(costs)
        if args.save_dir:
            d = os.path.join(args.save_dir, f"pass-{pass_id:05d}")
            os.makedirs(d, exist_ok=True)
            fluid.io.save_persistables(exe, d, main_program=cfg["main"])
            print(f"saved parameters to {d}")
    return {"costs": passes, "exe": exe}


def job_test(cfg, args):
    if not args.init_model_path:
        raise SystemExit(
            "--job=test requires --init_model_path (otherwise it would "
            "evaluate freshly initialized random parameters)")
    loss = cfg["loss"]
    test_prog = cfg["main"].clone(for_test=True)
    exe = _executor(args)
    _run_startup_or_load(exe, cfg, args)
    reader = cfg.get("test_reader") or cfg["reader"]
    costs = []
    for batch_id, feed in enumerate(reader()):
        if args.batches_per_pass and batch_id >= args.batches_per_pass:
            break
        out, = exe.run(test_prog, feed=feed, fetch_list=[loss])
        costs.append(_scalar(out))
    print(f"test: {len(costs)} batches, avg cost {np.mean(costs):.6f}")
    return {"costs": costs, "avg_cost": float(np.mean(costs)), "exe": exe}


def _synchronize(exe):
    import torch

    if exe.device.type == "cuda":
        torch.cuda.synchronize(exe.device)


def job_time(cfg, args):
    """`--job=time` (reference benchmark mode: paddle train --job=time,
    benchmark/paddle/image/run.sh): the mean wall time of a batch in the
    steady state.  Two warm-up runs (the default mode runs the block
    eagerly at its miss and captures it into a CUDA graph at its first
    hit), then the timed runs, fetching without a copy to the host; the
    clock is read after the card has finished them."""
    import paddle_tpu_torch as fluid

    loss = cfg["loss"]
    opt = cfg.get("optimizer") or fluid.SGD(learning_rate=0.01)
    with fluid.program_guard(cfg["main"], cfg["startup"]):
        opt.minimize(loss)
    exe = _executor(args)
    _run_startup_or_load(exe, cfg, args)
    feed = next(iter(cfg["reader"]()))
    for _ in range(2):
        exe.run(cfg["main"], feed=feed, fetch_list=[loss],
                return_numpy=False)
    _synchronize(exe)
    n = args.batches_per_pass or 10
    t0 = time.perf_counter()
    for _ in range(n):
        exe.run(cfg["main"], feed=feed, fetch_list=[loss],
                return_numpy=False)
    _synchronize(exe)
    ms = (time.perf_counter() - t0) / n * 1000
    print(f"time: {ms:.2f} ms/batch over {n} batches")
    return {"ms_per_batch": ms, "batches": n, "exe": exe}


def _host_copy(t) -> np.ndarray:
    """A scope value as a host array of its own (never a view of a
    buffer a CUDA graph replays into)."""
    import torch

    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.detach().cpu().numpy().copy()


def job_checkgrad(cfg, args):
    """Central finite-difference check of d(loss)/d(param) (reference
    --job=checkgrad, trainer/tests + gserver test_LayerGrad machinery).

    Each perturbed parameter is a new tensor in the scope, and the
    parameter is restored from its host copy: in the default mode the
    scope's tensor after a replay is the graph's own input buffer, which
    the next replay overwrites with whatever tensor the scope then
    holds, so it can neither be perturbed in place nor serve as the
    saved value."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core.executor import global_scope
    from paddle_tpu_torch.core.scope import tensor_from_numpy

    loss = cfg["loss"]
    main = cfg["main"]
    params = main.global_block().all_parameters()
    with fluid.program_guard(main, cfg["startup"]):
        grads = fluid.calc_gradient(loss, params)
    exe = _executor(args)
    _run_startup_or_load(exe, cfg, args)
    feed = next(iter(cfg["reader"]()))
    scope = global_scope()
    fetched = exe.run(main, feed=feed, fetch_list=[loss] + list(grads))
    analytic = {p.name: np.asarray(g) for p, g in zip(params, fetched[1:])}

    def put(name, arr, like):
        scope.set_var(name, tensor_from_numpy(arr).to(
            dtype=like.dtype, device=like.device))

    delta = args.checkgrad_eps
    rng = np.random.RandomState(0)
    worst, per_param = 0.0, {}
    for p in params:
        held = scope.find_var(p.name)
        val = _host_copy(held)
        flat = val.reshape(-1)
        k = min(args.checkgrad_samples, flat.size)
        idxs = rng.choice(flat.size, size=k, replace=False)
        num = np.zeros(k)
        for j, i in enumerate(idxs):
            for sgn in (+1, -1):
                flat2 = flat.copy()
                flat2[i] += sgn * delta
                put(p.name, flat2.reshape(val.shape), held)
                out, = exe.run(main, feed=feed, fetch_list=[loss])
                num[j] += sgn * _scalar(out)
            num[j] /= 2 * delta
        put(p.name, val, held)
        ana = analytic[p.name].reshape(-1)[idxs]
        denom = np.maximum(np.abs(num) + np.abs(ana), 1e-6)
        err = float(np.max(np.abs(num - ana) / denom))
        worst = max(worst, err)
        per_param[p.name] = {"indices": idxs, "numeric": num,
                             "analytic": ana, "max_rel_err": err}
        status = "OK" if err < args.checkgrad_tol else "FAIL"
        print(f"checkgrad {p.name}: max rel err {err:.3e} [{status}]")
    if worst >= args.checkgrad_tol:
        raise SystemExit(f"checkgrad FAILED (worst {worst:.3e} >= "
                         f"{args.checkgrad_tol})")
    print(f"checkgrad passed (worst {worst:.3e})")
    return {"worst": worst, "params": per_param, "analytic": analytic,
            "exe": exe}


def job_merge(cfg, args):
    """MergeModel: config + params -> single-file inference model."""
    import paddle_tpu_torch as fluid

    targets = cfg.get("infer_targets")
    if not targets:
        raise SystemExit("--job=merge needs 'infer_targets' from build()")
    if not args.init_model_path:
        raise SystemExit(
            "--job=merge requires --init_model_path (otherwise it would "
            "package freshly initialized random parameters)")
    exe = _executor(args)
    _run_startup_or_load(exe, cfg, args)
    feed_names = cfg.get("feed_order")
    if not feed_names:
        raise SystemExit("--job=merge needs 'feed_order' from build()")
    out = args.save_dir or "merged_model"
    fluid.io.save_inference_model(
        out, feed_names, targets, exe, main_program=cfg["main"],
        model_filename="__model__", params_filename="__params__")
    print(f"merged model written to {out}")
    return {"dir": out, "exe": exe}


def _snapshot_scalars(snap):
    """{(name, label-items) -> (type, value)} for counters/gauges plus
    histogram _count/_sum pseudo-series — the diffable subset of a
    JSON snapshot."""
    out = {}
    for name, m in snap.get("metrics", {}).items():
        for s in m["samples"]:
            key_labels = tuple(sorted(s["labels"].items()))
            if m["type"] == "histogram":
                out[(name + "_count", key_labels)] = (
                    "counter", float(s["value"]["count"]))
                out[(name + "_sum", key_labels)] = (
                    "counter", float(s["value"]["sum"]))
            else:
                out[(name, key_labels)] = (m["type"],
                                           float(s["value"]))
    return out


def _print_metrics_diff(path_a, path_b, snap_a, snap_b):
    """Counter deltas (and gauge before->after) between two snapshots
    — the poor man's rate view over the atexit dumps."""
    from paddle_tpu_torch.observability.exporters import _fmt_labels

    a = _snapshot_scalars(snap_a)
    b = _snapshot_scalars(snap_b)
    dt = float(snap_b.get("time", 0)) - float(snap_a.get("time", 0))
    rows = []
    for key in sorted(set(a) | set(b)):
        name, labels = key
        kind_a, va = a.get(key, (None, 0.0))
        kind_b, vb = b.get(key, (None, 0.0))
        kind = kind_b or kind_a
        label = _fmt_labels(dict(labels))
        if kind == "gauge":
            if va != vb:
                rows.append((f"{name}{label}", "gauge",
                             f"{va:g} -> {vb:g}"))
        else:
            delta = vb - va
            if delta:
                per_s = f"  ({delta / dt:.6g}/s)" if dt > 0 else ""
                rows.append((f"{name}{label}", kind or "counter",
                             f"{delta:+g}{per_s}"))
    print(f"{path_a} -> {path_b}"
          + (f"  (dt {dt:.3f}s)" if dt > 0 else ""))
    if not rows:
        print("no series moved between the two snapshots")
        return
    name_w = max(len(r[0]) for r in rows)
    print(f"{'Metric':<{name_w}}  {'Type':<9}  Delta")
    for n, t, v in rows:
        print(f"{n:<{name_w}}  {t:<9}  {v}")


def cmd_metrics(argv):
    """`python -m paddle_tpu_torch.cli metrics DUMP.json` — render a JSON
    metrics snapshot (observability.exporters.write_json, or the
    --metrics_out of `cli trace`) as a table.  `--diff A.json B.json`
    instead prints the counter deltas (and per-second rates, from the
    snapshots' timestamps) between two dumps."""
    import json

    from paddle_tpu_torch.observability.exporters import format_metrics_table

    ap = argparse.ArgumentParser(
        prog="paddle_tpu_torch.cli metrics",
        description="render or diff metrics JSON snapshots")
    ap.add_argument("snapshot", nargs="?", default="",
                    help="JSON snapshot file written by "
                    "observability.exporters.write_json")
    ap.add_argument("--diff", nargs=2, metavar=("A.json", "B.json"),
                    help="print counter deltas between two snapshots "
                    "(A = earlier, B = later)")
    args = ap.parse_args(argv)
    if args.diff:
        path_a, path_b = args.diff
        with open(path_a) as f:
            snap_a = json.load(f)
        with open(path_b) as f:
            snap_b = json.load(f)
        _print_metrics_diff(path_a, path_b, snap_a, snap_b)
        return 0
    if not args.snapshot:
        raise SystemExit("metrics: give a snapshot file or --diff A B")
    with open(args.snapshot) as f:
        snap = json.load(f)
    n = len(snap.get("metrics", {}))
    print(f"{args.snapshot}: {n} metric(s) from pid "
          f"{snap.get('pid', '?')}")
    print(format_metrics_table(snap))
    return 0


def cmd_trace(argv):
    """`python -m paddle_tpu_torch.cli trace CONFIG OUT.json [--steps N]` —
    run a build() config file for a few steps with span recording on and
    write the Chrome-trace JSON (open in chrome://tracing or
    https://ui.perfetto.dev)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.observability import exporters, metrics, tracing

    ap = argparse.ArgumentParser(
        prog="paddle_tpu_torch.cli trace",
        description="run a config under tracing; emit Chrome trace JSON")
    ap.add_argument("config", help="python file defining build() "
                    "(CLI config contract)")
    ap.add_argument("out", help="Chrome-trace JSON output path")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--use_gpu", "--use_tpu", dest="use_gpu", type=int,
                    default=1,
                    help="1: CUDAPlace(0), raising without a card; 0: the "
                    "CPU (--use_tpu: the JAX package's name, an alias)")
    ap.add_argument("--metrics_out", default="",
                    help="also write a metrics JSON snapshot here "
                    "(view with `cli metrics`)")
    args = ap.parse_args(argv)

    from paddle_tpu_torch.core.executor import scope_guard
    from paddle_tpu_torch.core.scope import Scope

    metrics.set_enabled(True)
    tracing.set_enabled(True)
    mod = _load_config(args.config)
    with scope_guard(Scope()):
        cfg = _build(mod)
        if "reader" not in cfg:
            raise SystemExit("trace needs 'reader' from build()")
        loss = cfg["loss"]
        opt = cfg.get("optimizer") or fluid.SGD(learning_rate=0.01)
        with fluid.program_guard(cfg["main"], cfg["startup"]):
            opt.minimize(loss)
        exe = fluid.Executor(_place(args.use_gpu))
        exe.run(cfg["startup"])
        it = iter(cfg["reader"]())
        steps = 0
        with tracing.span("cli.trace", config=args.config):
            for i in range(args.steps):
                feed = next(it, None)
                if feed is None:
                    break
                with tracing.span("trainer.step", batch_id=i):
                    exe.run(cfg["main"], feed=feed, fetch_list=[loss])
                steps += 1
    path = tracing.write_chrome_trace(args.out)
    print(f"trace: {steps} step(s), {len(tracing.finished_spans())} "
          f"span(s) -> {path}")
    if args.metrics_out:
        print(f"metrics snapshot -> "
              f"{exporters.write_json(args.metrics_out)}")
    return 0


# ---------------------------------------------------------------------------
# `top` / `slo` subcommands: the fleet telemetry plane
# (docs/observability.md "Fleet telemetry")
# ---------------------------------------------------------------------------

# which series feed each fleet-table column, per member kind; the
# fallback row renders "-" for kinds without a mapping
_TOP_COLUMNS = {
    "generation": {
        "qps": "paddle_tpu_serving_generation_requests_total",
        "latency": "paddle_tpu_serving_generation_seconds",
        "queue": "paddle_tpu_serving_generation_queue_depth",
        "util": "paddle_tpu_serving_kv_pool_utilization",
    },
    "serving": {
        "qps": "paddle_tpu_serving_requests_total",
        "latency": "paddle_tpu_serving_request_seconds",
        "queue": "paddle_tpu_serving_queue_depth",
    },
    "pserver": {
        "qps": "paddle_tpu_pserver_requests_total",
        "latency": "paddle_tpu_pserver_optimize_seconds",
    },
    "trainer": {
        "qps": "paddle_tpu_trainer_steps_total",
        "latency": "paddle_tpu_trainer_step_seconds",
    },
    "router": {
        "qps": "paddle_tpu_serving_router_requests_total",
        "latency": "paddle_tpu_serving_router_request_seconds",
        "queue": "paddle_tpu_serving_router_outstanding_tokens",
    },
}


def _fmt_stat(v, fmt="{:.3g}"):
    import math

    if v is None or (isinstance(v, float) and math.isnan(v)):
        return "-"
    return fmt.format(v)


def format_fleet_table(coll, window_s: float = 60.0) -> str:
    """The `cli top` table: one row per member with windowed qps /
    p50 / p99 / queue depth / KV utilization from the collector's
    fleet time-series."""
    rows = []
    for m in coll.members():
        cols = _TOP_COLUMNS.get(m["kind"], {})
        lbl = {"member": m["member"]}
        qps = p50 = p99 = queue = util = None
        if "qps" in cols:
            qps = coll.series.rate(cols["qps"], window_s, labels=lbl)
        if "latency" in cols:
            p50 = coll.series.p50(cols["latency"], window_s,
                                  labels=lbl)
            p99 = coll.series.p99(cols["latency"], window_s,
                                  labels=lbl)
        if "queue" in cols:
            queue = coll.series.latest(cols["queue"], labels=lbl)
        if "util" in cols:
            util = coll.series.latest(cols["util"], labels=lbl)
        rows.append((m["member"], m["kind"],
                     "up" if m["up"] else "DOWN",
                     _fmt_stat(qps), _fmt_stat(p50, "{:.4g}"),
                     _fmt_stat(p99, "{:.4g}"), _fmt_stat(queue),
                     _fmt_stat(util, "{:.2f}")))
    header = ("MEMBER", "KIND", "UP", "QPS", "P50", "P99", "QUEUE",
              "KV_UTIL")
    widths = [max([len(header[i])] + [len(r[i]) for r in rows])
              for i in range(len(header))]
    lines = ["  ".join(h.ljust(w) for h, w in zip(header, widths))]
    for r in rows:
        lines.append("  ".join(c.ljust(w) for c, w in zip(r, widths)))
    if not rows:
        lines.append("(no members announced yet)")
    return "\n".join(lines)


def format_straggler_lines(coll, window_s: float = 60.0,
                           flag_at: float = 3.0) -> str:
    """Comm-endpoint straggler scores for the `cli top` footer: one
    line per endpoint whose mean round time drifts above its peers',
    the SLO-able detector threshold marked.  Empty string when the
    fleet has no per-endpoint round data (no distributed training
    running, or a single pserver)."""
    from paddle_tpu_torch.observability import attribution

    scores = attribution.straggler_scores(coll.series,
                                          window_s=window_s)
    drifted = {ep: s for ep, s in scores.items() if s > 0.5}
    if not drifted:
        return ""
    lines = ["stragglers (round-time z-score vs peers):"]
    for ep, s in sorted(drifted.items(), key=lambda t: -t[1]):
        mark = "  << STRAGGLER" if s >= flag_at else ""
        lines.append(f"  {ep}  {s:.1f}{mark}")
    return "\n".join(lines)


def cmd_top(argv):
    """`python -m paddle_tpu_torch.cli top --registry HOST:PORT` — the live
    fleet table: every announced member (trainers, pservers, serving
    replicas, routers) with windowed qps, p50/p99 latency, queue depth
    and KV-pool utilization from a TelemetryCollector scrape, plus the
    SLO scoreboard when --slo points at a spec file.  One render after
    --samples scrapes by default; --watch refreshes until ^C."""
    import time as _time

    from paddle_tpu_torch.observability import slo as slo_mod
    from paddle_tpu_torch.observability.collector import TelemetryCollector

    ap = argparse.ArgumentParser(
        prog="paddle_tpu_torch.cli top",
        description="live fleet telemetry table "
        "(docs/observability.md 'Fleet telemetry')")
    ap.add_argument("--registry", required=True,
                    help="TTL-lease registry HOST:PORT the fleet's "
                    "members announce() in")
    ap.add_argument("--period", type=float, default=0.5,
                    help="scrape period seconds")
    ap.add_argument("--samples", type=int, default=4,
                    help="scrapes before the (first) render — two or "
                    "more make windowed rates/quantiles meaningful")
    ap.add_argument("--window", type=float, default=60.0,
                    help="window seconds for qps/p50/p99")
    ap.add_argument("--slo", default="",
                    help="SLO spec file (tools/slo.json) to score "
                    "against the fleet series")
    ap.add_argument("--watch", action="store_true",
                    help="keep refreshing until interrupted")
    args = ap.parse_args(argv)

    coll = TelemetryCollector(registry_addr=args.registry,
                              period_s=args.period)
    specs = slo_mod.load_slos(args.slo) if args.slo else []
    try:
        while True:
            for i in range(max(args.samples, 1)):
                if i:  # sleep BETWEEN scrapes, never after the last
                    _time.sleep(args.period)
                coll.scrape_once()
            print(format_fleet_table(coll, window_s=args.window))
            straggler = format_straggler_lines(coll,
                                               window_s=args.window)
            if straggler:
                print(straggler)
            if specs:
                print()
                print(slo_mod.format_slo_table(
                    slo_mod.evaluate(specs, coll.series)))
            if not args.watch:
                break
            print()
            # --samples 1 never sleeps inside the scrape loop; without
            # this the watch loop would hammer every member endpoint
            _time.sleep(args.period)
    except KeyboardInterrupt:
        pass
    finally:
        coll.close()
    return 0


def cmd_slo(argv):
    """`python -m paddle_tpu_torch.cli slo --check [--spec tools/slo.json]`
    — evaluate the fleet SLOs and exit nonzero on violation.  Two
    modes: `--registry HOST:PORT` samples a live fleet through a
    TelemetryCollector and applies the full multiwindow burn-rate rule;
    `--prom DUMP` gates a single Prometheus dump (federation output or
    any scrape) on lifetime stats — the CI smoke mode."""
    import time as _time

    from paddle_tpu_torch.observability import slo as slo_mod

    ap = argparse.ArgumentParser(
        prog="paddle_tpu_torch.cli slo",
        description="evaluate SLO specs against fleet telemetry "
        "(docs/observability.md 'Fleet telemetry')")
    ap.add_argument("--spec", default="tools/slo.json",
                    help="SLO spec file (grammar + dict forms)")
    ap.add_argument("--check", action="store_true",
                    help="exit nonzero when any objective alerts")
    ap.add_argument("--registry", default="",
                    help="live mode: scrape this fleet registry")
    ap.add_argument("--prom", default="",
                    help="snapshot mode: gate this Prometheus text "
                    "dump")
    ap.add_argument("--period", type=float, default=0.5)
    ap.add_argument("--samples", type=int, default=6,
                    help="live mode: scrapes before evaluating")
    args = ap.parse_args(argv)

    specs = slo_mod.load_slos(args.spec)
    if bool(args.registry) == bool(args.prom):
        raise SystemExit(
            "slo: give exactly one of --registry (live) or --prom "
            "(snapshot)")
    if args.prom:
        from paddle_tpu_torch.observability.collector import \
            parse_prometheus_text

        with open(args.prom) as f:
            families = parse_prometheus_text(f.read())
        statuses = slo_mod.evaluate_snapshot(specs, families)
    else:
        from paddle_tpu_torch.observability.collector import \
            TelemetryCollector

        coll = TelemetryCollector(registry_addr=args.registry,
                                  period_s=args.period)
        try:
            for i in range(max(args.samples, 2)):
                if i:  # sleep BETWEEN scrapes, never after the last
                    _time.sleep(args.period)
                coll.scrape_once()
            statuses = slo_mod.evaluate(specs, coll.series)
        finally:
            coll.close()
    print(slo_mod.format_slo_table(statuses))
    bad = slo_mod.failed(statuses)
    print(f"slo: {len(statuses)} objective(s) — "
          + ("FAILED" if bad else "all met"))
    if args.check and bad:
        return 1
    return 0


# ---------------------------------------------------------------------------
# `why` / `trace-of` subcommands: the time-attribution plane
# (docs/observability.md "Time attribution")
# ---------------------------------------------------------------------------


def cmd_why(argv):
    """`python -m paddle_tpu_torch.cli why [--kind generation|trainer|
    pserver]` — the fleet "where does the time go" table: per
    (kind, member, phase) share of attributed time.  Two modes like
    `cli slo`: `--prom DUMP` reads lifetime sums from a federated
    Prometheus dump; `--registry HOST:PORT` scrapes a live fleet and
    shows windowed rates."""
    import time as _time

    from paddle_tpu_torch.observability import attribution

    ap = argparse.ArgumentParser(
        prog="paddle_tpu_torch.cli why",
        description="per-phase time attribution across the fleet "
        "(docs/observability.md 'Time attribution')")
    ap.add_argument("--kind", default="",
                    choices=[""] + list(attribution.KINDS),
                    help="restrict to one member kind")
    ap.add_argument("--prom", default="",
                    help="snapshot mode: a federated Prometheus dump")
    ap.add_argument("--registry", default="",
                    help="live mode: scrape this fleet registry")
    ap.add_argument("--period", type=float, default=0.5)
    ap.add_argument("--samples", type=int, default=4)
    ap.add_argument("--window", type=float, default=60.0)
    args = ap.parse_args(argv)

    kind = args.kind or None
    if bool(args.registry) == bool(args.prom):
        raise SystemExit("why: give exactly one of --registry (live) "
                         "or --prom (snapshot)")
    if args.prom:
        from paddle_tpu_torch.observability.collector import \
            parse_prometheus_text

        with open(args.prom) as f:
            parsed = parse_prometheus_text(f.read())
        rows = attribution.why_rows_from_parsed(parsed, kind)
    else:
        from paddle_tpu_torch.observability.collector import \
            TelemetryCollector

        coll = TelemetryCollector(registry_addr=args.registry,
                                  period_s=args.period)
        try:
            for i in range(max(args.samples, 2)):
                if i:
                    _time.sleep(args.period)
                coll.scrape_once()
            rows = attribution.why_rows(coll.series, kind,
                                        window_s=args.window)
        finally:
            coll.close()
    print(attribution.format_why_table(rows))
    return 0


def cmd_trace_of(argv):
    """`python -m paddle_tpu_torch.cli trace-of --metric serving.request
    --prom DUMP [--trace-dir DIR]` — resolve a latency outlier to its
    trace: pick the histogram exemplar nearest the requested quantile
    (p99 by default) from a federated dump, and, when --trace-dir
    holds the fleet's trace/flight files, assemble the end-to-end
    Chrome trace for that trace id."""
    from paddle_tpu_torch.observability import attribution
    from paddle_tpu_torch.observability import slo as slo_mod
    from paddle_tpu_torch.observability.collector import (
        assemble_traces, parse_prometheus_text)

    ap = argparse.ArgumentParser(
        prog="paddle_tpu_torch.cli trace-of",
        description="histogram exemplar -> joined Chrome trace "
        "(docs/observability.md 'Time attribution')")
    ap.add_argument("--metric", required=True,
                    help="histogram family (short alias like "
                    "'serving.request' or full paddle_tpu_* name)")
    ap.add_argument("--prom", required=True,
                    help="federated Prometheus dump with exemplars")
    ap.add_argument("--p99", action="store_true",
                    help="target the p99 outlier (the default)")
    ap.add_argument("--q", type=float, default=0.99,
                    help="target quantile (overrides --p99)")
    ap.add_argument("--trace-dir", default="",
                    help="fleet trace dir: also write the joined "
                    "Chrome trace for the picked trace id")
    ap.add_argument("--out", default="",
                    help="output dir for the joined trace "
                    "(default: --trace-dir)")
    args = ap.parse_args(argv)

    with open(args.prom) as f:
        parsed = parse_prometheus_text(f.read())
    name = args.metric
    if name not in parsed:
        name = slo_mod.ALIASES.get(args.metric, name)
    if name not in parsed and not name.startswith("paddle_tpu_"):
        name = "paddle_tpu_" + name
    ex = attribution.pick_exemplar(parsed, name, q=args.q)
    if ex is None:
        print(f"trace-of: no exemplars on {name!r} — run the fleet "
              "with PADDLE_TPU_EXEMPLARS=on and PADDLE_TPU_TRACE=on")
        return 1
    qs = ex.get("quantile_s")
    print(f"metric   {name}")
    if qs is not None:
        print(f"p{args.q * 100:g}      {qs:.6g}s")
    print(f"exemplar {ex['value']:.6g}s  labels={ex['labels']}")
    print(f"trace_id {ex['trace_id']}")
    if args.trace_dir:
        joined = assemble_traces(args.trace_dir,
                                 args.out or args.trace_dir)
        path = joined.get(ex["trace_id"])
        if path:
            print(f"trace    {path}")
        else:
            print(f"trace    (trace_id not found under "
                  f"{args.trace_dir} — was the member running with "
                  "PADDLE_TPU_TRACE_DIR pointed there?)")
            return 1
    return 0


# ---------------------------------------------------------------------------
# `serve` subcommand: one generation replica (docs/serving.md)
# ---------------------------------------------------------------------------


def cmd_serve(argv):
    """`python -m paddle_tpu_torch.cli serve MODEL_DIR [--port P]` — front a
    continuous-batching GenerationServer with the TCP replica protocol
    (serving/replica.py).  MODEL_DIR is a directory written by
    serving.save_generation_model (generation.json spec + params npz).
    With --registry (or PADDLE_TPU_REGISTRY), the replica registers
    under a TTL lease so a cloud.router.ReplicaRouter front door
    discovers, health-checks, and hot-swaps it."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.serving import ReplicaServer, server_from_model_dir

    ap = argparse.ArgumentParser(
        prog="paddle_tpu_torch.cli serve",
        description="serve a saved generation model as one replica")
    ap.add_argument("model_dir", help="save_generation_model output dir")
    ap.add_argument("--port", type=int, default=0,
                    help="TCP port (0 = ephemeral, printed on start)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--slots", type=int, default=0,
                    help="decode slots (0 = model spec / default 8)")
    ap.add_argument("--kv_blocks", type=int, default=0,
                    help="KV pool blocks (0 = model spec / default 64)")
    ap.add_argument("--block_size", type=int, default=0,
                    help="KV block size in positions (0 = spec / 16)")
    ap.add_argument("--kv_dtype", default="",
                    help="KV pool precision: fp32|bf16|int8 ('' = "
                    "model spec / PADDLE_TPU_SERVING_KV_DTYPE / fp32); "
                    "docs/serving.md 'KV quantization'")
    ap.add_argument("--spec_k", type=int, default=0,
                    help="speculative draft tokens per tick (0 = model "
                    "spec / flag default; needs draft params in the "
                    "model dir)")
    ap.add_argument("--no_draft", action="store_true",
                    help="ignore draft params in the model dir "
                    "(disable speculative decoding)")
    ap.add_argument("--registry",
                    default=os.environ.get("PADDLE_TPU_REGISTRY", ""),
                    help="TTL-lease registry HOST:PORT to register "
                    "with (kind 'generation')")
    ap.add_argument("--ttl", type=float, default=2.0,
                    help="registry lease TTL seconds")
    ap.add_argument("--drain_grace", "--drain-grace", type=float,
                    default=30.0, dest="drain_grace",
                    help="graceful-SIGTERM drain budget seconds: on "
                    "SIGTERM the replica stops admission, releases "
                    "its lease, finishes in-flight streams within "
                    "this budget, delists telemetry, then exits "
                    "(docs/serving.md 'Autoscaling')")
    ap.add_argument("--cold", action="store_true",
                    help="ignore the model dir's warm-start "
                    "kernel_cache artifact (build the CUDA kernels "
                    "with nvcc — the baseline the artifact is measured "
                    "against)")
    ap.add_argument("--telemetry",
                    default=os.environ.get(
                        "PADDLE_TPU_TELEMETRY_REGISTRY", ""),
                    help="fleet telemetry registry HOST:PORT — the "
                    "replica announces its /metrics endpoint there "
                    "for a TelemetryCollector (docs/observability.md "
                    "'Fleet telemetry')")
    ap.add_argument("--use_gpu", "--use_tpu", dest="use_gpu", type=int,
                    default=1,
                    help="1: CUDAPlace(0), raising without a card; 0: the "
                    "CPU (--use_tpu: the JAX package's name, an alias)")
    args = ap.parse_args(argv)
    if args.telemetry:
        # ReplicaServer's env-gated maybe_announce() does the work
        os.environ["PADDLE_TPU_TELEMETRY_REGISTRY"] = args.telemetry

    server = server_from_model_dir(
        args.model_dir, slots=args.slots or None,
        kv_blocks=args.kv_blocks or None,
        block_size=args.block_size or None,
        kv_dtype=args.kv_dtype or None,
        spec_k=args.spec_k or None,
        use_draft=not args.no_draft,
        warm_start=not args.cold,
        place=_place(args.use_gpu))
    rep = ReplicaServer(server, port=args.port, host=args.host,
                        registry_addr=args.registry or None,
                        ttl_s=args.ttl,
                        drain_grace_s=args.drain_grace,
                        own_announcement=True)
    # graceful scale-in: SIGTERM drains before exit, chaining onto the
    # flight recorder's dump handler when PADDLE_TPU_FLIGHT_DIR is set
    rep.install_sigterm()
    suffix = (f", registered in {args.registry}" if args.registry
              else "")
    ws = server.warmup_stats
    if server.warm_start_dir:
        suffix += (f" (warm start: {ws['cache_hits']} kernel builds "
                   f"loaded, {ws['cache_misses']} built, "
                   f"warmup {ws['warmup_s']:.2f}s)")
    else:
        suffix += (f" (cold start: {ws['compiles']} kernel builds, "
                   f"{ws['cache_hits']} loaded, "
                   f"warmup {ws['warmup_s']:.2f}s)")
    print(f"serving {args.model_dir} on {rep.addr}{suffix}", flush=True)
    try:
        rep.wait()
    except KeyboardInterrupt:
        pass
    finally:
        rep.close()
        server.close()
    return 0


# ---------------------------------------------------------------------------
# `autoscale` subcommand: the self-scaling serving front door
# ---------------------------------------------------------------------------


def cmd_autoscale(argv):
    """`python -m paddle_tpu_torch.cli autoscale MODEL_DIR [--min 1 --max 4]`
    — run the self-scaling front door: a ReplicaRouter (hosting the
    TTL-lease replica registry unless --registry joins an existing
    one) plus an Autoscaler that spawns/retires `cli serve` replicas
    of MODEL_DIR from the router's windowed backlog/p99 signals
    (docs/serving.md "Autoscaling").  Prints a status line every
    --status_period seconds until interrupted; on exit the spawned
    replicas are retired gracefully."""
    import time as _time

    from paddle_tpu_torch.cloud.autoscaler import (Autoscaler,
                                             AutoscalerPolicy,
                                             SubprocessReplicaLauncher)
    from paddle_tpu_torch.cloud.router import ReplicaRouter

    ap = argparse.ArgumentParser(
        prog="paddle_tpu_torch.cli autoscale",
        description="signal-driven autoscaling serving fleet")
    ap.add_argument("model_dir", help="save_generation_model output "
                    "dir (ship it with warm_start=True so scale-out "
                    "replicas load the CUDA kernels instead of building "
                    "them)")
    ap.add_argument("--registry", default="",
                    help="join an existing replica registry instead "
                    "of hosting one")
    ap.add_argument("--min", type=int, default=1, dest="min_replicas")
    ap.add_argument("--max", type=int, default=4, dest="max_replicas")
    ap.add_argument("--p99_high", type=float, default=2.0,
                    help="scale-out latency target seconds")
    ap.add_argument("--backlog_high", type=float, default=512,
                    help="scale-out reserved-token backlog threshold")
    ap.add_argument("--backlog_low", type=float, default=32,
                    help="scale-in idle backlog threshold (hysteresis "
                    "floor)")
    ap.add_argument("--sustain", type=float, default=3.0,
                    help="seconds the hot signal must hold")
    ap.add_argument("--idle_sustain", type=float, default=10.0,
                    help="seconds the cold signal must hold")
    ap.add_argument("--cooldown", type=float, default=15.0,
                    help="refractory seconds after any scale action")
    ap.add_argument("--poll", type=float, default=0.5)
    ap.add_argument("--window", type=float, default=15.0,
                    help="signal window seconds (router.signals)")
    ap.add_argument("--drain_grace", "--drain-grace", type=float,
                    default=30.0, dest="drain_grace")
    ap.add_argument("--spawn_timeout", type=float, default=300.0)
    ap.add_argument("--status_period", type=float, default=5.0)
    ap.add_argument("--use_gpu", "--use_tpu", dest="use_gpu", type=int,
                    default=1,
                    help="1: CUDAPlace(0), raising without a card; 0: the "
                    "CPU (--use_tpu: the JAX package's name, an alias)")
    args = ap.parse_args(argv)

    policy = AutoscalerPolicy(
        args.min_replicas, args.max_replicas,
        p99_high_s=args.p99_high, backlog_high=args.backlog_high,
        backlog_low=args.backlog_low, sustain_s=args.sustain,
        idle_sustain_s=args.idle_sustain, cooldown_s=args.cooldown)
    router = ReplicaRouter(registry_addr=args.registry or None,
                           desired=max(args.max_replicas * 2, 8))
    launcher = SubprocessReplicaLauncher(
        args.model_dir, router.registry_addr, use_gpu=args.use_gpu,
        drain_grace_s=args.drain_grace)
    scaler = Autoscaler(router, launcher, policy, poll_s=args.poll,
                        window_s=args.window,
                        spawn_timeout_s=args.spawn_timeout,
                        drain_grace_s=args.drain_grace)
    print(f"autoscale: fronting {args.model_dir}; replica registry at "
          f"{router.registry_addr} (band {args.min_replicas}.."
          f"{args.max_replicas})", flush=True)
    try:
        # inside the try: a Ctrl-C during the cold boot (the floor
        # replica can take minutes on the compile path) must still
        # reach the finally and retire whatever was already spawned
        scaler.ensure_min()
        scaler.start()
        while True:
            _time.sleep(args.status_period)
            st = scaler.status()
            sig = router.signals(args.window)
            print(f"autoscale: live={len(st['live'])} "
                  f"pending={st['pending_spawns']} "
                  f"qps={_fmt_stat(sig['qps'])} "
                  f"p99={_fmt_stat(sig['p99'], '{:.4g}')} "
                  f"backlog={_fmt_stat(sig['outstanding_tokens'])} "
                  f"| {st['last_event']}", flush=True)
    except KeyboardInterrupt:
        print("autoscale: retiring owned replicas", flush=True)
    finally:
        scaler.close(retire_owned=True)
        router.close()
    return 0


# ---------------------------------------------------------------------------
# `verify` subcommand: static analysis of saved / buildable programs
# ---------------------------------------------------------------------------


def _programs_from_target(path):
    """Yield (label, program, feed_names, fetch_names) for one verify
    target: a model dir saved by io.save_inference_model (`__model__`
    JSON), or a python file defining build() (CLI config contract, or an
    example-style build returning Program objects)."""
    import paddle_tpu_torch as fluid

    if os.path.isdir(path):
        import json

        from paddle_tpu_torch.io import MODEL_FILENAME

        model_path = os.path.join(path, MODEL_FILENAME)
        if not os.path.exists(model_path):
            raise SystemExit(
                f"{path!r} has no {MODEL_FILENAME} file — not a model "
                "dir saved by save_inference_model")
        with open(model_path) as f:
            payload = json.load(f)
        yield (f"{path}/{MODEL_FILENAME}",
               fluid.Program.from_dict(payload["program"]),
               payload.get("feed_var_names"),
               payload.get("fetch_var_names"))
        return

    from paddle_tpu_torch.core.framework import reset_unique_names

    mod = _load_config(path)
    reset_unique_names()
    main_p, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main_p, startup):
        out = mod.build()
    # collect every Program the config touched: returned directly
    # (example-style tuples / dicts) or built under the ambient guard
    # (CLI config contract)
    seen = {}

    def add(label, prog):
        if isinstance(prog, fluid.Program) and id(prog) not in seen:
            seen[id(prog)] = (label, prog)

    if isinstance(out, dict):
        for k, v in out.items():
            add(f"{path}:{k}", v)
    elif isinstance(out, (list, tuple)):
        for i, v in enumerate(out):
            add(f"{path}:build()[{i}]", v)
    else:
        add(f"{path}:build()", out)
    add(f"{path}:main", main_p)
    add(f"{path}:startup", startup)
    for label, prog in seen.values():
        if prog.global_block().ops or len(prog.blocks) > 1:
            yield label, prog, None, None


def _diagnostics_json(diagnostics):
    """The shared machine-readable diagnostics list (`cli verify --json`
    and `cli analyze --json` emit the same shape): one dict per
    Diagnostic with severity / pass / location / hint
    (analysis.Diagnostic.to_dict), strongest severity first."""
    from paddle_tpu_torch.analysis import severity_rank

    ordered = sorted(
        diagnostics,
        key=lambda d: (-severity_rank(d.severity), d.block_idx,
                       -1 if d.op_idx is None else d.op_idx))
    return [d.to_dict() for d in ordered]


def cmd_verify(argv):
    """`python -m paddle_tpu_torch.cli verify TARGET... [--level error]
    [--json]` — run the static analyzer (paddle_tpu_torch.analysis) over
    programs saved by io.py or built by config/example files; exit
    non-zero when any diagnostic reaches --level.  `--json` replaces the
    human report with one JSON document (diagnostics as a structured
    list) for CI and editor consumers."""
    import json

    from paddle_tpu_torch.analysis import format_diagnostics, severity_rank

    ap = argparse.ArgumentParser(
        prog="paddle_tpu_torch.cli verify",
        description="static analysis of Program IR (docs/analysis.md)")
    ap.add_argument("targets", nargs="+",
                    help="model dir (save_inference_model output) or "
                    "python file defining build()")
    ap.add_argument("--level", default="error",
                    choices=["error", "warn", "info"],
                    help="minimum severity that fails the check")
    ap.add_argument("--passes", default="",
                    help="comma-separated pass ids (default: all)")
    ap.add_argument("--show", default="warning",
                    choices=["error", "warning", "info"],
                    help="minimum severity to print")
    ap.add_argument("--json", action="store_true",
                    help="emit one JSON document instead of the human "
                    "report (machine-readable diagnostics)")
    args = ap.parse_args(argv)

    passes = [p for p in args.passes.split(",") if p] or None
    fail_rank = severity_rank(
        "warning" if args.level == "warn" else args.level)
    n_programs = 0
    failed = False
    results = []
    for target in args.targets:
        for label, prog, feeds, fetches in _programs_from_target(target):
            n_programs += 1
            diagnostics = prog.verify(level=None, passes=passes,
                                      feed_names=feeds,
                                      fetch_names=fetches)
            bad = [d for d in diagnostics
                   if severity_rank(d.severity) >= fail_rank]
            failed = failed or bool(bad)
            if args.json:
                results.append({
                    "target": target,
                    "label": label,
                    "status": "fail" if bad else "ok",
                    "diagnostics": _diagnostics_json(diagnostics),
                })
                continue
            shown = [d for d in diagnostics
                     if severity_rank(d.severity)
                     >= severity_rank(args.show)]
            status = "FAIL" if bad else "ok"
            print(f"[{status}] {label}: {len(diagnostics)} diagnostic(s)")
            if shown:
                print(format_diagnostics(shown))
    if not n_programs:
        raise SystemExit("verify: no programs found in the given targets")
    if args.json:
        print(json.dumps({"level": args.level, "failed": failed,
                          "programs": results}, indent=1))
    else:
        print(f"verify: {n_programs} program(s) checked — "
              + ("FAILED" if failed else "all clean at level "
                 + args.level))
    return 1 if failed else 0


# ---------------------------------------------------------------------------
# `analyze` subcommand: static cost / roofline / comm / budget gate
# ---------------------------------------------------------------------------


def _load_budgets(path):
    import json

    with open(path) as f:
        budgets = json.load(f)
    if not isinstance(budgets.get("models", None), dict):
        raise SystemExit(
            f"budget file {path!r} must be "
            "{'defaults': {...}, 'models': {target: {...}}} "
            "(docs/analysis.md 'Budget gate')")
    return budgets


def _budget_for(budgets, target):
    """Budget entry for one analyze target: exact key match on the
    target as given, else on its basename — overlaid on 'defaults'."""
    models = budgets.get("models", {})
    entry = models.get(target)
    if entry is None:
        entry = models.get(os.path.basename(target))
    if entry is None:
        return None
    return {**budgets.get("defaults", {}), **entry}


def cmd_analyze(argv):
    """`python -m paddle_tpu_torch.cli analyze TARGET... [--json]
    [--budget budgets.json] [--batch N]` — the compile-free cost
    report: static roofline (FLOPs, HBM traffic, arithmetic intensity
    vs the device ridge point, memory/compute-bound verdict), the
    liveness-based peak-HBM estimate, per-mesh-axis comm volume, and
    the cost/collective diagnostics, for every program a target builds
    — plus generation model dirs (generation.json), costed from the
    serving-kernel entries without building a decoder.

    With `--budget`, each target's headline program is gated against
    its checked-in budget entry and the exit status is non-zero on any
    violation — a perf-regression gate that never runs a step
    (docs/analysis.md 'Budget gate')."""
    import json as _json

    from paddle_tpu_torch import analysis
    from paddle_tpu_torch.analysis import cost_model

    ap = argparse.ArgumentParser(
        prog="paddle_tpu_torch.cli analyze",
        description="static cost analysis of Program IR / generation "
        "model dirs (docs/analysis.md)")
    ap.add_argument("targets", nargs="+",
                    help="config/example file defining build(), model "
                    "dir (save_inference_model output), or generation "
                    "model dir (save_generation_model output)")
    ap.add_argument("--json", action="store_true",
                    help="emit one JSON document (shares the verify "
                    "--json diagnostics shape)")
    ap.add_argument("--budget", default="",
                    help="budgets.json path: exit non-zero when an "
                    "estimate exceeds its checked-in budget")
    ap.add_argument("--batch", type=int,
                    default=cost_model.DEFAULT_BATCH,
                    help="batch size substituted for -1 dims "
                    f"(default {cost_model.DEFAULT_BATCH})")
    ap.add_argument("--device", default=cost_model.DEFAULT_DEVICE,
                    choices=sorted(cost_model.DEVICE_SPECS),
                    help="ridge-point card (default: the H100 SXM row)")
    ap.add_argument("--top", type=int, default=5,
                    help="top-N traffic-heavy ops to list per program")
    args = ap.parse_args(argv)

    budgets = _load_budgets(args.budget) if args.budget else None
    out = {"programs": [], "violations": []}
    n_targets = 0

    for target in args.targets:
        spec_path = os.path.join(target, "generation.json") \
            if os.path.isdir(target) else ""
        if spec_path and os.path.exists(spec_path):
            n_targets += 1
            with open(spec_path) as f:
                spec = _json.load(f)
            rep = analysis.analyze_generation_spec(spec,
                                                   device=args.device)
            out["programs"].append({"target": target,
                                    "kind": "generation",
                                    "report": rep})
            if not args.json:
                _print_generation_report(target, rep)
            if budgets is not None and _budget_for(budgets,
                                                  target) is not None:
                # fail loudly rather than silently skipping a budget
                # the operator checked in
                out["violations"].append(
                    f"{target}: budget entries for generation model "
                    "dirs are not supported (budgets gate Program "
                    "targets)")
            continue

        headline = None
        target_unknown: dict = {}
        for label, prog, feeds, fetches in _programs_from_target(target):
            n_targets += 1
            est = analysis.estimate_program(
                prog, batch_size=args.batch, feed_names=feeds,
                fetch_names=fetches, device=args.device)
            if (not est.total_flops and not est.total_bytes
                    and not est.unknown_types):
                continue  # empty program: no roofline signal.  A
                # program whose ops are all cost-UNKNOWN must NOT be
                # skipped — that is the coverage regression the
                # max_unknown_ops budget floor exists to catch
            comm = analysis.estimate_comm(
                prog, batch_size=args.batch,
                fetch_names=fetches).by_axis()
            # collective-safety only: the cost-model/comm-volume pass
            # output would just re-derive the `est`/`comm` tables this
            # report already carries (and re-run the liveness walk)
            diagnostics = prog.verify(
                level=None, passes=["collective-safety"],
                feed_names=feeds, fetch_names=fetches)
            rep = {
                "target": target,
                "label": label,
                "kind": "program",
                "roofline": est.roofline(),
                "comm": comm,
                "top_traffic_ops": [
                    {"block": b, "op": i, "type": t, "ai": ai,
                     "bytes": by}
                    for b, i, t, ai, by in est.top_memory_bound(args.top)
                ],
                "diagnostics": _diagnostics_json(diagnostics),
            }
            out["programs"].append(rep)
            for t, c in est.unknown_types.items():
                target_unknown[t] = target_unknown.get(t, 0) + c
            if headline is None or (est.total_flops
                                    > headline[1].total_flops):
                headline = (rep, est)
            if not args.json:
                _print_program_report(rep)

        if budgets is not None:
            budget = _budget_for(budgets, target)
            if headline is None:
                if budget is not None:
                    # a budgeted target with nothing analyzable is a
                    # failure, not a silent pass (the config may have
                    # stopped building, or every op lost its metadata)
                    out["violations"].append(
                        f"{target}: has a budget entry but produced no "
                        "analyzable program")
            elif budget is None:
                out["violations"].append(
                    f"{target}: no budget entry in {args.budget} "
                    "(add one under 'models')")
            else:
                # flops/traffic/peak limits gate the headline program
                # (budgets are seeded from it), but the COVERAGE floor
                # is target-wide: an unknown-cost op in ANY program of
                # the target is the regression max_unknown_ops catches
                gated = dict(headline[0])
                gated["roofline"] = {
                    **headline[0]["roofline"],
                    "unknown_ops": sum(target_unknown.values()),
                    "unknown_types": sorted(target_unknown),
                }
                for v in analysis.check_budget(gated, budget):
                    out["violations"].append(f"{target}: {v}")

    if not n_targets:
        raise SystemExit("analyze: no programs found in the given "
                         "targets")
    if args.json:
        print(_json.dumps(out, indent=1, default=float))
    else:
        for v in out["violations"]:
            print(f"BUDGET VIOLATION: {v}")
        print(f"analyze: {n_targets} program(s)"
              + (f", {len(out['violations'])} budget violation(s)"
                 if budgets is not None else "")
              + (" — FAILED" if out["violations"] else ""))
    return 1 if out["violations"] else 0


def _print_program_report(rep):
    roof = rep["roofline"]
    print(f"== {rep['label']} ==")
    line = (f"  flops {roof['est_flops'] / 1e9:.2f} G"
            f"  traffic {roof['est_hbm_traffic_gb']} GB")
    if "ai_flop_per_byte" in roof:
        line += (f"  AI {roof['ai_flop_per_byte']} vs ridge "
                 f"{roof['ridge_flop_per_byte']} flop/B "
                 f"({roof['device']}) -> {roof['bound']}-bound")
    print(line)
    print(f"  est peak HBM {roof['est_peak_hbm_gb']} GB  "
          f"(batch {roof['batch_size']} assumed, {roof['n_ops']} ops)")
    if roof["unknown_ops"]:
        print(f"  coverage: {roof['unknown_ops']} op(s) without cost "
              f"metadata: {roof['unknown_types']}")
    for axis, kinds in sorted(rep["comm"].items()):
        detail = ", ".join(f"{k} {b / 1e6:.3f} MB"
                           for k, b in sorted(kinds.items()))
        print(f"  comm[{axis}]: {detail}")
    if rep["top_traffic_ops"]:
        tops = ", ".join(
            f"{t['type']}@{t['block']}:{t['op']} "
            f"({t['bytes'] / 1e6:.1f} MB, AI {t['ai']})"
            for t in rep["top_traffic_ops"][:3])
        print(f"  heaviest traffic: {tops}")
    errors = [d for d in rep["diagnostics"] if d["severity"] == "error"]
    for d in errors:
        print(f"  [error] {d['pass']}: {d['message']}")


def _print_generation_report(target, rep):
    print(f"== {target} (generation model dir) ==")
    m = rep["model"]
    print(f"  d_model {m['d_model']}  layers {m['n_layers']}  vocab "
          f"{m['vocab_size']}  kv_dtype {m['kv_dtype']}  slots "
          f"{m['slots']}")
    print(f"  params {rep['param_bytes'] / 1e6:.1f} MB  KV "
          f"{rep['bytes_per_block'] / 1e3:.1f} kB/block")
    for k in rep["kernels"]:
        line = (f"  {k['kernel']}: {k['flops'] / 1e6:.2f} MFLOP, "
                f"{k['bytes'] / 1e6:.2f} MB/tick")
        if "ai_flop_per_byte" in k:
            line += (f", AI {k['ai_flop_per_byte']} vs ridge "
                     f"{k['ridge_flop_per_byte']} -> {k['bound']}-bound")
        print(line)


# ---------------------------------------------------------------------------
# `concurrency` subcommand: lock-order/race lint + schedule checking
# ---------------------------------------------------------------------------


def cmd_concurrency(argv):
    """`python -m paddle_tpu_torch.cli concurrency [PATHS...] [--json]
    [--sched] [--rules r1,r2]` — the whole-repo AST concurrency
    analyzer (docs/analysis.md "Concurrency analysis"): lock inventory,
    lock-order cycles, blocking-calls-under-lock, RacerD-style
    unguarded-attribute races, thread hygiene.  Exit non-zero on any
    UNSUPPRESSED error-severity finding (`# lint: <rule>-ok` comments
    demote to info).

    `--sched` additionally runs the fast deterministic-schedule-checker
    protocol subset (analysis/schedmodels.py): FENCE->MIGRATE->COMMIT,
    elastic_round replay, GenerationServer admit/finish/swap over the
    real PagedKVCache, and CommPool.send_round ordering — each must
    hold its invariant over every explored interleaving."""
    import json

    from paddle_tpu_torch.analysis import concurrency as conc

    ap = argparse.ArgumentParser(
        prog="paddle_tpu_torch.cli concurrency",
        description="AST concurrency lint + schedule checking "
        "(docs/analysis.md)")
    ap.add_argument("paths", nargs="*",
                    help="files/dirs to analyze (default: the whole "
                    "paddle_tpu_torch package)")
    ap.add_argument("--json", action="store_true",
                    help="emit one JSON document (shares the verify "
                    "--json diagnostics shape)")
    ap.add_argument("--rules", default="",
                    help="comma-separated rule subset "
                    f"(default: all of {', '.join(conc.RULES)})")
    ap.add_argument("--sched", action="store_true",
                    help="also run the schedule-checker protocol "
                    "models (a few seconds)")
    ap.add_argument("--sched-schedules", type=int, default=120,
                    help="bounded-DFS schedule budget per protocol")
    ap.add_argument("--show", default="warning",
                    choices=["error", "warning", "info"],
                    help="minimum severity to print (human mode)")
    args = ap.parse_args(argv)

    rules = [r for r in args.rules.split(",") if r] or None
    if rules:
        unknown = sorted(set(rules) - set(conc.RULES))
        if unknown:
            # a typo'd rule must not silently verify nothing
            raise SystemExit(
                f"concurrency: unknown rule(s) {unknown}; "
                f"valid: {', '.join(conc.RULES)}")
    missing = [p for p in args.paths if not os.path.exists(p)]
    if missing:
        # a typo'd path must not silently verify nothing either
        raise SystemExit(f"concurrency: no such path(s): {missing}")
    findings = conc.analyze_paths(args.paths or None, rules=rules)
    errors = [f for f in findings if f.severity == "error"]

    sched_results = []
    if args.sched:
        from paddle_tpu_torch.analysis import schedcheck, schedmodels

        for name, (factory, inv) in schedmodels.PROTOCOLS.items():
            res = schedcheck.explore(
                factory(), inv,
                max_schedules=args.sched_schedules,
                random_schedules=30)
            sched_results.append(
                {"protocol": name, "schedules": res.schedules,
                 "ok": res.ok,
                 "violation": (str(res.violation)
                               if res.violation else None)})

    failed = bool(errors) or any(not r["ok"] for r in sched_results)
    if args.json:
        from paddle_tpu_torch.analysis.concurrency import to_diagnostics

        print(json.dumps({
            "failed": failed,
            "summary": conc.summarize(findings),
            "diagnostics": [d.to_dict()
                            for d in to_diagnostics(findings)],
            "schedcheck": sched_results,
        }, indent=1))
        return 1 if failed else 0

    order = {"error": 0, "warning": 1, "info": 2}
    shown = [f for f in findings
             if order[f.severity] <= order[args.show]]
    for f in sorted(shown, key=lambda f: (order[f.severity], f.file,
                                          f.line)):
        print(f)
        if f.hint:
            print(f"    hint: {f.hint}")
    for r in sched_results:
        status = "ok" if r["ok"] else "FAIL"
        print(f"schedcheck {r['protocol']}: [{status}] "
              f"{r['schedules']} schedule(s) explored")
        if r["violation"]:
            print(f"    {r['violation']}")
    print(f"concurrency: {conc.summarize(findings)}"
          + (f"; {len(sched_results)} protocol(s) schedule-checked"
             if sched_results else "")
          + (" — FAILED" if failed else ""))
    return 1 if failed else 0


def main(argv=None):
    """Run one job (or subcommand) -> the job's result dict, with the
    scope it ran in under "scope"."""
    argv = sys.argv[1:] if argv is None else list(argv)
    subcommands = {"verify": cmd_verify, "analyze": cmd_analyze,
                   "metrics": cmd_metrics, "trace": cmd_trace,
                   "serve": cmd_serve, "autoscale": cmd_autoscale,
                   "concurrency": cmd_concurrency,
                   "top": cmd_top, "slo": cmd_slo,
                   "why": cmd_why, "trace-of": cmd_trace_of}
    if argv and argv[0] in subcommands:
        sys.exit(subcommands[argv[0]](argv[1:]))
    ap = argparse.ArgumentParser(
        prog="paddle_tpu_torch.cli",
        description="legacy `paddle train` workflow over Program/Executor"
        " on the card (plus subcommands: `python -m paddle_tpu_torch.cli "
        "verify|analyze|concurrency|metrics|trace|serve|autoscale|"
        "top|slo|why|trace-of --help`)")
    ap.add_argument("--config", required=True, help="python config file "
                    "defining build()")
    ap.add_argument("--job", default="train",
                    choices=["train", "test", "checkgrad", "time", "merge"])
    ap.add_argument("--use_gpu", "--use_tpu", dest="use_gpu", type=int,
                    default=1,
                    help="1: CUDAPlace(0), raising without a card; 0: the "
                    "CPU (--use_tpu: the JAX package's name, an alias)")
    ap.add_argument("--num_passes", type=int, default=1)
    ap.add_argument("--batches_per_pass", type=int, default=0,
                    help="0 = drain the reader")
    ap.add_argument("--log_period", type=int, default=100)
    ap.add_argument("--save_dir", default="",
                    help="per-pass param dirs (ParamUtil) / merge output")
    ap.add_argument("--init_model_path", default="",
                    help="load persistables before the job (--start_pass "
                    "resume analogue)")
    ap.add_argument("--checkgrad_eps", type=float, default=1e-3)
    ap.add_argument("--checkgrad_samples", type=int, default=8)
    ap.add_argument("--checkgrad_tol", type=float, default=1e-2)
    args = ap.parse_args(argv)

    from paddle_tpu_torch.core.executor import scope_guard
    from paddle_tpu_torch.core.scope import Scope

    mod = _load_config(args.config)
    scope = Scope()
    with scope_guard(scope):
        cfg = _build(mod)
        result = {"train": job_train, "test": job_test, "time": job_time,
                  "checkgrad": job_checkgrad, "merge": job_merge}[
                      args.job](cfg, args)
    return {**result, "cfg": cfg, "scope": scope}


if __name__ == "__main__":
    main()
