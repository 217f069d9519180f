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
The other subcommands of the JAX package's CLI raise naming the ROADMAP
item they wait for: `verify`, `analyze` and `concurrency` (A12's
analysis), `metrics`, `trace`, `top`, `slo`, `why` and `trace-of` (A12's
observability part), `serve` and `autoscale` (A11).
"""
from __future__ import annotations

import argparse
import importlib.util
import os
import sys
import time

import numpy as np

# subcommand -> the ROADMAP item it waits for
_WAITING = {
    "verify": "A12, the analysis passes",
    "analyze": "A12, the analysis passes",
    "concurrency": "A12, the analysis passes",
    "metrics": "A12's second part, the observability rest",
    "trace": "A12's second part, the observability rest",
    "top": "A12's second part, the observability rest",
    "slo": "A12's second part, the observability rest",
    "why": "A12's second part, the observability rest",
    "trace-of": "A12's second part, the observability rest",
    "serve": "A11, the distributed runtime and fleet",
    "autoscale": "A11, the distributed runtime and fleet",
}


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


def _waiting(name):
    def cmd(argv):
        raise NotImplementedError(
            f"paddle_tpu_torch.cli {name}: not ported yet; it waits for "
            f"ROADMAP {_WAITING[name]}")
    return cmd


def main(argv=None):
    """Run one job (or subcommand) -> the job's result dict, with the
    scope it ran in under "scope"."""
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] in _WAITING:
        return _waiting(argv[0])(argv[1:])
    ap = argparse.ArgumentParser(
        prog="paddle_tpu_torch.cli",
        description="legacy `paddle train` workflow over Program/Executor"
        " on the card (the subcommands of the JAX package's CLI, "
        "verify|analyze|concurrency|metrics|trace|serve|autoscale|"
        "top|slo|why|trace-of, are not ported yet)")
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
