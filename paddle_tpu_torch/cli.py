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

The static-analysis subcommands exit with their status (0 clean):
`verify TARGET...` (the Program verifier over a saved model dir or a
config's programs), `analyze TARGET...` (the cost model's roofline on a
card of `--device`, the peak-memory and comm estimates, the budget gate;
generation model dirs too) and `concurrency [PATHS...] [--sched]` (the
AST lint over paddle_tpu_torch/ and the schedule checker's protocol
models).  The other subcommands of the JAX package's CLI raise naming
the ROADMAP item they wait for: `metrics`, `trace`, `top`, `slo`, `why`
and `trace-of` (A12's observability part), `serve` and `autoscale`
(A11).
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
    subcommands = {"verify": cmd_verify, "analyze": cmd_analyze,
                   "concurrency": cmd_concurrency}
    if argv and argv[0] in subcommands:
        sys.exit(subcommands[argv[0]](argv[1:]))
    if argv and argv[0] in _WAITING:
        return _waiting(argv[0])(argv[1:])
    ap = argparse.ArgumentParser(
        prog="paddle_tpu_torch.cli",
        description="legacy `paddle train` workflow over Program/Executor"
        " on the card (subcommands: verify, analyze and concurrency, the "
        "static analysis; the JAX package's metrics|trace|serve|autoscale|"
        "top|slo|why|trace-of are not ported yet)")
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
