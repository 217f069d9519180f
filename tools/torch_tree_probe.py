"""Probes of the PyTorch port on one CUDA card, made to compare two
checkouts of the port on the same card (for instance a parent commit's
`git archive` and this tree, in turns):

    python3 tools/torch_tree_probe.py paged [--package-root DIR]
    python3 tools/torch_tree_probe.py dp-memory [--package-root DIR]
    python3 tools/torch_tree_probe.py moe-memory [--package-root DIR]
    python3 tools/torch_tree_probe.py sgd-sweep
    python3 tools/torch_tree_probe.py host [--fp32] [--mode MODE]
                                          [--package-root DIR]
    python3 tools/torch_tree_probe.py convnets [--package-root DIR]
    python3 tools/torch_tree_probe.py conv-fp32 [--package-root DIR]

paged      device time (torch.profiler) and launch grid of the
           paged-attention decode kernel at the kernels phase's shapes
           of chip_smoke.py (fp32/bf16/int8, W 1 and 4);
dp-memory  chip_smoke.py's dp phase model and steps under the CUDA
           allocator's history: the peak of allocated bytes, the step it
           sat in, and the bytes live at that peak by the lines of the
           package that allocated them;
moe-memory the same for chip_smoke.py's moe phase: the MoE LM's steps
           on the kernel path and on the plain path (the dense
           einsums), each from a fresh startup;
sgd-sweep  csrc/fused_update.cu built once for each setting of its
           SGD_UNROLL / SGD_BLOCKS_PER_SM / SGD_STREAMING switches and
           timed in place at the dp path's largest bucket beside
           torch.add and p.add_ (CUDA events, cold L2, three rounds
           interleaved); every variant is checked bit for bit;
convnets   chip_smoke.py's image phases alone (resnet50,
           resnet_card_vs_cpu, vgg_segmented), with its TF32 settings;
conv-fp32  float32 convolution on the card through cuDNN (deterministic
           algorithms, TF32 off) against PyTorch's own convolution (the
           conv lowering's float32 route), each against float64: the
           largest relative error of the forward, dInput and dFilter at
           ResNet shapes; every state after chip_smoke's card-vs-CPU
           ResNet-18 steps against the same steps in float64 on the CPU;
           and the VGG phase's step time with either route;
host       chip_smoke.py's train phase LM (bf16 amp; --fp32: float32)
           trained chip_smoke's T_STEPS steps, then one more under
           torch.profiler: the step's wall time, device time, and the
           CUDA runtime calls (launches, copies, synchronisations) by
           count and host time.  --mode interpreted (the default) runs
           compiled=False with every Program op in a record_function:
           host time by op type (inclusive, so an op that waits on the
           device carries the wait).  --mode compiled runs the
           Executor's default mode, whose later steps replay a CUDA
           graph: the replayed step's host time by part (feeds to
           tensors, the state check, the cache key and lookup, the
           input copies, the graph launch, the fetch's copy out of the
           pool and to the host).  dp-memory and moe-memory run amp, as
           the dp and moe phases do, where the package has it.

The measuring code is this checkout's chip_smoke.py; `paddle_tpu_torch`
is imported from DIR (default: this checkout).  Each result is one JSON
object on a line of its own.
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import importlib.util
import inspect
import itertools
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def emit(obj):
    print(json.dumps(obj), flush=True)


def _smoke():
    """This checkout's chip_smoke.py as a module, whatever is first on
    sys.path."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def paged(cs, dev):
    from paddle_tpu_torch.kernels.paged_attention import paged_attention

    # the kernels phase's inputs: the same generator, drawn in order
    gen = torch.Generator().manual_seed(cs.SEED)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=dev)
    layer = cs.N_LAYERS // 2
    for kv_dtype in cs.KV_DTYPES:
        for w_n in (1, 4):
            args = (*cs._kernel_inputs(kv_dtype, w_n, dev, gen), layer)
            run = lambda: paged_attention(*args, n_heads=cs.N_HEADS)  # noqa
            ms = cs.cold_ms(run, 200, flush)
            dev_ms, n_kernels, grids = cs.device_ms(run, 200, flush,
                                                    "paged_")
            emit({"probe": "paged", "case": f"{kv_dtype}_w{w_n}",
                  "ms": ms, "device_ms": dev_ms,
                  "device_kernels_profiled": n_kernels, "grids": grids})


def _repo_frames(frames):
    """The allocation's frames inside the package, innermost first, as
    'path:line function'."""
    out = []
    for f in frames:
        path = f.get("filename", "")
        if "paddle_tpu_torch" in path:
            rel = path[path.rindex("paddle_tpu_torch"):]
            out.append(f"{rel}:{f.get('line')} {f.get('name')}")
    return out


def dp_memory(cs, dev):
    import torch.distributed as dist

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import CUDAPlace

    torch.backends.cuda.matmul.allow_tf32 = False
    _amp_on(fluid)
    main, startup, loss = cs._lm_program(fluid.SGD(learning_rate=0.01))
    persist = [v.name for v in main.list_vars() if v.persistable]
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.memory._record_memory_history(max_entries=4_000_000,
                                             stacks="python")
    marks = []
    try:
        t = fluid.ShardingTranspiler()
        t.transpile(program=main, startup_program=startup, mesh={"dp": 1},
                    overlap="bucketed")
        pe = t.build_executor(["ids", "lbl"], [loss], place=CUDAPlace(0))
        # the dp phase holds a copy of every persistable meanwhile
        init = {n: pe.state(n, return_numpy=False).clone() for n in persist}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for step in range(cs.T_STEPS):
            marks.append(len(torch.cuda.memory._snapshot()
                             ["device_traces"][dev.index]))
            pe.run(cs._train_feed(step))
            torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        trace = torch.cuda.memory._snapshot()["device_traces"][dev.index]
        del init, pe
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
        dist.destroy_process_group()
        torch.cuda.empty_cache()
    emit({"probe": "dp-memory", "max_memory_allocated": peak,
          **_peak_sites(trace, base, marks)})


def _peak_sites(trace, base, marks):
    """Replay an allocator history (allocated bytes rise at each alloc
    and fall at each free the program requests) -> the peak, the step it
    sat in (`marks`: each step's first event) and the bytes live at it
    by the lines of the package that allocated them."""
    cur, top, at = base, base, 0
    for i, ev in enumerate(trace):
        if ev["action"] == "alloc":
            cur += ev["size"]
        elif ev["action"] == "free_requested":
            cur -= ev["size"]
        if cur > top:
            top, at = cur, i
    live = {}
    for ev in trace[:at + 1]:
        if ev["action"] == "alloc":
            live[ev["addr"]] = ev
        elif ev["action"] == "free_requested":
            live.pop(ev["addr"], None)
    groups = collections.defaultdict(lambda: [0, 0])
    for ev in live.values():
        frames = _repo_frames(ev.get("frames", []))
        key = " <- ".join(frames[:2]) if frames else "(outside the package)"
        groups[key][0] += ev["size"]
        groups[key][1] += 1
    step = sum(m <= at for m in marks)
    return {"replayed_peak": top, "before_trace": base,
            "peak_in_step": step if step else None,
            "peak_event": {k: trace[at].get(k) for k in ("action", "size")},
            "peak_event_frames": _repo_frames(trace[at].get("frames",
                                                            []))[:4],
            "live_at_peak_by_site": sorted(
                ({"bytes": b, "blocks": n, "site": k}
                 for k, (b, n) in groups.items()),
                key=lambda r: -r["bytes"])[:16]}


def moe_memory(cs, dev):
    import contextlib

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import CUDAPlace
    from paddle_tpu_torch.core import executor as executor_mod
    from paddle_tpu_torch.core import framework as fw
    from paddle_tpu_torch.core.scope import Scope
    from paddle_tpu_torch.models.moe import build_moe_lm

    torch.backends.cuda.matmul.allow_tf32 = False
    _amp_on(fluid)
    fw.reset_unique_names()
    main, startup, loss = build_moe_lm(
        cs.M_BATCH, cs.M_SEQ, cs.M_VOCAB, cs.M_D, cs.M_HEADS, cs.M_LAYERS,
        cs.M_EXPERTS, cs.M_TOPK, cs.M_CF, aux_weight=cs.M_AUX)
    # the moe phase's kernel path, and its plain path (the dense
    # einsums, chip_smoke's _PlainMoe), each from a fresh startup
    for path in ("kernel", "plain"):
        prev = executor_mod.switch_scope(Scope())
        marks = []
        try:
            exe = fluid.Executor(CUDAPlace(0), seed=cs.SEED)
            exe.run(startup)
            cs._reset_peak()
            base = torch.cuda.memory_allocated()
            torch.cuda.memory._record_memory_history(max_entries=4_000_000,
                                                     stacks="python")
            with (cs._PlainMoe() if path == "plain"
                  else contextlib.nullcontext()):
                for step in range(cs.T_STEPS):
                    marks.append(len(torch.cuda.memory._snapshot()
                                     ["device_traces"][dev.index]))
                    exe.run(main, feed=cs._train_feed(step),
                            fetch_list=[loss])
                    torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            trace = torch.cuda.memory._snapshot()["device_traces"][dev.index]
            del exe
        finally:
            torch.cuda.memory._record_memory_history(enabled=None)
            executor_mod.switch_scope(prev)
            torch.cuda.empty_cache()
        emit({"probe": "moe-memory", "path": path,
              "max_memory_allocated": peak,
              **_peak_sites(trace, base, marks)})


_SWEEP = {"SGD_UNROLL": (1, 2, 4, 8), "SGD_BLOCKS_PER_SM": (0, 8, 16, 32),
          "SGD_STREAMING": (0, 1)}


def sgd_sweep(cs, dev):
    from paddle_tpu_torch.kernels import cuda_build
    from paddle_tpu_torch.kernels.fused_update import (
        SOURCE, fused_bucket_sgd_reference)

    src = os.path.join(cuda_build.CSRC_DIR, SOURCE)
    variants = [dict(zip(_SWEEP, vals))
                for vals in itertools.product(*_SWEEP.values())]
    libs = {}
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        for v in variants:
            name = "u{SGD_UNROLL}_b{SGD_BLOCKS_PER_SM}_s{SGD_STREAMING}" \
                .format(**v)
            so = os.path.join(tmp, f"{name}.so")
            procs.append((name, so, subprocess.Popen(
                [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS,
                 *(f"-D{k}={x}" for k, x in v.items()), "-o", so, src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        ptxas = {}
        for name, so, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f"nvcc {name}: {log[-2000:]}")
            ptxas[name] = cs._ptxas_summary(log)
            fn = ctypes.CDLL(so).fused_sgd_update_
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong,
                                                   ctypes.c_void_p]
            fn.restype = ctypes.c_int
            libs[name] = fn
        n = cs.T_VOCAB * cs.T_D        # the dp path's largest bucket
        gen = torch.Generator(device=dev).manual_seed(cs.SEED)
        p = torch.randn(n, generator=gen, device=dev)
        g = torch.randn(n, generator=gen, device=dev)
        lr_host = 0.01
        lr = torch.tensor([lr_host], device=dev)
        flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        want = fused_bucket_sgd_reference(p, g, lr)
        for name, fn in libs.items():
            q = p.clone()
            if fn(q.data_ptr(), g.data_ptr(), lr.data_ptr(), n, stream):
                raise RuntimeError(f"{name}: launch failed")
            torch.cuda.synchronize()
            if not torch.equal(q, want):
                raise RuntimeError(f"{name}: not bit-identical to the "
                                   "plain version")
        del q, want
        calls = {"torch.add": lambda: torch.add(p, g, alpha=-lr_host),
                 "p.add_": lambda: p.add_(g, alpha=-lr_host)}
        for name, fn in libs.items():
            calls[name] = (lambda fn=fn: fn(p.data_ptr(), g.data_ptr(),
                                            lr.data_ptr(), n, stream))
        rounds = collections.defaultdict(list)
        for _ in range(3):
            for name, call in calls.items():
                rounds[name].append(cs.cold_ms(call, 50, flush))
    for name, ms in sorted(rounds.items(), key=lambda kv: min(kv[1])):
        emit({"probe": "sgd-sweep", "variant": name, "numel": n,
              "ms_rounds": ms, "ptxas": ptxas.get(name)})


def _amp_on(fluid):
    """bf16 amp on, as chip_smoke's amp phases run, where the package
    has it (a parent checkout may not)."""
    if hasattr(fluid, "amp"):
        fluid.amp.enable_bf16()


def _replay_parts(executor_mod):
    """Wrap the parts of a compiled run in record_functions ("part:...")
    -> a function that undoes it."""
    from torch.profiler import record_function

    exe_cls, entry_cls = executor_mod.Executor, executor_mod._Entry
    sites = [(executor_mod, "_feed_tensor", "feeds to tensors"),
             (exe_cls, "_states", "state layout"),
             (exe_cls, "_read_states", "state check"),
             (exe_cls, "_compiled_key", "cache key"),
             (exe_cls, "_lookup", "cache lookup"),
             (entry_cls, "replay", "input copies + graph launch"),
             (torch.cuda.CUDAGraph, "replay", "graph launch"),
             (exe_cls, "_copied_out", "fetch copy out of the pool"),
             (executor_mod, "_to_numpy", "fetch to host")]
    saved = []
    for owner, name, label in sites:
        fn = inspect.getattr_static(owner, name)
        inner = fn.__func__ if isinstance(fn, staticmethod) else fn

        def wrapped(*a, _inner=inner, _label=label, **k):
            with record_function("part:" + _label):
                return _inner(*a, **k)

        saved.append((owner, name, owner.__dict__.get(name)))
        setattr(owner, name, staticmethod(wrapped)
                if isinstance(fn, staticmethod) else wrapped)

    def undo():
        for owner, name, fn in saved:
            if fn is None:      # inherited: drop the wrapper
                delattr(owner, name)
            else:
                setattr(owner, name, fn)

    return undo


def host(cs, dev, fp32=False, mode="interpreted"):
    import time

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import CUDAPlace
    from paddle_tpu_torch.core import executor as executor_mod
    from paddle_tpu_torch.core.scope import Scope

    torch.backends.cuda.matmul.allow_tf32 = False
    if not fp32:
        _amp_on(fluid)
    main, startup, loss = cs._lm_program(
        fluid.Momentum(learning_rate=0.01, momentum=0.9))
    executor_mod.switch_scope(Scope())
    exe = fluid.Executor(CUDAPlace(0), seed=cs.SEED)
    exe.run(startup)
    compiled = None if mode == "compiled" else False
    secs = []
    for step in range(cs.T_STEPS):
        t0 = time.perf_counter()
        exe.run(main, feed=cs._train_feed(step), fetch_list=[loss],
                compiled=compiled)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    run_op = executor_mod.run_op

    def traced(ctx, op, env):
        with record_function("op:" + op.type):
            return run_op(ctx, op, env)

    if mode == "compiled":
        undo = _replay_parts(executor_mod)
    else:
        executor_mod.run_op = traced
    replays = exe.graph_stats()["replays"]
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            with record_function("exe.run"):
                exe.run(main, feed=cs._train_feed(cs.T_STEPS),
                        fetch_list=[loss], compiled=compiled)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        if mode == "compiled":
            undo()
        executor_mod.run_op = run_op
    by_op, parts, runtime, device, run_ms = {}, {}, {}, 0.0, 0.0
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            device += ev.self_device_time_total / 1e3
        elif ev.key.startswith("op:"):
            by_op[ev.key[3:]] = [ev.count, ev.cpu_time_total / 1e3]
        elif ev.key.startswith("part:"):
            parts[ev.key[5:]] = [ev.count, ev.cpu_time_total / 1e3]
        elif ev.key == "exe.run":
            run_ms = ev.cpu_time_total / 1e3
        elif ev.key.startswith("cuda"):
            runtime[ev.key] = [ev.count, ev.self_cpu_time_total / 1e3]
    top = sorted(by_op.items(), key=lambda kv: -kv[1][1])
    out = {"probe": "host", "dtype": "float32" if fp32 else "bf16 amp",
           "mode": mode, "step_s": secs, "profiled_wall_ms": wall * 1e3,
           "device_ms": device, "exe_run_host_ms": run_ms,
           "cuda_runtime_count_ms": runtime}
    if mode == "compiled":
        out.update(replayed=exe.graph_stats()["replays"] == replays + 1,
                   graph_stats=exe.graph_stats(),
                   cache_stats=exe.cache_stats(),
                   host_ms_by_part=parts)
    else:
        out.update(ops=sum(c for c, _ in by_op.values()),
                   op_host_ms=sum(ms for _, ms in by_op.values()),
                   by_op_type_count_ms=dict(top))
    emit(out)
    exe.close()


def convnets(cs, dev):
    """chip_smoke's image phases, as its main() sets the card up."""
    from paddle_tpu_torch import CUDAPlace

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    _, peaks = cs.card_peaks(name)
    card = {"name": name}
    cs.resnet50_phase(card, CUDAPlace(0), peaks)
    cs.resnet_card_vs_cpu_phase(card, CUDAPlace(0))
    cs.vgg_segmented_phase(card, CUDAPlace(0))


def _cudnn_fp32(conv_mod):
    """conv_mod.conv_pinned swapped for one that keeps cuDNN on for
    float32 (deterministic, no benchmark search, TF32 off) -> undo()."""
    import contextlib

    inner = conv_mod.conv_pinned

    @contextlib.contextmanager
    def cudnn_always(dtype):
        with inner(torch.bfloat16):
            yield

    conv_mod.conv_pinned = cudnn_always

    def undo():
        conv_mod.conv_pinned = inner

    return undo


def conv_fp32(cs, dev):
    """float32 convolution: cuDNN against the lowering's route."""
    import torch.nn.functional as F

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import executor as executor_mod
    from paddle_tpu_torch.core.scope import (Scope, scope_from_numpy,
                                             scope_to_numpy)
    from paddle_tpu_torch.ops import conv as conv_mod

    card = fluid.CUDAPlace(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    routes = ("cudnn", "lowering")
    gen = torch.Generator().manual_seed(0)
    shapes = []
    for xs, ws, st, pd in (((8, 3, 64, 64), (64, 3, 7, 7), 2, 3),
                           ((8, 64, 16, 16), (64, 64, 3, 3), 1, 1),
                           ((8, 128, 8, 8), (128, 128, 3, 3), 1, 1),
                           ((8, 64, 16, 16), (128, 64, 1, 1), 2, 0),
                           ((8, 256, 4, 4), (256, 256, 3, 3), 1, 1)):
        x = torch.randn(xs, generator=gen, dtype=torch.float64)
        w = torch.randn(ws, generator=gen, dtype=torch.float64)
        y = F.conv2d(x, w, None, st, pd)
        dy = torch.randn(y.shape, generator=gen, dtype=torch.float64)
        want = (y, *torch.ops.aten.convolution_backward(
            dy, x, w, None, [st, st], [pd, pd], [1, 1], False, [0, 0], 1,
            [True, True, False])[:2])
        row = {"x": list(xs), "w": list(ws), "stride": st}
        for route in routes:
            pin = (conv_mod.conv_pinned(torch.bfloat16) if route == "cudnn"
                   else conv_mod.conv_pinned(torch.float32))
            with pin:
                xf, wf, dyf = (t.float().to(dev) for t in (x, w, dy))
                got = (F.conv2d(xf, wf, None, st, pd),
                       *torch.ops.aten.convolution_backward(
                           dyf, xf, wf, None, [st, st], [pd, pd], [1, 1],
                           False, [0, 0], 1, [True, True, False])[:2])
            row[route] = {k: float((g.double().cpu() - r).abs().max()
                                   / r.abs().max())
                          for k, g, r in zip(("fwd", "dx", "dw"), got, want)}
        shapes.append(row)
    emit({"probe": "conv-fp32", "part": "single convs, max |err| / max "
          "|float64|", "shapes": shapes})

    main, startup, loss = cs._image_program(
        f"resnet{cs.C_DEPTH}", cs.C_IMG, cs.C_CLASSES, "float32")
    persist = cs._persistables(main)
    feed = cs._image_feed(cs.C_BATCH, cs.C_IMG, cs.C_CLASSES, "float32")
    prev = executor_mod.switch_scope(Scope())
    try:
        fluid.Executor(fluid.CPUPlace(), seed=cs.SEED).run(startup)
        init = scope_to_numpy(fluid.global_scope(), persist)

        def steps(place, dtype):
            executor_mod.switch_scope(Scope())
            scope_from_numpy({n: v.astype(dtype) for n, v in init.items()},
                             place, fluid.global_scope())
            exe = fluid.Executor(place, seed=cs.SEED)
            f = {"img": feed["img"].to(getattr(torch, dtype)),
                 "label": feed["label"]}
            for _ in range(cs.C_STEPS):
                exe.run(main, feed=f, fetch_list=[loss], compiled=False)
            return {n: v.astype(np.float64) for n, v in scope_to_numpy(
                fluid.global_scope(), persist).items()}

        ref = steps(fluid.CPUPlace(), "float64")
        errs = {"cpu": steps(fluid.CPUPlace(), "float32")}
        undo = _cudnn_fp32(conv_mod)
        try:
            errs["cudnn"] = steps(card, "float32")
        finally:
            undo()
        errs["lowering"] = steps(card, "float32")
        out = {}
        for route, st in errs.items():
            rel = {n: float(np.abs(st[n] - ref[n]).max()
                            / max(1.0, np.abs(ref[n]).max())) for n in persist}
            worst = max(rel, key=rel.get)
            out[route] = {"max": rel[worst], "argmax": worst,
                          "argmax_largest": float(np.abs(ref[worst]).max())}
        emit({"probe": "conv-fp32", "part": f"resnet{cs.C_DEPTH} at "
              f"{cs.C_IMG}x{cs.C_IMG}, batch {cs.C_BATCH}, {cs.C_STEPS} "
              "Momentum steps: max |state - float64 CPU| / max(1, |state|)",
              **out})

        main, startup, loss = cs._image_program(
            "vgg16_bn_drop", cs.V_IMG, cs.V_CLASSES, "float32")
        feed = cs._image_feed(cs.V_BATCH, cs.V_IMG, cs.V_CLASSES, "float32")
        times = {}
        for route in ("cudnn", "lowering", "cudnn", "lowering"):
            undo = _cudnn_fp32(conv_mod) if route == "cudnn" else None
            try:
                executor_mod.switch_scope(Scope())
                exe = fluid.Executor(card, seed=cs.SEED)
                exe.run(startup)
                secs = []
                for _ in range(cs.G_STEPS):
                    t0 = time.perf_counter()
                    exe.run(main, feed=feed, fetch_list=[loss])
                    torch.cuda.synchronize()
                    secs.append(time.perf_counter() - t0)
                exe.close()
            finally:
                if undo is not None:
                    undo()
            times.setdefault(route, []).append(
                float(np.median(secs[2:])) * 1e3)
        emit({"probe": "conv-fp32", "part": "vgg16_bn_drop, the "
              "vgg_segmented phase's model and batch, default mode: median "
              "ms a replayed step (3..N), two runs each, in turns",
              "ms_per_step": times})
    finally:
        executor_mod.switch_scope(prev)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("probe", choices=("paged", "dp-memory", "moe-memory",
                                      "sgd-sweep", "host", "convnets",
                                      "conv-fp32"))
    ap.add_argument("--fp32", action="store_true",
                    help="host: the float32 train step (default: amp)")
    ap.add_argument("--mode", choices=("interpreted", "compiled"),
                    default="interpreted",
                    help="host: the Executor's mode (compiled: the "
                    "default mode, a replayed CUDA graph)")
    ap.add_argument("--package-root", default=ROOT,
                    help="import paddle_tpu_torch from this checkout")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_tree_probe: no CUDA device", file=sys.stderr)
        return 2
    cs = _smoke()
    sys.path.insert(0, os.path.abspath(args.package_root))
    import paddle_tpu_torch

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    emit({"probe": args.probe, "card": smi,
          "package": os.path.dirname(paddle_tpu_torch.__file__)})
    if args.probe == "host":
        host(cs, dev, fp32=args.fp32, mode=args.mode)
    else:
        {"paged": paged, "dp-memory": dp_memory, "moe-memory": moe_memory,
         "sgd-sweep": sgd_sweep, "convnets": convnets,
         "conv-fp32": conv_fp32}[args.probe](cs, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
