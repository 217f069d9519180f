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
    python3 tools/torch_tree_probe.py seq2seq [--package-root DIR]
    python3 tools/torch_tree_probe.py image-models [--package-root DIR]
    python3 tools/torch_tree_probe.py ctr [--package-root DIR]
    python3 tools/torch_tree_probe.py rnn [--package-root DIR]
    python3 tools/torch_tree_probe.py book08 [--package-root DIR]
    python3 tools/torch_tree_probe.py a73 [--package-root DIR]
    python3 tools/torch_tree_probe.py sparse-host [--package-root DIR]
    python3 tools/torch_tree_probe.py dp2-fault
    python3 tools/torch_tree_probe.py replays [--package-root DIR]
    python3 tools/torch_tree_probe.py gloo-dtypes [--package-root DIR]
    python3 tools/torch_tree_probe.py memory-plan [--package-root DIR]
    python3 tools/torch_tree_probe.py a4b-a6 [--package-root DIR]
    python3 tools/torch_tree_probe.py a3-a10 [--package-root DIR]
    python3 tools/torch_tree_probe.py maxpool-routes [--package-root DIR]
    python3 tools/torch_tree_probe.py a10b [--package-root DIR]
    python3 tools/torch_tree_probe.py tp-zero [--package-root DIR]
    python3 tools/torch_tree_probe.py a9 [--package-root DIR]
    python3 tools/torch_tree_probe.py pserver [--package-root DIR]
    python3 tools/torch_tree_probe.py elastic [--package-root DIR]
    python3 tools/torch_tree_probe.py fleet [--package-root DIR]

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
seq2seq    chip_smoke.py's flash phase (every case, the seq2seq shapes
           among them) and its seq2seq phase alone;
image-models  chip_smoke.py's dropout_rows and image_models phases
           alone;
ctr        chip_smoke.py's optimizers and ctr phases alone (the update
           ops at one CTR table's shape; DeepFM and wide&deep with
           sparse embedding gradients);
rnn        chip_smoke.py's ops phase (the LoD op cases among the rest)
           and its rnn phases alone (run_rnn's LSTM classifier, ragged
           LoDs, card against CPU, run_seq2seq's LSTM translator);
book08     chip_smoke.py's ops phase and its book08 phase alone
           (book/08's DynamicRNN translator and its attention variant,
           the While + beam-search decoder, card against CPU);
a73        chip_smoke.py's ops and ops_working phases and its ssd,
           ocr_ctc and readers phases alone (CTC, hsigmoid, nce, the
           detection ops and the readers; MobileNet-SSD300 and CRNN-CTC
           trained and decoded, card against CPU);
sparse-host  the smallest program whose SelectedRows gradient crosses a
           host op between device segments: an is_sparse embedding, an
           fc and a mean square loss under SGD, with a `print` of the
           loss inserted between the embedding's lookup_table_grad and
           its sgd; three steps in the Executor's default mode on the
           card (a miss, a capture, a replay) against the interpreter
           and the CPU, or the error the default mode raised;
dp2-fault  chip_smoke.py's dp2_one_card part with a fault planted in
           both ranks at run time: batch_norm's gradient all-reduces
           Scale@GRAD and Bias@GRAD over the group, so the bucket
           all-reduce sums them a second time (dp times too large);
           the part's readings and what its verdict failed, which must
           not be empty;
replays    chip_smoke.py's replayed recurrent and seq2seq steps alone:
           its flash phase (the seq2seq path's kernels), seq2seq, rnn,
           rnn_seq2seq and book08 phases, each step time from its line
           (no ops phase: a parent checkout registers fewer op types);
gloo-dtypes  two processes on the one card over a gloo group: whether
           all_reduce and all_gather take CUDA tensors of each dtype the
           data-parallel step reduces (float32, bfloat16, float16,
           float64, int64), and the summed values; then four processes
           on the card, with a gloo sub-group an axis of a dp2 x tp2
           mesh made as parallel/mesh.py makes them: for each collective
           kind the tensor-parallel and ZeRO-1 paths and the c_* ops
           issue (all_reduce sum and max, all_gather, all_gather_into_
           tensor, reduce_scatter, reduce_scatter_tensor, broadcast,
           send/recv, batch_isend_irecv, and the pipeline's and the
           Ulysses / MoE paths' isend + recv and all_to_all_single) and
           each dtype, whether gloo takes CUDA tensors and gives the
           right values;
memory-plan  chip_smoke.py's replayed train (amp), seq2seq (amp) and
           resnet50 steps (`memory_plan_steps`: peak memory over the
           eager run, the capture and two replays, and the replay's ms)
           with the compiled mode's frees taken out (`_Plan.dead_after`
           returning none), then as the package has them, then without
           and with again;
a4b-a6     chip_smoke.py's remat, memory_plan, generate and image_serve
           phases alone (the kernels built first);
a3-a10     chip_smoke.py's persist, conv_rest and ops phases alone (the
           kernels built first);
maxpool-routes  the max pools' two backward routes (`ops/conv.py`
           `_MaxPool`: a copy where windows are disjoint, else a sorted
           segment sum) on the same disjoint windows at the conv_rest
           shapes (C3D's 2x2x2 / 2 pool, SegNet's 2x2 / 2): each one's ms
           and their results bit for bit;
a10b       chip_smoke.py's aot_native phase alone (the kernels built
           first): the LM, MoE LM and ResNet-50 torch.export artifacts,
           the C inference ABI, native_pipeline and a go block;
tp-zero    chip_smoke.py's tp_zero phase alone (the kernels built
           first): tensor parallelism and ZeRO-1 on four gloo ranks on the
           card against the serial Executor;
a9         chip_smoke.py's a9 phase alone (the kernels built first):
           pipeline (GPipe, 1F1B with tp, GPipe with sp) and expert
           parallelism on four gloo ranks on the card against the serial
           Executor, and the raw ring / Ulysses / MoE forms;
pserver    chip_smoke.py's pserver phase alone (the flash kernels built
           first; the phase builds the native library itself): DeepFM,
           vgg16_cluster and the seq2seq translator with their trainers
           on the card and their pservers on the host;
elastic    chip_smoke.py's elastic phase alone (the flash kernels built
           first): the seq2seq translator through Trainer.train(cluster=)
           on the card, three elastic host pservers, one SIGKILLed and
           one joining, against the serial Executor, under a
           telemetry collector;
fleet      chip_smoke.py's fleet phase alone (the paged-attention
           kernel built first): the serve row's LM saved with its
           warm-start artifact, `cli serve` replicas behind a
           ReplicaRouter and an Autoscaler through a ramp and a
           SIGKILL, a cold replica, the telemetry tools on the fleet;
a10c       chip_smoke.py's tools phase with what it reads: the flash
           phase, the train phase (amp) with the tools profiler part on
           its replayed graph, the seq2seq phase, then the tools CLI
           part (the translator's jobs, checkgrad);
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

    card, _, peaks = _card(cs)
    cs.resnet50_phase(card, CUDAPlace(0), peaks)
    cs.resnet_card_vs_cpu_phase(card, CUDAPlace(0))
    cs.vgg_segmented_phase(card, CUDAPlace(0))


def _card(cs):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    bw, peaks = cs.card_peaks(name)
    return {"name": name}, bw, peaks


def seq2seq(cs, dev):
    """chip_smoke's flash kernels (all cases, the seq2seq shapes among
    them) and its seq2seq phase."""
    from paddle_tpu_torch import CUDAPlace
    from paddle_tpu_torch.kernels import flash_attention as fa

    card, bw, peaks = _card(cs)
    fa.build()
    cs.seq2seq_phase(card, CUDAPlace(0), peaks,
                     cs.flash_phase(dev, bw, peaks))


def image_models(cs, dev):
    """chip_smoke's dropout_rows and image_models phases."""
    from paddle_tpu_torch import CUDAPlace

    card, _, peaks = _card(cs)
    cs.dropout_rows_phase(card, dev)
    cs.image_models_phase(card, CUDAPlace(0), peaks)


def ctr(cs, dev):
    """chip_smoke's optimizers and ctr phases."""
    from paddle_tpu_torch import CUDAPlace

    card, _, _ = _card(cs)
    cs.optimizers_phase(card, dev)
    cs.ctr_phase(card, CUDAPlace(0))


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


def rnn(cs, dev):
    """chip_smoke's ops phase and its rnn phases."""
    from paddle_tpu_torch import CUDAPlace

    card, _, peaks = _card(cs)
    cs.ops_phase(card, dev)
    cs.rnn_phase(card, CUDAPlace(0), peaks)


def book08(cs, dev):
    """chip_smoke's ops phase and its book08 phase (book/08's DynamicRNN
    translators and the While + beam-search decoder)."""
    from paddle_tpu_torch import CUDAPlace

    card, _, peaks = _card(cs)
    cs.ops_phase(card, dev)
    cs.book08_phase(card, CUDAPlace(0), peaks)


def a73(cs, dev):
    """chip_smoke's ops and ops_working phases and its ssd, ocr_ctc and
    readers phases (CTC, sampling, detection and the readers)."""
    from paddle_tpu_torch import CUDAPlace

    card, _, peaks = _card(cs)
    cs.ops_phase(card, dev)
    cs.ops_working_phase(card, dev)
    cs.ssd_phase(card, CUDAPlace(0), peaks)
    cs.ocr_ctc_phase(card, CUDAPlace(0))
    cs.readers_phase(card, CUDAPlace(0))


def sparse_host_program(fluid):
    """(main, startup, loss): an is_sparse embedding's gradient read by
    its sgd across a host `print` of the loss."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        ids = fluid.layers.data(name="ids", shape=[1], dtype="int64")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        emb = fluid.layers.embedding(input=ids, size=[64, 8],
                                     is_sparse=True)
        pred = fluid.layers.fc(input=emb, size=1)
        loss = fluid.layers.mean(
            fluid.layers.square_error_cost(input=pred, label=y))
        fluid.SGD(learning_rate=0.1).minimize(loss)
    block = main.global_block()
    at = next(i for i, op in enumerate(block.ops)
              if op.type == "lookup_table_grad") + 1
    out = block.create_var(name=loss.name + ".printed", shape=loss.shape,
                           dtype=loss.dtype)
    block.insert_op(at, "print", {"In": [loss.name]}, {"Out": [out.name]},
                    {"first_n": 1})
    return main, startup, loss


def sparse_host_feeds(steps=3, batch=16):
    r = np.random.RandomState(7)
    return [{"ids": r.randint(0, 64, (batch, 1)).astype(np.int64),
             "y": r.standard_normal((batch, 1)).astype(np.float32)}
            for _ in range(steps)]


def sparse_host(cs, dev):
    """The default mode on the card (segments: forward and backward, the
    host print, the update) against the interpreter and the CPU."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import executor as executor_mod
    from paddle_tpu_torch.core.scope import Scope

    main, startup, loss = sparse_host_program(fluid)
    feeds = sparse_host_feeds()
    params = [p.name for p in main.global_block().all_parameters()]
    out = {}
    for mode, place, compiled in (("default", fluid.CUDAPlace(0), None),
                                  ("interpreted", fluid.CUDAPlace(0), False),
                                  ("cpu", fluid.CPUPlace(), False)):
        prev = executor_mod.switch_scope(Scope())
        try:
            exe = fluid.Executor(place, seed=0)
            exe.run(startup)
            if mode != "default":
                for n in params:
                    fluid.global_scope().set_var(
                        n, torch.from_numpy(out["init"][n]).to(exe.device))
            else:
                out["init"] = {n: fluid.global_scope().find_var(n)
                               .cpu().numpy() for n in params}
            try:
                losses = [float(exe.run(main, feed=f, fetch_list=[loss],
                                        compiled=compiled)[0][0])
                          for f in feeds]
            except Exception as e:   # the record is the error itself
                out[mode] = {"raised": f"{type(e).__name__}: {e}"[:600]}
                continue
            out[mode] = {"losses": losses, "params": {
                n: fluid.global_scope().find_var(n).cpu().numpy()
                for n in params}}
            if mode == "default":
                out[mode]["graphs"] = exe.graph_stats()
        finally:
            executor_mod.switch_scope(prev)
    rec = {"probe": "sparse-host", "segments": [
        op.type for op in main.global_block().ops]}
    for mode in ("default", "interpreted", "cpu"):
        r = out[mode]
        if "raised" in r:
            rec[mode] = r
            continue
        rec[mode] = {"losses": r["losses"], **({"graphs": r["graphs"]}
                                               if "graphs" in r else {})}
        if mode != "interpreted" and "raised" not in out["interpreted"]:
            ref = out["interpreted"]
            rec[mode]["bit_equal_to_interpreter"] = bool(
                r["losses"] == ref["losses"] and all(
                    np.array_equal(r["params"][n], ref["params"][n])
                    for n in params))
            rec[mode]["max_param_diff"] = max(
                float(np.abs(r["params"][n] - ref["params"][n]).max())
                for n in params)
    emit(rec)


def _plant_double_reduce():
    """batch_norm's gradient with Scale@GRAD and Bias@GRAD all-reduced over
    the sync-BN form's group (the fault dp2-fault plants)."""
    from paddle_tpu_torch.core import registry

    info = registry.get_op_info("batch_norm")
    inner = info.grad_lower

    def faulty(ctx, ins, attrs):
        out = inner(ctx, ins, attrs)
        if ctx.sync_group is not None and not attrs.get("is_test"):
            for k in ("Scale@GRAD", "Bias@GRAD"):
                out[k] = [ctx.sync_group.all_reduce(out[k][0].clone())]
        return out

    info.grad_lower = faulty


def dp2_fault(cs, dev):
    card, _, _ = _card(cs)
    rec, failed = cs._dp2_verdict(card, cs._dp2_ranks(
        [sys.executable, os.path.abspath(__file__), "--dp2-fault-worker"]))
    emit({"probe": "dp2-fault", "planted": "Scale@GRAD and Bias@GRAD "
          "all-reduced in batch_norm's gradient", "failed": failed,
          "programs": {n: p["against_serial"]
                       for n, p in rec["programs"].items()}})


def replays(cs, dev):
    """chip_smoke's flash, seq2seq, rnn and book08 phases."""
    from paddle_tpu_torch import CUDAPlace

    from paddle_tpu_torch.kernels import flash_attention as fa

    card, bw, peaks = _card(cs)
    fa.build()
    flash_cases = cs.flash_phase(dev, bw, peaks)
    cs.seq2seq_phase(card, CUDAPlace(0), peaks, flash_cases)
    cs.rnn_phase(card, CUDAPlace(0), peaks)
    cs.book08_phase(card, CUDAPlace(0), peaks)


def memory_plan(cs, dev):
    """The replayed steps' peaks without and with the compiled mode's
    frees, in turns (without, with, with, without)."""
    from paddle_tpu_torch import CUDAPlace
    from paddle_tpu_torch.core import executor as executor_mod

    _card(cs)
    frees = executor_mod._Plan.dead_after
    for label in ("without_frees", "with_frees", "with_frees",
                  "without_frees"):
        executor_mod._Plan.dead_after = (
            frees if label == "with_frees"
            else lambda self, keep: {})
        try:
            emit({"probe": "memory-plan", "run": label,
                  "steps": cs.memory_plan_steps(CUDAPlace(0))})
        finally:
            executor_mod._Plan.dead_after = frees


def a4b_a6(cs, dev):
    """chip_smoke's remat, memory_plan, generate and image_serve phases,
    the kernels built first."""
    from paddle_tpu_torch import CUDAPlace
    from paddle_tpu_torch.kernels import cuda_build

    card, _, _ = _card(cs)
    cuda_build.build_all()
    emit({"remat_flash": cs.remat_phase(card, CUDAPlace(0))})
    cs.memory_plan_phase(card, CUDAPlace(0))
    cs.generate_phase(card, CUDAPlace(0))
    cs.image_serve_phase(card, CUDAPlace(0))


def a3_a10(cs, dev):
    """chip_smoke's persist, conv_rest and ops phases, the kernels built
    first."""
    from paddle_tpu_torch import CUDAPlace
    from paddle_tpu_torch.kernels import cuda_build

    card, _, _ = _card(cs)
    cuda_build.build_all()
    emit({"persist_flash": cs.persist_phase(card, CUDAPlace(0))})
    cs.conv_rest_phase(card, dev, CUDAPlace(0))
    cs.ops_phase(card, dev)


def a10b(cs, dev):
    """chip_smoke's aot_native phase alone, the kernels built first."""
    from paddle_tpu_torch import CUDAPlace
    from paddle_tpu_torch.kernels import cuda_build

    card, _, _ = _card(cs)
    cuda_build.build_all()
    emit({"aot_launches": cs.aot_native_phase(card, dev, CUDAPlace(0))})


def a10c(cs, dev):
    """chip_smoke's tools phase and the phases it reads (flash, train
    under amp, seq2seq), the kernels built first."""
    from paddle_tpu_torch import CUDAPlace
    from paddle_tpu_torch.kernels import cuda_build

    card, bw, peaks = _card(cs)
    cuda_build.build_all()
    flash_cases = cs.flash_phase(dev, bw, peaks)
    _, _, tools = cs.train_phase(card, CUDAPlace(0), peaks, flash_cases,
                                 amp=True, tools=True)
    cs.emit(tools, aside=True)
    _, _, s2s_ms = cs.seq2seq_phase(card, CUDAPlace(0), peaks, flash_cases)
    cs.tools_cli_phase(card, CUDAPlace(0), s2s_ms)


def a12(cs, dev):
    """chip_smoke's analysis phase and the phases it reads (kernels for
    the paged case, flash, train under amp — PADDLE_TPU_VERIFY=error —
    seq2seq, serve, resnet50, memory_plan), the kernels built first."""
    from paddle_tpu_torch import CUDAPlace
    from paddle_tpu_torch.kernels import cuda_build

    card, bw, peaks = _card(cs)
    cuda_build.build_all()
    cases = cs.kernels_phase(dev, bw, peaks[torch.float32])
    flash_cases = cs.flash_phase(dev, bw, peaks)
    cs.train_phase(card, CUDAPlace(0), peaks, flash_cases, amp=True)
    cs.seq2seq_phase(card, CUDAPlace(0), peaks, flash_cases)
    cs.serve_phases(card, CUDAPlace(0))
    cs.resnet50_phase(card, CUDAPlace(0), peaks)
    plan_steps = cs.memory_plan_phase(card, CUDAPlace(0))
    cs.analysis_phase(card, plan_steps, cases["fp32_w1"], bw)
    cs.emit({"phase": "timing", "phases": cs.PHASE_SECONDS})


def tp_zero(cs, dev):
    """chip_smoke's tp_zero phase alone (the kernels built first): the
    run_ridge LM at dp2 x tp2 with ZeRO-1 on four gloo ranks against the
    serial Executor, amp at 12 layers and float32 at 2."""
    from paddle_tpu_torch.kernels import cuda_build

    card, _, _ = _card(cs)
    cuda_build.build_all()
    cs.tp_zero_phase(card)
    cs.emit({"phase": "timing", "phases": cs.PHASE_SECONDS})


def a9(cs, dev):
    """chip_smoke's a9 phase alone (the kernels built first)."""
    from paddle_tpu_torch.kernels import cuda_build

    card, _, _ = _card(cs)
    cuda_build.build_all()
    cs.a9_phase(card)
    cs.emit({"phase": "timing", "phases": cs.PHASE_SECONDS})


def pserver(cs, dev):
    """chip_smoke's pserver phase alone (the flash kernels built
    first)."""
    from paddle_tpu_torch.kernels import flash_attention

    card, _, _ = _card(cs)
    flash_attention.build()
    cs.pserver_phase(card)
    cs.emit({"phase": "timing", "phases": cs.PHASE_SECONDS})


def elastic(cs, dev):
    """chip_smoke's elastic phase alone (the flash kernels built
    first)."""
    from paddle_tpu_torch.kernels import flash_attention

    card, _, _ = _card(cs)
    flash_attention.build()
    cs.elastic_phase(card)
    cs.emit({"phase": "timing", "phases": cs.PHASE_SECONDS})


def fleet(cs, dev):
    """chip_smoke's fleet phase alone (the paged-attention kernel built
    first, as the serve phase leaves it)."""
    from paddle_tpu_torch import CUDAPlace
    from paddle_tpu_torch.kernels import paged_attention

    card, _, _ = _card(cs)
    paged_attention.build()
    cs.fleet_phase(card, CUDAPlace(0))
    cs.emit({"phase": "timing", "phases": cs.PHASE_SECONDS})


def maxpool_routes(cs, dev):
    """`_MaxPool.backward` by its copy and by its sorted segment sum on
    the same disjoint windows."""
    from paddle_tpu_torch.ops.conv import _MaxPool

    class Ctx:
        def save_for_backward(self, *t):
            self.saved_tensors = t

        def mark_non_differentiable(self, *t):
            pass

    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    for name, shape, k in (("c3d_pool", (8, 64, 16, 112, 112), (2, 2, 2)),
                           ("segnet_pool", (4, 64, 360, 480), (2, 2))):
        x = torch.randn(shape, generator=gen, device=dev)
        ctx = Ctx()
        vals, _ = _MaxPool.forward(ctx, x, k, k, (0,) * len(k))
        g = torch.randn(vals.shape, generator=gen, device=dev)
        res, ms = {}, {}
        for route, disjoint in (("copy", True), ("segment_sum", False)):
            ctx.disjoint = disjoint
            res[route] = _MaxPool.backward(ctx, g, None)[0]
            ms[route] = cs.cold_ms(lambda: _MaxPool.backward(ctx, g, None),
                                   5, flush)
        emit({"probe": "maxpool-routes", "case": name, "shape": shape,
              "ksize": k, "backward_ms": ms,
              "bit_equal": bool(torch.equal(res["copy"],
                                            res["segment_sum"]))})


def _gloo_rank(rank, port, out_path):
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=2, rank=rank)
    res = {}
    try:
        for name in ("float32", "bfloat16", "float16", "float64", "int64"):
            dt = getattr(torch, name)
            t = torch.full((5,), rank + 1, dtype=dt, device="cuda")
            try:
                dist.all_reduce(t, async_op=True).wait()
                parts = [torch.empty_like(t) for _ in range(2)]
                dist.all_gather(parts, t)
                res[name] = {"all_reduce": t.float().cpu().tolist(),
                             "all_gather_ok": all(
                                 bool((p == t).all()) for p in parts),
                             "device": str(t.device)}
            except Exception as e:
                res[name] = {"raised": f"{type(e).__name__}: {e}"[:300]}
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(res, f)


_GLOO_KINDS = ("all_reduce_sum", "all_reduce_max", "all_gather",
               "all_gather_into_tensor", "reduce_scatter",
               "reduce_scatter_tensor", "broadcast", "send_recv",
               "batch_isend_irecv", "isend_recv", "all_to_all_single")


def _gloo_kind(kind, t, group, ranks, me):
    """Run collective `kind` on CUDA tensor `t` over `group` (global
    `ranks`, this process global rank `me`) -> whether the values are
    right."""
    import torch.distributed as dist

    n, i = len(ranks), ranks.index(me)
    want_sum = sum(r + 1 for r in ranks)
    if kind in ("all_reduce_sum", "all_reduce_max"):
        op = dist.ReduceOp.SUM if kind.endswith("sum") else dist.ReduceOp.MAX
        x = t.clone()
        dist.all_reduce(x, op=op, group=group)
        want = want_sum if kind.endswith("sum") else max(ranks) + 1
        return x.device.type == "cuda" and bool((x == want).all())
    if kind == "all_gather":
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t, group=group)
        return all(bool((p == r + 1).all()) for p, r in zip(parts, ranks))
    if kind == "all_gather_into_tensor":
        out = torch.empty((n * t.numel(),), dtype=t.dtype, device=t.device)
        dist.all_gather_into_tensor(out, t, group=group)
        return all(bool((p == r + 1).all())
                   for p, r in zip(out.chunk(n), ranks))
    if kind == "reduce_scatter":
        out = torch.empty_like(t)
        dist.reduce_scatter(out, [t.clone() for _ in range(n)], group=group)
        return bool((out == want_sum).all())
    if kind == "reduce_scatter_tensor":
        out = torch.empty((t.numel() // n,), dtype=t.dtype, device=t.device)
        dist.reduce_scatter_tensor(out, t.clone(), group=group)
        return bool((out == want_sum).all())
    if kind == "broadcast":
        x = t.clone()
        dist.broadcast(x, src=ranks[0], group=group)
        return bool((x == ranks[0] + 1).all())
    if kind == "all_to_all_single":
        # block j of every rank to rank j: rank i gets block i of each
        src = torch.cat([t.clone() for _ in range(n)])
        got = torch.empty_like(src)
        dist.all_to_all_single(got, src, group=group)
        return all(bool((c == r + 1).all())
                   for c, r in zip(got.chunk(n), ranks))
    nxt, prv = ranks[(i + 1) % n], ranks[(i - 1) % n]
    got = torch.empty_like(t)
    if kind == "isend_recv":
        # the pipeline's hop: a send not waited on, then a blocking recv
        work = dist.isend(t, nxt, group=group)
        dist.recv(got, prv, group=group)
        work.wait()
        return bool((got == prv + 1).all())
    if kind == "send_recv":
        if i % 2 == 0:
            dist.send(t, nxt, group=group)
            dist.recv(got, prv, group=group)
        else:
            dist.recv(got, prv, group=group)
            dist.send(t, nxt, group=group)
    else:
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, t, nxt, group),
            dist.P2POp(dist.irecv, got, prv, group)])
        for r in reqs:
            r.wait()
    return bool((got == prv + 1).all())


def _gloo_mesh_rank(rank, port, out_path, kind):
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=4, rank=rank)
    # the dp x tp = 2 x 2 mesh's axis groups, made in parallel/mesh.py's
    # order on every rank: tp {0,1} {2,3}, then dp {0,2} {1,3}
    groups = {}
    for axis, members in (("tp", ((0, 1), (2, 3))),
                          ("dp", ((0, 2), (1, 3)))):
        for ranks in members:
            g = dist.new_group(list(ranks), backend="gloo")
            if rank in ranks:
                groups[axis] = (g, list(ranks))
    res = {}
    try:
        for name in ("float32", "bfloat16", "int64"):
            for axis, (g, ranks) in groups.items():
                t = torch.full((4,), rank + 1, dtype=getattr(torch, name),
                               device="cuda")
                try:
                    ok = _gloo_kind(kind, t, g, ranks, rank)
                    res[f"{name}.{axis}"] = "ok" if ok else "wrong values"
                except Exception as e:
                    res[f"{name}.{axis}"] = \
                        f"raised {type(e).__name__}: {e}"[:200]
                dist.barrier()
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(res, f)


def gloo_dtypes(cs, dev):
    import socket

    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "gloo.json")
        mp.spawn(_gloo_rank, args=(port, path), nprocs=2, join=True)
        with open(path) as f:
            emit({"probe": "gloo-dtypes", "ranks": 2, "device": "cuda:0",
                  "dtypes": json.load(f)})
    kinds = {}
    for kind in _GLOO_KINDS:
        # one spawn a kind: gloo aborts the process on a CUDA pointer it
        # cannot take (writev: Bad address), so a kind's crash is its own
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "gloo_mesh.json")
            try:
                mp.spawn(_gloo_mesh_rank, args=(port, path, kind),
                         nprocs=4, join=True)
                with open(path) as f:
                    kinds[kind] = json.load(f)
            except Exception as e:
                kinds[kind] = f"crashed: {type(e).__name__}: {e}"[:200]
    emit({"probe": "gloo-kinds", "ranks": 4, "mesh": {"dp": 2, "tp": 2},
          "device": "cuda:0", "kinds": kinds})


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("probe", choices=("paged", "dp-memory", "moe-memory",
                                      "sgd-sweep", "host", "convnets",
                                      "conv-fp32", "seq2seq",
                                      "image-models", "ctr", "rnn", "book08",
                                      "a73",
                                      "sparse-host", "dp2-fault",
                                      "replays",
                                      "gloo-dtypes", "memory-plan",
                                      "a4b-a6", "a3-a10",
                                      "maxpool-routes", "a10b", "a10c",
                                      "a12", "tp-zero", "a9", "pserver",
                                      "elastic", "fleet"))
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
         "conv-fp32": conv_fp32, "seq2seq": seq2seq,
         "image-models": image_models, "ctr": ctr,
         "rnn": rnn, "book08": book08, "a73": a73,
         "sparse-host": sparse_host, "dp2-fault": dp2_fault,
         "replays": replays,
         "gloo-dtypes": gloo_dtypes, "memory-plan": memory_plan,
         "a4b-a6": a4b_a6, "a3-a10": a3_a10,
         "maxpool-routes": maxpool_routes, "a10b": a10b,
         "a10c": a10c, "a12": a12, "tp-zero": tp_zero,
         "a9": a9, "pserver": pserver,
         "elastic": elastic, "fleet": fleet}[args.probe](cs, dev)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp2-fault-worker"]:
        # a rank of dp2-fault: chip_smoke.py's dp2 worker, fault planted
        sys.path.insert(0, ROOT)
        _plant_double_reduce()
        _smoke()._dp2_worker(int(sys.argv[2]), int(sys.argv[3]),
                             sys.argv[4])
        sys.exit(0)
    sys.exit(main())
