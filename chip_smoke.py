#!/usr/bin/env python3
"""Smoke run of the PyTorch port (paddle_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Drives the port's training and serving paths the way a user would and
holds every hand-written kernel on them to its plain PyTorch version.
Phases, one JSON line each:

  env      torch and CUDA versions, the card's name and power limit;
  build    compiles every csrc/ source with nvcc (in parallel), with
           each kernel's ptxas registers, stack and spills;
  kernels  paged-attention decode at the serving geometry (8 slots,
           context 512 = 32 blocks of 16, d_model 512, 8 heads) for
           fp32/bf16/int8 pools and windows W in {1, 4}: the kernel
           against its plain version and against itself (bit-equal over
           two calls), with the kernel's time between CUDA events and
           its device time in torch.profiler, the host time of a call
           (direct, and through the decoder's wrapper), its split-KV
           grid (split length, CTAs), and the plain version's and a
           library composition's (gather + scaled_dot_product_attention)
           times beside the bound;
  flash    the flash-attention forward, dQ and dK/dV kernels at the
           training shape [8, 512, 16, 128] (causal fp32, causal bf16,
           non-causal fp32), each against its plain version, with the
           kernel's, the plain version's and scaled_dot_product_attention's
           (forward against the forward kernel; backward against dQ +
           dK/dV; in every case) times
           beside the bound (float32 over TF32/3, the rate of float32-
           accurate 3xTF32 products, with the scalar-fp32 bound beside
           it; bf16 over the bf16 tensor peak);
  grads    the explicit gradient lowerings against the generic gradient
           (autograd over the forward lowering) at the train shapes: the
           `flash_attention` grad op (bf16 and fp32, from the forward's
           Out and lse: no forward launch, bit-equal to the generic
           route), and the `mul` grad op (a projection, fp32 and amp, and
           the LM head under amp) against autograd's matmul backward,
           with each route's time;
  train    the transformer LM of benchmark/run_ridge.py at its full
           width (vocab 30000, d_model 2048, 16 heads, 12 layers, seq
           512, batch 8; Momentum) under bf16 amp, as run_ridge runs it
           (`fluid.amp.enable_bf16()` before the Program is built; f32
           master weights), built as a Fluid Program and
           trained from one seeded startup in the Executor's default
           mode, as the JAX package's cells run: the block compiled,
           run eagerly at its miss, captured into a CUDA graph at its
           first hit and replayed after (6 timed steps and one profiled
           replay: one miss, then hits, no recompile; the kernels
           counted at the eager run and the capture, and by the
           profiler in the replay); then 6 from the same state in the
           interpreter (compiled=False), whose losses and parameters
           must equal the replay's bit for bit, and 6 on the plain path
           (interpreted; the op's lowering and its gradient swapped for
           the plain composition inside this script): per-step losses
           and every weight matrix's change compared; every parameter
           and parameter gradient float32; step time in both modes,
           capture seconds, the replay's device time and idle share,
           peak allocated and reserved memory, the interpreter's host
           synchronisations;
  train_fp32  the same LM and steps in float32 (amp off);
  serve    the full-width LM of benchmark/run_generation.py (vocab
           32000, d_model 512, 8 heads, 6 layers, d_inner 2048) with
           seeded random weights, written as a model dir and served
           through server_from_model_dir (8 slots, 256 KV blocks):
           16 staggered requests per kv_dtype on the plain path and on
           the kernel path, batched-vs-solo bit identity, pool drain;
  spec     the same model as its own draft (spec_k 3, the W=4 kernel):
           accept rate 1.0 and the plain greedy tokens;
  dp       the train phase's LM with plain SGD under amp, trained
           data-parallel
           through ShardingTranspiler(mesh={"dp": 1}, overlap=
           "bucketed") and ParallelExecutor over a single-rank NCCL
           group: bucketed gradient all-reduces and the fused bucket
           update kernel in place over each bucket's flat parameter
           buffer, then the per-op sgd chain from the same state;
  fused_update  the fused bucket SGD kernel against its plain version
           (bit for bit), in place and into a new buffer, on the dp
           path's largest bucket and odd sizes, beside torch.add and
           p.add_;
  moe_kernel  the MoE gate + dispatch kernels against their plain
           versions at the MoE LM's shape (T 4096, D 1024, E 8): top-2,
           top-1 and an overflowing capacity; the routing form (routing,
           expert_in, slot weights, aux), the dense contract (combine)
           and the backward kernel, each bit-equal over two calls, the
           autograd Functions' gradients, and each one's time (events and
           device) beside its bound and its plain version;
  moe      the MoE transformer LM of benchmark/run_moe.py at its
           defaults (vocab 30000, d_model 1024, 8 heads, 6 layers, 8
           experts, top-2, capacity factor 1.25, seq 512, batch 8;
           Momentum; bf16 amp as run_moe runs it, which leaves the MoE
           FFN float32) trained as the train phase is: the kernel path
           in the default mode (routing form, gather combine; no
           [T, E, C] tensor and no GEMM with an E * C operand; the
           replay held bit for bit to the interpreter), then the plain
           path (the dense einsums, interpreted) from the same state,
           the for_test clone's forward on both, and a profiled step of
           each with its GEMMs split by shape;
  resnet50  benchmark/run_image.py's ResNet-50 at its defaults (224x224,
           1000 classes, batch 128, bf16 throughout: no amp; Momentum),
           seeded images and labels as run_image makes them: steps in
           the Executor's default mode (one CUDA graph: one miss, then
           hits replaying it) and a profiled replay (device time by
           group: cuDNN forward, dgrad and wgrad, layout transposes,
           pooling, copies, batch norm and elementwise), then the same
           steps interpreted from the same state (losses, parameters,
           velocities and running statistics bit for bit the replay's),
           then again with conv_layout=NHWC; ms a step, images/s, the
           idle share, peak memory, capture seconds and the model FLOPs
           (the Program's conv2d and fc shapes, forward x 3) against the
           bf16 peak;
  resnet_card_vs_cpu  ResNet-18 at 64x64, batch 8, float32: two steps
           on the CPU and on the card (with cuDNN's TF32 switch on) from
           the same startup weights, losses and every state within 1e-4;
  vgg_segmented  the book's VGG-16 with batch norm and dropout at the
           CIFAR-10 width (32x32, 10 classes, batch 128, float32) in the
           default mode, which the dropout ops make segmented (each runs
           eagerly between captured device segments): the segment
           counts, finite losses, and the interpreter's losses and keep
           rates from the same state and seed.

The main paths are the train phase's kernel path (flash attention; the
train_fp32 phase's too), the kernel-path serve and spec phases (paged
attention), the dp phase's fused run (fused bucket update) and the moe
phase's kernel path (MoE gate + dispatch and its backward): each
kernel's launch counts are zeroed just before its path and read just
after.  A CUDA graph's replay runs the captured kernels without their
wrappers, so on the train and moe paths the counts cover the eager
first step and the capture, and the kernels line adds the profiler's
count in a replayed step.  The image phases run no kernel of the
port's own: convolution, pooling and batch norm are cuDNN or plain
PyTorch calls there, as they are XLA ops in the JAX package.
Any failed check raises, and the script exits non-zero.  The last line is
the device record {"ok": true, "device": {...}}.  With no CUDA device,
or without the package beside it, it exits non-zero and prints no
result.
"""
from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# published dense peaks (NVIDIA data sheets, without sparsity): HBM
# bytes/s, fp32 FLOP/s outside the tensor cores, bf16 and TF32 FLOP/s on
# the tensor cores
_CARD_PEAKS = (("H200", 4.8e12, 67e12, 989e12, 495e12),
               ("H100 NVL", 3.9e12, 60e12, 835e12, 418e12),
               ("H100 PCIe", 2.0e12, 51e12, 756e12, 378e12),
               ("H100", 3.35e12, 67e12, 989e12, 495e12))

V, D_MODEL, N_HEADS, N_LAYERS, D_INNER = 32000, 512, 8, 6, 2048
BLOCK, MAX_BLOCKS, SLOTS, KV_BLOCKS = 16, 32, 8, 256
N_REQUESTS, SEED = 16, 0
KV_DTYPES = ("fp32", "bf16", "int8")

# the training configuration: benchmark/run_ridge.py's defaults
T_VOCAB, T_D, T_HEADS, T_LAYERS, T_SEQ, T_BATCH = 30000, 2048, 16, 12, 512, 8
T_STEPS = 4
# the train and moe phases' steps in each mode: in the default mode the
# miss (eager), the first hit (captured into a CUDA graph, then
# replayed) and 4 replays
G_STEPS = 6
# kernel path vs plain path: per-step loss, and each weight matrix's
# change over the steps (||dW_kernel - dW_plain|| / ||dW_plain||).  At
# random init the attention is near uniform, so dS = P (dP - delta) is a
# difference of near-equal terms and the Q/K projections' updates differ
# by up to ~1e-3 from float32 summation order alone; a miswired backward
# (dK and dV swapped, a scale dropped) moves them by order one
LOSS_RTOL, PARAM_RTOL = 1e-5, 1e-2
# the same under bf16 amp (train and moe phases; the dp phase's fused
# and chain runs share every product, so they keep the fp32 limits):
# each step's loss within one bf16 ulp of the plain path's (ulp(v) =
# 2^(floor(log2|v|) - 7)), each weight matrix's change within 15 %.
# From the CPU parity runs (tests/test_torch_amp.py, 5 steps of a
# 2-layer LM): the step-0 forward is bit-equal to the JAX package's,
# and bf16 rounding flips (1-3 ulps in bias and layer-norm gradients)
# then grow to at most 0.4 ulp in the loss and 10 % in a parameter's
# change — the JAX package's own compiled and interpreted modes differ
# by up to 13.5 %.  A miswired gradient moves a weight by order one
LOSS_ULPS_BF16, PARAM_RTOL_BF16 = 1, 0.15
FLASH_SHAPE = (T_BATCH, T_SEQ, T_HEADS, T_D // T_HEADS)

# the MoE configuration: benchmark/run_moe.py's defaults
M_VOCAB, M_D, M_HEADS, M_LAYERS, M_SEQ, M_BATCH = 30000, 1024, 8, 6, 512, 8
M_EXPERTS, M_TOPK, M_CF, M_AUX = 8, 2, 1.25, 0.01
# the moe_kernel phase's router: N(0, 0.05), about the spread of the
# LM's Xavier-initialised [1024, 8] gate weights
M_GATE_STD = 0.05

# the image configurations: benchmark/run_image.py's resnet50 at its
# defaults (224x224, 1000 classes, batch 128, bf16 throughout: the image,
# every parameter and Momentum's velocity); ResNet-18 at 64x64, batch 8,
# float32, on the card and on the CPU (the card-vs-CPU phase); the
# book's VGG-16 with batch norm and dropout at the CIFAR-10 width (32x32,
# 10 classes, batch 128, float32)
R_IMG, R_CLASSES, R_BATCH, R_DEPTH = 224, 1000, 128, 50
C_IMG, C_CLASSES, C_BATCH, C_DEPTH, C_STEPS = 64, 1000, 8, 18, 2
V_IMG, V_CLASSES, V_BATCH = 32, 10, 128
# card against CPU in float32: losses, and every parameter, velocity and
# running statistic after the steps, within 1e-4 of max(1, |CPU value|)
# (cuDNN and the CPU's convolutions sum in other orders; the CPU tests
# hold the CPU path to the JAX package at the same 1e-4)
CARD_CPU_RTOL = 1e-4


class CheckFailed(RuntimeError):
    pass


def check(cond, what):
    if not cond:
        raise CheckFailed(what)


def emit(obj):
    print(json.dumps(obj), flush=True)


def card_peaks(name):
    """-> (bytes/s, {torch.float32: scalar fp32, torch.bfloat16: bf16
    tensor, "tf32": TF32 tensor FLOP/s}) of the card."""
    for key, bw, fp32, bf16, tf32 in _CARD_PEAKS:
        if key in name:
            return bw, {torch.float32: fp32, torch.bfloat16: bf16,
                        "tf32": tf32}
    raise CheckFailed(f"no published peaks for card {name!r}")


def _ptxas_summary(log):
    """nvcc -Xptxas=-v output -> one line per kernel: its name (the
    flash kernels as name<dtype,D>), registers, and stack and spills."""
    import re

    out, name, frame = [], "?", ""
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = m.group(1)
            short = re.search(
                r"([a-z_]+_kernel)I(f|13__nv_bfloat16|a)Li(\d+)E", name)
            if short:
                dt = {"f": "f32", "a": "i8"}.get(short.group(2), "bf16")
                name = f"{short.group(1)}<{dt},{short.group(3)}>"
            else:
                name = name[:80]
        elif "spill" in ln:
            frame = ln.strip()
        elif "registers" in ln:
            used = ln.split(":", 1)[-1].strip()
            out.append(f"{name}: {used}; {frame}")
    return out


def cold_ms(fn, n, flush):
    """Median device time of `fn` in ms over `n` calls, each after the
    L2 cache was overwritten (the serving step finds K/V cold: a tick
    streams 50+ MB of weights between two layers' attention)."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(n):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in pairs]))


def device_ms(fn, n, flush, match):
    """-> (median device time in ms of the kernels whose name contains
    `match`, how many there were, their launch grids) over `n` cold-L2
    calls of `fn` under torch.profiler: the kernel's own duration on the
    card, with no launch gap and no host time in it, and the grid as
    the profiler recorded the launch."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # the profiler may miss kernels of a window (a few of the first; once,
    # in the moe_kernel phase, 17 of 30): up to three windows
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        kernels = [e for e in events if e.get("cat") == "kernel"
                   and match in e.get("name", "")]
        if len(kernels) >= n // 2:
            break
    check(len(kernels) >= n // 2, f"device_ms: the profile shows "
          f"{len(kernels)} {match!r} kernels for {n} calls")
    grids = sorted({tuple(e["args"]["grid"]) for e in kernels
                    if "grid" in e.get("args", {})})
    check(grids, f"device_ms: the profile records no grid for {match!r}")
    return (float(np.median([e["dur"] for e in kernels])) / 1e3,
            len(kernels), [list(g) for g in grids])


def _reset_peak():
    """Start a phase's peak-memory reading: tensors that an earlier phase
    left in reference cycles are collected first, so the peak counts
    what this phase holds, not what the collector had not reached yet."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def host_us(fn, n):
    """Host time of one call of `fn` in microseconds: `n` calls back to
    back with no synchronisation between them (the card finishes each
    faster than the host issues the next, so the clock reads the host)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


# -- kernels phase -----------------------------------------------------------

def _kernel_inputs(kv_dtype, w_n, dev, gen):
    s_n, ctx = SLOTS, BLOCK * MAX_BLOCKS
    nb_pool = KV_BLOCKS + 1
    # cursors spread over the whole context, the last one at its end
    positions = torch.tensor(
        [round(s * (ctx - w_n) / (s_n - 1)) for s in range(s_n)],
        dtype=torch.int32)
    tables = torch.zeros((s_n, MAX_BLOCKS), dtype=torch.int32)
    perm = torch.randperm(nb_pool - 1, generator=gen) + 1
    used = 0
    for s in range(s_n):
        n = -(-(int(positions[s]) + w_n) // BLOCK)
        tables[s, :n] = perm[used:used + n]
        used += n
    shape = (N_LAYERS, nb_pool, BLOCK, D_MODEL)
    pools = []
    for _ in range(2):
        if kv_dtype == "int8":
            pay = torch.randint(-127, 128, shape, generator=gen,
                                dtype=torch.int8)
            sc = torch.rand((N_LAYERS, nb_pool), generator=gen) * 0.05 + 1e-3
            pools.append((pay.to(dev), sc.to(dev)))
        else:
            t = torch.randn(shape, generator=gen)
            if kv_dtype == "bf16":
                t = t.bfloat16()
            pools.append(t.to(dev))
    q = torch.randn((s_n, w_n, D_MODEL), generator=gen).to(dev)
    return q, pools[0], pools[1], tables.to(dev), positions.to(dev)


def _library_attention(q, pool_k, pool_v, tables, positions, layer):
    """gather + dequantize + F.scaled_dot_product_attention with a mask:
    the yardstick a PyTorch user would write.  Timed only; the port
    never calls it."""
    from paddle_tpu_torch.kernels.paged_attention import _gather

    s_n, w_n, d = q.shape
    dh = d // N_HEADS
    k = _gather(pool_k, layer, tables).reshape(s_n, -1, N_HEADS, dh)
    v = _gather(pool_v, layer, tables).reshape(s_n, -1, N_HEADS, dh)
    ctx = k.shape[1]
    pos_w = positions.long()[:, None] + torch.arange(w_n, device=q.device)
    mask = torch.arange(ctx, device=q.device)[None, None, :] <= pos_w[:, :,
                                                                      None]
    out = torch.nn.functional.scaled_dot_product_attention(
        q.reshape(s_n, w_n, N_HEADS, dh).transpose(1, 2),
        k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask[:, None])
    return out.transpose(1, 2).reshape(s_n, w_n, d)


def _bound(kv_dtype, q, positions, w_n, bw, flops):
    """Least time for the work these inputs need: each needed K/V row
    (positions <= pos + W - 1) read once, q/tables/positions read and
    the context written once; 4 fp32 operations per K/V element per
    window row (q.k and p.v multiply-adds)."""
    ctx = BLOCK * MAX_BLOCKS
    n_ctx = [min(int(p) + w_n, ctx) for p in positions.tolist()]
    elem = {"fp32": 4, "bf16": 2, "int8": 1}[kv_dtype]
    kv = 2 * sum(n_ctx) * D_MODEL * elem
    if kv_dtype == "int8":
        kv += 2 * 4 * sum(-(-n // BLOCK) for n in n_ctx)
    io = 2 * q.numel() * 4 + sum(-(-n // BLOCK) for n in n_ctx) * 4 \
        + positions.numel() * 4
    ops = 4 * w_n * sum(n_ctx) * D_MODEL
    t_bytes, t_ops = (kv + io) / bw * 1e3, ops / flops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), kv + io


def kernels_phase(dev, bw, flops):
    from paddle_tpu_torch.kernels.paged_attention import (
        paged_attention, paged_attention_reference)

    gen = torch.Generator().manual_seed(SEED)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=dev)
    layer = N_LAYERS // 2
    cases = {}
    for kv_dtype in KV_DTYPES:
        for w_n in (1, 4):
            q, pk, pv, tables, positions = _kernel_inputs(kv_dtype, w_n,
                                                          dev, gen)
            args = (q, pk, pv, tables, positions, layer)
            out = paged_attention(*args, n_heads=N_HEADS)
            ref = paged_attention_reference(*args, n_heads=N_HEADS)
            lib = _library_attention(*args)
            torch.cuda.synchronize()
            check(out.shape == ref.shape and bool(torch.isfinite(out).all()),
                  f"paged_attention {kv_dtype} W={w_n}: bad output")
            err = float((out - ref).abs().max())
            tol = 1e-5 * max(1.0, float(ref.abs().max()))
            lib_err = float((lib - ref).abs().max())
            check(err <= tol, f"paged_attention {kv_dtype} W={w_n}: "
                  f"max_abs_err {err} > {tol}")
            bound, bound_by, nbytes = _bound(kv_dtype, q, positions, w_n,
                                             bw, flops)
            again = paged_attention(*args, n_heads=N_HEADS)
            torch.cuda.synchronize()
            check(torch.equal(out, again), f"paged_attention {kv_dtype} "
                  f"W={w_n}: two calls differ")
            run = lambda: paged_attention(*args, n_heads=N_HEADS)  # noqa
            ms = cold_ms(run, 200, flush)
            dev_ms, n_kernels, grids = device_ms(run, 200, flush, "paged_")
            check(len(grids) == 1, f"paged_attention {kv_dtype} W={w_n}: "
                  f"launch grids {grids}")
            plain_ms = cold_ms(
                lambda: paged_attention_reference(*args, n_heads=N_HEADS),
                50, flush)
            library_ms = cold_ms(lambda: _library_attention(*args), 50, flush)
            cases[f"{kv_dtype}_w{w_n}"] = {
                "max_abs_err": err, "tol": tol, "library_max_abs_err": lib_err,
                "ms": ms, "device_ms": dev_ms,
                "device_kernels_profiled": n_kernels,
                # the grid is (splits, heads, slots)
                "grid": grids[0], "splits": grids[0][0],
                "ctas": int(np.prod(grids[0])),
                "host_us": host_us(run, 200),
                "plain_ms": plain_ms, "library_ms": library_ms,
                "bound_ms": bound, "bound_by": bound_by, "bytes": nbytes,
                "bytes_per_s": nbytes / (dev_ms * 1e-3)}
    emit({"phase": "kernels", "kernel": "paged_attention_decode",
          "slots": SLOTS, "context": BLOCK * MAX_BLOCKS, "d_model": D_MODEL,
          "n_heads": N_HEADS, "layer": layer,
          "timing": "ms: median of cold-L2 calls between CUDA events; "
                    "device_ms: median duration of the kernel itself in "
                    "torch.profiler over the same cold-L2 calls, and grid "
                    "its launch grid there; host_us: host time per call "
                    "of paged_attention; bytes_per_s over device_ms",
          "cases": cases})
    return cases


# -- flash phase -------------------------------------------------------------

def _flash_work(kind, b, sq, sk, h, d, causal, elem):
    """(FLOPs, bytes) the kernel must do on these shapes: 2 per
    multiply-add, only the (query, key) pairs causal masking keeps; each
    input read once, each output written once."""
    pairs = b * h * (sum(min(i + 1, sk) for i in range(sq)) if causal
                     else sq * sk)
    qo = b * sq * h * d * elem
    kv = b * sk * h * d * elem
    vec = b * h * sq * 4
    if kind == "fwd":      # S = QK^T, O = PV; q,k,v in, o and lse out
        return 4 * d * pairs, 2 * qo + 2 * kv + vec
    if kind == "dq":       # S, dP = dO V^T, dQ = dS K
        return 6 * d * pairs, 3 * qo + 2 * kv + 2 * vec
    # S, dP, dV = P^T dO, dK = dS^T Q; q, do, k, v, lse, delta in
    return 8 * d * pairs, 2 * qo + 4 * kv + 2 * vec


def _sdpa(q, k, v, causal):
    """torch's fused attention on [b, s, h, d] views — the library
    yardstick.  Timed only; the port never calls it."""
    out = torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=causal)
    return out.transpose(1, 2)


def _close_bf16(got, want):
    """(ok, limits) for a bfloat16 result against its plain version, both
    rounded from float32: the largest error at most one bf16 ulp of
    max|plain| (a rounding flip where float32 sums differ), the error's
    RMS at most 2^-9 of the plain values' RMS."""
    top = float(want.abs().max())
    lim = 2.0 ** (np.floor(np.log2(top)) - 7) if top > 0 else 0.0
    rms_lim = 2.0 ** -9 * float(want.pow(2).mean().sqrt())
    err = (got - want).abs()
    rms = float(err.pow(2).mean().sqrt())
    return float(err.max()) <= lim and rms <= rms_lim, lim, rms, rms_lim


def flash_phase(dev, bw, peaks):
    from paddle_tpu_torch.kernels import flash_attention as fa

    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=dev)
    b, s, h, d = FLASH_SHAPE
    cases = {}
    for name, dtype, causal in (("fp32_causal", torch.float32, True),
                                ("bf16_causal", torch.bfloat16, True),
                                ("fp32_full", torch.float32, False)):
        gen = torch.Generator().manual_seed(SEED)
        q, k, v, do = (torch.randn(FLASH_SHAPE, generator=gen).to(dev, dtype)
                       for _ in range(4))
        fp32 = dtype == torch.float32
        o, lse = fa.flash_attention_fwd(q, k, v, causal)
        o_ref, lse_ref = fa.flash_attention_fwd_reference(q, k, v, causal)
        delta = fa.attention_delta(o_ref, do)
        bwd = (q, k, v, do, lse_ref, delta, causal)
        dq = fa.flash_attention_dq(*bwd)
        dk, dv = fa.flash_attention_dkv(*bwd)
        dq_ref = fa.flash_attention_dq_reference(*bwd)
        dk_ref, dv_ref = fa.flash_attention_dkv_reference(*bwd)
        lib_o = _sdpa(q, k, v, causal)
        torch.cuda.synchronize()
        errs, rms_errs = {}, {}
        for key, got, want, tol in (
                ("fwd", o, o_ref, 2e-5), ("lse", lse, lse_ref, 2e-5),
                ("dq", dq, dq_ref, 2e-4), ("dk", dk, dk_ref, 2e-4),
                ("dv", dv, dv_ref, 2e-4)):
            bf16 = got.dtype == torch.bfloat16
            got, want = got.float(), want.float()
            check(bool(torch.isfinite(got).all()), f"flash {name} {key}: "
                  "non-finite output")
            err = float((got - want).abs().max())
            rms_errs[key] = float((got - want).pow(2).mean().sqrt())
            if bf16:
                ok, lim, rms, rms_lim = _close_bf16(got, want)
                check(ok, f"flash {name} {key}: max_abs_err {err} > {lim} "
                      f"or RMS error {rms} > {rms_lim}")
            else:
                lim = tol * max(1.0, float(want.abs().max()))
                check(err <= lim,
                      f"flash {name} {key}: max_abs_err {err} > {lim}")
            errs[key] = err
        lib_err = float((lib_o.float() - o_ref.float()).abs().max())

        # library yardstick: SDPA forward, and its backward alone (one
        # autograd call computing dQ, dK and dV together)
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        lib_out = _sdpa(*leaves, causal)
        lib_bwd = lambda: torch.autograd.grad(  # noqa: E731
            lib_out, leaves, do, retain_graph=True)
        elem = 4 if fp32 else 2
        # float32-accurate products on the tensor cores take three TF32
        # products each (3xTF32: the backward kernels, and SDPA's float32
        # path); the scalar float32 peak stays beside it for PRs 2-3
        flops = peaks["tf32"] / 3 if fp32 else peaks[dtype]
        res = {"max_abs_err": errs, "rms_err": rms_errs,
               "sdpa_fwd_max_abs_err": lib_err, "peak_flops": flops,
               "sdpa_fwd_ms": cold_ms(lambda: _sdpa(q, k, v, causal), 20,
                                      flush),
               "sdpa_bwd_ms": cold_ms(lib_bwd, 20, flush)}
        res["sdpa_fwd_bwd_ms"] = res["sdpa_fwd_ms"] + res["sdpa_bwd_ms"]
        if fp32:
            res["peak_flops_fp32_scalar"] = peaks[torch.float32]
        for kind, run, plain in (
                ("fwd", lambda: fa.flash_attention_fwd(q, k, v, causal),
                 lambda: fa.flash_attention_fwd_reference(q, k, v, causal)),
                ("dq", lambda: fa.flash_attention_dq(*bwd),
                 lambda: fa.flash_attention_dq_reference(*bwd)),
                ("dkv", lambda: fa.flash_attention_dkv(*bwd),
                 lambda: fa.flash_attention_dkv_reference(*bwd))):
            n_ops, n_bytes = _flash_work(kind, b, s, s, h, d, causal, elem)
            t_ops, t_bytes = n_ops / flops * 1e3, n_bytes / bw * 1e3
            ms = cold_ms(run, 20, flush)
            bound = max(t_ops, t_bytes)
            res[kind] = {"ms": ms, "plain_ms": cold_ms(plain, 10, flush),
                         "bound_ms": bound,
                         "bound_by": ("operations" if t_ops >= t_bytes
                                      else "bytes"),
                         "bound_share": bound / ms,
                         "flop": n_ops, "bytes": n_bytes,
                         "flop_per_s": n_ops / (ms * 1e-3)}
            if fp32:
                res[kind]["bound_ms_fp32_scalar"] = max(
                    n_ops / peaks[torch.float32] * 1e3, t_bytes)
            check(res[kind]["bound_share"] <= 1.0,
                  f"flash {name} {kind}: {ms} ms beats its bound {bound} ms")
        res["fwd_over_sdpa_fwd"] = res["fwd"]["ms"] / res["sdpa_fwd_ms"]
        res["bwd_ms"] = res["dq"]["ms"] + res["dkv"]["ms"]
        res["bwd_over_sdpa_bwd"] = res["bwd_ms"] / res["sdpa_bwd_ms"]
        del leaves, lib_out
        cases[name] = res
    emit({"phase": "flash", "shape_bshd": list(FLASH_SHAPE),
          "timing": "median of cold-L2 calls, CUDA events; the backward "
                    "kernels take the plain forward's lse and delta; "
                    "fwd against sdpa_fwd_ms, and bwd_ms = dq + dkv "
                    "against sdpa_bwd_ms (one call computing dQ, dK and "
                    "dV), in every case; bounds over "
                    "peak_flops: bf16 on the tensor cores for bf16, TF32/3 "
                    "(3xTF32) for float32, with bound_ms_fp32_scalar over "
                    "the scalar float32 peak beside it",
          "cases": cases})
    return cases


# -- grads phase -------------------------------------------------------------

def _close_ulp(got, want):
    """Each element within one bf16 ulp of the larger of the two values:
    two bf16 products whose float32 sums rounded to neighbouring bf16
    values."""
    a, b = got.float(), want.float()
    top = torch.maximum(a.abs(), b.abs())
    ulp = torch.where(top > 0, torch.exp2(torch.floor(torch.log2(top)) - 7),
                      torch.zeros_like(top))
    return bool(((a - b).abs() <= ulp).all())


def grads_phase(dev):
    """The explicit gradient lowerings (`registry.register_grad_lower`)
    against the generic gradient (torch autograd over the forward
    lowering, the route every other op takes) on the train shapes: the
    flash_attention grad op from the forward op's Out (and the lse it
    carries) — bit-equal to the generic route, whose forward recompute
    is the same deterministic kernel, with no forward launch; an Out
    without an lse re-runs the forward kernel.  The mul grad op against
    autograd's matmul backward: bit-equal, or else within 1e-5 of the
    largest element in float32 and one bf16 ulp under amp."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.core.execution import (ExecContext,
                                                 generic_grad_lower)
    from paddle_tpu_torch.core.registry import get_op_info
    from paddle_tpu_torch.kernels.flash_attention import flash_attention

    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=dev)
    ctx = ExecContext(dev)
    gen = torch.Generator().manual_seed(SEED)
    launches = flash_attention.launches
    info = get_op_info("flash_attention")
    attrs = {**info.attrs, "causal": True}
    flash = {}
    for name, dtype in (("bf16_causal", torch.bfloat16),
                        ("fp32_causal", torch.float32)):
        q, k, v, do = (torch.randn(FLASH_SHAPE, generator=gen).to(dev, dtype)
                       for _ in range(4))
        o = info.lower(ctx, {"Q": [q], "K": [k], "V": [v]}, attrs)["Out"]
        ins = {"Q": [q], "K": [k], "V": [v], "Out": [o], "Out@GRAD": [do]}
        routes = {
            "explicit": lambda: info.grad_lower(ctx, ins, attrs),
            "generic": lambda: generic_grad_lower(ctx, ins, attrs, info),
            "explicit_no_lse": lambda: info.grad_lower(
                ctx, dict(ins, Out=[o.clone()]), attrs)}
        grads, counted = {}, {}
        for route, fn in routes.items():
            before = dict(launches)
            grads[route] = fn()
            torch.cuda.synchronize()
            counted[route] = {kk: launches[kk] - before[kk] for kk in launches}
        for route, fwd in (("explicit", 0), ("generic", 1),
                           ("explicit_no_lse", 1)):
            check(counted[route] == {"fwd": fwd, "dq": 1, "dkv": 1},
                  f"grads flash {name} {route}: launches {counted[route]}")
        for route in ("generic", "explicit_no_lse"):
            for slot, g in grads["explicit"].items():
                check(g[0].dtype == dtype
                      and torch.equal(g[0], grads[route][slot][0]),
                      f"grads flash {name}: explicit {slot} is not the "
                      f"{route} route's bit for bit")
        del grads
        flash[name] = {
            "bit_equal_to_generic": True, "launches": counted,
            "explicit_ms": cold_ms(routes["explicit"], 10, flush),
            "generic_ms": cold_ms(routes["generic"], 10, flush)}
        del q, k, v, do, o, ins, routes

    minfo = get_op_info("mul")
    mattrs = {"x_num_col_dims": 2, "y_num_col_dims": 1}
    mul = {}
    for name, n_out, use_amp in (("proj_fp32", T_D, False),
                                 ("proj_amp", T_D, True),
                                 ("head_amp", T_VOCAB, True)):
        x = torch.randn((T_BATCH, T_SEQ, T_D), generator=gen).to(dev)
        w = (torch.randn((T_D, n_out), generator=gen) * 0.02).to(dev)
        if use_amp:
            amp.enable_bf16()
        try:
            y = minfo.lower(ctx, {"X": [x], "Y": [w]}, mattrs)["Out"]
            dy = torch.randn(tuple(y.shape), generator=gen).to(dev, y.dtype)
            ins = {"X": [x], "Y": [w], "Out": [y], "Out@GRAD": [dy]}
            explicit = minfo.grad_lower(ctx, ins, mattrs)
            generic = generic_grad_lower(ctx, ins, mattrs, minfo)
            torch.cuda.synchronize()
            res = {"out_dtype": str(y.dtype), "bit_equal": {},
                   "max_abs_err": {}}
            for slot, want_dt in (("X@GRAD", x.dtype), ("Y@GRAD", w.dtype)):
                got, want = explicit[slot][0], generic[slot][0]
                check(got.dtype == want.dtype == want_dt,
                      f"grads mul {name} {slot}: {got.dtype} / {want.dtype}")
                res["bit_equal"][slot] = bool(torch.equal(got, want))
                res["max_abs_err"][slot] = float((got - want).abs().max())
                if use_amp:
                    ok = _close_ulp(got, want)
                else:
                    err, lim = _tol_err(got, want, 1e-5)
                    ok = err <= lim
                check(ok, f"grads mul {name} {slot}: explicit and generic "
                      f"differ by {res['max_abs_err'][slot]}")
            del explicit, generic
            res["explicit_ms"] = cold_ms(
                lambda: minfo.grad_lower(ctx, ins, mattrs), 10, flush)
            res["generic_ms"] = cold_ms(
                lambda: generic_grad_lower(ctx, ins, mattrs, minfo), 10,
                flush)
        finally:
            if use_amp:
                amp.disable_bf16()
        mul[name] = dict(res, shape_x=[T_BATCH, T_SEQ, T_D],
                         shape_y=[T_D, n_out])
        del x, w, y, dy, ins
    emit({"phase": "grads", "flash": flash, "mul": mul,
          "timing": "median of cold-L2 calls, CUDA events, of the grad "
                    "op's explicit lowering and of the generic gradient "
                    "(forward recompute + autograd) on the same inputs"})
    return flash, mul


# -- train phase -------------------------------------------------------------

def _param_count(vocab, d_model, n_layers, seq):
    """benchmark/run_ridge.py's analytic count for the 6*N*P convention:
    12*d^2 per block plus token, position and output tables."""
    return (n_layers * 12 * d_model * d_model + 2 * vocab * d_model
            + max(seq, 2048) * d_model)


def _train_feed(step):
    """The periodic next-token data of examples/transformer_lm.py."""
    base = np.arange(T_BATCH * T_SEQ).reshape(T_BATCH, T_SEQ) % 97
    return {"ids": ((base + step) % 97).astype(np.int64),
            "lbl": ((base + step + 1) % 97).astype(np.int64)[..., None]}


def _timed_steps(run_step, counts, steps=T_STEPS):
    """`steps` steps of `run_step(step)` (-> the loss) -> (losses, step
    seconds, per step {name: how much counts[name]() grew})."""
    losses, secs, per_step = [], [], []
    for step in range(steps):
        before = {k: f() for k, f in counts.items()}
        t0 = time.perf_counter()
        out = run_step(step)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(out.reshape(-1)[0]))
        per_step.append({k: f() - before[k] for k, f in counts.items()})
    return losses, secs, per_step


def _lm_program(optimizer):
    """The run_ridge transformer LM's training Program -> (main, startup,
    loss)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import framework as fw
    from paddle_tpu_torch.models.transformer import transformer_lm

    fw.reset_unique_names()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        ids = fluid.layers.data(name="ids", shape=[T_SEQ], dtype="int64")
        lbl = fluid.layers.data(name="lbl", shape=[T_SEQ, 1], dtype="int64")
        logits = transformer_lm(ids, T_VOCAB, d_model=T_D, n_heads=T_HEADS,
                                n_layers=T_LAYERS, max_len=max(T_SEQ, 2048),
                                return_logits=True)
        cost = fluid.layers.softmax_with_cross_entropy(
            fluid.layers.reshape(logits, shape=[-1, T_VOCAB]),
            fluid.layers.reshape(lbl, shape=[-1, 1]))
        loss = fluid.layers.mean(cost)
        optimizer.minimize(loss)
    return main, startup, loss


_GEMM_NAMES = ("gemm", "cublas", "cutlass", "nvjet", "xmma")


_CONV_GROUPS = (("wgrad", "conv_wgrad"), ("dgrad", "conv_dgrad"),
                ("fprop", "conv_fwd"), ("convolve", "conv_fwd"))


def _kernel_group(name):
    """Device-time group of a kernel by its name.  cuBLAS names its
    Hopper bf16 GEMMs `nvjet_*` or `sm90_xmma_*` beside the
    `*gemm*`/`cutlass` names of its float32 ones; cuDNN names its
    convolutions' implicit GEMMs by pass (`fprop`, `dgrad`, `wgrad`) and
    its layout changes `nchwToNhwc`/`nhwcToNchw`."""
    low = name.lower()
    for pat, group in _CONV_GROUPS:
        if pat in low:
            return group
    if "nchwtonhwc" in low or "nhwctonchw" in low:
        return "layout"
    if "pool" in low:
        return "pooling"
    if any(k in low for k in _GEMM_NAMES):
        return "matmul"
    if any(k in name for k in ("fwd_kernel<", "dq_kernel<", "dkv_kernel<")):
        return "flash_attention"
    if "route_kernel<" in name or "place_kernel(" in name:
        return "moe_dispatch"
    if "route_backward_kernel<" in name:
        return "moe_backward"
    if "fused_sgd_kernel" in name:
        return "fused_update"
    if "memcpy" in low or "memset" in low:
        return "copy"
    return "other"


_GEMM_OPS = ("aten::mm", "aten::bmm", "aten::addmm", "aten::baddbmm")


def _gemm_split(prof, dim):
    """Device time of the profiled GEMM calls (aten mm/bmm/addmm/baddbmm,
    by input shape) with an operand dimension `dim` and of the others:
    at dim = E * C, the dense [T, E, C] dispatch and combine products
    and their VJPs."""
    from torch.autograd import DeviceType

    out = {"dim": dim, "with_dim_ms": 0.0, "with_dim_calls": 0,
           "other_ms": 0.0, "other_calls": 0, "shapes_with_dim": []}
    for ev in prof.key_averages(group_by_input_shape=True):
        if ev.device_type != DeviceType.CPU or ev.key not in _GEMM_OPS:
            continue
        shapes = [list(sh) for sh in (ev.input_shapes or []) if sh]
        key = "with_dim" if any(dim in sh for sh in shapes) else "other"
        out[f"{key}_ms"] += ev.self_device_time_total / 1e3
        out[f"{key}_calls"] += ev.count
        if key == "with_dim":
            out["shapes_with_dim"].append([ev.key, shapes])
    return out


_SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
               "cudaEventSynchronize")


def _profile_step(run_step, need, phase, gemm_dim=None, kinds=None):
    """`run_step()` (one more step) under torch.profiler -> device time
    by kernel group and the top kernels (self device time, ms), how many
    kernels ran (and of each kind in `kinds`, {kind: a substring of the
    kernel's name}), the device-to-device copies, the host's
    synchronisations (CUDA runtime calls that wait for the card), the
    step's span between CUDA events around it, and with `gemm_dim` the
    GEMMs split by that operand dimension (_gemm_split); every group in
    `need` must show."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=gemm_dim is not None) as prof:
        start.record()
        run_step()
        end.record()
        torch.cuda.synchronize()
    kernels, counts, syncs = {}, {}, {}
    # device-side events only: host ops would count twice
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA and ev.self_device_time_total:
            kernels[ev.key] = ev.self_device_time_total / 1e3
            counts[ev.key] = ev.count
        elif ev.key in _SYNC_CALLS:
            syncs[ev.key] = ev.count
    groups = {}
    for name, ms in kernels.items():
        g = _kernel_group(name)
        groups[g] = groups.get(g, 0.0) + ms
    for g in need:
        check(groups.get(g, 0.0) > 0,
              f"{phase}: the profile shows no {g} kernel: {groups}")
    top = sorted(kernels.items(), key=lambda kv: -kv[1])
    by_group_top = {}
    for n, ms in top:
        g = by_group_top.setdefault(_kernel_group(n), [])
        if len(g) < 3:
            g.append([n[:120], ms, counts[n]])
    dtod = [n for n in kernels if n.startswith("Memcpy DtoD")]
    out = {"device_ms": sum(kernels.values()), "by_group_ms": groups,
           "top_kernels_ms": [[n[:120], ms] for n, ms in top[:10]],
           "by_group_top_kernels": by_group_top,
           "kernels": sum(counts.values()),
           "kind_counts": {k: sum(c for n, c in counts.items() if pat in n)
                           for k, pat in (kinds or {}).items()},
           "memcpy_dtod_ms": sum(kernels[n] for n in dtod),
           "memcpy_dtod_count": sum(counts[n] for n in dtod),
           "host_syncs": syncs, "event_ms": start.elapsed_time(end)}
    if gemm_dim is not None:
        out["gemm_split"] = _gemm_split(prof, gemm_dim)
    return out


def _default_mode_path(exe, run, counts, want, kinds, need, phase,
                       snapshot):
    """The main path in the Executor's default mode: G_STEPS timed steps
    (the miss runs the block eagerly, the first hit captures it into a
    CUDA graph and replays it, every later hit replays) and a profiled
    replay.  Holds the cache (one miss, then hits, no recompile after
    warm-up), the graphs (one capture, then replays), the wrappers'
    counts (`want` a step on the eager run and on the capture, none on a
    replay) and the kernels the profiler saw the replay run (`want`
    again, by `kinds`).  -> (losses, step seconds, per-step counts,
    `snapshot()` after the timed steps, the profile, a record for the
    phase's line)."""
    s0, g0 = exe.cache_stats(), exe.graph_stats()
    losses, secs, per_step = _timed_steps(run, counts, G_STEPS)
    state = snapshot()
    peak = torch.cuda.max_memory_allocated()
    reserved = torch.cuda.max_memory_reserved()
    zero = {k: 0 for k in want}
    check(per_step[:2] == [want, want] and all(st == zero
                                               for st in per_step[2:]),
          f"{phase}: wrapper launches per step {per_step}: want {want} on "
          "the eager run and the capture, none on a replay")
    # the profiled step is a replay; the profiler may drop records of a
    # window (see device_ms): up to three windows.  Its peak memory is a
    # replay's alone
    torch.cuda.reset_peak_memory_stats()
    for windows in range(1, 4):
        before = {k: f() for k, f in counts.items()}
        profile = _profile_step(lambda: run(G_STEPS), need, phase,
                                kinds=kinds)
        check({k: f() - before[k] for k, f in counts.items()} == zero,
              f"{phase}: a wrapper ran during the profiled replay")
        if profile["kind_counts"] == want:
            break
    check(profile["kind_counts"] == want, f"{phase}: the profiled replay "
          f"ran kernels {profile['kind_counts']}, want {want}")
    replay_peak = torch.cuda.max_memory_allocated()
    s1, g1 = exe.cache_stats(), exe.graph_stats()
    stats = {k: s1[k] - s0[k] for k in ("hits", "misses", "entries",
                                        "recompiles_after_warmup")}
    graphs = {k: g1[k] - g0[k] for k in ("captures", "replays")}
    check(stats == {"hits": G_STEPS - 1 + windows, "misses": 1,
                    "entries": 1, "recompiles_after_warmup": 0}
          and graphs == {"captures": 1, "replays": G_STEPS - 2 + windows},
          f"{phase}: the main Program's cache {stats} and graphs {graphs}: "
          "want one miss, then hits replaying one captured graph")
    return losses, secs, per_step, state, profile, {
        "cache": stats, "graphs": graphs, "profile_windows": windows,
        "capture_s": g1["capture_s"] - g0["capture_s"],
        "compile_s": s1["compile_s"] - s0["compile_s"],
        "write_back_bytes": g1["write_back_bytes"],
        "peak_memory_bytes": peak, "peak_reserved_bytes": reserved,
        "replay_peak_memory_bytes": replay_peak}


class _PlainAttention:
    """The `flash_attention` op's lowering and its gradient swapped for
    the plain composition and its autograd gradient while the block runs
    (the package itself has one path on the card); `calls` counts the
    plain forward runs (the op's and the gradient's recompute),
    `grad_calls` the gradient ops."""

    def __enter__(self):
        from paddle_tpu_torch.core.registry import get_op_info

        self.info = get_op_info("flash_attention")
        self.lower, self.grad_lower = self.info.lower, self.info.grad_lower
        self.calls = self.grad_calls = 0
        self.info.lower, self.info.grad_lower = self._plain, self._plain_grad
        return self

    def __exit__(self, *exc):
        self.info.lower, self.info.grad_lower = self.lower, self.grad_lower

    def _plain(self, ctx, ins, attrs):
        from paddle_tpu_torch.core.execution import one
        from paddle_tpu_torch.kernels.flash_attention import (
            flash_attention_reference)

        self.calls += 1
        scale = None if attrs.get("default_scale", True) else attrs["scale"]
        return {"Out": flash_attention_reference(
            one(ins, "Q"), one(ins, "K"), one(ins, "V"),
            causal=bool(attrs.get("causal", False)), scale=scale)}

    def _plain_grad(self, ctx, ins, attrs):
        from paddle_tpu_torch.core.execution import generic_grad_lower

        self.grad_calls += 1
        return generic_grad_lower(ctx, ins, attrs, self.info)


class _PlainMoe:
    """The `moe_ffn` op's lowering swapped for the plain composition
    (moe_gate, the dispatch einsum, the expert FFNs, the combine einsum)
    while the block runs; `calls` counts the forward and
    recomputed-forward runs."""

    def __enter__(self):
        from paddle_tpu_torch.core.registry import get_op_info

        self.info = get_op_info("moe_ffn")
        self.lower, self.calls = self.info.lower, 0
        self.info.lower = self._plain
        return self

    def __exit__(self, *exc):
        self.info.lower = self.lower

    def _plain(self, ctx, ins, attrs):
        from paddle_tpu_torch.core.execution import one
        from paddle_tpu_torch.kernels.moe_dispatch import (
            moe_gate_dispatch_reference)
        from paddle_tpu_torch.parallel.moe import _capacity, _expert_mm

        self.calls += 1
        x, gw = one(ins, "X"), one(ins, "GateW")
        flat = x.reshape(-1, x.shape[-1])
        e_n, top_k = gw.shape[1], int(attrs["top_k"])
        c_n = _capacity(flat.shape[0], e_n, float(attrs["capacity_factor"]),
                        top_k)
        expert_in, combine, aux = moe_gate_dispatch_reference(flat, gw, e_n,
                                                              c_n, top_k)
        y = torch.einsum("ecd,tec->td", _expert_mm(
            expert_in, one(ins, "WIn"), one(ins, "WOut"), torch.relu),
            combine)
        return {"Out": y.reshape(*x.shape[:-1], y.shape[-1]),
                "AuxLoss": aux.reshape(1)}


class _PerOpChain:
    """The ParallelExecutor's fused bucket update swapped for the
    program's own per-op `sgd` chain while the block runs (the package
    has one path on the card); `calls` counts the sgd ops run."""

    def __init__(self, pe):
        self.pe = pe

    def __enter__(self):
        from paddle_tpu_torch.core.registry import get_op_info

        self.plan = self.pe._plan
        buckets, issue_after, _ = self.plan
        self.pe._plan = (buckets, issue_after, None)
        self.info = get_op_info("sgd")
        self.lower, self.calls = self.info.lower, 0
        self.info.lower = self._counted
        return self

    def __exit__(self, *exc):
        self.info.lower = self.lower
        self.pe._plan = self.plan

    def _counted(self, ctx, ins, attrs):
        self.calls += 1
        return self.lower(ctx, ins, attrs)


def _param_rel_diff(current, init, k_params):
    """{name: ||dW_kernel - dW_plain|| / ||dW_plain||} over the weight
    matrices, dW = value after the steps - initial value; `current(n)`
    is the plain path's value now."""
    out = {}
    for n, k_val in k_params.items():
        d_plain = current(n) - init[n]
        d_kern = k_val - init[n]
        out[n] = float((d_kern - d_plain).norm() / d_plain.norm())
    return out


def _bf16_ulp(v):
    return 2.0 ** (np.floor(np.log2(abs(v))) - 7)


def _loss_check(phase, k_loss, p_loss, amp):
    """-> (per-step differences, limit, unit): the kernel path's losses
    against the plain path's, in bf16 ulps of the plain loss under amp
    and relative in float32; raises outside the limit."""
    check(all(np.isfinite(k_loss + p_loss)), f"{phase}: non-finite "
          f"losses {k_loss} / {p_loss}")
    if amp:
        diff = [abs(a - b) / _bf16_ulp(b) for a, b in zip(k_loss, p_loss)]
        lim, unit = LOSS_ULPS_BF16, "bf16 ulps of the plain loss"
    else:
        diff = [abs(a - b) / abs(b) for a, b in zip(k_loss, p_loss)]
        lim, unit = LOSS_RTOL, "relative"
    check(max(diff) <= lim, f"{phase}: kernel/plain losses differ {diff} "
          f"({unit}; limit {lim})")
    return diff, lim, unit


def _grad_names(program):
    """The gradient var each optimizer op applies, by parameter."""
    return {op.input("Param")[0]: op.input("Grad")[0]
            for op in program.global_block().ops
            if "Param" in op.inputs and "Grad" in op.inputs}


def _bit_equal(phase, k_loss, i_loss, k_params, current):
    """The default mode's losses and parameters against the
    interpreter's from the same state and feeds: bit for bit (same
    kernels, same order, one stream); `current(n)` is the interpreter's
    value now."""
    check(k_loss == i_loss, f"{phase}: replayed losses {k_loss} differ "
          f"from the interpreter's {i_loss}")
    diff = sorted(n for n, v in k_params.items()
                  if not torch.equal(v, current(n)))
    check(not diff, f"{phase}: after the same steps {len(diff)} "
          f"parameters differ between the replay and the interpreter: "
          f"{diff[:5]}")


def _interpreter_record(i_secs, i_profile):
    step_ms = float(np.median(i_secs[1:])) * 1e3
    return {"interpreted_ms_per_step": step_ms,
            "interpreted_device_idle_share":
                1.0 - i_profile["device_ms"] / step_ms,
            "interpreted_profiled_step": i_profile,
            "interpreted_host_syncs_per_step": i_profile["host_syncs"]}


def train_phase(card, place, peaks, flash_cases, amp):
    """The run_ridge LM trained in the Executor's default mode (the block
    compiled: eager at the miss, then a CUDA graph, captured at the first
    hit and replayed), under bf16 amp (phase "train", the main path) or
    in float32 ("train_fp32"); then the interpreter and the plain path
    from the same state."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import executor as executor_mod
    from paddle_tpu_torch.core.scope import Scope
    from paddle_tpu_torch.kernels.flash_attention import flash_attention

    phase = "train" if amp else "train_fp32"
    if amp:
        fluid.amp.enable_bf16()     # before the Program is built
    prev_scope = executor_mod.switch_scope(Scope())
    exe = None
    try:
        main, startup, loss = _lm_program(
            fluid.Momentum(learning_rate=0.01, momentum=0.9))
        params = main.global_block().all_parameters()
        n_params = sum(int(np.prod(p.shape)) for p in params)
        weights = [p.name for p in params if len(p.shape) == 2]
        persist = [v.name for v in main.list_vars() if v.persistable]
        grads = _grad_names(main)
        check(sorted(grads) == sorted(p.name for p in params)
              and all(p.dtype == "float32" for p in params),
              f"{phase}: a parameter is not float32 or has no gradient")
        scope = fluid.global_scope()
        exe = fluid.Executor(place, seed=SEED)
        t0 = time.perf_counter()
        exe.run(startup)
        torch.cuda.synchronize()
        startup_s = time.perf_counter() - t0
        init = {n: scope.find_var(n).clone() for n in persist}

        # the main path: counts zeroed just before, read just after
        launches = flash_attention.launches
        for key in launches:
            launches[key] = 0
        _reset_peak()
        run = lambda step: exe.run(  # noqa: E731
            main, feed=_train_feed(step), fetch_list=[loss])[0]
        counts = {k: (lambda k=k: launches[k]) for k in launches}
        want = {"fwd": T_LAYERS, "dq": T_LAYERS, "dkv": T_LAYERS}
        k_loss, k_secs, k_steps, k_params, profile, graph = \
            _default_mode_path(
                exe, run, counts, want, {"fwd": "fwd_kernel<",
                                         "dq": "dq_kernel<",
                                         "dkv": "dkv_kernel<"},
                ("flash_attention", "matmul"), phase,
                lambda: {n: scope.find_var(n).clone() for n in grads})
        k_total = dict(launches)
        # the graph and its pool go before the interpreter's runs
        exe.close()
        exe = fluid.Executor(place, seed=SEED)

        # the interpreter from the same state and feeds
        for n in persist:
            scope.set_var(n, init[n].clone())
        run_i = lambda step: exe.run(  # noqa: E731
            main, feed=_train_feed(step), fetch_list=[loss],
            compiled=False)[0]
        i_loss, i_secs, i_steps = _timed_steps(run_i, counts, G_STEPS)
        check(all(st == want for st in i_steps),
              f"{phase}: interpreter flash launches per step {i_steps}, "
              f"want {want}")
        _bit_equal(phase, k_loss, i_loss, k_params, scope.find_var)
        fetched = []
        i_profile = _profile_step(
            lambda: fetched.extend(exe.run(
                main, feed=_train_feed(G_STEPS),
                fetch_list=[loss] + list(grads.values()),
                return_numpy=False, compiled=False)),
            ("flash_attention", "matmul"), phase)
        # master weights: every parameter and its gradient float32
        bad = sorted(({str(t.dtype) for t in fetched[1:]}
                      | {str(scope.find_var(p.name).dtype) for p in params})
                     - {"torch.float32"})
        check(not bad, f"{phase}: parameters or gradients in {bad}")
        del fetched

        # the plain path from the same state and feeds, interpreted (its
        # counters tick at each run of the swapped lowering)
        for n in persist:
            scope.set_var(n, init[n].clone())
        with _PlainAttention() as plain:
            p_loss, p_secs, p_steps = _timed_steps(
                run_i, counts, G_STEPS)
        check(all(st == {"fwd": 0, "dq": 0, "dkv": 0} for st in p_steps),
              f"{phase}: the plain path launched flash kernels {p_steps}")
        check(plain.calls == 2 * T_LAYERS * G_STEPS
              and plain.grad_calls == T_LAYERS * G_STEPS,
              f"{phase}: {plain.calls} plain attentions and "
              f"{plain.grad_calls} plain gradients on the plain path")
        param_rel = _param_rel_diff(scope.find_var, init,
                                    {n: k_params[n] for n in weights})
        del init, k_params
    finally:
        executor_mod.switch_scope(prev_scope)
        if exe is not None:
            exe.close()
        del exe
        torch.cuda.empty_cache()
        if amp:
            fluid.amp.disable_bf16()

    diff, lim, unit = _loss_check(phase, k_loss, p_loss, amp)
    p_lim = PARAM_RTOL_BF16 if amp else PARAM_RTOL
    worst = max(param_rel, key=param_rel.get)
    check(param_rel[worst] <= p_lim, f"{phase}: weight {worst} moved "
          f"{param_rel[worst]} apart on the kernel and plain paths")
    tokens = T_BATCH * T_SEQ
    p_an = _param_count(T_VOCAB, T_D, T_LAYERS, T_SEQ)
    step_s = float(np.median(k_secs[2:]))       # the replays
    plain_step_s = float(np.median(p_secs[1:]))
    fc = flash_cases["bf16_causal" if amp else "fp32_causal"]
    attn_ms = sum(fc[kind]["ms"] * want[kind] for kind in want)
    mfu = ({"mfu_6np_bf16": 6.0 * tokens * p_an / step_s
            / peaks[torch.bfloat16]} if amp else
           {"mfu_6np_fp32": 6.0 * tokens * p_an / step_s
            / peaks[torch.float32]})
    emit({"phase": phase, "card": card, "vocab": T_VOCAB, "d_model": T_D,
          "n_heads": T_HEADS, "n_layers": T_LAYERS, "seq": T_SEQ,
          "batch": T_BATCH,
          "dtype": "bf16 amp, f32 master weights" if amp else "float32",
          "optimizer": "momentum", "mode": "compiled (CUDA graph replay)",
          "params": n_params, "params_analytic": p_an,
          "startup_s": startup_s, "steps": G_STEPS,
          "kernel_path": {"losses": k_loss, "step_s": k_secs,
                          "launches_per_step": k_steps,
                          "launches": k_total,
                          "replayed_kernels_per_step":
                              profile["kind_counts"], **graph},
          "interpreter": {"losses": i_loss, "step_s": i_secs,
                          "launches_per_step": i_steps[0],
                          "bit_equal_to_replay": True},
          "plain_path": {"losses": p_loss, "step_s": p_secs,
                         "mode": "interpreted",
                         "plain_attentions": plain.calls,
                         "plain_attention_grads": plain.grad_calls},
          "loss_diff": diff, "loss_limit": lim, "loss_diff_unit": unit,
          "weight_change_rel_diff": {"max": param_rel[worst],
                                     "argmax": worst,
                                     "n_weights": len(param_rel),
                                     "per_weight": param_rel,
                                     "limit": p_lim},
          "ms_per_step": step_s * 1e3,
          **_interpreter_record(i_secs, i_profile),
          "plain_ms_per_step": plain_step_s * 1e3,
          "tokens_per_s": tokens / step_s, **mfu,
          "attention_ms_per_step": attn_ms,
          "attention_share": attn_ms / (step_s * 1e3),
          "profiled_step": profile,
          "device_idle_share": 1.0 - profile["device_ms"] / (step_s * 1e3),
          "peak_memory_bytes": graph["peak_memory_bytes"],
          "peak_reserved_bytes": graph["peak_reserved_bytes"],
          "timing": "host clock around exe.run + synchronize; ms_per_step "
                    "the median of the replayed steps (3..N), the "
                    "interpreter's and the plain path's of steps 2..N; "
                    "attention from the flash phase's cold kernel ms "
                    "(bf16 causal under amp) x launches per step; the "
                    "profiled step (torch.profiler, a replay after the "
                    "timed ones) gives device time by kernel, and the "
                    "idle share is 1 - its device time / the median "
                    "replayed step; peak memory over the default mode's "
                    "steps (allocated, and reserved with the graph's "
                    "pool)"})
    return k_total, profile["kind_counts"]


# -- serve / spec phases -----------------------------------------------------

def _random_states(shapes, seed):
    """Seeded parameters: N(0, 0.02) matrices and embeddings, layer-norm
    scales one, biases and shifts zero."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name in sorted(shapes):
        shp = shapes[name]
        if len(shp) >= 2:
            out[name] = (torch.randn(shp, generator=gen) * 0.02).numpy()
        elif ".scale" in name:
            out[name] = np.ones(shp, np.float32)
        else:
            out[name] = np.zeros(shp, np.float32)
    return out


def _requests(seed):
    r = np.random.RandomState(seed)
    prompts = [r.randint(0, V, int(r.randint(16, 129))).tolist()
               for _ in range(N_REQUESTS)]
    max_news = [int(r.randint(32, 65)) for _ in range(N_REQUESTS)]
    return prompts, max_news


def _serve(srv, prompts, max_news):
    """Half the requests first; the rest arrive once the first tokens
    are out, so admissions land in a running batch."""
    st0 = srv.stats()
    half = len(prompts) // 2
    t0 = time.perf_counter()
    streams = [srv.submit(p, m) for p, m in zip(prompts[:half],
                                                 max_news[:half])]
    while srv.stats()["generated_tokens"] == st0["generated_tokens"]:
        time.sleep(0.0005)
    streams += [srv.submit(p, m) for p, m in zip(prompts[half:],
                                                  max_news[half:])]
    out = [s.result(timeout=600) for s in streams]
    wall = time.perf_counter() - t0
    st = srv.stats()
    ticks = st["ticks"] - st0["ticks"]
    toks = st["generated_tokens"] - st0["generated_tokens"]
    check([len(o) for o in out] == list(max_news), "wrong token counts")
    check(all(0 <= t < V for o in out for t in o), "token out of vocab")
    return out, st, {"wall_s": wall, "ticks": ticks, "tokens": toks,
                     "tokens_per_s": toks / wall,
                     "ms_per_tick": wall / ticks * 1e3}


def _agreement(a, b):
    pairs = [(x, y) for oa, ob in zip(a, b) for x, y in zip(oa, ob)]
    return sum(x == y for x, y in pairs) / len(pairs)


def serve_phases(card, place):
    from paddle_tpu_torch.core import framework as fw
    from paddle_tpu_torch.core.flags import get_flag, set_flags
    from paddle_tpu_torch.kernels.paged_attention import paged_attention
    from paddle_tpu_torch.models.transformer import build_lm_paged_decoder
    from paddle_tpu_torch.serving import (save_generation_model,
                                          server_from_model_dir)

    fw.reset_unique_names()
    _, dec = build_lm_paged_decoder(V, BLOCK, MAX_BLOCKS, d_model=D_MODEL,
                                    n_heads=N_HEADS, n_layers=N_LAYERS,
                                    d_inner=D_INNER, place=place)
    states = _random_states(dec.state_shapes, SEED)
    n_params = sum(int(np.prod(s)) for s in dec.state_shapes.values())
    spec = {"vocab_size": V, "d_model": D_MODEL, "n_heads": N_HEADS,
            "n_layers": N_LAYERS, "d_inner": D_INNER, "block_size": BLOCK,
            "max_blocks_per_seq": MAX_BLOCKS, "slots": SLOTS,
            "kv_blocks": KV_BLOCKS}
    prompts, max_news = _requests(SEED + 1)
    solo_ids = (0, N_REQUESTS - 1)
    kw = {"slots": SLOTS, "kv_blocks": KV_BLOCKS, "place": place}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        model_dir = save_generation_model(os.path.join(tmp, "lm"), states,
                                          spec)
        spec_dir = save_generation_model(
            os.path.join(tmp, "lm_spec"), states,
            dict(spec, spec_k=3, draft={"d_model": D_MODEL,
                                        "n_heads": N_HEADS,
                                        "n_layers": N_LAYERS,
                                        "d_inner": D_INNER}),
            draft_states=states)

        # the plain path (kernel tier off) gives the reference tokens
        plain = {}
        mode = get_flag("serving_kernels")
        set_flags({"serving_kernels": "off"})
        try:
            for kv in KV_DTYPES:
                srv = server_from_model_dir(model_dir, kv_dtype=kv, **kw)
                try:
                    picked = srv.stats()["decode_kernel"]
                    check(picked == "plain:disarmed",
                          f"plain server picked {picked}")
                    plain[kv] = _serve(srv, prompts, max_news)
                finally:
                    srv.close()
        finally:
            set_flags({"serving_kernels": mode})

        # the main path: counts zeroed just before, read just after
        paged_attention.launches = 0
        serve, steps = {}, 0
        for kv in KV_DTYPES:
            srv = server_from_model_dir(model_dir, kv_dtype=kv, **kw)
            try:
                picked = srv.stats()["decode_kernel"]
                check(picked == "cuda", f"kernel server picked {picked}")
                out, st, perf = _serve(srv, prompts, max_news)
                solo = [srv.generate(prompts[i], max_news[i], timeout=600)
                        for i in solo_ids]
                end = srv.stats()
                check(end["kv_blocks_free"] == KV_BLOCKS,
                      f"{kv}: pool did not drain back")
                steps += end["ticks"] + 1          # + the warmup step
            finally:
                srv.close()
            check(all(solo[j] == out[i] for j, i in enumerate(solo_ids)),
                  f"{kv}: batched tokens differ from solo")
            agree = _agreement(out, plain[kv][0])
            floor = 0.99 if kv == "fp32" else 0.9
            check(agree >= floor,
                  f"{kv}: kernel/plain greedy agreement {agree} < {floor}")
            serve[kv] = {"agreement_vs_plain": agree, "kernel_path": perf,
                         "plain_path": plain[kv][2],
                         "kv_blocks_free": st["kv_blocks_free"],
                         "decode_kernel": st["decode_kernel"],
                         "warmup": {k: st[k] for k in (
                             "warmup_s", "compiles", "cache_hits")}}
            serve[kv]["out"] = out
        serve_launches = paged_attention.launches
        check(serve_launches == N_LAYERS * steps,
              f"serve: {serve_launches} launches for {steps} decode steps "
              f"of {N_LAYERS} layers")
        emit({"phase": "serve", "card": card, "params": n_params,
              "vocab": V, "d_model": D_MODEL, "n_heads": N_HEADS,
              "n_layers": N_LAYERS, "context": BLOCK * MAX_BLOCKS,
              "slots": SLOTS, "kv_blocks": KV_BLOCKS,
              "requests": N_REQUESTS, "solo_checked": list(solo_ids),
              "paged_attention_launches": serve_launches,
              "decode_steps": steps,
              "by_kv_dtype": {kv: {k: v for k, v in r.items() if k != "out"}
                              for kv, r in serve.items()}})

        paged_attention.launches = 0
        srv = server_from_model_dir(spec_dir, **kw)
        try:
            check(srv.stats()["spec_k"] == 3, "spec model dir armed no draft")
            out, st, perf = _serve(srv, prompts, max_news)
        finally:
            srv.close()
        spec_launches = paged_attention.launches
        accept = st["draft_accepted"] / max(st["draft_proposed"], 1)
        check(st["draft_proposed"] > 0, "spec: nothing proposed")
        check(accept == 1.0, f"spec: accept rate {accept} with a perfect "
              "draft")
        check(out == serve["fp32"]["out"],
              "spec: tokens differ from greedy decode")
        check(spec_launches > 0, "spec phase launched no kernel")
        emit({"phase": "spec", "card": card, "spec_k": 3,
              "accept_rate": accept, "draft_proposed": st["draft_proposed"],
              "paged_attention_launches": spec_launches, **perf})
    return serve_launches + spec_launches


# -- dp / fused_update phases ------------------------------------------------

def dp_phase(card, place, peaks):
    """The data-parallel path at the train phase's width, under bf16 amp
    (f32 master weights, so every bucket is f32).  The optimizer
    is plain SGD (lr 0.01): ParallelExecutor._plan_fused_update fuses
    only a chain of plain dense `sgd` ops (Momentum or Adam keep the
    per-op chain, as in the JAX package), and this phase drives the
    fused update.  One card: a single-rank NCCL group, so every bucket's
    all-reduce is issued and waited on, and reduces nothing.  The chain
    run swaps the fused update for the per-op sgd chain in this script
    (`_PerOpChain`)."""
    import torch.distributed as dist

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core.flags import get_flag
    from paddle_tpu_torch.kernels.fused_update import fused_bucket_sgd_

    fluid.amp.enable_bf16()     # before the Program is built
    main, startup, loss = _lm_program(fluid.SGD(learning_rate=0.01))
    params = main.global_block().all_parameters()
    weights = [p.name for p in params if len(p.shape) == 2]
    persist = [v.name for v in main.list_vars() if v.persistable]
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    pe = None
    try:
        t = fluid.ShardingTranspiler()
        t.transpile(program=main, startup_program=startup, mesh={"dp": 1},
                    overlap="bucketed")
        t0 = time.perf_counter()
        pe = t.build_executor(["ids", "lbl"], [loss], place=place)
        torch.cuda.synchronize()
        startup_s = time.perf_counter() - t0
        info = dict(pe.overlap_info)
        check(info["mode"] == "bucketed" and info["update"] == "fused",
              f"dp: overlap_info {info}")
        init = {n: pe.state(n, return_numpy=False) for n in persist}
        buckets = info["buckets"]
        # a bucket holds at most overlap_bucket_bytes unless one
        # gradient is larger: then it is that gradient alone, so the
        # largest bucket is the largest parameter
        largest = max(int(np.prod(p.shape)) for p in params)
        check(4 * largest > get_flag("overlap_bucket_bytes"),
              "dp: the largest parameter fits a bucket with others")

        # the main path: counts zeroed just before, read just after
        fused_bucket_sgd_.launches = 0
        _reset_peak()
        run = lambda step: pe.run(_train_feed(step))[0]  # noqa: E731
        counts = {"fused": lambda: fused_bucket_sgd_.launches,
                  "grad_all_reduce":
                  lambda: pe.collective_calls["grad_all_reduce"]}
        k_loss, k_secs, k_steps = _timed_steps(run, counts)
        peak = torch.cuda.max_memory_allocated()
        k_params = {n: pe.state(n, return_numpy=False) for n in weights}
        before = fused_bucket_sgd_.launches
        profile = _profile_step(lambda: pe.run(_train_feed(T_STEPS)),
                                ("fused_update", "flash_attention",
                                 "matmul"), "dp")
        k_total = fused_bucket_sgd_.launches
        check(k_total - before == buckets,
              f"dp: {k_total - before} fused launches in the profiled step")
        # in place: every weight is still a view of its bucket's buffer
        in_place = all(pe._in_bucket(pe._states[n]) for n in weights)
        check(in_place, "dp: a weight is no view of its bucket's flat "
              "buffer after the fused steps")
        # every bucket holds its parameters' f32, and a gradient of
        # another dtype raises in the overlap step (`_bucket_grad`)
        dtypes = {str(pe.state(p.name, return_numpy=False).dtype)
                  for p in params} | {str(b[0][2]) for b in pe._plan[0]}
        check(dtypes == {"torch.float32", "float32"},
              f"dp: parameters or buckets in {dtypes}")
        want = {"fused": buckets, "grad_all_reduce": buckets}
        check(all(st == want for st in k_steps),
              f"dp: per-step launches {k_steps}, want {want}")

        # the per-op sgd chain from the same state and feeds
        for n in persist:
            pe.set_state(n, init[n].clone())
        with _PerOpChain(pe) as chain:
            p_loss, p_secs, p_steps = _timed_steps(run, counts)
        check(all(st == {"fused": 0, "grad_all_reduce": buckets}
                  for st in p_steps),
              f"dp: the chain run's per-step launches {p_steps}")
        check(chain.calls == info["grads"] * T_STEPS,
              f"dp: the chain run ran {chain.calls} sgd ops in {T_STEPS} "
              f"steps of {info['grads']} gradients")
        param_rel = _param_rel_diff(
            lambda n: pe.state(n, return_numpy=False), init, k_params)
        del init, k_params
    finally:
        del pe
        dist.destroy_process_group()
        torch.cuda.empty_cache()
        fluid.amp.disable_bf16()

    check(all(np.isfinite(k_loss + p_loss)), f"dp: non-finite losses "
          f"{k_loss} / {p_loss}")
    rel = [abs(a - b) / abs(b) for a, b in zip(k_loss, p_loss)]
    check(max(rel) <= LOSS_RTOL, f"dp: fused/chain losses differ {rel}")
    worst = max(param_rel, key=param_rel.get)
    check(param_rel[worst] <= PARAM_RTOL, f"dp: weight {worst} moved "
          f"{param_rel[worst]} apart on the fused and chain runs")
    tokens = T_BATCH * T_SEQ
    p_an = _param_count(T_VOCAB, T_D, T_LAYERS, T_SEQ)
    step_s = float(np.median(k_secs[1:]))
    emit({"phase": "dp", "card": card, "mesh": {"dp": 1},
          "backend": "nccl", "vocab": T_VOCAB, "d_model": T_D,
          "n_heads": T_HEADS, "n_layers": T_LAYERS, "seq": T_SEQ,
          "batch": T_BATCH, "dtype": "bf16 amp, f32 master weights",
          "optimizer": "sgd", "overlap_info": info, "largest_bucket_numel": largest,
          "fused_in_place": in_place,
          "copies_ms": profile["by_group_ms"].get("copy", 0.0),
          "startup_s": startup_s, "steps": T_STEPS,
          "fused_run": {"losses": k_loss, "step_s": k_secs,
                        "launches_per_step": k_steps[0],
                        "fused_launches": k_total},
          "chain_run": {"losses": p_loss, "step_s": p_secs,
                        "sgd_ops": chain.calls,
                        "launches_per_step": p_steps[0]},
          "loss_rel_diff": rel, "loss_rtol": LOSS_RTOL,
          "weight_change_rel_diff": {"max": param_rel[worst],
                                     "argmax": worst,
                                     "n_weights": len(param_rel),
                                     "limit": PARAM_RTOL},
          "ms_per_step": step_s * 1e3,
          "chain_ms_per_step": float(np.median(p_secs[1:])) * 1e3,
          "tokens_per_s": tokens / step_s,
          "mfu_6np_bf16": 6.0 * tokens * p_an / step_s
          / peaks[torch.bfloat16],
          "profiled_step": profile,
          "device_idle_share": 1.0 - profile["device_ms"] / (step_s * 1e3),
          "peak_memory_bytes": peak,
          "timing": "host clock around pe.run + synchronize; median of "
                    "steps 2..N; the profiled step (torch.profiler, one "
                    "step after the timed ones) gives device time by "
                    "kernel group"})
    return k_total, largest


def fused_update_phase(dev, bw, flops, largest):
    """The fused bucket SGD kernel against its plain version on the dp
    path's largest bucket and odd sizes: in place, as the dp path calls
    it, bit for bit, lr a device scalar.  Times: the kernel, the plain
    version (two PyTorch kernels into a new tensor), and
    torch.add(p, g, alpha=-lr) and p.add_(g, alpha=-lr) with a host lr
    (one kernel each; yardsticks only, they round once)."""
    from paddle_tpu_torch.kernels.fused_update import (
        fused_bucket_sgd_, fused_bucket_sgd_reference)

    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    lr_host = 0.01
    lr = torch.tensor([lr_host], device=dev)
    cases = {}
    for name, n in (("largest_bucket", largest), ("n1", 1),
                    ("n1023", 1023), ("n1048583", (1 << 20) + 7)):
        p = torch.randn(n, generator=gen, device=dev)
        g = torch.randn(n, generator=gen, device=dev)
        ref = fused_bucket_sgd_reference(p, g, lr)
        lib = torch.add(p, g, alpha=-lr_host)
        q = p.clone()
        got = fused_bucket_sgd_(q, g, lr)
        torch.cuda.synchronize()
        check(got is q and torch.equal(q, ref),
              f"fused_update {name}: the in-place update is not "
              "bit-identical to the plain version")
        nbytes, n_ops = 12 * n, 2 * n
        t_bytes, t_ops = nbytes / bw * 1e3, n_ops / flops * 1e3
        res = {
            "numel": n,
            "max_abs_err": float((q - ref).abs().max()),
            "library_max_abs_err": float((lib - ref).abs().max()),
            "plain_ms": cold_ms(
                lambda: fused_bucket_sgd_reference(p, g, lr), 50, flush),
            "library_ms": cold_ms(
                lambda: torch.add(p, g, alpha=-lr_host), 50, flush),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes}
        del q, got, ref, lib
        # the in-place calls last: they move p
        res["ms"] = cold_ms(lambda: fused_bucket_sgd_(p, g, lr), 50, flush)
        res["library_in_place_ms"] = cold_ms(
            lambda: p.add_(g, alpha=-lr_host), 50, flush)
        res["bytes_per_s"] = nbytes / (res["ms"] * 1e-3)
        cases[name] = res
        del p, g
    emit({"phase": "fused_update", "kernel": "fused_bucket_sgd",
          "timing": "median of cold-L2 calls, CUDA events; library = "
                    "torch.add(p, g, alpha=-lr), library_in_place = "
                    "p.add_(g, alpha=-lr), with a host lr",
          "cases": cases})
    return cases


# -- moe_kernel / moe phases -------------------------------------------------

def _tol_err(got, want, tol):
    err = float((got - want).abs().max())
    return err, tol * max(1.0, float(want.abs().max()))


def _moe_bytes(t_n, d, e_n, c_n, top_k, dense):
    """Bytes the forward must move: x and gate_w read once; expert_in,
    the routing (probs, idx, slot_of, slot_token, slot_weight,
    first_count) and aux written once; the dense combine when asked."""
    n = (t_n * d + d * e_n + e_n * c_n * d + t_n * e_n + 2 * top_k * t_n
         + 2 * e_n * c_n + e_n + 1)
    return 4 * (n + (t_n * e_n * c_n if dense else 0))


def moe_kernel_phase(dev, bw, flops):
    from paddle_tpu_torch.kernels.moe_dispatch import (
        moe_gate_dispatch, moe_gate_dispatch_reference, moe_gate_route,
        moe_gate_route_backward, moe_gate_route_launch,
        moe_gate_route_reference, moe_gate_route_vjp,
        moe_route_backward_launch, moe_routing_reference)
    from paddle_tpu_torch.parallel.moe import _capacity

    t_n, d, e_n = M_BATCH * M_SEQ, M_D, M_EXPERTS
    # 1 GiB: its memset (about 0.4 ms) outlasts the host's ~0.1 ms of
    # Python a call, so the card never waits on the host between a cold
    # call's events and the events time the kernels
    flush = torch.empty(256 * 2 ** 20, dtype=torch.int32, device=dev)
    flush_l2 = flush[:64 * 2 ** 20]   # for device times: L2 is 50 MB
    gen = torch.Generator().manual_seed(SEED)
    x = torch.randn((t_n, d), generator=gen).to(dev)
    gw = (torch.randn((d, e_n), generator=gen) * M_GATE_STD).to(dev)
    cases = {}
    for name, top_k, cf in (("top2", 2, M_CF), ("top1", 1, M_CF),
                            ("top2_cf0.5", 2, 0.5)):
        c_n = _capacity(t_n, e_n, cf, top_k)
        errs = {}
        # the routing form and the dense contract against their plain
        # versions, and each against a second call (bit for bit)
        runs = [moe_gate_route_launch(x, gw, e_n, c_n, top_k, dense=dense)
                for dense in (False, False, True, True)]
        (ei, sw, aux, slot_of, slot_token, probs, idx, first,
         _) = runs[0]
        ei_r, sw_r, aux_r, slot_of_r, slot_token_r = \
            moe_gate_route_reference(x, gw, e_n, c_n, top_k)
        _, idx_r, _ = moe_routing_reference(x, gw, e_n, c_n, top_k)
        _, cb_r, _ = moe_gate_dispatch_reference(x, gw, e_n, c_n, top_k)
        torch.cuda.synchronize()
        check(torch.equal(idx, idx_r), f"moe_kernel {name}: experts differ "
              f"for {int((idx != idx_r).any(0).sum())} tokens")
        check(torch.equal(slot_of, slot_of_r) and torch.equal(
            slot_token, slot_token_r), f"moe_kernel {name}: capacity "
            "slots differ")
        check(torch.equal(ei, ei_r), f"moe_kernel {name}: expert_in is not "
              "bit-equal")
        for key, got, want in (("slot_weight", sw, sw_r), ("aux", aux, aux_r),
                               ("combine", runs[2][8], cb_r)):
            err, lim = _tol_err(got, want, 1e-6)
            check(err <= lim, f"moe_kernel {name} {key}: {err} > {lim}")
            errs[key] = err
        for other in runs[1:]:
            check(all(torch.equal(a, b) for a, b in zip(runs[0][:8],
                                                        other[:8])),
                  f"moe_kernel {name}: two calls differ")
        check(torch.equal(runs[2][8], runs[3][8]),
              f"moe_kernel {name}: two dense combines differ")
        kept = int((slot_token >= 0).sum())
        del runs, cb_r

        # the backward kernel against the plain VJP at the kernel's
        # routing, twice (bit for bit); the Functions' gradients (routing
        # form and dense contract) against plain autograd
        cots = [torch.randn(s, generator=gen).to(dev)
                for s in (ei.shape, sw.shape, aux.shape)]
        bwd = [moe_gate_route_backward(x, gw, probs, idx, slot_of, first,
                                       *cots, capacity=c_n)
               for _ in range(2)]
        want = moe_gate_route_vjp(x, gw, probs, idx, slot_of, *cots)
        for key, g, g2, w in zip(("bwd_dx", "bwd_dgate_w"), bwd[0], bwd[1],
                                 want):
            err, lim = _tol_err(g, w, 1e-5)
            check(err <= lim, f"moe_kernel {name} {key}: {err} > {lim}")
            check(torch.equal(g, g2), f"moe_kernel {name} {key}: two calls "
                  "differ")
            errs[key] = err
        del bwd, want
        for form, fn, ref, shapes in (
                ("route", moe_gate_route, moe_gate_route_reference,
                 (ei.shape, sw.shape, aux.shape)),
                ("dense", moe_gate_dispatch, moe_gate_dispatch_reference,
                 (ei.shape, (t_n, e_n, c_n), aux.shape))):
            fcots = [torch.randn(s, generator=gen).to(dev) for s in shapes]
            leaves = [t.clone().requires_grad_(True) for t in (x, gw)]
            got = torch.autograd.grad(fn(*leaves, e_n, c_n, top_k)[:3],
                                      leaves, fcots)
            ref_leaves = [t.clone().requires_grad_(True) for t in (x, gw)]
            want = torch.autograd.grad(ref(*ref_leaves, e_n, c_n, top_k)[:3],
                                       ref_leaves, fcots)
            for key, g, w in zip(("dx", "dgate_w"), got, want):
                err, lim = _tol_err(g, w, 1e-5)
                check(err <= lim, f"moe_kernel {name} {form} {key}: "
                      f"{err} > {lim}")
                errs[f"{form}_{key}"] = err
            if form == "dense":   # the Function's whole backward
                outs = fn(*leaves, e_n, c_n, top_k)
                dense_bwd_ms = cold_ms(lambda: torch.autograd.grad(
                    outs, leaves, fcots, retain_graph=True), 10, flush)
                del outs
            del fcots, leaves, ref_leaves, got, want

        # times: CUDA events around the entry point (host time included
        # where the host is slower than the card) and the kernels' own
        # device time (torch.profiler)
        def route():
            return moe_gate_route(x, gw, e_n, c_n, top_k)

        def dense():
            return moe_gate_dispatch(x, gw, e_n, c_n, top_k)

        def backward():
            return moe_route_backward_launch(gw, probs, idx, slot_of, first,
                                             *cots, c_n, d)

        with torch.no_grad():
            forms = {}
            for form, fn, plain, is_dense in (
                    ("route", route, lambda: moe_gate_route_reference(
                        x, gw, e_n, c_n, top_k), False),
                    ("dense", dense, lambda: moe_gate_dispatch_reference(
                        x, gw, e_n, c_n, top_k), True)):
                nbytes = _moe_bytes(t_n, d, e_n, c_n, top_k, is_dense)
                t_bytes = nbytes / bw * 1e3
                t_ops = 2 * t_n * d * e_n / flops * 1e3
                dev_ms = [device_ms(fn, 30, flush_l2, k)[0]
                          for k in ("route_kernel<", "place_kernel(")]
                forms[form] = {
                    "ms": cold_ms(fn, 50, flush),
                    "host_us": host_us(fn, 200),
                    "device_ms": sum(dev_ms),
                    "device_ms_route_place": dev_ms,
                    "plain_ms": cold_ms(plain, 10, flush),
                    "bound_ms": max(t_bytes, t_ops),
                    "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                    "bytes": nbytes}
            # the backward kernel: the kept d expert_in rows read, the
            # routing and d slot_weight read, dx and d_logits written
            nbytes = 4 * (kept * d + d * e_n + t_n * e_n + 2 * top_k * t_n
                          + e_n + e_n * c_n + 1 + t_n * d + t_n * e_n)
            t_bytes = nbytes / bw * 1e3
            t_ops = 2 * t_n * d * e_n / flops * 1e3
            forms["backward"] = {
                "ms": cold_ms(backward, 50, flush),
                "device_ms": device_ms(backward, 30, flush_l2,
                                       "route_backward_kernel<")[0],
                "plain_ms": cold_ms(lambda: moe_gate_route_vjp(
                    x, gw, probs, idx, slot_of, *cots), 10, flush),
                "function_ms": cold_ms(lambda: moe_gate_route_backward(
                    x, gw, probs, idx, slot_of, first, *cots,
                    capacity=c_n), 50, flush),
                "dense_function_backward_ms": dense_bwd_ms,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bytes": nbytes}
        for f in forms.values():
            f["library_ms"] = None
            f["bytes_per_s"] = f["bytes"] / (f["device_ms"] * 1e-3)
        cases[name] = {"top_k": top_k, "capacity_factor": cf,
                       "capacity": c_n, "assignments": t_n * top_k,
                       "kept": kept, "max_abs_err": errs, **forms}
        del ei, sw, aux, slot_of, slot_token, probs, idx, first, cots
        del ei_r, sw_r, aux_r, slot_of_r, slot_token_r
    emit({"phase": "moe_kernel", "kernel": "moe_gate_dispatch",
          "tokens": t_n, "d_model": d, "experts": e_n,
          "gate_std": M_GATE_STD,
          "timing": "cold L2 (a 1 GiB memset before each call timed "
                    "between events, 256 MB before each profiled one); "
                    "ms: median between CUDA events around the entry point "
                    "(moe_gate_route, moe_gate_dispatch, the backward "
                    "launch); host_us: host time of a call; device_ms: "
                    "the kernels' own durations "
                    "in torch.profiler (route + place for the forward); "
                    "backward function_ms: the kernel plus the dgate_w "
                    "GEMM; dense_function_backward_ms: the dense "
                    "contract's autograd backward; library_ms null: no "
                    "PyTorch call computes gate + capacity dispatch",
          "cases": cases})
    return cases


class _TecWatch:
    """Records every tensor an op makes (through a TorchDispatchMode)
    whose shape is a dense [T, E, C] dispatch or combine: dims T, E, C
    in a row, or dims T and E * C."""

    def __init__(self, t_n, e_n, c_n):
        from torch.utils._python_dispatch import TorchDispatchMode

        watch = self
        self.t_n, self.e_n, self.c_n, self.hits = t_n, e_n, c_n, []

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                for t in torch.utils._pytree.tree_leaves(out):
                    if isinstance(t, torch.Tensor) and watch.dense(t.shape):
                        watch.hits.append([str(func), list(t.shape)])
                return out

        self.mode = Mode()

    def dense(self, shape):
        sh = tuple(shape)
        tec = (self.t_n, self.e_n, self.c_n)
        return ((self.t_n in sh and self.e_n * self.c_n in sh)
                or any(sh[i:i + 3] == tec for i in range(len(sh) - 2)))

    def __enter__(self):
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self.mode.__exit__(*exc)


def moe_phase(card, place, peaks, moe_cases):
    """The run_moe LM under bf16 amp, as run_moe runs it: the attention
    projections and the LM head in bf16, the MoE FFN in float32 (its
    input is the f32 layer-norm output; the MoE kernel takes f32 only
    and raises on bf16)."""
    import torch.utils._pytree  # noqa: F401  (_TecWatch)

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import executor as executor_mod
    from paddle_tpu_torch.core import framework as fw
    from paddle_tpu_torch.core.scope import Scope
    from paddle_tpu_torch.kernels.moe_dispatch import (
        moe_gate_dispatch, moe_gate_route, moe_gate_route_backward)
    from paddle_tpu_torch.models.moe import active_param_count, build_moe_lm
    from paddle_tpu_torch.parallel.moe import _capacity
    from paddle_tpu_torch.parallel.spmd import backward_start_index

    tokens = M_BATCH * M_SEQ
    c_n = _capacity(tokens, M_EXPERTS, M_CF, M_TOPK)
    ec_n = M_EXPERTS * c_n
    fluid.amp.enable_bf16()     # before the Program is built
    fw.reset_unique_names()
    main, startup, loss = build_moe_lm(M_BATCH, M_SEQ, M_VOCAB, M_D,
                                       M_HEADS, M_LAYERS, M_EXPERTS, M_TOPK,
                                       M_CF, aux_weight=M_AUX)
    moe_x = {main.global_block().var(op.input("X")[0]).dtype
             for op in main.global_block().ops if op.type == "moe_ffn"}
    check(moe_x == {"float32"}, f"moe: the MoE FFN takes {moe_x} under amp")
    params = main.global_block().all_parameters()
    n_params = sum(int(np.prod(p.shape)) for p in params)
    weights = [p.name for p in params if len(p.shape) >= 2]
    persist = [v.name for v in main.list_vars() if v.persistable]
    # the for_test clone, cut to its forward; its logits are the cross
    # entropy's input
    test_prog = main.clone(for_test=True)
    blk = test_prog.global_block()
    blk.ops = blk.ops[:backward_start_index(blk)]
    logits_name = next(op.input("Logits")[0] for op in blk.ops
                       if op.type == "softmax_with_cross_entropy")
    prev_scope = executor_mod.switch_scope(Scope())
    exe = None
    try:
        scope = fluid.global_scope()
        exe = fluid.Executor(place, seed=SEED)
        t0 = time.perf_counter()
        exe.run(startup)
        torch.cuda.synchronize()
        startup_s = time.perf_counter() - t0
        init = {n: scope.find_var(n).clone() for n in persist}

        # the main path: counts zeroed just before, read just after
        moe_gate_dispatch.launches = 0
        moe_gate_route_backward.launches = 0
        _reset_peak()
        run = lambda step: exe.run(  # noqa: E731
            main, feed=_train_feed(step), fetch_list=[loss])[0]
        counts = {"moe": lambda: moe_gate_dispatch.launches,
                  "moe_bwd": lambda: moe_gate_route_backward.launches}
        want = {"moe": 2 * M_LAYERS, "moe_bwd": M_LAYERS}
        grads = _grad_names(main)
        k_loss, k_secs, k_steps, k_params, profile, graph = \
            _default_mode_path(
                exe, run, counts, want,
                {"moe": "route_kernel<",
                 "moe_bwd": "route_backward_kernel<"},
                ("moe_dispatch", "moe_backward", "flash_attention",
                 "matmul"), "moe",
                lambda: {n: scope.find_var(n).clone() for n in grads})
        k_bwd = [st["moe_bwd"] for st in k_steps]
        k_steps = [st["moe"] for st in k_steps]
        k_total = moe_gate_dispatch.launches
        k_bwd_total = moe_gate_route_backward.launches
        # the graph and its pool go before the interpreter's runs
        exe.close()
        exe = fluid.Executor(place, seed=SEED)

        # the interpreter from the same state and feeds
        for n in persist:
            scope.set_var(n, init[n].clone())
        run_i = lambda step: exe.run(  # noqa: E731
            main, feed=_train_feed(step), fetch_list=[loss],
            compiled=False)[0]
        i_loss, i_secs, i_steps = _timed_steps(run_i, counts, G_STEPS)
        check(all(st == want for st in i_steps),
              f"moe: interpreter MoE launches per step {i_steps}, want "
              f"{want}")
        _bit_equal("moe", k_loss, i_loss, k_params, scope.find_var)
        fetched = []
        i_profile = _profile_step(
            lambda: fetched.extend(exe.run(
                main, feed=_train_feed(G_STEPS),
                fetch_list=[loss] + list(grads.values()),
                return_numpy=False, compiled=False)),
            ("moe_dispatch", "moe_backward", "flash_attention", "matmul"),
            "moe", gemm_dim=ec_n)
        # the GEMM split needs the aten ops a replay does not dispatch: it
        # is taken from this interpreted step of the kernel path, which
        # must show GEMMs and none with an E*C operand dimension
        split = i_profile["gemm_split"]
        check(split["other_calls"] > 0 and split["with_dim_calls"] == 0,
              f"moe: the kernel path's GEMMs {split['other_calls']} without "
              f"and {split['with_dim_calls']} with an E*C operand "
              f"dimension: {split['shapes_with_dim']}")
        # master weights: every parameter has an f32 gradient
        grad_dtypes = {str(t.dtype) for t in fetched[1:]}
        check(len(grads) == len(params)
              and grad_dtypes == {"torch.float32"},
              f"moe: {len(grads)} gradients for {len(params)} parameters, "
              f"in {grad_dtypes}")
        del fetched
        # the kernel takes float32 only: a bf16 x raises, launching nothing
        dev = exe.device
        x_bf16 = torch.zeros((tokens, M_D), dtype=torch.bfloat16,
                             device=dev)
        gw = torch.zeros((M_D, M_EXPERTS), device=dev)
        n_launched = moe_gate_dispatch.launches
        try:
            moe_gate_route(x_bf16, gw, M_EXPERTS, c_n, M_TOPK)
            raised = False
        except ValueError:
            raised = True
        check(raised and moe_gate_dispatch.launches == n_launched,
              "moe: the MoE kernel took a bf16 x")
        del x_bf16, gw
        # one more kernel-path step watched (interpreted: a replay makes
        # no tensor to watch): no [T, E, C] tensor is made
        with _TecWatch(tokens, M_EXPERTS, c_n) as k_watch:
            run_i(G_STEPS + 1)
        check(not k_watch.hits, "moe: the kernel path made dense [T, E, C] "
              f"tensors: {k_watch.hits[:4]}")

        # the for_test forward from the initial state on both paths
        for n in persist:
            scope.set_var(n, init[n].clone())
        logits_k, = exe.run(test_prog, feed=_train_feed(0),
                            fetch_list=[logits_name], return_numpy=False,
                            compiled=False)
        with _PlainMoe() as plain, _TecWatch(tokens, M_EXPERTS,
                                             c_n) as p_watch:
            logits_p, = exe.run(test_prog, feed=_train_feed(0),
                                fetch_list=[logits_name], return_numpy=False,
                                compiled=False)
        check(plain.calls == M_LAYERS,
              f"moe: {plain.calls} plain MoE FFNs in the for_test forward")
        # the watch's control: the plain composition makes them
        check(len(p_watch.hits) >= M_LAYERS, "moe: the [T, E, C] watch saw "
              f"{len(p_watch.hits)} dense tensors on the plain path")
        check(bool(torch.isfinite(logits_k).all()),
              "moe: non-finite for_test logits")
        logits_rel = float((logits_k - logits_p).abs().max()
                           / logits_p.abs().max())
        logits_ok, logits_lim, logits_rms, logits_rms_lim = _close_bf16(
            logits_k.float(), logits_p.float())
        del logits_k, logits_p

        # the plain path from the same state and feeds, interpreted (its
        # counter ticks at each run of the swapped lowering)
        for n in persist:
            scope.set_var(n, init[n].clone())
        _reset_peak()
        with _PlainMoe() as plain:
            p_loss, p_secs, p_steps = _timed_steps(run_i, counts, G_STEPS)
        p_peak = torch.cuda.max_memory_allocated()
        p_steps = [st["moe"] + st["moe_bwd"] for st in p_steps]
        check(all(st == 0 for st in p_steps),
              f"moe: the plain path launched the MoE kernels {p_steps}")
        check(plain.calls == 2 * M_LAYERS * G_STEPS,
              f"moe: {plain.calls} plain MoE FFNs on the plain path")
        param_rel = _param_rel_diff(scope.find_var, init,
                                    {n: k_params[n] for n in weights})
        with _PlainMoe():
            p_profile = _profile_step(
                lambda: run_i(G_STEPS), ("matmul",), "moe plain",
                gemm_dim=ec_n)
        # the split's control: the plain composition runs such GEMMs
        check(p_profile["gemm_split"]["with_dim_calls"] > 0,
              "moe: the GEMM split saw no E*C operand on the plain path")
        dtypes = {str(scope.find_var(p.name).dtype) for p in params}
        check(dtypes == {"torch.float32"}, f"moe: parameters in {dtypes}")
        del init, k_params
    finally:
        executor_mod.switch_scope(prev_scope)
        if exe is not None:
            exe.close()
        del exe
        torch.cuda.empty_cache()
        fluid.amp.disable_bf16()

    # bf16 logits: the largest error one bf16 ulp of max|plain| and the
    # RMS error 2^-9 of the RMS (the flash phase's bf16 gate; the same
    # comparison on the CPU at a small width is bit-equal: the f32 MoE
    # outputs' summation-order differences vanish in the bf16 residual)
    check(logits_ok, f"moe: for_test logits differ by {logits_rel} of "
          f"max|plain| (limit {logits_lim} absolute, RMS {logits_rms} "
          f"against {logits_rms_lim})")
    diff, lim, unit = _loss_check("moe", k_loss, p_loss, True)
    worst = max(param_rel, key=param_rel.get)
    check(param_rel[worst] <= PARAM_RTOL_BF16, f"moe: weight {worst} moved "
          f"{param_rel[worst]} apart on the kernel and plain paths")
    p_active = active_param_count(M_VOCAB, M_D, M_LAYERS, M_EXPERTS,
                                  M_TOPK, M_SEQ)
    step_s = float(np.median(k_secs[2:]))       # the replays
    p_step_s = float(np.median(p_secs[1:]))
    kern_ms = profile["by_group_ms"].get("moe_dispatch", 0.0)
    bwd_ms = profile["by_group_ms"].get("moe_backward", 0.0)
    emit({"phase": "moe", "card": card, "vocab": M_VOCAB, "d_model": M_D,
          "n_heads": M_HEADS, "n_layers": M_LAYERS, "experts": M_EXPERTS,
          "top_k": M_TOPK, "capacity_factor": M_CF, "capacity": c_n,
          "aux_weight": M_AUX, "seq": M_SEQ, "batch": M_BATCH,
          "dtype": "bf16 amp (MoE FFN float32), f32 master weights",
          "optimizer": "momentum", "params": n_params,
          "params_active": p_active, "startup_s": startup_s,
          "steps": G_STEPS, "mode": "compiled (CUDA graph replay)",
          "kernel_path": {"losses": k_loss, "step_s": k_secs,
                          "launches_per_step": k_steps,
                          "launches": k_total,
                          "backward_launches_per_step": k_bwd,
                          "backward_launches": k_bwd_total,
                          "replayed_kernels_per_step":
                              profile["kind_counts"],
                          "dense_tec_tensors": len(k_watch.hits), **graph},
          "interpreter": {"losses": i_loss, "step_s": i_secs,
                          "launches_per_step": i_steps[0],
                          "bit_equal_to_replay": True},
          **_interpreter_record(i_secs, i_profile),
          "plain_path": {"losses": p_loss, "step_s": p_secs,
                         "mode": "interpreted",
                         "launches_per_step": p_steps,
                         "plain_moe_ffns": plain.calls,
                         "dense_tec_tensors_for_test": len(p_watch.hits),
                         "peak_memory_bytes": p_peak,
                         "tokens_per_s": tokens / p_step_s,
                         "mfu_6np_active_bf16":
                             6.0 * tokens * p_active / p_step_s
                             / peaks[torch.bfloat16],
                         "device_idle_share":
                             1.0 - p_profile["device_ms"] / (p_step_s * 1e3),
                         "profiled_step": p_profile},
          "loss_diff": diff, "loss_limit": lim, "loss_diff_unit": unit,
          "for_test_logits_rel_diff": logits_rel,
          "for_test_logits_rms_err": logits_rms,
          "weight_change_rel_diff": {"max": param_rel[worst],
                                     "argmax": worst,
                                     "n_weights": len(param_rel),
                                     "limit": PARAM_RTOL_BF16},
          "ms_per_step": step_s * 1e3,
          "plain_ms_per_step": p_step_s * 1e3,
          "tokens_per_s": tokens / step_s,
          "mfu_6np_active_bf16": 6.0 * tokens * p_active / step_s
          / peaks[torch.bfloat16],
          "moe_kernel_ms_per_step": kern_ms,
          "moe_backward_kernel_ms_per_step": bwd_ms,
          "moe_kernel_share": (kern_ms + bwd_ms) / (step_s * 1e3),
          "moe_kernel_device_ms_x_launches":
              moe_cases["top2"]["route"]["device_ms"] * 2 * M_LAYERS,
          "profiled_step": profile,
          "device_idle_share": 1.0 - profile["device_ms"] / (step_s * 1e3),
          "peak_memory_bytes": graph["peak_memory_bytes"],
          "peak_reserved_bytes": graph["peak_reserved_bytes"],
          "timing": "host clock around exe.run + synchronize; ms_per_step "
                    "the median of the replayed steps (3..N), the "
                    "interpreter's and the plain path's of steps 2..N; "
                    "the MoE kernels' device time from the profiled "
                    "replay (route + place; the backward kernel); "
                    "gemm_split (of the interpreted kernel-path step and "
                    "the plain path's step): aten mm/bmm/addmm/baddbmm "
                    "device time by whether an operand has an E*C "
                    "dimension (the dense [T, E, C] dispatch/combine "
                    "products and their VJPs)"})
    return k_total, k_bwd_total, profile["kind_counts"]


# -- image phases -------------------------------------------------------------

def _image_program(model, img, classes, dtype):
    """benchmark/run_image.py's training Program (`build`, :42-66) for
    `model` ("resnet<depth>" through resnet_imagenet, or "vgg16_bn_drop")
    -> (main, startup, loss)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import models
    from paddle_tpu_torch.core import framework as fw

    fw.reset_unique_names()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        data = fluid.layers.data(name="img", shape=[3, img, img],
                                 dtype=dtype)
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        if model == "vgg16_bn_drop":
            predict = models.vgg16_bn_drop(data, class_dim=classes)
        else:
            predict = models.resnet_imagenet(data, class_dim=classes,
                                             depth=int(model[len("resnet"):]))
        cost = fluid.layers.cross_entropy(input=predict, label=label)
        avg = fluid.layers.mean(cost)
        fluid.Momentum(learning_rate=0.01, momentum=0.9).minimize(avg)
    return main, startup, avg


def _image_feed(batch, img, classes, dtype):
    """run_image's feed (:76-79): uniform images from RandomState(0) in
    `dtype` (bf16 as a torch tensor: numpy has no bf16) and int32
    labels, the same every step."""
    r = np.random.RandomState(0)
    x = torch.from_numpy(r.rand(batch, 3, img, img).astype(np.float32))
    if dtype == "bfloat16":
        x = x.to(torch.bfloat16)
    return {"img": x,
            "label": r.randint(0, classes, (batch, 1)).astype(np.int32)}


def _conv_net_flops(program, batch):
    """A training step's model FLOPs from the Program's shapes: 2 x the
    multiply-adds of every conv2d (output positions x filter elements)
    and every mul (fc), forward x 3 (the backward's data and weight
    gradients each cost a forward)."""
    blk = program.global_block()
    fwd = 0
    for op in blk.ops:
        if op.type == "conv2d":
            out = blk.var(op.output("Output")[0]).shape
            w = blk.var(op.input("Filter")[0]).shape
            hw = out[1:3] if op.attrs.get("data_format") == "NHWC" \
                else out[2:4]
            fwd += 2 * batch * int(np.prod(w)) * int(np.prod(hw))
        elif op.type == "mul":
            fwd += 2 * batch * int(np.prod(blk.var(op.input("Y")[0]).shape))
    return 3 * fwd


def _persistables(program):
    return [v.name for v in program.list_vars() if v.persistable]


def resnet50_phase(card, place, peaks):
    """run_image's ResNet-50, bf16, batch 128, 224x224: G_STEPS steps in
    the Executor's default mode (one compiled block: eager at the miss,
    captured into a CUDA graph at the first hit, replayed after) and a
    profiled replay, then the same steps from the same state
    interpreted (bit for bit the replay's losses, parameters, velocities
    and running statistics), then the default mode again with
    conv_layout=NHWC."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import executor as executor_mod
    from paddle_tpu_torch.core.flags import set_flags
    from paddle_tpu_torch.core.scope import Scope

    phase = "resnet50"
    main, startup, loss = _image_program(f"resnet{R_DEPTH}", R_IMG,
                                         R_CLASSES, "bfloat16")
    blk = main.global_block()
    params = blk.all_parameters()
    check(all(p.dtype == "bfloat16" for p in params),
          f"{phase}: a parameter is not bf16")
    types = [op.type for op in blk.ops]
    persist = _persistables(main)
    flops = _conv_net_flops(main, R_BATCH)
    feed = _image_feed(R_BATCH, R_IMG, R_CLASSES, "bfloat16")
    need = ("conv_fwd", "conv_dgrad", "conv_wgrad", "pooling")
    prev_scope = executor_mod.switch_scope(Scope())
    exe = None
    try:
        scope = fluid.global_scope()
        exe = fluid.Executor(place, seed=SEED)
        t0 = time.perf_counter()
        exe.run(startup)
        torch.cuda.synchronize()
        startup_s = time.perf_counter() - t0
        init = {n: scope.find_var(n).clone() for n in persist}
        snapshot = lambda: {n: scope.find_var(n).clone()  # noqa: E731
                            for n in persist}

        _reset_peak()
        run = lambda step: exe.run(  # noqa: E731
            main, feed=feed, fetch_list=[loss])[0]
        k_loss, k_secs, _, k_state, profile, graph = _default_mode_path(
            exe, run, {}, {}, {}, need, phase, snapshot)
        exe.close()

        # the interpreter from the same state and feeds
        exe = fluid.Executor(place, seed=SEED)
        for n in persist:
            scope.set_var(n, init[n].clone())
        run_i = lambda step: exe.run(  # noqa: E731
            main, feed=feed, fetch_list=[loss], compiled=False)[0]
        i_loss, i_secs, _ = _timed_steps(run_i, {}, G_STEPS)
        _bit_equal(phase, k_loss, i_loss, k_state, scope.find_var)
        i_profile = _profile_step(lambda: run_i(G_STEPS), need, phase)
        del k_state
        exe.close()

        # the default mode again, the convolutions channels-last
        set_flags({"conv_layout": "NHWC"})
        exe = fluid.Executor(place, seed=SEED)
        for n in persist:
            scope.set_var(n, init[n].clone())
        _reset_peak()
        run_n = lambda step: exe.run(  # noqa: E731
            main, feed=feed, fetch_list=[loss])[0]
        n_loss, n_secs, _ = _timed_steps(run_n, {}, G_STEPS)
        n_peak = torch.cuda.max_memory_allocated()
        n_profile = _profile_step(lambda: run_n(G_STEPS), need, phase)
        del init
    finally:
        set_flags({"conv_layout": ""})
        executor_mod.switch_scope(prev_scope)
        if exe is not None:
            exe.close()
        del exe
        torch.cuda.empty_cache()

    check(all(np.isfinite(k_loss + n_loss)), f"{phase}: non-finite losses "
          f"{k_loss} / {n_loss}")
    check(abs(n_loss[0] - k_loss[0]) <= _bf16_ulp(k_loss[0]),
          f"{phase}: the first NHWC loss {n_loss[0]} is more than one bf16 "
          f"ulp from the NCHW one {k_loss[0]}")
    step_s = float(np.median(k_secs[2:]))       # the replays
    i_step_s = float(np.median(i_secs[1:]))
    n_step_s = float(np.median(n_secs[2:]))
    step_ms = step_s * 1e3
    bound_ms = flops / peaks[torch.bfloat16] * 1e3
    emit({"phase": phase, "card": card, "model": f"resnet{R_DEPTH}",
          "source": "benchmark/run_image.py:42-66 (resnet50, defaults "
                    "224x224, 1000 classes, batch 128, --dtype bfloat16)",
          "image": R_IMG, "classes": R_CLASSES, "batch": R_BATCH,
          "dtype": "bfloat16 throughout (image, parameters, velocities)",
          "optimizer": "momentum", "mode": "compiled (CUDA graph replay)",
          "ops": len(types), "conv2d_ops": types.count("conv2d"),
          "batch_norm_ops": types.count("batch_norm"),
          "params": sum(int(np.prod(p.shape)) for p in params
                        if p.trainable),
          "startup_s": startup_s, "steps": G_STEPS,
          "default_mode": {"losses": k_loss, "step_s": k_secs, **graph},
          "interpreter": {"losses": i_loss, "step_s": i_secs,
                          "bit_equal_to_replay": True},
          "ms_per_step": step_ms, "images_per_s": R_BATCH / step_s,
          "interpreted_ms_per_step": i_step_s * 1e3,
          "interpreted_images_per_s": R_BATCH / i_step_s,
          "interpreted_device_idle_share":
              1.0 - i_profile["device_ms"] / (i_step_s * 1e3),
          "interpreted_profiled_step": i_profile,
          "model_flops_per_step": flops,
          "model_flops_share_of_bf16_peak": bound_ms / step_ms,
          "bound_ms": bound_ms, "bound_by": "operations",
          "profiled_step": profile,
          "device_ms_by_group": profile["by_group_ms"],
          "device_idle_share": 1.0 - profile["device_ms"] / step_ms,
          "peak_memory_bytes": graph["peak_memory_bytes"],
          "peak_reserved_bytes": graph["peak_reserved_bytes"],
          "capture_s": graph["capture_s"],
          "conv_layout_nhwc": {
              "losses": n_loss, "step_s": n_secs,
              "ms_per_step": n_step_s * 1e3,
              "images_per_s": R_BATCH / n_step_s,
              "device_ms_by_group": n_profile["by_group_ms"],
              "device_idle_share":
                  1.0 - n_profile["device_ms"] / (n_step_s * 1e3),
              "peak_memory_bytes": n_peak,
              "top_kernels_ms": n_profile["top_kernels_ms"]},
          "groups": "conv_fwd/conv_dgrad/conv_wgrad: cuDNN's kernels by "
                    "pass (fprop, dgrad, wgrad in the name); pooling; "
                    "layout: cuDNN's NCHW<->NHWC transposes; copy: "
                    "memcpy/memset (the state write-back); matmul: the "
                    "fc; other: batch norm, relu, the residual adds, the "
                    "loss and Momentum (elementwise and reductions)",
          "timing": "host clock around exe.run + synchronize; ms_per_step "
                    "the median of the replayed steps (3..N), the "
                    "interpreter's of steps 2..N; device time by group "
                    "from one profiled step (torch.profiler); idle share "
                    "1 - its device time / the median step; "
                    "model FLOPs from the Program's conv2d and mul shapes "
                    "(forward x 3) over the bf16 dense peak"})


def resnet_card_vs_cpu_phase(card, place):
    """ResNet-18 at 64x64, batch 8, float32: C_STEPS steps on the CPU,
    then on the card from the same startup weights, with the caller's
    cuDNN TF32 switch ON (the conv lowering must pin float32 itself):
    losses and every state within CARD_CPU_RTOL.  The CPU tests hold
    the CPU path to the JAX package; this ties the cuDNN route to it."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import executor as executor_mod
    from paddle_tpu_torch.core.scope import (Scope, scope_from_numpy,
                                             scope_to_numpy)

    phase = "resnet_card_vs_cpu"
    main, startup, loss = _image_program(f"resnet{C_DEPTH}", C_IMG,
                                         C_CLASSES, "float32")
    persist = _persistables(main)
    feed = _image_feed(C_BATCH, C_IMG, C_CLASSES, "float32")
    prev_scope = executor_mod.switch_scope(Scope())
    tf32 = torch.backends.cudnn.allow_tf32
    exe = None
    try:
        cpu = fluid.Executor(fluid.CPUPlace(), seed=SEED)
        cpu.run(startup)
        init = scope_to_numpy(fluid.global_scope(), persist)
        t0 = time.perf_counter()
        cpu_loss = [float(cpu.run(main, feed=feed, fetch_list=[loss])[0][0])
                    for _ in range(C_STEPS)]
        cpu_s = time.perf_counter() - t0
        cpu_state = scope_to_numpy(fluid.global_scope(), persist)

        executor_mod.switch_scope(Scope())
        scope_from_numpy(init, place, fluid.global_scope())
        torch.backends.cudnn.allow_tf32 = True
        exe = fluid.Executor(place, seed=SEED)
        card_loss = [float(exe.run(main, feed=feed, fetch_list=[loss])[0][0])
                     for _ in range(C_STEPS)]
        card_state = scope_to_numpy(fluid.global_scope(), persist)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
        executor_mod.switch_scope(prev_scope)
        if exe is not None:
            exe.close()
        del exe

    loss_rel = [abs(a - b) / abs(b) for a, b in zip(card_loss, cpu_loss)]
    check(all(np.isfinite(card_loss)) and max(loss_rel) <= CARD_CPU_RTOL,
          f"{phase}: card losses {card_loss} against the CPU's {cpu_loss}")
    rel = {n: float(np.abs(card_state[n] - cpu_state[n]).max()
                    / max(1.0, float(np.abs(cpu_state[n]).max())))
           for n in persist}
    worst = max(rel, key=rel.get)
    check(rel[worst] <= CARD_CPU_RTOL, f"{phase}: states differ by more "
          f"than {CARD_CPU_RTOL} of max(1, |CPU|) between the card and the "
          f"CPU: {sorted(rel.items(), key=lambda kv: -kv[1])[:5]}; losses "
          f"{card_loss} / {cpu_loss}")
    emit({"phase": phase, "card": card, "model": f"resnet{C_DEPTH}",
          "image": C_IMG, "classes": C_CLASSES, "batch": C_BATCH,
          "dtype": "float32", "steps": C_STEPS,
          "cudnn_allow_tf32_during_card_run": True,
          "card_losses": card_loss, "cpu_losses": cpu_loss,
          "loss_rel_diff": loss_rel, "states": len(persist),
          "state_max_rel_diff": rel[worst], "state_argmax": worst,
          "limit": CARD_CPU_RTOL, "cpu_s": cpu_s})


def vgg_segmented_phase(card, place):
    """The book's VGG-16 with batch norm and dropout at the CIFAR-10
    width, float32, batch 128, G_STEPS steps in the default mode: its
    dropout ops draw from per-run seeded generators, so on the card the
    block runs segmented (each dropout eagerly between captured device
    segments).  Then the interpreter from the same state, with the same
    executor seed and step count (so the same draws): the same losses
    and the same keep rate."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import executor as executor_mod
    from paddle_tpu_torch.core.scope import Scope

    phase = "vgg_segmented"
    main, startup, loss = _image_program("vgg16_bn_drop", V_IMG, V_CLASSES,
                                         "float32")
    blk = main.global_block()
    drops = [op for op in blk.ops if op.type == "dropout"]
    mask, prob = drops[0].output("Mask")[0], drops[0].attrs["dropout_prob"]
    persist = _persistables(main)
    feed = _image_feed(V_BATCH, V_IMG, V_CLASSES, "float32")
    prev_scope = executor_mod.switch_scope(Scope())
    exe = None
    runs = {}
    try:
        scope = fluid.global_scope()
        init = None
        for mode in ("segmented", "interpreted"):
            exe = fluid.Executor(place, seed=SEED)
            exe.run(startup)    # both executors count the same steps
            if init is None:
                init = {n: scope.find_var(n).clone() for n in persist}
            for n in persist:
                scope.set_var(n, init[n].clone())
            compiled = None if mode == "segmented" else False
            losses, keeps, secs = [], [], []
            s0, g0 = exe.cache_stats(), exe.graph_stats()
            for _ in range(G_STEPS):
                t0 = time.perf_counter()
                out, m = exe.run(main, feed=feed, fetch_list=[loss, mask],
                                 compiled=compiled)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
                losses.append(float(out[0]))
                keeps.append(float(m.mean()))
            s1, g1 = exe.cache_stats(), exe.graph_stats()
            runs[mode] = {"losses": losses, "keep_rates": keeps,
                          "step_s": secs,
                          "cache": {k: s1[k] - s0[k] for k in
                                    ("hits", "misses", "entries")},
                          "graphs": {k: g1[k] - g0[k] for k in
                                     ("captures", "replays")}}
            if mode == "segmented":
                segs = exe._segments(blk, exe._fingerprint(main))
            exe.close()
        del init
    finally:
        executor_mod.switch_scope(prev_scope)
        if exe is not None:
            exe.close()
        del exe
        torch.cuda.empty_cache()

    host = [op.type for h, ops, _ in segs if h for op in ops]
    n_device = sum(1 for h, _, _ in segs if not h)
    check(host == ["dropout"] * len(drops) and n_device == len(drops) + 1,
          f"{phase}: host segments run {host}, {n_device} device segments "
          f"for {len(drops)} dropout ops")
    seg = runs["segmented"]
    check(seg["graphs"]["captures"] == n_device
          and seg["cache"]["misses"] == n_device,
          f"{phase}: {seg['graphs']} and {seg['cache']} for {n_device} "
          "device segments")
    check(all(np.isfinite(seg["losses"])), f"{phase}: non-finite losses "
          f"{seg['losses']}")
    check(seg["losses"] == runs["interpreted"]["losses"]
          and seg["keep_rates"] == runs["interpreted"]["keep_rates"],
          f"{phase}: segmented {seg['losses']} / {seg['keep_rates']} "
          f"against interpreted {runs['interpreted']}")
    n_mask = V_BATCH * 64 * V_IMG * V_IMG
    sigma = float(np.sqrt(prob * (1 - prob) / (n_mask * G_STEPS)))
    keep = float(np.mean(seg["keep_rates"]))
    check(abs(keep - (1 - prob)) <= 4 * sigma, f"{phase}: keep rate {keep} "
          f"for dropout_prob {prob} (sigma {sigma})")
    step_s = float(np.median(seg["step_s"][2:]))
    i_step_s = float(np.median(runs["interpreted"]["step_s"][1:]))
    emit({"phase": phase, "card": card, "model": "vgg16_bn_drop",
          "source": "paddle_tpu/models/vgg.py:28 (the book's CIFAR-10 "
                    "model)", "image": V_IMG, "classes": V_CLASSES,
          "batch": V_BATCH, "dtype": "float32", "optimizer": "momentum",
          "dropout_ops": len(drops), "device_segments": n_device,
          "host_segments": len(host), **runs,
          "first_dropout_prob": prob, "keep_rate": keep,
          "keep_rate_sigma": sigma,
          "ms_per_step": step_s * 1e3, "images_per_s": V_BATCH / step_s,
          "interpreted_ms_per_step": i_step_s * 1e3,
          "timing": "host clock around exe.run + synchronize, the fetch "
                    "of the first dropout's mask included; ms_per_step "
                    "the median of the replayed steps (3..N), the "
                    "interpreter's of steps 2..N"})


_REPLAY_NOTE = ("launches: the wrappers' count over the main path, which "
                "runs them at the Executor's eager first step and at the "
                "capture; a replay runs the captured kernels without the "
                "wrapper: replayed_per_step is the profiler's count in a "
                "replayed step")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import paddle_tpu_torch  # noqa: F401  (fails outside the repo)
    from paddle_tpu_torch.kernels import cuda_build
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import fused_update as fu
    from paddle_tpu_torch.kernels import moe_dispatch as md
    from paddle_tpu_torch.kernels import paged_attention as pa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    bw, peaks = card_peaks(name)
    flops = peaks[torch.float32]
    card = {"name": name, "nvidia_smi": smi}
    emit({"phase": "env", "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "card": card, "peak_bytes_per_s": bw, "peak_fp32_flops": flops,
          "peak_bf16_tensor_flops": peaks[torch.bfloat16],
          "peak_tf32_tensor_flops": peaks["tf32"]})

    t0 = time.perf_counter()
    cuda_build.build_all()
    for mod in (pa, fa, fu, md):
        mod.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "counts": cuda_build.build_counts(),
          "ptxas": {src: _ptxas_summary(cuda_build.build_log(src))
                    for src in (pa.SOURCE, fa.SOURCE, fu.SOURCE,
                                md.SOURCE)}})

    cases = kernels_phase(dev, bw, flops)
    flash_cases = flash_phase(dev, bw, peaks)
    grads_flash, _ = grads_phase(dev)
    from paddle_tpu_torch import CUDAPlace

    # the main path runs bf16 amp, the reference cells' mode
    flash_launches, flash_replayed = train_phase(
        card, CUDAPlace(0), peaks, flash_cases, amp=True)
    fp32_launches, _ = train_phase(card, CUDAPlace(0), peaks, flash_cases,
                                   amp=False)
    launches = serve_phases(card, CUDAPlace(0))
    fused_launches, largest = dp_phase(card, CUDAPlace(0), peaks)
    fused_cases = fused_update_phase(dev, bw, flops, largest)
    moe_cases = moe_kernel_phase(dev, bw, flops)
    moe_launches, moe_bwd_launches, moe_replayed = moe_phase(
        card, CUDAPlace(0), peaks, moe_cases)
    resnet50_phase(card, CUDAPlace(0), peaks)
    resnet_card_vs_cpu_phase(card, CUDAPlace(0))
    vgg_segmented_phase(card, CUDAPlace(0))

    main_case = cases["fp32_w1"]    # the decode step's case
    entry = {"name": "paged_attention_decode", "route": "cuda",
             "source": "paddle_tpu_torch/kernels/csrc/paged_attention.cu",
             "replaces": "paddle_tpu/kernels/paged_attention.py:90",
             "launches": launches,
             "max_abs_err": max(c["max_abs_err"] for c in cases.values()),
             **{k: main_case[k] for k in ("ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms",
                                          "device_ms", "splits", "ctas")},
             "case": "fp32_w1", "cases": cases}
    entries = [entry]
    src = "paddle_tpu_torch/kernels/csrc/flash_attention.cu"
    main_case = flash_cases["bf16_causal"]      # the amp train path's
    for kind, kname, line, err_keys in (
            ("fwd", "flash_attention_fwd", 63, ("fwd", "lse")),
            ("dq", "flash_attention_bwd_dq", 188, ("dq",)),
            ("dkv", "flash_attention_bwd_dkv", 239, ("dk", "dv"))):
        # SDPA computes the forward alone, but dQ, dK and dV only
        # together: the backward rows carry it, against dq + dkv
        sdpa_keys = (("sdpa_fwd_ms", "fwd_over_sdpa_fwd") if kind == "fwd"
                     else ("sdpa_bwd_ms", "bwd_ms", "bwd_over_sdpa_bwd"))
        per_case = {n: dict(c[kind], max_abs_err=max(
            c["max_abs_err"][e] for e in err_keys),
            peak_flops=c["peak_flops"], **{k: c[k] for k in sdpa_keys})
            for n, c in flash_cases.items()}
        lib = ({"library_ms": main_case["sdpa_fwd_ms"]} if kind == "fwd"
               else {"library_ms": None,
                     "library_bwd_ms": main_case["sdpa_bwd_ms"],
                     "bwd_ms": main_case["bwd_ms"]})
        entries.append({
            "name": kname, "route": "cuda", "source": src,
            "replaces": f"paddle_tpu/kernels/flash_attention.py:{line}",
            "launches": flash_launches[kind],
            "replayed_per_step": flash_replayed[kind],
            "launches_note": _REPLAY_NOTE,
            "launches_train_fp32": fp32_launches[kind],
            "max_abs_err": per_case["bf16_causal"]["max_abs_err"],
            **{k: main_case[kind][k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by")},
            **lib, "case": "bf16_causal", "cases": per_case,
            "grad_op": grads_flash})
    main_case = fused_cases["largest_bucket"]
    entries.append({
        "name": "fused_bucket_sgd", "route": "cuda",
        "source": "paddle_tpu_torch/kernels/csrc/fused_update.cu",
        "replaces": "paddle_tpu/kernels/fused_update.py:58",
        "launches": fused_launches,
        "max_abs_err": max(c["max_abs_err"] for c in fused_cases.values()),
        **{k: main_case[k] for k in ("ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms")},
        "case": "largest_bucket", "cases": fused_cases})
    main_case = moe_cases["top2"]
    keys = ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    entries.append({
        "name": "moe_gate_dispatch", "route": "cuda",
        "source": "paddle_tpu_torch/kernels/csrc/moe_dispatch.cu",
        "replaces": "paddle_tpu/kernels/moe_dispatch.py:68",
        "launches": moe_launches,
        "replayed_per_step": moe_replayed["moe"],
        "launches_note": _REPLAY_NOTE,
        "max_abs_err": max(c["max_abs_err"][k] for c in moe_cases.values()
                           for k in ("slot_weight", "combine", "aux")),
        **{k: main_case["route"][k] for k in keys},
        "form": "routing (the main path's); dense: the JAX contract",
        "dense": {k: main_case["dense"][k] for k in keys},
        "library_note": "no PyTorch call computes gate + capacity dispatch",
        "case": "top2", "cases": moe_cases})
    entries.append({
        "name": "moe_gate_dispatch_backward", "route": "cuda",
        "source": "paddle_tpu_torch/kernels/csrc/moe_dispatch.cu",
        "replaces": "paddle_tpu/parallel/moe.py:48",
        "replaces_note": "no TPU kernel: the JAX package takes this "
                         "gradient by jax.vjp of moe_gate and the dispatch "
                         "einsum (its Pallas kernel has no VJP)",
        "launches": moe_bwd_launches,
        "replayed_per_step": moe_replayed["moe_bwd"],
        "launches_note": _REPLAY_NOTE,
        "max_abs_err": max(c["max_abs_err"][k] for c in moe_cases.values()
                           for k in ("bwd_dx", "bwd_dgate_w")),
        **{k: main_case["backward"][k] for k in keys},
        "function_ms": main_case["backward"]["function_ms"],
        "dense_function_backward_ms":
            main_case["backward"]["dense_function_backward_ms"],
        "library_note": "no PyTorch call computes this gradient",
        "case": "top2"})
    emit({"kernels": entries})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
