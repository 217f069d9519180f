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
           against its plain version, with the kernel's, the plain
           version's and a library composition's (gather +
           scaled_dot_product_attention) times beside the bound;
  flash    the flash-attention forward, dQ and dK/dV kernels at the
           training shape [8, 512, 16, 128] (causal fp32, causal bf16,
           non-causal fp32), each against its plain version, with the
           kernel's, the plain version's and scaled_dot_product_attention's
           (forward against the forward kernel; backward against dQ +
           dK/dV; in every case) times
           beside the bound (float32 over TF32/3, the rate of float32-
           accurate 3xTF32 products, with the scalar-fp32 bound beside
           it; bf16 over the bf16 tensor peak);
  train    the transformer LM of benchmark/run_ridge.py at its full
           width (vocab 30000, d_model 2048, 16 heads, 12 layers, seq
           512, batch 8; fp32, Momentum) built as a Fluid Program and
           trained by the interpreter Executor from one seeded startup:
           4 timed steps and one profiled step on the kernel path, then
           4 from the same state on the plain path (the op's lowering
           swapped for the plain composition inside this script):
           per-step losses and every weight matrix's change compared;
  serve    the full-width LM of benchmark/run_generation.py (vocab
           32000, d_model 512, 8 heads, 6 layers, d_inner 2048) with
           seeded random weights, written as a model dir and served
           through server_from_model_dir (8 slots, 256 KV blocks):
           16 staggered requests per kv_dtype on the plain path and on
           the kernel path, batched-vs-solo bit identity, pool drain;
  spec     the same model as its own draft (spec_k 3, the W=4 kernel):
           accept rate 1.0 and the plain greedy tokens;
  dp       the train phase's LM with plain SGD, trained data-parallel
           through ShardingTranspiler(mesh={"dp": 1}, overlap=
           "bucketed") and ParallelExecutor over a single-rank NCCL
           group: bucketed gradient all-reduces and the fused bucket
           update kernel, then the per-op sgd chain from the same state;
  fused_update  the fused bucket SGD kernel against its plain version
           (bit for bit) on the dp path's largest bucket and odd sizes;
  moe_kernel  the MoE gate + dispatch kernel against its plain version
           at the MoE LM's shape (T 4096, D 1024, E 8): top-2, top-1 and
           an overflowing capacity; routing, expert_in, combine, aux and
           the autograd Function's gradients;
  moe      the MoE transformer LM of benchmark/run_moe.py at its
           defaults (vocab 30000, d_model 1024, 8 heads, 6 layers, 8
           experts, top-2, capacity factor 1.25, seq 512, batch 8; fp32,
           Momentum) trained by the interpreter Executor: the kernel
           path, then the plain path from the same state, and the
           for_test clone's forward on both.

The main paths are the train phase's kernel path (flash attention), the
kernel-path serve and spec phases (paged attention), the dp phase's
fused run (fused bucket update) and the moe phase's kernel path (MoE
gate + dispatch): each kernel's launch counts are zeroed just before
its path and read just after.
Any failed check raises, and the script exits non-zero.  The last line is
the device record {"ok": true, "device": {...}}.  With no CUDA device,
or without the package beside it, it exits non-zero and prints no
result.
"""
from __future__ import annotations

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
# kernel path vs plain path: per-step loss, and each weight matrix's
# change over the steps (||dW_kernel - dW_plain|| / ||dW_plain||).  At
# random init the attention is near uniform, so dS = P (dP - delta) is a
# difference of near-equal terms and the Q/K projections' updates differ
# by up to ~1e-3 from float32 summation order alone; a miswired backward
# (dK and dV swapped, a scale dropped) moves them by order one
LOSS_RTOL, PARAM_RTOL = 1e-5, 1e-2
FLASH_SHAPE = (T_BATCH, T_SEQ, T_HEADS, T_D // T_HEADS)

# the MoE configuration: benchmark/run_moe.py's defaults
M_VOCAB, M_D, M_HEADS, M_LAYERS, M_SEQ, M_BATCH = 30000, 1024, 8, 6, 512, 8
M_EXPERTS, M_TOPK, M_CF, M_AUX = 8, 2, 1.25, 0.01
# the moe_kernel phase's router: N(0, 0.05), about the spread of the
# LM's Xavier-initialised [1024, 8] gate weights
M_GATE_STD = 0.05


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
                r"([a-z]+_kernel)I(f|13__nv_bfloat16)Li(\d+)E", name)
            if short:
                dt = "f32" if short.group(2) == "f" else "bf16"
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
            ms = cold_ms(lambda: paged_attention(*args, n_heads=N_HEADS),
                         200, flush)
            plain_ms = cold_ms(
                lambda: paged_attention_reference(*args, n_heads=N_HEADS),
                50, flush)
            library_ms = cold_ms(lambda: _library_attention(*args), 50, flush)
            cases[f"{kv_dtype}_w{w_n}"] = {
                "max_abs_err": err, "tol": tol, "library_max_abs_err": lib_err,
                "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                "bound_ms": bound, "bound_by": bound_by, "bytes": nbytes,
                "bytes_per_s": nbytes / (ms * 1e-3)}
    emit({"phase": "kernels", "kernel": "paged_attention_decode",
          "slots": SLOTS, "context": BLOCK * MAX_BLOCKS, "d_model": D_MODEL,
          "n_heads": N_HEADS, "layer": layer,
          "timing": "median of cold-L2 calls, CUDA events",
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


def _timed_steps(run_step, counts):
    """T_STEPS steps of `run_step(step)` (-> the loss) -> (losses, step
    seconds, per step {name: how much counts[name]() grew})."""
    losses, secs, per_step = [], [], []
    for step in range(T_STEPS):
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


def _kernel_group(name):
    low = name.lower()
    if "gemm" in low or "cublas" in low or "cutlass" in low:
        return "matmul"
    if any(k in name for k in ("fwd_kernel<", "dq_kernel<", "dkv_kernel<")):
        return "flash_attention"
    if any(k in name for k in ("route_kernel", "position_kernel",
                               "write_kernel")):
        return "moe_dispatch"
    if "fused_sgd_kernel" in name:
        return "fused_update"
    if "memcpy" in low or "memset" in low:
        return "copy"
    return "other"


def _profile_step(run_step, need, phase):
    """`run_step()` (one more kernel-path step) under torch.profiler ->
    device time by kernel group and the top kernels (self device time,
    ms); every group in `need` must show."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run_step()
        torch.cuda.synchronize()
    kernels = {}   # device-side events only: host ops would count twice
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA and ev.self_device_time_total:
            kernels[ev.key] = ev.self_device_time_total / 1e3
    groups = {}
    for name, ms in kernels.items():
        g = _kernel_group(name)
        groups[g] = groups.get(g, 0.0) + ms
    for g in need:
        check(groups.get(g, 0.0) > 0,
              f"{phase}: the profile shows no {g} kernel: {groups}")
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ms": sum(kernels.values()), "by_group_ms": groups,
            "top_kernels_ms": [[n[:120], ms] for n, ms in top]}


class _PlainAttention:
    """The `flash_attention` op's lowering swapped for the plain
    composition while the block runs (the package itself has one path on
    the card); `calls` counts the forward and recomputed-forward runs."""

    def __enter__(self):
        from paddle_tpu_torch.core.registry import get_op_info

        self.info = get_op_info("flash_attention")
        self.lower, self.calls = self.info.lower, 0
        self.info.lower = self._plain
        return self

    def __exit__(self, *exc):
        self.info.lower = self.lower

    def _plain(self, ctx, ins, attrs):
        from paddle_tpu_torch.core.execution import one
        from paddle_tpu_torch.kernels.flash_attention import (
            flash_attention_reference)

        self.calls += 1
        scale = None if attrs.get("default_scale", True) else attrs["scale"]
        return {"Out": flash_attention_reference(
            one(ins, "Q"), one(ins, "K"), one(ins, "V"),
            causal=bool(attrs.get("causal", False)), scale=scale)}


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


def train_phase(card, place, flops, flash_cases):
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import executor as executor_mod
    from paddle_tpu_torch.core.scope import Scope
    from paddle_tpu_torch.kernels.flash_attention import flash_attention

    main, startup, loss = _lm_program(
        fluid.Momentum(learning_rate=0.01, momentum=0.9))
    params = main.global_block().all_parameters()
    n_params = sum(int(np.prod(p.shape)) for p in params)
    weights = [p.name for p in params if len(p.shape) == 2]
    persist = [v.name for v in main.list_vars() if v.persistable]
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
        launches = flash_attention.launches
        for key in launches:
            launches[key] = 0
        torch.cuda.reset_peak_memory_stats()
        run = lambda step: exe.run(  # noqa: E731
            main, feed=_train_feed(step), fetch_list=[loss])[0]
        counts = {k: (lambda k=k: launches[k]) for k in launches}
        k_loss, k_secs, k_steps = _timed_steps(run, counts)
        peak = torch.cuda.max_memory_allocated()
        k_params = {n: scope.find_var(n).clone() for n in weights}
        before = dict(launches)
        profile = _profile_step(
            lambda: exe.run(main, feed=_train_feed(T_STEPS),
                            fetch_list=[loss]),
            ("flash_attention",), "train")
        k_steps.append({k: launches[k] - before[k] for k in launches})
        k_total = dict(launches)
        want = {"fwd": 2 * T_LAYERS, "dq": T_LAYERS, "dkv": T_LAYERS}
        check(all(st == want for st in k_steps),
              f"train: flash launches per step {k_steps}, want {want}")

        # the plain path from the same state and feeds
        for n in persist:
            scope.set_var(n, init[n].clone())
        with _PlainAttention() as plain:
            p_loss, p_secs, p_steps = _timed_steps(run, counts)
        check(all(st == {"fwd": 0, "dq": 0, "dkv": 0} for st in p_steps),
              f"train: the plain path launched flash kernels {p_steps}")
        check(plain.calls == 2 * T_LAYERS * T_STEPS,
              f"train: {plain.calls} plain attentions on the plain path")
        param_rel = _param_rel_diff(scope.find_var, init, k_params)
        del init, k_params
    finally:
        executor_mod.switch_scope(prev_scope)
        del exe
        torch.cuda.empty_cache()

    check(all(np.isfinite(k_loss + p_loss)), f"train: non-finite losses "
          f"{k_loss} / {p_loss}")
    rel = [abs(a - b) / abs(b) for a, b in zip(k_loss, p_loss)]
    check(max(rel) <= LOSS_RTOL, f"train: kernel/plain losses differ {rel}")
    worst = max(param_rel, key=param_rel.get)
    check(param_rel[worst] <= PARAM_RTOL, f"train: weight {worst} moved "
          f"{param_rel[worst]} apart on the kernel and plain paths")
    tokens = T_BATCH * T_SEQ
    p_an = _param_count(T_VOCAB, T_D, T_LAYERS, T_SEQ)
    step_s = float(np.median(k_secs[1:]))
    plain_step_s = float(np.median(p_secs[1:]))
    fc = flash_cases["fp32_causal"]
    attn_ms = sum(fc[kind]["ms"] * want[kind] for kind in want)
    emit({"phase": "train", "card": card, "vocab": T_VOCAB, "d_model": T_D,
          "n_heads": T_HEADS, "n_layers": T_LAYERS, "seq": T_SEQ,
          "batch": T_BATCH, "dtype": "float32", "optimizer": "momentum",
          "params": n_params, "params_analytic": p_an,
          "startup_s": startup_s, "steps": T_STEPS,
          "kernel_path": {"losses": k_loss, "step_s": k_secs,
                          "launches_per_step": k_steps[0],
                          "launches": k_total},
          "plain_path": {"losses": p_loss, "step_s": p_secs,
                         "plain_attentions": plain.calls},
          "loss_rel_diff": rel, "loss_rtol": LOSS_RTOL,
          "weight_change_rel_diff": {"max": param_rel[worst],
                                     "argmax": worst,
                                     "n_weights": len(param_rel),
                                     "per_weight": param_rel,
                                     "limit": PARAM_RTOL},
          "ms_per_step": step_s * 1e3,
          "plain_ms_per_step": plain_step_s * 1e3,
          "tokens_per_s": tokens / step_s,
          "mfu_6np_fp32": 6.0 * tokens * p_an / step_s / flops,
          "attention_ms_per_step": attn_ms,
          "attention_share": attn_ms / (step_s * 1e3),
          "profiled_step": profile,
          "device_idle_share": 1.0 - profile["device_ms"] / (step_s * 1e3),
          "peak_memory_bytes": peak,
          "timing": "host clock around exe.run + synchronize; median of "
                    "steps 2..N; attention from the flash phase's cold "
                    "kernel ms x launches per step; the profiled step "
                    "(torch.profiler, one step after the timed ones) "
                    "gives device time by kernel, and the idle share is "
                    "1 - its device time / the median step"})
    return k_total


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

def dp_phase(card, place, flops):
    """The data-parallel path at the train phase's width.  The optimizer
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
    from paddle_tpu_torch.kernels.fused_update import fused_bucket_sgd

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
        init = {n: pe.state(n, return_numpy=False).clone() for n in persist}
        buckets = info["buckets"]
        # a bucket holds at most overlap_bucket_bytes unless one
        # gradient is larger: then it is that gradient alone, so the
        # largest bucket is the largest parameter
        largest = max(int(np.prod(p.shape)) for p in params)
        check(4 * largest > get_flag("overlap_bucket_bytes"),
              "dp: the largest parameter fits a bucket with others")

        # the main path: counts zeroed just before, read just after
        fused_bucket_sgd.launches = 0
        torch.cuda.reset_peak_memory_stats()
        run = lambda step: pe.run(_train_feed(step))[0]  # noqa: E731
        counts = {"fused": lambda: fused_bucket_sgd.launches,
                  "grad_all_reduce":
                  lambda: pe.collective_calls["grad_all_reduce"]}
        k_loss, k_secs, k_steps = _timed_steps(run, counts)
        peak = torch.cuda.max_memory_allocated()
        k_params = {n: pe.state(n, return_numpy=False).clone()
                    for n in weights}
        before = fused_bucket_sgd.launches
        profile = _profile_step(lambda: pe.run(_train_feed(T_STEPS)),
                                ("fused_update", "flash_attention"), "dp")
        k_total = fused_bucket_sgd.launches
        check(k_total - before == buckets,
              f"dp: {k_total - before} fused launches in the profiled step")
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
          "batch": T_BATCH, "dtype": "float32", "optimizer": "sgd",
          "overlap_info": info, "largest_bucket_numel": largest,
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
          "mfu_6np_fp32": 6.0 * tokens * p_an / step_s / flops,
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
    path's largest bucket and odd sizes: bit for bit, lr a device
    scalar.  Times: the kernel, the plain version (two PyTorch kernels)
    and torch.add(p, g, alpha=-lr) with a host lr (one kernel; a
    yardstick only, it rounds once)."""
    from paddle_tpu_torch.kernels.fused_update import (
        fused_bucket_sgd, fused_bucket_sgd_reference)

    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    lr_host = 0.01
    lr = torch.tensor([lr_host], device=dev)
    cases = {}
    for name, n in (("largest_bucket", largest), ("n1", 1),
                    ("n1023", 1023), ("n1048583", (1 << 20) + 7)):
        p = torch.randn(n, generator=gen, device=dev)
        g = torch.randn(n, generator=gen, device=dev)
        out = fused_bucket_sgd(p, g, lr)
        ref = fused_bucket_sgd_reference(p, g, lr)
        lib = torch.add(p, g, alpha=-lr_host)
        torch.cuda.synchronize()
        check(torch.equal(out, ref),
              f"fused_update {name}: not bit-identical to the plain version")
        nbytes, n_ops = 12 * n, 2 * n
        t_bytes, t_ops = nbytes / bw * 1e3, n_ops / flops * 1e3
        ms = cold_ms(lambda: fused_bucket_sgd(p, g, lr), 50, flush)
        cases[name] = {
            "numel": n, "max_abs_err": float((out - ref).abs().max()),
            "library_max_abs_err": float((lib - ref).abs().max()),
            "ms": ms,
            "plain_ms": cold_ms(
                lambda: fused_bucket_sgd_reference(p, g, lr), 50, flush),
            "library_ms": cold_ms(
                lambda: torch.add(p, g, alpha=-lr_host), 50, flush),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "bytes_per_s": nbytes / (ms * 1e-3)}
        del p, g, out, ref, lib
    emit({"phase": "fused_update", "kernel": "fused_bucket_sgd",
          "timing": "median of cold-L2 calls, CUDA events; library = "
                    "torch.add(p, g, alpha=-lr) with a host lr",
          "cases": cases})
    return cases


# -- moe_kernel / moe phases -------------------------------------------------

def _tol_err(got, want, tol):
    err = float((got - want).abs().max())
    return err, tol * max(1.0, float(want.abs().max()))


def moe_kernel_phase(dev, bw, flops):
    from paddle_tpu_torch.kernels.moe_dispatch import (
        moe_gate_dispatch, moe_gate_dispatch_launch,
        moe_gate_dispatch_reference, moe_routing_reference)
    from paddle_tpu_torch.parallel.moe import _capacity

    t_n, d, e_n = M_BATCH * M_SEQ, M_D, M_EXPERTS
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=dev)
    gen = torch.Generator().manual_seed(SEED)
    x = torch.randn((t_n, d), generator=gen).to(dev)
    gw = (torch.randn((d, e_n), generator=gen) * M_GATE_STD).to(dev)
    cases = {}
    for name, top_k, cf in (("top2", 2, M_CF), ("top1", 1, M_CF),
                            ("top2_cf0.5", 2, 0.5)):
        c_n = _capacity(t_n, e_n, cf, top_k)
        ei, cb, aux, _, idx, slots = moe_gate_dispatch_launch(x, gw, e_n,
                                                              c_n, top_k)
        ei_r, cb_r, aux_r = moe_gate_dispatch_reference(x, gw, e_n, c_n,
                                                        top_k)
        _, idx_r, slots_r = moe_routing_reference(x, gw, e_n, c_n, top_k)
        torch.cuda.synchronize()
        check(torch.equal(idx, idx_r), f"moe_kernel {name}: experts differ "
              f"for {int((idx != idx_r).any(0).sum())} tokens")
        check(torch.equal(slots, slots_r),
              f"moe_kernel {name}: capacity slots differ")
        check(torch.equal(ei, ei_r), f"moe_kernel {name}: expert_in is not "
              "bit-equal")
        errs = {}
        for key, got, want in (("combine", cb, cb_r), ("aux", aux, aux_r)):
            err, lim = _tol_err(got, want, 1e-6)
            check(err <= lim, f"moe_kernel {name} {key}: {err} > {lim}")
            errs[key] = err
        kept = int((slots >= 0).sum())

        # the Function's gradients against plain autograd
        cots = [torch.randn(s, generator=gen).to(dev)
                for s in (ei.shape, cb.shape, aux.shape)]
        leaves = [t.clone().requires_grad_(True) for t in (x, gw)]
        outs = moe_gate_dispatch(*leaves, e_n, c_n, top_k)
        got = torch.autograd.grad(outs, leaves, cots, retain_graph=True)
        ref_leaves = [t.clone().requires_grad_(True) for t in (x, gw)]
        want = torch.autograd.grad(
            moe_gate_dispatch_reference(*ref_leaves, e_n, c_n, top_k),
            ref_leaves, cots)
        for key, g, w in zip(("dx", "dgate_w"), got, want):
            err, lim = _tol_err(g, w, 1e-5)
            check(err <= lim, f"moe_kernel {name} {key}: {err} > {lim}")
            errs[key] = err
        bwd_ms = cold_ms(lambda: torch.autograd.grad(
            outs, leaves, cots, retain_graph=True), 10, flush)
        del outs, got, want, leaves, ref_leaves, cots

        nbytes = 4 * (t_n * d + d * e_n + e_n * c_n * d + t_n * e_n * c_n
                      + 1)
        n_ops = 2 * t_n * d * e_n
        t_bytes, t_ops = nbytes / bw * 1e3, n_ops / flops * 1e3
        with torch.no_grad():
            ms = cold_ms(lambda: moe_gate_dispatch(x, gw, e_n, c_n, top_k),
                         50, flush)
            plain_ms = cold_ms(lambda: moe_gate_dispatch_reference(
                x, gw, e_n, c_n, top_k), 10, flush)
        cases[name] = {
            "top_k": top_k, "capacity_factor": cf, "capacity": c_n,
            "assignments": t_n * top_k, "kept": kept,
            "max_abs_err": errs, "ms": ms, "plain_ms": plain_ms,
            "library_ms": None, "backward_ms": bwd_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "bytes_per_s": nbytes / (ms * 1e-3)}
        del ei, cb, aux, ei_r, cb_r, aux_r
    emit({"phase": "moe_kernel", "kernel": "moe_gate_dispatch",
          "tokens": t_n, "d_model": d, "experts": e_n,
          "gate_std": M_GATE_STD,
          "timing": "median of cold-L2 calls, CUDA events; backward_ms is "
                    "the autograd Function's backward (the plain "
                    "composition's VJP at the kernel's saved routing); "
                    "library_ms null: no PyTorch call computes gate + "
                    "capacity dispatch",
          "cases": cases})
    return cases


def moe_phase(card, place, flops, moe_cases):
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import executor as executor_mod
    from paddle_tpu_torch.core import framework as fw
    from paddle_tpu_torch.core.scope import Scope
    from paddle_tpu_torch.kernels.moe_dispatch import moe_gate_dispatch
    from paddle_tpu_torch.models.moe import active_param_count, build_moe_lm
    from paddle_tpu_torch.parallel.spmd import backward_start_index

    fw.reset_unique_names()
    main, startup, loss = build_moe_lm(M_BATCH, M_SEQ, M_VOCAB, M_D,
                                       M_HEADS, M_LAYERS, M_EXPERTS, M_TOPK,
                                       M_CF, aux_weight=M_AUX)
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
        torch.cuda.reset_peak_memory_stats()
        run = lambda step: exe.run(  # noqa: E731
            main, feed=_train_feed(step), fetch_list=[loss])[0]
        counts = {"moe": lambda: moe_gate_dispatch.launches}
        k_loss, k_secs, k_steps = _timed_steps(run, counts)
        k_steps = [st["moe"] for st in k_steps]
        peak = torch.cuda.max_memory_allocated()
        k_params = {n: scope.find_var(n).clone() for n in weights}
        before = moe_gate_dispatch.launches
        profile = _profile_step(
            lambda: exe.run(main, feed=_train_feed(T_STEPS),
                            fetch_list=[loss]),
            ("moe_dispatch", "flash_attention"), "moe")
        k_steps.append(moe_gate_dispatch.launches - before)
        k_total = moe_gate_dispatch.launches
        check(all(st == 2 * M_LAYERS for st in k_steps),
              f"moe: MoE launches per step {k_steps}, want {2 * M_LAYERS}")

        # the for_test forward from the initial state on both paths
        for n in persist:
            scope.set_var(n, init[n].clone())
        logits_k, = exe.run(test_prog, feed=_train_feed(0),
                            fetch_list=[logits_name], return_numpy=False)
        with _PlainMoe() as plain:
            logits_p, = exe.run(test_prog, feed=_train_feed(0),
                                fetch_list=[logits_name], return_numpy=False)
        check(plain.calls == M_LAYERS,
              f"moe: {plain.calls} plain MoE FFNs in the for_test forward")
        check(bool(torch.isfinite(logits_k).all()),
              "moe: non-finite for_test logits")
        logits_rel = float((logits_k - logits_p).abs().max()
                           / logits_p.abs().max())
        del logits_k, logits_p

        # the plain path from the same state and feeds
        for n in persist:
            scope.set_var(n, init[n].clone())
        with _PlainMoe() as plain:
            p_loss, p_secs, p_steps = _timed_steps(run, counts)
        p_steps = [st["moe"] for st in p_steps]
        check(all(st == 0 for st in p_steps),
              f"moe: the plain path launched the MoE kernel {p_steps}")
        check(plain.calls == 2 * M_LAYERS * T_STEPS,
              f"moe: {plain.calls} plain MoE FFNs on the plain path")
        param_rel = _param_rel_diff(scope.find_var, init, k_params)
        del init, k_params
    finally:
        executor_mod.switch_scope(prev_scope)
        del exe
        torch.cuda.empty_cache()

    check(logits_rel <= LOSS_RTOL, f"moe: for_test logits differ "
          f"{logits_rel} relative between the kernel and plain paths")
    check(all(np.isfinite(k_loss + p_loss)), f"moe: non-finite losses "
          f"{k_loss} / {p_loss}")
    rel = [abs(a - b) / abs(b) for a, b in zip(k_loss, p_loss)]
    check(max(rel) <= LOSS_RTOL, f"moe: kernel/plain losses differ {rel}")
    worst = max(param_rel, key=param_rel.get)
    check(param_rel[worst] <= PARAM_RTOL, f"moe: weight {worst} moved "
          f"{param_rel[worst]} apart on the kernel and plain paths")
    tokens = M_BATCH * M_SEQ
    p_active = active_param_count(M_VOCAB, M_D, M_LAYERS, M_EXPERTS,
                                  M_TOPK, M_SEQ)
    step_s = float(np.median(k_secs[1:]))
    kern_ms = profile["by_group_ms"].get("moe_dispatch", 0.0)
    emit({"phase": "moe", "card": card, "vocab": M_VOCAB, "d_model": M_D,
          "n_heads": M_HEADS, "n_layers": M_LAYERS, "experts": M_EXPERTS,
          "top_k": M_TOPK, "capacity_factor": M_CF, "aux_weight": M_AUX,
          "seq": M_SEQ, "batch": M_BATCH, "dtype": "float32",
          "optimizer": "momentum", "params": n_params,
          "params_active": p_active, "startup_s": startup_s,
          "steps": T_STEPS,
          "kernel_path": {"losses": k_loss, "step_s": k_secs,
                          "launches_per_step": k_steps,
                          "launches": k_total},
          "plain_path": {"losses": p_loss, "step_s": p_secs,
                         "launches_per_step": p_steps,
                         "plain_moe_ffns": plain.calls},
          "loss_rel_diff": rel, "loss_rtol": LOSS_RTOL,
          "for_test_logits_rel_diff": logits_rel,
          "weight_change_rel_diff": {"max": param_rel[worst],
                                     "argmax": worst,
                                     "n_weights": len(param_rel),
                                     "limit": PARAM_RTOL},
          "ms_per_step": step_s * 1e3,
          "plain_ms_per_step": float(np.median(p_secs[1:])) * 1e3,
          "tokens_per_s": tokens / step_s,
          "mfu_6np_active_fp32": 6.0 * tokens * p_active / step_s / flops,
          "moe_kernel_ms_per_step": kern_ms,
          "moe_kernel_share": kern_ms / (step_s * 1e3),
          "moe_kernel_cold_ms_x_launches": moe_cases["top2"]["ms"]
          * 2 * M_LAYERS,
          "profiled_step": profile,
          "device_idle_share": 1.0 - profile["device_ms"] / (step_s * 1e3),
          "peak_memory_bytes": peak,
          "timing": "host clock around exe.run + synchronize; median of "
                    "steps 2..N; the MoE kernel's share from the profiled "
                    "step's device time of its three CUDA kernels"})
    return k_total


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
    from paddle_tpu_torch import CUDAPlace

    flash_launches = train_phase(card, CUDAPlace(0), flops, flash_cases)
    launches = serve_phases(card, CUDAPlace(0))
    fused_launches, largest = dp_phase(card, CUDAPlace(0), flops)
    fused_cases = fused_update_phase(dev, bw, flops, largest)
    moe_cases = moe_kernel_phase(dev, bw, flops)
    moe_launches = moe_phase(card, CUDAPlace(0), flops, moe_cases)

    main_case = cases["fp32_w1"]    # the decode step's case
    entry = {"name": "paged_attention_decode", "route": "cuda",
             "source": "paddle_tpu_torch/kernels/csrc/paged_attention.cu",
             "replaces": "paddle_tpu/kernels/paged_attention.py:90",
             "launches": launches,
             "max_abs_err": max(c["max_abs_err"] for c in cases.values()),
             **{k: main_case[k] for k in ("ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms")},
             "case": "fp32_w1", "cases": cases}
    entries = [entry]
    src = "paddle_tpu_torch/kernels/csrc/flash_attention.cu"
    main_case = flash_cases["fp32_causal"]
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
            "max_abs_err": per_case["fp32_causal"]["max_abs_err"],
            **{k: main_case[kind][k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by",
                "bound_ms_fp32_scalar")},
            **lib, "case": "fp32_causal", "cases": per_case})
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
    entries.append({
        "name": "moe_gate_dispatch", "route": "cuda",
        "source": "paddle_tpu_torch/kernels/csrc/moe_dispatch.cu",
        "replaces": "paddle_tpu/kernels/moe_dispatch.py:68",
        "launches": moe_launches,
        "max_abs_err": max(c["max_abs_err"][k] for c in moe_cases.values()
                           for k in ("combine", "aux")),
        **{k: main_case[k] for k in ("ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms")},
        "library_note": "no PyTorch call computes gate + capacity dispatch",
        "case": "top2", "cases": moe_cases})
    emit({"kernels": entries})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
