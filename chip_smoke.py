#!/usr/bin/env python3
"""Smoke run of the PyTorch port (paddle_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Drives the port's training and serving paths the way a user would and
holds every hand-written kernel on them to its plain PyTorch version.
Phases, one JSON line each:

  env      torch and CUDA versions, the card's name and power limit;
  build    compiles every csrc/ source with nvcc (in parallel);
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
           (forward; backward) times beside the bound;
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
           accept rate 1.0 and the plain greedy tokens.

The main paths are the train phase's kernel path (flash attention) and
the kernel-path serve and spec phases (paged attention): each kernel's
launch counts are zeroed just before its path and read just after.
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

# published dense peaks (NVIDIA data sheets): HBM bytes/s, fp32 FLOP/s
# outside the tensor cores, bf16 FLOP/s on the tensor cores
_CARD_PEAKS = (("H200", 4.8e12, 67e12, 989e12),
               ("H100 NVL", 3.9e12, 60e12, 835e12),
               ("H100 PCIe", 2.0e12, 51e12, 756e12),
               ("H100", 3.35e12, 67e12, 989e12))

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


class CheckFailed(RuntimeError):
    pass


def check(cond, what):
    if not cond:
        raise CheckFailed(what)


def emit(obj):
    print(json.dumps(obj), flush=True)


def card_peaks(name):
    """-> (bytes/s, {dtype: FLOP/s}) of the card."""
    for key, bw, fp32, bf16 in _CARD_PEAKS:
        if key in name:
            return bw, {torch.float32: fp32, torch.bfloat16: bf16}
    raise CheckFailed(f"no published peaks for card {name!r}")


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
        flops = peaks[dtype]
        res = {"max_abs_err": errs, "rms_err": rms_errs,
               "sdpa_fwd_max_abs_err": lib_err, "peak_flops": flops,
               "sdpa_fwd_ms": cold_ms(lambda: _sdpa(q, k, v, causal), 20,
                                      flush),
               "sdpa_bwd_ms": cold_ms(lib_bwd, 20, flush)}
        res["sdpa_fwd_bwd_ms"] = res["sdpa_fwd_ms"] + res["sdpa_bwd_ms"]
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
            res[kind] = {"ms": ms, "plain_ms": cold_ms(plain, 10, flush),
                         "bound_ms": max(t_ops, t_bytes),
                         "bound_by": ("operations" if t_ops >= t_bytes
                                      else "bytes"),
                         "flop": n_ops, "bytes": n_bytes,
                         "flop_per_s": n_ops / (ms * 1e-3)}
        res["bwd_ms"] = res["dq"]["ms"] + res["dkv"]["ms"]
        del leaves, lib_out
        cases[name] = res
    emit({"phase": "flash", "shape_bshd": list(FLASH_SHAPE),
          "timing": "median of cold-L2 calls, CUDA events; the backward "
                    "kernels take the plain forward's lse and delta; "
                    "bwd_ms = dq + dkv against sdpa_bwd_ms (one call "
                    "computing dQ, dK and dV); bounds over peak_flops, "
                    "the card's peak for the case's dtype",
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


def _train_steps(exe, main, loss, launches):
    """T_STEPS steps -> (losses, step seconds, flash launches per step)."""
    losses, secs, per_step = [], [], []
    for step in range(T_STEPS):
        before = dict(launches)
        t0 = time.perf_counter()
        out, = exe.run(main, feed=_train_feed(step), fetch_list=[loss])
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(out.reshape(-1)[0]))
        per_step.append({k: launches[k] - before[k] for k in launches})
    return losses, secs, per_step


def _kernel_group(name):
    low = name.lower()
    if "gemm" in low or "cublas" in low or "cutlass" in low:
        return "matmul"
    if any(k in name for k in ("fwd_kernel<", "dq_kernel<", "dkv_kernel<")):
        return "flash_attention"
    if "memcpy" in low or "memset" in low:
        return "copy"
    return "other"


def _profile_step(exe, main, loss, step):
    """One more kernel-path step under torch.profiler -> device time by
    kernel group and the top kernels (self device time, ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        exe.run(main, feed=_train_feed(step), fetch_list=[loss])
        torch.cuda.synchronize()
    kernels = {}   # device-side events only: host ops would count twice
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA and ev.self_device_time_total:
            kernels[ev.key] = ev.self_device_time_total / 1e3
    groups = {}
    for name, ms in kernels.items():
        g = _kernel_group(name)
        groups[g] = groups.get(g, 0.0) + ms
    check(groups.get("flash_attention", 0.0) > 0,
          f"train: the profile shows no flash-attention kernel: {groups}")
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


def _param_rel_diff(scope, init, k_params):
    """{name: ||dW_kernel - dW_plain|| / ||dW_plain||} over the weight
    matrices, dW = value after the steps - initial value."""
    out = {}
    for n, k_val in k_params.items():
        d_plain = scope.find_var(n) - init[n]
        d_kern = k_val - init[n]
        out[n] = float((d_kern - d_plain).norm() / d_plain.norm())
    return out


def train_phase(card, place, flops, flash_cases):
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import executor as executor_mod
    from paddle_tpu_torch.core import framework as fw
    from paddle_tpu_torch.core.scope import Scope
    from paddle_tpu_torch.kernels.flash_attention import flash_attention
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
        fluid.Momentum(learning_rate=0.01, momentum=0.9).minimize(loss)
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
        k_loss, k_secs, k_steps = _train_steps(exe, main, loss, launches)
        peak = torch.cuda.max_memory_allocated()
        k_params = {n: scope.find_var(n).clone() for n in weights}
        before = dict(launches)
        profile = _profile_step(exe, main, loss, T_STEPS)
        k_steps.append({k: launches[k] - before[k] for k in launches})
        k_total = dict(launches)
        want = {"fwd": 2 * T_LAYERS, "dq": T_LAYERS, "dkv": T_LAYERS}
        check(all(st == want for st in k_steps),
              f"train: flash launches per step {k_steps}, want {want}")

        # the plain path from the same state and feeds
        for n in persist:
            scope.set_var(n, init[n].clone())
        with _PlainAttention() as plain:
            p_loss, p_secs, p_steps = _train_steps(exe, main, loss, launches)
        check(all(st == {"fwd": 0, "dq": 0, "dkv": 0} for st in p_steps),
              f"train: the plain path launched flash kernels {p_steps}")
        check(plain.calls == 2 * T_LAYERS * T_STEPS,
              f"train: {plain.calls} plain attentions on the plain path")
        param_rel = _param_rel_diff(scope, init, k_params)
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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import paddle_tpu_torch  # noqa: F401  (fails outside the repo)
    from paddle_tpu_torch.kernels import cuda_build
    from paddle_tpu_torch.kernels import flash_attention as fa
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
          "peak_bf16_tensor_flops": peaks[torch.bfloat16]})

    t0 = time.perf_counter()
    cuda_build.build_all()
    pa.build()
    fa.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "counts": cuda_build.build_counts(),
          "ptxas": {src: [ln.strip() for ln in
                          cuda_build.build_log(src).splitlines()
                          if "registers" in ln or "spill" in ln]
                    for src in (pa.SOURCE, fa.SOURCE)}})

    cases = kernels_phase(dev, bw, flops)
    flash_cases = flash_phase(dev, bw, peaks)
    from paddle_tpu_torch import CUDAPlace

    flash_launches = train_phase(card, CUDAPlace(0), flops, flash_cases)
    launches = serve_phases(card, CUDAPlace(0))

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
        per_case = {n: dict(c[kind], max_abs_err=max(
            c["max_abs_err"][e] for e in err_keys),
            peak_flops=c["peak_flops"]) for n, c in flash_cases.items()}
        # SDPA computes the forward alone, but dQ, dK and dV only
        # together: the backward rows carry it once, against dq + dkv
        lib = ({"library_ms": main_case["sdpa_fwd_ms"]} if kind == "fwd"
               else {"library_ms": None,
                     "library_bwd_ms": main_case["sdpa_bwd_ms"],
                     "bwd_ms": main_case["bwd_ms"]})
        entries.append({
            "name": kname, "route": "cuda", "source": src,
            "replaces": f"paddle_tpu/kernels/flash_attention.py:{line}",
            "launches": flash_launches[kind],
            "max_abs_err": per_case["fp32_causal"]["max_abs_err"],
            **{k: main_case[kind][k] for k in ("ms", "plain_ms", "bound_ms",
                                                "bound_by")},
            **lib, "case": "fp32_causal", "cases": per_case})
    emit({"kernels": entries})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
