"""The split-KV paged-attention kernel's arithmetic, modelled on the CPU.

The CUDA kernel (paddle_tpu_torch/kernels/csrc/paged_attention.cu) cuts
each slot's context into runs of `split_len` positions, computes per run
and window row the partial (m, l, acc) — the run's max score, its sum of
exp(score - m) and its unnormalised P.V — and merges the runs in order:
m* = max m_i, l* = sum l_i e^(m_i - m*), o = sum acc_i e^(m_i - m*) / l*.
A slot whose context fits one run takes acc / l directly.  The kernel
runs only on a card; `split_model` below repeats that arithmetic in
plain PyTorch, so the CPU can hold it to `paged_attention_reference` and
to the JAX Pallas kernel in interpret mode (as
tests/test_serving_kernels.py runs it), for fp32/bf16/int8 pools,
windows W in {1, 4}, split lengths 16/64/128, and cursors on, one short
of and one past a split edge, including slots whose context fills one
split exactly.

Tolerance: 1e-5 * max(1, max|reference|), the card's gate: the
dequantization is exact in float32, and only the order of the sums
differs (per-run softmax and merge against one softmax over the row).
"""
import functools

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from paddle_tpu.kernels.paged_attention import build_paged_attention

from paddle_tpu_torch.kernels.paged_attention import (
    _gather, paged_attention_reference, split_len_for)

D, H, BS, NB, LAYERS, POOL = 64, 2, 4, 32, 2, 96
CTX = BS * NB            # 128: 8 / 2 / 1 splits of 16 / 64 / 128
TOL = 1e-5


def _positions(w_n):
    """Cursors whose last visible position (pos + W - 1) sits at the
    start of the context, on a 16-split edge (the context fills one
    split of 16 exactly) and one past it, one short of a 64-split edge,
    on it (fills one split of 64) and one past it, and at the end of the
    context (fills one split of 128)."""
    ends = [1, 16, 17, 63, 64, 65, CTX]
    return np.array([e - w_n for e in ends if e - w_n >= 0], np.int32)


def _inputs(kv_dtype, w_n, seed=0):
    r = np.random.RandomState(seed)
    positions = _positions(w_n)
    s_n = len(positions)
    q = r.standard_normal((s_n, w_n, D)).astype(np.float32)
    tables = np.zeros((s_n, NB), np.int32)          # null-block tails
    perm = r.permutation(np.arange(1, POOL))
    used = 0
    for s, p in enumerate(positions):
        n = -(-(int(p) + w_n) // BS)
        tables[s, :n] = perm[used:used + n]
        used += n
    shape = (LAYERS, POOL, BS, D)
    pools_t, pools_j = [], []
    for _ in range(2):
        if kv_dtype == "int8":
            pay = r.randint(-127, 128, shape).astype(np.int8)
            sc = (r.rand(LAYERS, POOL) * 0.05 + 1e-3).astype(np.float32)
            pools_t.append((torch.from_numpy(pay), torch.from_numpy(sc)))
            pools_j.append((jnp.asarray(pay), jnp.asarray(sc)))
        elif kv_dtype == "bf16":
            t = torch.from_numpy(
                r.standard_normal(shape).astype(np.float32)).bfloat16()
            pools_t.append(t)
            pools_j.append(jnp.asarray(
                t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)))
        else:
            a = r.standard_normal(shape).astype(np.float32)
            pools_t.append(torch.from_numpy(a))
            pools_j.append(jnp.asarray(a))
    return q, tables, positions, pools_t, pools_j


def split_model(q, pool_k, pool_v, tables, positions, layer, *, n_heads,
                split_len):
    """The kernel's split-KV partials and fixed-order merge in float32.
    q [S, W, D] -> [S, W, D]."""
    s_n, w_n, d_model = q.shape
    dh = d_model // n_heads
    ctx_len = tables.shape[1] * BS
    kh = _gather(pool_k, layer, tables).reshape(s_n, ctx_len, n_heads, dh)
    vh = _gather(pool_v, layer, tables).reshape(s_n, ctx_len, n_heads, dh)
    qh = q.reshape(s_n, w_n, n_heads, dh)
    out = torch.empty_like(qh)
    for s in range(s_n):
        pos = int(positions[s])
        n_ctx = min(pos + w_n, ctx_len)
        parts = []
        for start in range(0, n_ctx, split_len):
            j = torch.arange(start, min(start + split_len, n_ctx))
            sc = torch.einsum("whd,jhd->whj", qh[s], kh[s, j]) / np.sqrt(dh)
            keep = j[None, :] <= pos + torch.arange(w_n)[:, None]
            sc = sc.masked_fill(~keep[:, None, :], float("-inf"))
            m = sc.amax(-1)                                    # [W, H]
            e = torch.where(sc == float("-inf"), torch.zeros(()),
                            torch.exp(sc - m[..., None]))
            parts.append((m, e.sum(-1),
                          torch.einsum("whj,jhd->whd", e, vh[s, j])))
        if len(parts) == 1:
            m, l, acc = parts[0]
            out[s] = acc / l[..., None]
            continue
        m_all = torch.stack([m for m, _, _ in parts]).amax(0)
        l_all = torch.zeros_like(m_all)
        o = torch.zeros_like(qh[s])
        for m, l, acc in parts:        # in split order
            f = torch.where(m == float("-inf"), torch.zeros(()),
                            torch.exp(m - m_all))
            l_all = l_all + f * l
            o = o + f[..., None] * acc
        out[s] = o / l_all[..., None]
    return out.reshape(s_n, w_n, d_model)


@functools.lru_cache(maxsize=None)
def _jax_out(kv_dtype, w_n, layer):
    q, tables, positions, _, pools_j = _inputs(kv_dtype, w_n)
    attend = build_paged_attention(d_model=D, n_heads=H, block_size=BS,
                                   max_blocks_per_seq=NB, kv_dtype=kv_dtype,
                                   interpret=True, platform="cpu")
    return np.asarray(attend(jnp.asarray(q), pools_j[0], pools_j[1],
                             jnp.asarray(tables), jnp.asarray(positions),
                             layer))


def _close(got, want, what):
    lim = TOL * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= lim, f"{what}: max_abs_err {err} > {lim}"


@pytest.mark.parametrize("split_len", [16, 64, 128])
@pytest.mark.parametrize("w_n", [1, 4])
@pytest.mark.parametrize("kv_dtype", ["fp32", "bf16", "int8"])
def test_split_model_matches_reference_and_jax_kernel(kv_dtype, w_n,
                                                      split_len):
    q, tables, positions, pools_t, _ = _inputs(kv_dtype, w_n)
    layer = 1
    args = (torch.from_numpy(q), pools_t[0], pools_t[1],
            torch.from_numpy(tables), torch.from_numpy(positions), layer)
    got = split_model(*args, n_heads=H, split_len=split_len).numpy()
    ref = paged_attention_reference(*args, n_heads=H).numpy()
    _close(got, ref, "split model vs paged_attention_reference")
    _close(got, _jax_out(kv_dtype, w_n, layer),
           "split model vs the JAX kernel (interpret)")


def test_split_model_covers_single_and_merged_slots():
    """The cursors reach both branches at every split length: a slot
    whose context fills one split exactly (written directly) and slots
    that merge two or more."""
    for w_n in (1, 4):
        positions = _positions(w_n)
        for split_len in (16, 64, 128):
            n_split = [-(-(int(p) + w_n) // split_len) for p in positions]
            assert 1 in n_split and (split_len == CTX or max(n_split) > 1)
            assert any(int(p) + w_n == split_len for p in positions)


def test_split_length_is_a_shape_choice():
    assert split_len_for(512) == 64
    assert split_len_for(4096) == 64
    assert split_len_for(4097) == 128
    # the serving shape of chip_smoke.py's kernels phase, a 512-position
    # context: 8 splits per (head, slot), so 8 slots x 8 heads launch 512
    # CTAs; its cursors spread over the context leave 288 with work, and
    # 56 (head, slot) pairs with more than one split to merge
    positions = [round(s * (512 - 1) / 7) for s in range(8)]
    per_slot = [-(-(p + 1) // split_len_for(512)) for p in positions]
    assert -(-512 // split_len_for(512)) * 8 * 8 == 512
    assert 8 * sum(per_slot) == 288
    assert 8 * sum(n > 1 for n in per_slot) == 56
