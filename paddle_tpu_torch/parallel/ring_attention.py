"""Ring attention and Ulysses attention: sequence parallelism over a
mesh axis.

Counterpart of paddle_tpu/parallel/ring_attention.py.  In ring attention
each rank keeps its query block and the key/value blocks travel round
the ring (`ppermute`, one hop a step), each step's partial result merged
into a streaming softmax, flash style: memory O(seq / n) a rank.
`all_to_all_attention` (the DeepSpeed-Ulysses layout) swaps the split
from the sequence to the heads with one all_to_all, runs full-sequence
attention on its heads, and swaps back.

The tile is composed in PyTorch, as the JAX package's is an XLA einsum
(its [b, h, blk, blk] scores materialise): putting the flash kernels in
it needs an (out, lse) partial with the lse cotangent carried through
the merge.  Every function here is differentiable with torch autograd:
the collectives are parallel/collective.py's `ppermute`, `all_to_all`,
`scatter_to` and `gather_from`, each with its conjugate backward.
"""
from __future__ import annotations

import torch

from .collective import all_to_all, gather_from, ppermute, scatter_to

__all__ = ["ring_attention", "ring_attention_local",
           "all_to_all_attention", "attention_reference"]


def _block_attn(q, k, v, scale, causal, q_off, kv_off):
    """One (q block, kv block) tile -> (unnormalised out [b, q, h, d],
    running max [b, h, q], running denominator [b, h, q]), in float32.
    A row with every key masked gets max 0 and denominator 0."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        qi = q_off + torch.arange(q.shape[1], device=q.device)[:, None]
        ki = kv_off + torch.arange(k.shape[1], device=q.device)[None, :]
        s = torch.where(qi >= ki, s, float("-inf"))
    m = s.amax(dim=-1)
    # guard fully masked rows
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m_safe[..., None])
    p = torch.where(torch.isfinite(s), p, torch.zeros_like(p))
    denom = p.sum(dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out, m_safe, denom


def _merge(acc, new):
    """Merge two streaming-softmax partials (the flash combine)."""
    out_a, m_a, d_a = acc
    out_n, m_n, d_n = new
    m = torch.maximum(m_a, m_n)
    ca = torch.exp(m_a - m)
    cn = torch.exp(m_n - m)
    out = (out_a * ca.transpose(1, 2)[..., None]
           + out_n * cn.transpose(1, 2)[..., None])
    return out, m, d_a * ca + d_n * cn


def ring_attention_local(q_blk, k_blk, v_blk, group, causal: bool = False,
                         scale: float = None):
    """The ring body on this rank's LOCAL [batch, seq/n, heads, dim]
    blocks over `group` (the axis's `AxisGroup`, size n): n tiles, the K/V
    blocks shifted one rank along the ring between tiles, causal
    offsets from this rank's index.  Used by `ring_attention` and by the
    flash_attention op when a PipelineExecutor stage runs with
    sequence parallelism."""
    n = group.size
    scale = scale if scale is not None else q_blk.shape[-1] ** -0.5
    blk, kv_blk = q_blk.shape[1], k_blk.shape[1]
    idx = group.index if n > 1 else 0
    q_off = idx * blk
    mvec = q_blk[..., 0].transpose(1, 2).float()           # [b, h, blk]
    acc = (torch.zeros(q_blk.shape, dtype=torch.float32,
                       device=q_blk.device),
           torch.full_like(mvec, float("-inf")), torch.zeros_like(mvec))
    k_cur, v_cur, src = k_blk, v_blk, idx
    for i in range(n):
        acc = _merge(acc, _block_attn(q_blk, k_cur, v_cur, scale, causal,
                                      q_off, src * kv_blk))
        if i < n - 1:
            # kv to the next ring position; the last tile needs none
            k_cur = ppermute(k_cur, group, 1)
            v_cur = ppermute(v_cur, group, 1)
        src = (src - 1) % n
    out, _, denom = acc
    out = out / torch.clamp(denom, min=1e-20).transpose(1, 2)[..., None]
    return out.to(q_blk.dtype)


def ring_attention(q, k, v, mesh, axis: str = "sp", causal: bool = False,
                   scale: float = None):
    """Attention with the sequence split over `axis`.  q/k/v: the GLOBAL
    [batch, seq, heads, dim] tensors on every rank; returns the global
    output on every rank (each rank computes its block, and the blocks
    are all-gathered)."""
    g = mesh.axis_group(axis)
    if q.shape[1] % g.size:
        raise ValueError(f"seq length {q.shape[1]} must divide the "
                         f"{axis!r} axis size {g.size}")
    qb, kb, vb = (scatter_to(t, g, 1) for t in (q, k, v))
    return gather_from(ring_attention_local(qb, kb, vb, g, causal=causal,
                                            scale=scale), g, 1)


def all_to_all_attention(q, k, v, mesh, axis: str = "sp",
                         causal: bool = False, scale: float = None):
    """Ulysses: all_to_all swaps the split from the sequence to the
    heads, full-sequence attention on each rank's heads, and the swap
    back.  Global tensors in and out, as `ring_attention`."""
    g = mesh.axis_group(axis)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if q.shape[2] % g.size or q.shape[1] % g.size:
        raise ValueError(f"heads {q.shape[2]} and seq {q.shape[1]} must "
                         f"divide the {axis!r} axis size {g.size}")
    # [b, s/n, h, d] -> [b, s, h/n, d]
    qh, kh, vh = (all_to_all(scatter_to(t, g, 1), g, 2, 1)
                  for t in (q, k, v))
    out, _, denom = _block_attn(qh, kh, vh, scale, causal, 0, 0)
    out = out / torch.clamp(denom, min=1e-20).transpose(1, 2)[..., None]
    return gather_from(all_to_all(out.to(q.dtype), g, 1, 2), g, 1)


def attention_reference(q, k, v, causal=False, scale=None):
    """Single-device reference (kernels.flash_attention_reference, the
    one oracle of the package)."""
    from ..kernels.flash_attention import flash_attention_reference

    return flash_attention_reference(q, k, v, causal=causal, scale=scale)
