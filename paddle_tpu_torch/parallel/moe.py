"""Mixture-of-Experts: gating, dispatch and the mesh-free MoE FFN.

Counterpart of paddle_tpu/parallel/moe.py.  `moe_gate` is the one gating
implementation (GShard/Switch dispatch-combine tensors, top-1 or
top-2, static capacity, differentiable through the gate probabilities),
and `moe_dense` the mesh-free MoE FFN the `moe_ffn` op lowers to.  On a
CUDA device gate and dispatch run as one hand-written CUDA kernel
(kernels/moe_dispatch.py, "moe_gate_dispatch"): the same math, with the
dispatch contraction done as a gather.

The expert-parallel forms `moe_ffn` and `moe_ffn_a2a` (replicated
routing over an 'ep' mesh axis, and all_to_all dispatch) are not ported
yet (ROADMAP A9).
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..kernels.registry import Selection

__all__ = ["moe_gate", "moe_dense", "load_balance", "drop_rate"]


def _one_hot(idx, n):
    """float32 one-hot of int indices; an index outside [0, n) gives a
    zero row (as jax.nn.one_hot)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def moe_gate(x, gate_w, num_experts: int, capacity: int, top_k: int = 1):
    """Top-1 (Switch) or top-2 (GShard) gating.  x: [T, D]; gate_w: [D, E].

    Returns (dispatch [T, E, C] one-hot, combine [T, E, C] weights,
    aux_loss scalar).  For top-2 the two gate values are renormalized to
    sum to 1 and second choices claim capacity only after ALL first
    choices (GShard's position rule), so a hot expert drops second
    choices first.  Ties go to the lowest expert index (argmax)."""
    if top_k not in (1, 2):
        raise ValueError(f"top_k must be 1 or 2, got {top_k}")
    logits = x @ gate_w                                  # [T, E]
    probs = torch.softmax(logits.float(), dim=-1)
    idx1 = torch.argmax(probs, dim=-1)                   # [T]
    mask1 = _one_hot(idx1, num_experts)
    g1 = torch.sum(probs * mask1, dim=-1)

    # position of each token within its expert's capacity buffer
    pos1 = torch.sum((torch.cumsum(mask1, dim=0) - 1.0) * mask1, dim=-1)
    keep1 = (pos1 < capacity).float()
    pos1_1h = _one_hot(pos1.long(), capacity)
    d1 = mask1[:, :, None] * pos1_1h[:, None, :] * keep1[:, None, None]

    # load-balance aux loss (Switch eq. 4): E * sum_e f_e * p_e, with
    # f_e the fraction of tokens whose FIRST choice is e
    frac_tokens = torch.mean(mask1, dim=0)
    frac_probs = torch.mean(probs, dim=0)
    aux = num_experts * torch.sum(frac_tokens * frac_probs)

    if top_k == 1:
        return d1, d1 * g1[:, None, None], aux

    probs2 = probs * (1.0 - mask1)
    idx2 = torch.argmax(probs2, dim=-1)
    mask2 = _one_hot(idx2, num_experts)
    g2 = torch.sum(probs * mask2, dim=-1)
    # second choices are placed after every first choice of that expert
    first_count = torch.sum(mask1, dim=0)                # [E]
    pos2 = torch.sum(((torch.cumsum(mask2, dim=0) - 1.0)
                      + first_count[None, :]) * mask2, dim=-1)
    keep2 = (pos2 < capacity).float()
    pos2_1h = _one_hot(pos2.long(), capacity)
    d2 = mask2[:, :, None] * pos2_1h[:, None, :] * keep2[:, None, None]

    denom = torch.clamp(g1 + g2, min=1e-9)
    combine = (d1 * (g1 / denom)[:, None, None]
               + d2 * (g2 / denom)[:, None, None])
    return d1 + d2, combine, aux


# the Selection of every moe_dense call that brings none: one ledger, so
# the fallback series it counts stay one per reason
_SELECTION = Selection()


def _capacity(T: int, E: int, capacity_factor: float, top_k: int) -> int:
    return max(1, int(capacity_factor * top_k * T / E))


def _expert_mm(inp, wi, wo, activation):
    """[*, C, D] tokens through per-expert FFNs [*, D, H] / [*, H, D] —
    batched dense matmuls."""
    h = activation(torch.einsum("...cd,...dh->...ch", inp, wi))
    return torch.einsum("...ch,...hd->...cd", h, wo)


def moe_dense(x, gate_w, w_in, w_out, capacity_factor: float = 1.25,
              top_k: int = 1, activation=torch.relu,
              capacity: int = None,
              selection=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mesh-free MoE FFN: the math every parallel form implements.
    x: [T, D]; returns (y [T, D], aux_loss).

    On a CUDA device gate + capacity dispatch always run as one CUDA
    kernel (kernels/moe_dispatch.py) — same math, the dispatch
    contraction a gather — and a call the kernel does not take raises:
    the port has no plain path on the card.  On the CPU the kernel tier
    follows the `serving_kernels` flag, as in the JAX package (the
    kernel's wrapper runs its plain version for CPU tensors).
    `selection` takes an existing kernels.registry.Selection for
    fallback-series ownership (defaults to this module's one)."""
    from ..core.types import canonical_dtype

    E = gate_w.shape[1]
    T = x.shape[0]
    if capacity is None:
        capacity = _capacity(T, E, capacity_factor, top_k)

    picker = selection if selection is not None else _SELECTION
    ctx = dict(tokens=int(T), d_model=int(x.shape[1]), num_experts=int(E),
               capacity=int(capacity), top_k=int(top_k),
               dtype=canonical_dtype(x.dtype))
    fused = (picker.require("moe_gate_dispatch", **ctx)
             if x.device.type == "cuda" else
             picker.pick("moe_gate_dispatch", platform=x.device.type, **ctx))
    if fused is not None:
        expert_in_f, combine, aux2 = fused(x, gate_w)
        expert_in = expert_in_f.to(x.dtype)
        aux = aux2[0, 0]
    else:
        dispatch, combine, aux = moe_gate(x, gate_w, E, capacity, top_k)
        expert_in = torch.einsum("td,tec->ecd", x.float(),
                                 dispatch).to(x.dtype)
    expert_out = _expert_mm(expert_in, w_in, w_out, activation)
    y = torch.einsum("ecd,tec->td", expert_out.float(),
                     combine).to(x.dtype)
    return y, aux


def load_balance(x, gate_w) -> dict:
    """Routing diagnostics: per-expert first-choice token fractions and
    their max/mean ratio (1.0 = perfectly balanced)."""
    probs = torch.softmax((x @ gate_w).float(), dim=-1)
    frac = torch.mean(_one_hot(torch.argmax(probs, -1), gate_w.shape[1]),
                      dim=0)
    return {"frac": frac, "imbalance": torch.max(frac) * gate_w.shape[1]}


def drop_rate(x, gate_w, capacity_factor: float = 1.25, top_k: int = 1,
              capacity: int = None, shards: int = 1) -> dict:
    """What static capacity costs at this routing state: the fraction of
    the T*top_k routing assignments that lost their capacity slot
    (`assignment_drop`) and the fraction of the total combine WEIGHT
    lost (`weight_drop`).  `shards` > 1 evaluates per-source capacity
    (C_loc per shard, hot-expert overflow drops locally)."""
    E = gate_w.shape[1]
    T = x.shape[0]
    if T % shards:
        raise ValueError(f"tokens {T} must divide shards {shards}")
    t_loc = T // shards
    cap = (_capacity(t_loc, E, capacity_factor, top_k)
           if capacity is None else capacity)
    assigned = kept = weight = weight_kept = 0.0
    for s in range(shards):
        xb = x[s * t_loc:(s + 1) * t_loc]
        dispatch, combine, _ = moe_gate(xb, gate_w, E, cap, top_k)
        probs = torch.softmax((xb @ gate_w).float(), -1)
        top = torch.topk(probs, top_k, dim=-1)[0]
        if top_k == 2:
            top = top / torch.clamp(top.sum(-1, keepdim=True), min=1e-9)
        assigned += t_loc * top_k
        kept += torch.sum(dispatch)
        weight += torch.sum(top)
        weight_kept += torch.sum(combine)
    return {"capacity": cap,
            "assignment_drop": float(1.0 - kept / assigned),
            "weight_drop": float(1.0 - weight_kept / weight)}
