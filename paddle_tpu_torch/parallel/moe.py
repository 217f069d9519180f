"""Mixture-of-Experts: gating, dispatch and the mesh-free MoE FFN.

Counterpart of paddle_tpu/parallel/moe.py.  `moe_gate` is the one gating
implementation of the JAX package (GShard/Switch dispatch-combine
tensors, top-1 or top-2, static capacity, differentiable through the
gate probabilities), and `moe_dense` the mesh-free MoE FFN the `moe_ffn`
op lowers to.  `moe_dense` computes the same function in routing form:
gate and dispatch give each capacity slot its token and combine weight
and each token its slots (kernels/moe_dispatch.py, "moe_gate_dispatch":
a hand-written CUDA kernel on a card, its plain version on the CPU), and
`moe_combine` gathers at most two expert rows a token instead of
contracting a dense [T, E, C] combine.

Two expert-parallel forms over an 'ep' mesh axis (one process a mesh
position, global tensors in and out on every rank, differentiable with
torch autograd through parallel/collective.py's conjugate collectives):

  * `moe_ffn`: replicated routing (every rank gates every token), each
    rank runs its E/n experts on their capacity slots, and the expert
    outputs are all-gathered over 'ep' before the combine;
  * `moe_ffn_a2a`: token-sharded routing (the GShard layout): each rank
    gates its own T/n tokens at a per-source capacity, one all_to_all
    regroups the capacity buffers expert-major, a second returns the
    outputs, and the aux loss is averaged over 'ep'.

`moe_ep_local` is the sharded ParallelExecutor's form of the `moe_ffn`
op with its expert weights placed over 'ep' (parallel/tensor_parallel.py):
routing on the rank's whole token set, its experts, the combine of its
experts' rows only, and one all-reduce of the output over 'ep'.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..kernels.registry import Selection

__all__ = ["moe_gate", "moe_dense", "moe_combine", "moe_ffn", "moe_ffn_a2a",
           "moe_ep_local", "load_balance", "drop_rate"]


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


class _MoeCombine(torch.autograd.Function):
    """y [T, D] = sum over a token's kept slots s of slot_weight[s] *
    expert_out[s]: two row gathers and a weighted add.  Each kept slot
    holds exactly one token, so the backward gathers dy at slot_token:
    no scatter, no atomics."""

    @staticmethod
    def forward(ctx, expert_out, slot_weight, slot_of, slot_token):
        d = expert_out.shape[-1]
        rows = expert_out.reshape(-1, d)
        weights = slot_weight.reshape(-1)
        held = slot_of >= 0
        at = slot_of.clamp(min=0).long()
        y = torch.where(held[0, :, None], weights[at[0], None] * rows[at[0]],
                        0.0)
        if slot_of.shape[0] == 2:
            y = y + torch.where(held[1, :, None],
                                weights[at[1], None] * rows[at[1]], 0.0)
        ctx.save_for_backward(expert_out, slot_weight, slot_token)
        return y

    @staticmethod
    def backward(ctx, dy):
        expert_out, slot_weight, slot_token = ctx.saved_tensors
        d = expert_out.shape[-1]
        tok = slot_token.reshape(-1).long()
        held = (tok >= 0)[:, None]
        g = dy[tok.clamp(min=0)]                           # [E * C, D]
        rows = expert_out.reshape(-1, d)
        d_weight = torch.where(held[:, 0], (g * rows).sum(-1), 0.0)
        d_rows = torch.where(held, slot_weight.reshape(-1, 1) * g, 0.0)
        return (d_rows.view_as(expert_out), d_weight.view_as(slot_weight),
                None, None)


def moe_combine(expert_out, slot_weight, slot_of, slot_token):
    """The combine in routing form: expert_out [E, C, D] f32, slot_weight
    [E, C] f32, slot_of [k, T] and slot_token [E, C] (int, -1 for a
    dropped choice or an empty slot) -> y [T, D] with y[t] = sum_j
    [slot_of[j, t] >= 0] slot_weight[slot_of[j, t]] expert_out[slot_of[j,
    t]]: `einsum("ecd,tec->td", expert_out, combine)` without the dense
    combine.  Differentiable in expert_out and slot_weight; plain
    PyTorch on every device."""
    return _MoeCombine.apply(expert_out, slot_weight, slot_of, slot_token)


def moe_dense(x, gate_w, w_in, w_out, capacity_factor: float = 1.25,
              top_k: int = 1, activation=torch.relu,
              capacity: int = None,
              selection=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mesh-free MoE FFN: the math every parallel form implements.
    x: [T, D]; returns (y [T, D], aux_loss).

    Gate and dispatch run in routing form and `moe_combine` gathers the
    expert rows back; no dense [T, E, C] dispatch or combine is formed.
    On a CUDA device they always run as the CUDA kernels
    (kernels/moe_dispatch.py), and a call the kernel does not take
    raises: the port has no plain path on the card.  On the CPU the
    kernel tier follows the `serving_kernels` flag, as in the JAX
    package (the kernel's wrapper runs its plain version for CPU
    tensors, so both give the same bits).  `selection` takes an existing
    kernels.registry.Selection for fallback-series ownership (defaults
    to this module's one)."""
    E = gate_w.shape[1]
    if capacity is None:
        capacity = _capacity(x.shape[0], E, capacity_factor, top_k)
    expert_in, slot_weight, aux2, slot_of, slot_token = _route(
        x, gate_w, E, capacity, top_k, selection)
    expert_out = _expert_mm(expert_in.to(x.dtype), w_in, w_out, activation)
    y = moe_combine(expert_out.float(), slot_weight, slot_of,
                    slot_token).to(x.dtype)
    return y, aux2[0, 0]


def _route(x, gate_w, E, capacity, top_k, selection=None):
    """Gate and dispatch in routing form -> (expert_in [E, C, D],
    slot_weight [E, C], aux [1, 1], slot_of [k, T], slot_token [E, C]):
    the CUDA kernel on a card (a call it does not take raises), the
    kernel tier's choice on the CPU."""
    from ..core.types import canonical_dtype
    from ..kernels.moe_dispatch import (moe_gate_route,
                                        moe_gate_route_reference)

    picker = selection if selection is not None else _SELECTION
    ctx = dict(tokens=int(x.shape[0]), d_model=int(x.shape[1]),
               num_experts=int(E), capacity=int(capacity),
               top_k=int(top_k), dtype=canonical_dtype(x.dtype))
    fused = (picker.require("moe_gate_dispatch", **ctx)
             if x.device.type == "cuda" else
             picker.pick("moe_gate_dispatch", platform=x.device.type, **ctx))
    if fused is not None:
        return fused.route(x, gate_w)
    if torch.compiler.is_exporting():
        # a traced program records the kernel's op on every device
        return moe_gate_route(x, gate_w, E, capacity, top_k)
    return moe_gate_route_reference(x, gate_w, E, capacity, top_k)


def _check_ep(E, n, what="experts"):
    if E % n:
        raise ValueError(f"{what} {E} must divide the ep axis size {n}")


def moe_ffn(x, gate_w, w_in, w_out, mesh, axis: str = "ep",
            capacity_factor: float = 1.25, top_k: int = 1,
            activation=torch.relu) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel FFN, replicated routing.  x: [T, D], gate_w:
    [D, E], w_in: [E, D, H], w_out: [E, H, D], global on every rank, E
    divisible by the axis size.  Returns (y [T, D], aux_loss), global on
    every rank."""
    from .collective import gather_from, scatter_to

    g = mesh.axis_group(axis)
    E = gate_w.shape[1]
    _check_ep(E, g.size)
    capacity = _capacity(x.shape[0], E, capacity_factor, top_k)
    expert_in, slot_weight, aux2, slot_of, slot_token = _route(
        x, gate_w, E, capacity, top_k)
    # this rank's experts; the blocks' gradients all-gathered back
    out = _expert_mm(scatter_to(expert_in.to(x.dtype), g, 0),
                     scatter_to(w_in, g, 0), scatter_to(w_out, g, 0),
                     activation)
    y = moe_combine(gather_from(out, g, 0).float(), slot_weight, slot_of,
                    slot_token).to(x.dtype)
    return y, aux2[0, 0]


def moe_ffn_a2a(x, gate_w, w_in, w_out, mesh, axis: str = "ep",
                capacity_factor: float = 1.25, top_k: int = 1,
                activation=torch.relu) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel FFN with token-sharded routing and all_to_all
    dispatch.  x: [T, D] with T divisible by the axis size; capacity is
    per (expert, source rank): C_loc = capacity_factor * top_k * (T/n) /
    E, so a hot expert drops a rank's overflow locally.  Returns (y
    [T, D], aux_loss averaged over the axis), global on every rank."""
    from .collective import all_to_all, copy_to, gather_from, \
        reduce_from, scatter_to

    g = mesh.axis_group(axis)
    E, n = gate_w.shape[1], g.size
    _check_ep(E, n)
    _check_ep(x.shape[0], n, "tokens")
    c_loc = _capacity(x.shape[0] // n, E, capacity_factor, top_k)
    x_blk = scatter_to(x, g, 0)
    expert_in, slot_weight, aux2, slot_of, slot_token = _route(
        x_blk, copy_to(gate_w, g), E, c_loc, top_k)
    # [E, C_loc, D] -> [E/n, n * C_loc, D]: this rank's experts, every
    # source's slots
    buf = all_to_all(expert_in.to(x.dtype), g, 0, 1)
    out = _expert_mm(buf, scatter_to(w_in, g, 0), scatter_to(w_out, g, 0),
                     activation)
    out = all_to_all(out, g, 1, 0)                        # [E, C_loc, D]
    y = moe_combine(out.float(), slot_weight, slot_of,
                    slot_token).to(x.dtype)
    return gather_from(y, g, 0), reduce_from(aux2[0, 0] / n, g)


def moe_ep_local(x, gate_w, w_in_blk, w_out_blk, group,
                 capacity_factor: float = 1.25, top_k: int = 1,
                 activation=torch.relu):
    """The `moe_ffn` op on a rank holding its E/n experts' weights
    (`w_in_blk` [E/n, D, H], `w_out_blk` [E/n, H, D]) over `group` (the
    'ep' axis): routing on every token of `x` [T, D] (the same tokens on
    every rank of the axis), this rank's experts on their capacity
    slots, the combine of their rows only, and the partial outputs
    summed over the axis (`reduce_from`: an all-reduce forward, the
    identity backward).  The aux loss, which every rank computes whole,
    enters the sum as its n-th part, so its gradient is counted once.
    The caller makes x's and gate_w's gradients whole (`copy_to`: the
    tensor-parallel rule's)."""
    from .collective import reduce_from

    n, i = group.size, group.index
    E = gate_w.shape[1]
    e_loc = w_in_blk.shape[0]
    if e_loc * n != E:
        raise ValueError(f"{e_loc} experts a rank over an ep axis of {n}: "
                         f"the gate has {E}")
    capacity = _capacity(x.shape[0], E, capacity_factor, top_k)
    expert_in, slot_weight, aux2, slot_of, slot_token = _route(
        x, gate_w, E, capacity, top_k)
    lo = i * e_loc
    out = _expert_mm(expert_in[lo:lo + e_loc].to(x.dtype), w_in_blk,
                     w_out_blk, activation)
    # this rank's slots only: another rank's slot index reads as dropped
    first, last = lo * capacity, (lo + e_loc) * capacity
    mine = (slot_of >= first) & (slot_of < last)
    y = moe_combine(out.float(), slot_weight[lo:lo + e_loc],
                    torch.where(mine, slot_of - first, -1),
                    slot_token[lo:lo + e_loc]).to(x.dtype)
    return reduce_from(y, group), reduce_from(aux2[0, 0] / n, group)


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
