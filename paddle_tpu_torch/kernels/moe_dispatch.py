"""Fused MoE gate + capacity dispatch: the CUDA kernels' wrappers and
their plain versions.

Replaces the TPU kernel paddle_tpu/kernels/moe_dispatch.py
`_gate_dispatch_kernel`: gate logits x . W_g, softmax, top-1 (Switch)
or top-2 (GShard) argmax, capacity positions by per-expert cumsum with
second choices after all first choices, `expert_in = einsum("td,tec->
ecd", x, dispatch)`, the combine weights and the load-balance aux loss.

The TPU kernel writes the combine as a dense [T, E, C] tensor for the
MXU; every row of it has at most two nonzeros.  csrc/moe_dispatch.cu
writes the routing instead (the source says how):

    slot_token [E, C]   the token in each capacity slot, or -1
    slot_weight [E, C]  its combine weight, 0 in an empty slot
    slot_of [k, T]      each token's slot e * C + pos per choice, or -1

and parallel/moe.moe_combine gathers at most two expert rows a token.

`moe_gate_route(x, gate_w, E, C, top_k)` -> (expert_in, slot_weight,
aux, slot_of, slot_token) is what `moe_dense` calls: on CUDA tensors a
`torch.autograd.Function` whose forward launches the routing-form kernel
(one count in `moe_gate_dispatch.launches` a call) and whose backward
launches the backward kernel through `moe_gate_route_backward` (one
count in `moe_gate_route_backward.launches`); CPU and meta tensors run
`moe_gate_route_reference` under autograd.  `moe_gate_dispatch(x,
gate_w, E, C, top_k)` -> (expert_in, combine [T, E, C], aux) keeps the
JAX package's contract: the same kernel writes the dense combine too,
and its backward gathers d_combine at the kept slots and runs the same
backward kernel.  Both gradients are the plain composition's VJP at the
routing the forward chose — the gradient the JAX package takes (its
Pallas kernel has no VJP, so it trains through the plain composition).
Selection goes through kernels/registry.py ("moe_gate_dispatch"); the
built callable carries the routing form as `.route`.  The routing
form's forward is also the PyTorch op `paddle_tpu_torch::moe_gate_route`
(`moe_gate_route_op`, no autograd), which `moe_gate_route` and
`moe_dense` take while torch.export traces, on any device, so an
exported program (io.export_aot_model) launches the kernel after a
reload.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from .registry import register_kernel

__all__ = ["moe_dispatch_supports", "build_moe_gate_dispatch",
           "moe_gate_dispatch", "moe_gate_dispatch_reference",
           "moe_gate_route", "moe_gate_route_reference",
           "moe_routing_reference", "moe_gate_dispatch_vjp",
           "moe_gate_route_vjp", "moe_gate_route_backward",
           "moe_gate_route_launch", "moe_gate_dispatch_launch",
           "moe_route_backward_launch", "moe_gate_route_op", "build",
           "SOURCE", "MAX_EXPERTS"]

SOURCE = "moe_dispatch.cu"
MAX_EXPERTS = 64

_count_lock = threading.Lock()
_lib = None


def moe_dispatch_supports(*, tokens: int, d_model: int,
                          num_experts: int, capacity: int,
                          top_k: int = 1, dtype: str = "float32",
                          platform: str = "cpu", **_) -> Optional[str]:
    # the JAX package also falls back above a 10 MiB VMEM routing budget
    # and on TPU lane/sublane misalignment; both are TPU limits: this
    # kernel keeps no routing tensor on chip and reads any D and T
    if top_k not in (1, 2):
        return "top_k"
    if dtype != "float32":
        return "dtype"
    if not 1 <= int(num_experts) <= MAX_EXPERTS:
        return "num_experts"
    if int(capacity) < 1:
        return "capacity"
    return None


def _route(probs, num_experts: int, capacity: int, top_k: int):
    """The plain routing from the gate probabilities, moe_gate's integer
    arithmetic without its [T, E, C] one-hots -> (idx [k, T], slot_of
    [k, T], src [E * C]: j * T + t for the choice j of token t held in
    each slot, or -1), all int64."""
    from ..parallel.moe import _one_hot

    T, E, C = probs.shape[0], num_experts, capacity
    idx1 = torch.argmax(probs, dim=-1)
    mask1 = _one_hot(idx1, E)
    idx = [idx1]
    pos = [torch.sum((torch.cumsum(mask1, dim=0) - 1.0) * mask1, dim=-1)]
    if top_k == 2:
        idx2 = torch.argmax(probs * (1.0 - mask1), dim=-1)
        mask2 = _one_hot(idx2, E)
        first_count = torch.sum(mask1, dim=0)
        idx.append(idx2)
        pos.append(torch.sum(((torch.cumsum(mask2, dim=0) - 1.0)
                              + first_count[None, :]) * mask2, dim=-1))
    idx = torch.stack(idx)
    pos = torch.stack(pos).long()
    slot_of = torch.where(pos < C, idx * C + pos, -1)
    # dropped choices write into a spare slot E * C that is cut off
    src = torch.full((E * C + 1,), -1, dtype=torch.long, device=probs.device)
    src.scatter_(0, torch.where(slot_of >= 0, slot_of, E * C).reshape(-1),
                 torch.arange(top_k * T, device=probs.device))
    return idx, slot_of, src[:E * C]


def _gate_weights(probs, idx):
    """[k, T] the combine weight of each choice: g1 (top-1), or g / (g1
    + g2) with the denominator clamped at 1e-9 (top-2)."""
    g = probs.gather(1, idx.t())                         # [T, k]
    if idx.shape[0] == 2:
        g = g / torch.clamp(g[:, :1] + g[:, 1:], min=1e-9)
    return g.t()


def moe_gate_route_reference(x, gate_w, num_experts: int, capacity: int,
                             top_k: int = 1):
    """The plain version of the routing form, differentiable in x and
    gate_w -> (expert_in [E, C, D] in x's dtype, slot_weight [E, C] f32,
    aux [1, 1] f32, slot_of [k, T] int32, slot_token [E, C] int32).
    The values are moe_gate's: its combine holds slot_weight at the kept
    slots, and its dispatch einsum gathers expert_in."""
    from ..parallel.moe import _one_hot

    E, C, T = int(num_experts), int(capacity), x.shape[0]
    if top_k not in (1, 2):
        raise ValueError(f"top_k must be 1 or 2, got {top_k}")
    probs = torch.softmax((x @ gate_w).float(), dim=-1)
    idx, slot_of, src = _route(probs.detach(), E, C, top_k)
    held = src >= 0
    at = src.clamp(min=0)
    slot_weight = torch.where(
        held, _gate_weights(probs, idx).reshape(-1)[at], 0.0).view(E, C)
    slot_token = torch.where(held, at % T, -1)
    expert_in = torch.where(held[:, None], x[slot_token.clamp(min=0)],
                            0.0).to(x.dtype).view(E, C, x.shape[1])
    aux = E * torch.sum(torch.mean(_one_hot(idx[0], E), dim=0)
                        * torch.mean(probs, dim=0))
    return (expert_in, slot_weight, aux.reshape(1, 1), slot_of.int(),
            slot_token.int().view(E, C))


def moe_gate_dispatch_reference(x, gate_w, num_experts: int, capacity: int,
                                top_k: int = 1):
    """The plain version of the JAX contract: parallel/moe.moe_gate plus
    moe_dense's dispatch einsum -> (expert_in [E, C, D], combine
    [T, E, C], aux [1, 1])."""
    from ..parallel.moe import moe_gate

    dispatch, combine, aux = moe_gate(x, gate_w, num_experts, capacity,
                                      top_k)
    expert_in = torch.einsum("td,tec->ecd", x.float(), dispatch)
    return expert_in, combine, aux.reshape(1, 1)


def moe_routing_reference(x, gate_w, num_experts: int, capacity: int,
                          top_k: int = 1):
    """The plain version's routing, in the kernel's form -> (probs
    [T, E] f32, idx [top_k, T] int32 each token's first (and second)
    expert, slot_token [E, C] int32 the token in each capacity slot or
    -1)."""
    with torch.no_grad():
        probs = torch.softmax((x @ gate_w).float(), dim=-1)
        idx, _, src = _route(probs, int(num_experts), int(capacity), top_k)
        slot_token = torch.where(src >= 0, src % x.shape[0], -1)
    return (probs, idx.int(),
            slot_token.int().view(int(num_experts), int(capacity)))


def moe_gate_route_vjp(x, gate_w, probs, idx, slot_of, d_expert_in,
                       d_slot_weight, d_aux):
    """The VJP of `moe_gate_route_reference` at a given routing (what
    the kernel or the plain version chose) -> (dx [T, D], dgate_w
    [D, E]).  A cotangent may be None (zero).

    expert_in gathers x, so dx gets the d expert_in rows at each token's
    slots; slot_weight holds the kept gate values (top-2: g / (g1 +
    g2)) and aux reads the mean probs: both reach the logits through the
    softmax.  Every term is a gather at slot_of: no atomics, and no
    value read back to the host (no boolean indexing, no bincount), so
    the backward queues without a sync."""
    T, E = probs.shape
    k = idx.shape[0]
    dev = probs.device
    held = slot_of >= 0
    at = slot_of.clamp(min=0).long()
    idx1 = idx[0].long()
    dprobs = torch.zeros((T, E), dtype=torch.float32, device=dev)
    if d_aux is not None:
        first_count = torch.zeros(E, dtype=torch.long, device=dev
                                  ).scatter_add_(0, idx1,
                                                 torch.ones_like(idx1))
        frac_tokens = first_count.float() / T
        dprobs += (d_aux.reshape(()).float() * E * frac_tokens / T)[None, :]
    if d_slot_weight is not None:
        dc = torch.where(held, d_slot_weight.reshape(-1)[at], 0.0)  # [k, T]
        gidx = idx.long().t()                                       # [T, k]
        if k == 2:
            g = probs.gather(1, gidx)
            total = g[:, 0] + g[:, 1]
            denom = torch.clamp(total, min=1e-9)
            d_denom = (-(dc[0] * g[:, 0] + dc[1] * g[:, 1]) / (denom * denom)
                       * (total >= 1e-9))
            dc = dc / denom + d_denom
        # one scatter per choice: a token whose two choices coincide
        # adds its two terms in a fixed order
        for j in range(k):
            dprobs.scatter_add_(1, gidx[:, j:j + 1], dc[j][:, None])
    d_logits = probs * (dprobs - (dprobs * probs).sum(-1, keepdim=True))
    dx = d_logits @ gate_w.t()
    if d_expert_in is not None:
        rows = d_expert_in.reshape(-1, x.shape[1]).to(dx.dtype)
        d_disp = torch.where(held[0, :, None], rows[at[0]], 0.0)
        if k == 2:
            d_disp = d_disp + torch.where(held[1, :, None], rows[at[1]], 0.0)
        dx = dx + d_disp
    return dx, x.t() @ d_logits


def _slot_of(idx, slot_token):
    """Invert the slot map -> slot_of [k, T]: a slot (e, c) holds a
    first choice exactly when c is below the number of tokens whose
    first choice is e, since second choices are placed after all of
    them."""
    E, C = slot_token.shape
    k, T = idx.shape
    dev = slot_token.device
    tok = slot_token.reshape(-1).long()
    slots = torch.arange(E * C, device=dev)
    idx1 = idx[0].long()
    first_count = torch.zeros(E, dtype=torch.long, device=dev).scatter_add_(
        0, idx1, torch.ones_like(idx1))
    # empty slots write into a spare column T that is cut off
    target = torch.where(tok >= 0, tok, T)
    if k == 2:
        second = (slots % C) >= first_count[slots // C]
        target = target + second.long() * (T + 1)
    slot_of = torch.full((k * (T + 1),), -1, dtype=torch.long, device=dev)
    return slot_of.scatter_(0, target, slots).view(k, T + 1)[:, :T]


def _d_slot_weight(d_combine, slot_token):
    """d slot_weight [E, C] from a dense combine's cotangent [T, E, C]:
    each kept slot's entry at its token."""
    tok = slot_token.reshape(1, -1).long()
    got = d_combine.reshape(d_combine.shape[0], -1).gather(
        0, tok.clamp(min=0))[0]
    return torch.where(tok[0] >= 0, got, 0.0).view(slot_token.shape)


def moe_gate_dispatch_vjp(x, gate_w, probs, idx, slot_token, d_expert_in,
                          d_combine, d_aux):
    """The VJP of `moe_gate_dispatch_reference` at a given routing ->
    (dx [T, D], dgate_w [D, E]); a cotangent may be None (zero).  The
    dense combine holds slot_weight at (slot_token[s], s), so its
    cotangent reaches slot_weight by a gather there, and the rest is
    `moe_gate_route_vjp`."""
    d_sw = (None if d_combine is None
            else _d_slot_weight(d_combine, slot_token))
    return moe_gate_route_vjp(x, gate_w, probs, idx,
                              _slot_of(idx, slot_token), d_expert_in, d_sw,
                              d_aux)


def _library():
    global _lib
    if _lib is None:
        from . import cuda_build

        lib = cuda_build.load_library(SOURCE)
        lib.moe_route_tile.argtypes = []
        lib.moe_route_tile.restype = ctypes.c_int
        fwd = lib.moe_route_forward
        fwd.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 5
                        + [ctypes.c_void_p])
        fwd.restype = ctypes.c_int
        bwd = lib.moe_route_backward
        bwd.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
                        + [ctypes.c_void_p])
        bwd.restype = ctypes.c_int
        _lib = lib
    return _lib


def build():
    """Build (or load) the kernel library; the first CUDA call builds it
    anyway — this lets a caller pay the build up front."""
    _library()


def _check_call(x, gate_w, E, C, k):
    if x.dim() != 2 or gate_w.dim() != 2 or gate_w.shape != (x.shape[1], E):
        raise ValueError(f"moe_gate_dispatch: x {tuple(x.shape)} and gate_w "
                         f"{tuple(gate_w.shape)} for {E} experts (want "
                         "x [T, D], gate_w [D, E])")
    T, D = x.shape
    dtype = ("float32" if x.dtype == gate_w.dtype == torch.float32
             else f"{x.dtype}/{gate_w.dtype}")
    reason = moe_dispatch_supports(tokens=T, d_model=D, num_experts=E,
                                   capacity=C, top_k=k, dtype=dtype)
    if reason is not None:
        raise ValueError(f"moe_gate_dispatch: the CUDA kernel does not take "
                         f"this call ({reason}): x {x.dtype}, gate_w "
                         f"{gate_w.dtype}, E {E}, C {C}, top_k {k}")
    if gate_w.device != x.device or x.device.type != "cuda":
        raise ValueError("moe_gate_dispatch: x and gate_w on "
                         f"{x.device} and {gate_w.device} (want one CUDA "
                         "device)")


def _ptr(t):
    return None if t is None else t.data_ptr()


def moe_gate_route_launch(x, gate_w, num_experts: int, capacity: int,
                          top_k: int = 1, dense: bool = False):
    """Launch the forward kernel on CUDA tensors (no autograd, not
    counted) -> (expert_in [E, C, D], slot_weight [E, C], aux [1, 1],
    slot_of [k, T] int32, slot_token [E, C] int32, probs [T, E], idx
    [k, T] int32 each token's first (and second) expert, first_count [E]
    int32 first choices per expert, and the dense combine [T, E, C] when
    `dense`, else None)."""
    E, C, k = int(num_experts), int(capacity), int(top_k)
    _check_call(x, gate_w, E, C, k)
    T, D = x.shape
    x, gate_w = x.contiguous(), gate_w.contiguous()
    dev = x.device
    f32, i32 = torch.float32, torch.int32
    lib = _library()
    tiles = -(-T // lib.moe_route_tile())
    probs = torch.empty((T, E), dtype=f32, device=dev)
    idx = torch.empty((k, T), dtype=i32, device=dev)
    counts = torch.empty((tiles, 2 * E), dtype=i32, device=dev)
    psum = torch.empty((tiles, E), dtype=torch.float64, device=dev)
    slot_token = torch.empty((E, C), dtype=i32, device=dev)
    slot_weight = torch.empty((E, C), dtype=f32, device=dev)
    slot_of = torch.empty((k, T), dtype=i32, device=dev)
    first_count = torch.empty((E,), dtype=i32, device=dev)
    expert_in = torch.empty((E, C, D), dtype=f32, device=dev)
    combine = (torch.empty((T, E, C), dtype=f32, device=dev) if dense
               else None)
    aux = torch.empty((1, 1), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.moe_route_forward(
            x.data_ptr(), gate_w.data_ptr(), probs.data_ptr(),
            idx.data_ptr(), counts.data_ptr(), psum.data_ptr(),
            slot_token.data_ptr(), slot_weight.data_ptr(),
            slot_of.data_ptr(), first_count.data_ptr(),
            expert_in.data_ptr(), _ptr(combine), aux.data_ptr(),
            T, D, E, C, k, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"moe_gate_dispatch launch failed: CUDA error {rc}")
    return (expert_in, slot_weight, aux, slot_of, slot_token, probs, idx,
            first_count, combine)


def moe_gate_dispatch_launch(x, gate_w, num_experts: int, capacity: int,
                             top_k: int = 1):
    """Launch the forward kernel with the dense combine (no autograd,
    not counted) -> (expert_in [E, C, D], combine [T, E, C], aux [1, 1],
    probs [T, E], idx [top_k, T] int32, slot_token [E, C] int32)."""
    out = moe_gate_route_launch(x, gate_w, num_experts, capacity, top_k,
                                dense=True)
    return out[0], out[8], out[2], out[5], out[6], out[4]


def _cotangent(t, shape, dev):
    if t is None:
        return None
    if tuple(t.shape) != tuple(shape) or t.device != dev:
        raise ValueError(f"moe_gate_route_backward: a cotangent of shape "
                         f"{tuple(t.shape)} on {t.device}, want {shape} "
                         f"on {dev}")
    return t.contiguous().float()


def moe_route_backward_launch(gate_w, probs, idx, slot_of, first_count,
                              d_expert_in, d_slot_weight, d_aux,
                              capacity: int, d_model: int):
    """Launch the backward kernel on CUDA tensors (not counted) ->
    (dx [T, D], d_logits [T, E]).  A cotangent may be None (zero)."""
    T, E = probs.shape
    k, C, D = idx.shape[0], int(capacity), int(d_model)
    dev = probs.device
    gate_w = gate_w.contiguous()
    if gate_w.dtype != torch.float32 or tuple(gate_w.shape) != (D, E):
        raise ValueError(f"moe_gate_route_backward: gate_w {gate_w.dtype} "
                         f"{tuple(gate_w.shape)}, want float32 [{D}, {E}]")
    d_ei = _cotangent(d_expert_in, (E, C, D), dev)
    d_sw = _cotangent(d_slot_weight, (E, C), dev)
    d_aux = _cotangent(d_aux, (1, 1), dev)
    dx = torch.empty((T, D), dtype=torch.float32, device=dev)
    d_logits = torch.empty((T, E), dtype=torch.float32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        rc = lib.moe_route_backward(
            gate_w.data_ptr(), probs.data_ptr(), idx.data_ptr(),
            slot_of.data_ptr(), first_count.data_ptr(), _ptr(d_ei),
            _ptr(d_sw), _ptr(d_aux), dx.data_ptr(), d_logits.data_ptr(),
            T, D, E, C, k, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"moe_gate_route_backward launch failed: CUDA "
                           f"error {rc}")
    return dx, d_logits




def moe_gate_route_backward(x, gate_w, probs, idx, slot_of, first_count,
                            d_expert_in, d_slot_weight, d_aux, *,
                            capacity: int):
    """The routing form's backward at the forward's routing -> (dx
    [T, D], dgate_w [D, E]); a cotangent may be None (zero).  CUDA
    tensors launch the backward kernel (one count a call) and take
    dgate_w = x^T . d_logits as a GEMM; CPU tensors run
    `moe_gate_route_vjp`."""
    if probs.device.type != "cuda":
        return moe_gate_route_vjp(x, gate_w, probs, idx, slot_of,
                                  d_expert_in, d_slot_weight, d_aux)
    dx, d_logits = moe_route_backward_launch(
        gate_w, probs, idx, slot_of, first_count, d_expert_in,
        d_slot_weight, d_aux, capacity, x.shape[1])
    with _count_lock:
        moe_gate_route_backward.launches += 1
    return dx, x.t() @ d_logits


moe_gate_route_backward.launches = 0


def _count_forward():
    with _count_lock:
        moe_gate_dispatch.launches += 1


class _MoeGateRoute(torch.autograd.Function):
    """The routing-form kernel under autograd; the backward is the
    backward kernel at the routing the forward chose."""

    @staticmethod
    def forward(ctx, x, gate_w, num_experts, capacity, top_k):
        (expert_in, slot_weight, aux, slot_of, slot_token, probs, idx,
         first_count, _) = moe_gate_route_launch(x, gate_w, num_experts,
                                                 capacity, top_k)
        _count_forward()
        ctx.capacity = capacity
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, gate_w, probs, idx, slot_of, first_count)
        ctx.mark_non_differentiable(slot_of, slot_token)
        return expert_in, slot_weight, aux, slot_of, slot_token

    @staticmethod
    def backward(ctx, d_expert_in, d_slot_weight, d_aux, _slot_of, _tok):
        x, gate_w, probs, idx, slot_of, first_count = ctx.saved_tensors
        dx, dgate_w = moe_gate_route_backward(
            x, gate_w, probs, idx, slot_of, first_count, d_expert_in,
            d_slot_weight, d_aux, capacity=ctx.capacity)
        return (dx if ctx.needs_input_grad[0] else None,
                dgate_w if ctx.needs_input_grad[1] else None,
                None, None, None)


class _MoeGateDispatch(torch.autograd.Function):
    """The kernel with the dense combine (the JAX contract) under
    autograd; the backward gathers d_combine at the kept slots and runs
    the backward kernel at the routing the forward chose."""

    @staticmethod
    def forward(ctx, x, gate_w, num_experts, capacity, top_k):
        (expert_in, _, aux, slot_of, slot_token, probs, idx, first_count,
         combine) = moe_gate_route_launch(x, gate_w, num_experts, capacity,
                                          top_k, dense=True)
        _count_forward()
        ctx.capacity = capacity
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, gate_w, probs, idx, slot_of, slot_token,
                              first_count)
        return expert_in, combine, aux

    @staticmethod
    def backward(ctx, d_expert_in, d_combine, d_aux):
        (x, gate_w, probs, idx, slot_of, slot_token,
         first_count) = ctx.saved_tensors
        d_sw = (None if d_combine is None
                else _d_slot_weight(d_combine, slot_token))
        dx, dgate_w = moe_gate_route_backward(
            x, gate_w, probs, idx, slot_of, first_count, d_expert_in, d_sw,
            d_aux, capacity=ctx.capacity)
        return (dx if ctx.needs_input_grad[0] else None,
                dgate_w if ctx.needs_input_grad[1] else None,
                None, None, None)


@torch.library.custom_op("paddle_tpu_torch::moe_gate_route",
                         mutates_args=(), device_types="cuda")
def moe_gate_route_op(x: torch.Tensor, gate_w: torch.Tensor,
                      num_experts: int, capacity: int, top_k: int
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                 torch.Tensor, torch.Tensor]:
    """The routing-form forward kernel as the PyTorch op
    `paddle_tpu_torch::moe_gate_route` -> (expert_in, slot_weight, aux,
    slot_of, slot_token): what a traced program (torch.export,
    io.export_aot_model) records in place of the ctypes launch.  On CUDA
    tensors it launches the kernel (one count in
    `moe_gate_dispatch.launches`) or raises; on CPU tensors it is
    `moe_gate_route_reference`; fake and meta tensors get shapes and
    dtypes only.  No autograd: the training path keeps _MoeGateRoute."""
    out = moe_gate_route_launch(x, gate_w, num_experts, capacity, top_k)
    _count_forward()
    return out[:5]


@moe_gate_route_op.register_kernel("cpu")
def _moe_gate_route_cpu(x, gate_w, num_experts, capacity, top_k):
    return tuple(t.contiguous() for t in moe_gate_route_reference(
        x, gate_w, num_experts, capacity, top_k))


@moe_gate_route_op.register_fake
def _moe_gate_route_fake(x, gate_w, num_experts, capacity, top_k):
    T, D = x.shape
    E, C, k = num_experts, capacity, top_k
    f32, i32 = torch.float32, torch.int32
    return (x.new_empty((E, C, D)), x.new_empty((E, C), dtype=f32),
            x.new_empty((1, 1), dtype=f32), x.new_empty((k, T), dtype=i32),
            x.new_empty((E, C), dtype=i32))


def moe_gate_route(x, gate_w, num_experts: int, capacity: int,
                   top_k: int = 1):
    """Gate + capacity dispatch in routing form: x [T, D] f32, gate_w
    [D, E] f32 -> (expert_in [E, C, D], slot_weight [E, C], aux [1, 1],
    slot_of [k, T] int32, slot_token [E, C] int32), differentiable in x
    and gate_w through expert_in, slot_weight and aux.  CPU and meta
    tensors run the plain version; CUDA tensors launch the kernel (one
    count per call) or raise.  While torch.export traces, on any
    device, it is the op `paddle_tpu_torch::moe_gate_route`
    (`moe_gate_route_op`, no autograd)."""
    if torch.compiler.is_exporting():
        return moe_gate_route_op(x, gate_w, int(num_experts),
                                 int(capacity), int(top_k))
    if x.device.type != "cuda":
        return moe_gate_route_reference(x, gate_w, num_experts, capacity,
                                        top_k)
    return _MoeGateRoute.apply(x, gate_w, int(num_experts), int(capacity),
                               int(top_k))


def moe_gate_dispatch(x, gate_w, num_experts: int, capacity: int,
                      top_k: int = 1):
    """Gate + capacity dispatch, the JAX contract: x [T, D] f32, gate_w
    [D, E] f32 -> (expert_in [E, C, D], combine [T, E, C], aux [1, 1]),
    differentiable in x and gate_w.  CPU and meta tensors run the plain
    version; CUDA tensors launch the kernel (one count per call) or
    raise."""
    if x.device.type != "cuda":
        return moe_gate_dispatch_reference(x, gate_w, num_experts, capacity,
                                           top_k)
    return _MoeGateDispatch.apply(x, gate_w, int(num_experts), int(capacity),
                                  int(top_k))


moe_gate_dispatch.launches = 0


@register_kernel("moe_gate_dispatch", moe_dispatch_supports)
def build_moe_gate_dispatch(*, tokens: int, d_model: int,
                            num_experts: int, capacity: int,
                            top_k: int = 1, **_):
    """-> fused(x [T, D] f32, gate_w [D, E] f32) ->
    (expert_in [E, C, D] f32, combine [T, E, C] f32, aux [1, 1] f32);
    `fused.route(x, gate_w)` is the routing form (`moe_gate_route`)."""
    T, D, E, C, k = (int(tokens), int(d_model), int(num_experts),
                     int(capacity), int(top_k))

    def _check(x):
        if tuple(x.shape) != (T, D):
            raise ValueError(f"moe_gate_dispatch built for x [{T}, {D}], "
                             f"got {tuple(x.shape)}")

    def fused(x, gate_w):
        _check(x)
        return moe_gate_dispatch(x, gate_w, E, C, k)

    def route(x, gate_w):
        _check(x)
        return moe_gate_route(x, gate_w, E, C, k)

    fused.route = route
    return fused
