"""Fused MoE gate + capacity dispatch: the CUDA kernel's wrapper and its
plain version.

Replaces the TPU kernel paddle_tpu/kernels/moe_dispatch.py
`_gate_dispatch_kernel`: gate logits x . W_g, softmax, top-1 (Switch)
or top-2 (GShard) argmax, capacity positions by per-expert cumsum with
second choices after all first choices, the combine weights [T, E, C],
`expert_in = einsum("td,tec->ecd", x, dispatch)` and the load-balance
aux loss.  csrc/moe_dispatch.cu computes the same outputs as routing
plus a gather (the one-hot contraction has one nonzero term per output
element, so the gather is bit-equal to it); the source says how.

`moe_gate_dispatch(x, gate_w, E, C, top_k)` is a
`torch.autograd.Function`: its forward launches the kernel (one count
in `moe_gate_dispatch.launches` per call: three CUDA launches) and
keeps the routing the kernel chose; its backward, `moe_gate_dispatch_vjp`,
is the plain composition's VJP at that routing — the gradient the JAX
package takes (its Pallas kernel has no VJP, so it trains through the
plain composition), with forward and backward on one routing by
construction.  CPU and meta tensors run `moe_gate_dispatch_reference`
under autograd.  Selection goes through kernels/registry.py
("moe_gate_dispatch").
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from .registry import register_kernel

__all__ = ["moe_dispatch_supports", "build_moe_gate_dispatch",
           "moe_gate_dispatch", "moe_gate_dispatch_reference",
           "moe_routing_reference", "moe_gate_dispatch_vjp",
           "moe_gate_dispatch_launch", "build", "SOURCE", "MAX_EXPERTS"]

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


def moe_gate_dispatch_reference(x, gate_w, num_experts: int, capacity: int,
                                top_k: int = 1):
    """The plain version: parallel/moe.moe_gate plus moe_dense's dispatch
    einsum -> (expert_in [E, C, D], combine [T, E, C], aux [1, 1])."""
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
    from ..parallel.moe import moe_gate

    with torch.no_grad():
        probs = torch.softmax((x @ gate_w).float(), dim=-1)
        idx = [torch.argmax(probs, -1)]
        if top_k == 2:
            first = torch.nn.functional.one_hot(idx[0], num_experts)
            idx.append(torch.argmax(probs * (1.0 - first), -1))
        per_slot = moe_gate(x, gate_w, num_experts, capacity,
                            top_k)[0].permute(1, 2, 0)       # [E, C, T]
        slot_token = torch.where(per_slot.sum(-1) > 0, per_slot.argmax(-1),
                                 torch.full_like(per_slot[..., 0], -1).long())
    return probs, torch.stack(idx).int(), slot_token.int()


def moe_gate_dispatch_vjp(x, gate_w, probs, idx, slot_token, d_expert_in,
                          d_combine, d_aux):
    """The VJP of `moe_gate_dispatch_reference` at a given routing (what
    the kernel or `moe_routing_reference` chose) -> (dx [T, D],
    dgate_w [D, E]).  A cotangent may be None (zero).

    expert_in gathers x, so dx gets each slot's d expert_in back at its
    token; combine is the kept gate values (top-2: g / (g1 + g2)) at the
    kept slots, and aux reads the mean probs: both reach the logits
    through the softmax.  A slot (e, c) holds a first choice exactly
    when c is below the number of tokens whose first choice is e, since
    second choices are placed after all of them; inverting the slot map
    gives each (choice, token) its slot, and every term is then a
    gather: no atomics, and no value read back to the host (no boolean
    indexing, no bincount), so the backward queues without a sync."""
    T, E = probs.shape
    C = slot_token.shape[1]
    k = idx.shape[0]
    dev = probs.device
    tok = slot_token.reshape(-1).long()
    slots = torch.arange(E * C, device=dev)
    idx1 = idx[0].long()
    first_count = torch.zeros(E, dtype=torch.long, device=dev).scatter_add_(
        0, idx1, torch.ones_like(idx1))
    # slot_of[j, t]: the slot holding token t's choice j, or -1 (dropped);
    # empty slots write into a spare column T that is cut off
    target = torch.where(tok >= 0, tok, T)
    if k == 2:
        second = (slots % C) >= first_count[slots // C]
        target = target + second.long() * (T + 1)
    slot_of = torch.full((k * (T + 1),), -1, dtype=torch.long, device=dev)
    slot_of = slot_of.scatter_(0, target, slots).view(k, T + 1)[:, :T]
    held = slot_of >= 0
    at = slot_of.clamp(min=0)

    dprobs = torch.zeros((T, E), dtype=torch.float32, device=dev)
    if d_aux is not None:
        frac_tokens = first_count.float() / T
        dprobs += (d_aux.reshape(()).float() * E * frac_tokens / T)[None, :]
    if d_combine is not None:
        dc = torch.where(held, d_combine.reshape(T, E * C).gather(1, at.t())
                         .t(), 0.0)                          # [k, T]
        gidx = idx.long().t()                                # [T, k]
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
        rows = d_expert_in.reshape(E * C, -1).to(dx.dtype)
        d_disp = torch.where(held[0, :, None], rows[at[0]], 0.0)
        if k == 2:
            d_disp = d_disp + torch.where(held[1, :, None], rows[at[1]], 0.0)
        dx = dx + d_disp
    return dx, x.t() @ d_logits


def _library():
    global _lib
    if _lib is None:
        from . import cuda_build

        lib = cuda_build.load_library(SOURCE)
        fn = lib.moe_gate_dispatch
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def build():
    """Build (or load) the kernel library; the first CUDA call builds it
    anyway — this lets a caller pay the build up front."""
    _library()


def moe_gate_dispatch_launch(x, gate_w, num_experts: int, capacity: int,
                             top_k: int = 1):
    """Launch the kernel on CUDA tensors (no autograd, not counted) ->
    (expert_in [E, C, D], combine [T, E, C], aux [1, 1], and the
    routing: probs [T, E], idx [top_k, T] int32 each token's first (and
    second) expert, slot_token [E, C] int32 the token in each capacity
    slot or -1)."""
    E, C, k = int(num_experts), int(capacity), int(top_k)
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
    if gate_w.device != x.device:
        raise ValueError("moe_gate_dispatch: x and gate_w on "
                         f"{x.device} and {gate_w.device}")
    x, gate_w = x.contiguous(), gate_w.contiguous()
    dev = x.device
    f32, i32 = torch.float32, torch.int32
    probs = torch.empty((T, E), dtype=f32, device=dev)
    idx = torch.empty((2, T), dtype=i32, device=dev)
    gate = torch.empty((2, T), dtype=f32, device=dev)
    slot_token = torch.empty((E, C), dtype=i32, device=dev)
    slot_weight = torch.empty((E, C), dtype=f32, device=dev)
    expert_in = torch.empty((E, C, D), dtype=f32, device=dev)
    combine = torch.empty((T, E, C), dtype=f32, device=dev)
    aux = torch.empty((1, 1), dtype=f32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        rc = lib.moe_gate_dispatch(
            x.data_ptr(), gate_w.data_ptr(), probs.data_ptr(),
            idx.data_ptr(), gate.data_ptr(), slot_token.data_ptr(),
            slot_weight.data_ptr(), expert_in.data_ptr(), combine.data_ptr(),
            aux.data_ptr(), T, D, E, C, k,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"moe_gate_dispatch launch failed: CUDA error {rc}")
    return expert_in, combine, aux, probs, idx[:k], slot_token


class _MoeGateDispatch(torch.autograd.Function):
    """The kernel forward under autograd; the backward is the plain
    composition's VJP at the routing the kernel chose."""

    @staticmethod
    def forward(ctx, x, gate_w, num_experts, capacity, top_k):
        expert_in, combine, aux, probs, idx, slot_token = \
            moe_gate_dispatch_launch(x, gate_w, num_experts, capacity, top_k)
        with _count_lock:
            moe_gate_dispatch.launches += 1
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, gate_w, probs, idx, slot_token)
        return expert_in, combine, aux

    @staticmethod
    def backward(ctx, d_expert_in, d_combine, d_aux):
        x, gate_w, probs, idx, slot_token = ctx.saved_tensors
        dx, dgate_w = moe_gate_dispatch_vjp(x, gate_w, probs, idx,
                                            slot_token, d_expert_in,
                                            d_combine, d_aux)
        return (dx if ctx.needs_input_grad[0] else None,
                dgate_w if ctx.needs_input_grad[1] else None,
                None, None, None)


def moe_gate_dispatch(x, gate_w, num_experts: int, capacity: int,
                      top_k: int = 1):
    """Gate + capacity dispatch: x [T, D] f32, gate_w [D, E] f32 ->
    (expert_in [E, C, D], combine [T, E, C], aux [1, 1]), differentiable
    in x and gate_w.  CPU and meta tensors run the plain version; CUDA
    tensors launch the kernel (one count per call) or raise."""
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
    (expert_in [E, C, D] f32, combine [T, E, C] f32, aux [1, 1] f32)."""
    T, D, E, C, k = (int(tokens), int(d_model), int(num_experts),
                     int(capacity), int(top_k))

    def fused(x, gate_w):
        if tuple(x.shape) != (T, D):
            raise ValueError(f"moe_gate_dispatch built for x [{T}, {D}], "
                             f"got {tuple(x.shape)}")
        return moe_gate_dispatch(x, gate_w, E, C, k)

    return fused
