"""Mixture-of-Experts FFN op (counterpart of paddle_tpu/ops/moe.py).

The op lowers to the mesh-free GShard math in parallel/moe.py
(`moe_dense`: top-1/top-2 gating, static capacity, dispatch/combine,
batched expert matmuls), with gate and dispatch on the hand-written
CUDA kernel when the kernel tier is armed.  The auxiliary load-balance
loss is a real output: add `aux_weight * AuxLoss` to the training loss
to train the router toward balance.
"""
from __future__ import annotations

from ..core.execution import one
from ..core.registry import register_op


@register_op("moe_ffn",
             inputs=("X", "GateW", "WIn", "WOut"),
             outputs=("Out", "AuxLoss"),
             attrs={"top_k": 1, "capacity_factor": 1.25},
             diff_inputs=("X", "GateW", "WIn", "WOut"),
             diff_outputs=("Out", "AuxLoss"),
             cost="moe")
def moe_ffn(ctx, ins, attrs):
    """Under expert parallelism the tensor-parallel rule sets `ep_axis`
    (parallel/tensor_parallel.py): WIn/WOut are this rank's experts'
    blocks and the op runs `moe_ep_local` over that axis's group."""
    from ..parallel.moe import moe_dense, moe_ep_local

    x = one(ins, "X")
    lead = x.shape[:-1]
    flat = x.reshape(-1, x.shape[-1])
    kw = dict(capacity_factor=float(attrs["capacity_factor"]),
              top_k=int(attrs["top_k"]))
    ep = attrs.get("ep_axis")
    if ep is not None and x.device.type != "meta":
        y, aux = moe_ep_local(flat, one(ins, "GateW"), one(ins, "WIn"),
                              one(ins, "WOut"), ctx.groups[ep], **kw)
    else:
        y, aux = moe_dense(flat, one(ins, "GateW"), one(ins, "WIn"),
                           one(ins, "WOut"), **kw)
    return {"Out": y.reshape(*lead, y.shape[-1]),
            "AuxLoss": aux.reshape(1)}
