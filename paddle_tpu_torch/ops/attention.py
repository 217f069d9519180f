"""The `flash_attention` op (counterpart of paddle_tpu/ops/attention.py).

On CUDA tensors it runs the hand-written flash-attention kernels
(kernels/flash_attention.py: forward here, dQ and dK/dV when the
generic gradient differentiates it), and a call the kernels do not take
(head_dim, dtype, shape) raises there.  CPU and meta tensors
(build-time shape inference) run the plain composition.  The
`min_seq_k` attr is kept so Programs equal the JAX package's, and is
not read: the JAX op's crossover was measured on a TPU.  The JAX op's
sequence-parallel branch (sp_axis) is ROADMAP A9.
"""
from __future__ import annotations

from ..core.execution import one
from ..core.registry import register_op
from ..kernels.flash_attention import flash_attention


@register_op("flash_attention", inputs=("Q", "K", "V"), outputs=("Out",),
             attrs={"causal": False, "scale": 1.0, "default_scale": True,
                    "min_seq_k": -1})
def flash_attention_op(ctx, ins, attrs):
    """Q/K/V: [batch, seq, heads, head_dim].  default_scale=True ->
    1/sqrt(head_dim); otherwise the explicit `scale` attr."""
    q, k, v = one(ins, "Q"), one(ins, "K"), one(ins, "V")
    scale = None if attrs.get("default_scale", True) else attrs["scale"]
    return {"Out": flash_attention(q, k, v,
                                   causal=bool(attrs.get("causal", False)),
                                   scale=scale)}
