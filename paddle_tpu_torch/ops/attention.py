"""The `flash_attention` op and its gradient (counterpart of
paddle_tpu/ops/attention.py).

On CUDA tensors the forward runs the hand-written flash-attention
kernel (kernels/flash_attention.py), whose output carries the forward's
logsumexp, and the gradient runs the dQ and dK/dV kernels from `Out`,
`Out@GRAD` and that logsumexp, with no forward recompute; a call the
kernels do not take (head_dim, dtype, shape) raises there.  CPU and meta
tensors (build-time shape inference) run the plain composition, and
their gradient is its autograd gradient.  The `min_seq_k` attr is kept
so Programs equal the JAX package's, and is not read: the JAX op's
crossover was measured on a TPU.

Sequence parallelism: when the context's root carries `sp_axis` (a
PipelineExecutor stage whose trunk activations are split on the
sequence dim), Q/K/V are this rank's sequence blocks and the op runs
ring attention over that axis's group (parallel/ring_attention.py
`ring_attention_local`, composed in PyTorch as the JAX package's is);
its gradient is the autograd gradient of the ring, whose K/V shifts
run backwards.
"""
from __future__ import annotations

from ..core.execution import generic_grad_lower, one
from ..core.registry import get_op_info, register_grad_lower, register_op
from ..kernels.flash_attention import (flash_attention, flash_attention_bwd,
                                       flash_attention_fwd, saved_lse)


def _causal_scale(attrs):
    """(causal, scale): default_scale=True -> scale None, 1/sqrt(head_dim);
    otherwise the explicit `scale` attr."""
    scale = None if attrs.get("default_scale", True) else attrs["scale"]
    return bool(attrs.get("causal", False)), scale


def _sp_group(ctx):
    """The sequence-parallel axis group the op rings over, or None."""
    root = getattr(ctx, "root", None)
    axis = getattr(root, "sp_axis", None)
    if axis is None or ctx.device.type == "meta":
        return None
    return ctx.groups[axis]


@register_op("flash_attention", inputs=("Q", "K", "V"), outputs=("Out",),
             attrs={"causal": False, "scale": 1.0, "default_scale": True,
                    "min_seq_k": -1},
             cost="attention")
def flash_attention_op(ctx, ins, attrs):
    """Q/K/V: [batch, seq, heads, head_dim]."""
    causal, scale = _causal_scale(attrs)
    group = _sp_group(ctx)
    if group is not None:
        from ..parallel.ring_attention import ring_attention_local

        return {"Out": ring_attention_local(
            one(ins, "Q"), one(ins, "K"), one(ins, "V"), group,
            causal=causal, scale=scale)}
    return {"Out": flash_attention(one(ins, "Q"), one(ins, "K"),
                                   one(ins, "V"), causal=causal,
                                   scale=scale)}


@register_grad_lower("flash_attention")
def flash_attention_grad(ctx, ins, attrs):
    """Q@GRAD, K@GRAD, V@GRAD.  On a card: the backward kernels from the
    forward's `Out` and the logsumexp it carries; an `Out` without one
    (not made by the forward kernel) re-runs the forward kernel for
    it.  CPU tensors: the plain composition's autograd gradient; under
    sequence parallelism, the ring's."""
    q, k, v = one(ins, "Q"), one(ins, "K"), one(ins, "V")
    if q.device.type != "cuda" or _sp_group(ctx) is not None:
        return generic_grad_lower(ctx, ins, attrs,
                                  get_op_info("flash_attention"))
    causal, scale = _causal_scale(attrs)
    out = one(ins, "Out")
    lse = saved_lse(out)
    if lse is None:
        out, lse = flash_attention_fwd(q, k, v, causal, scale)
    dq, dk, dv = flash_attention_bwd(q, k, v, out, one(ins, "Out@GRAD"),
                                     lse, causal, scale)
    return {"Q@GRAD": [dq], "K@GRAD": [dk], "V@GRAD": [dv]}
