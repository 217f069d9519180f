"""relu, square, sqrt, softmax and dropout (counterpart of
paddle_tpu/ops/activation.py)."""
from __future__ import annotations

import torch

from ..amp import amp_upcast
from ..core.execution import one
from ..core.registry import register_op


@register_op("relu", inputs=("X",), outputs=("Out",))
def relu(ctx, ins, attrs):
    return {"Out": torch.relu(one(ins, "X"))}


@register_op("square", inputs=("X",), outputs=("Out",))
def square(ctx, ins, attrs):
    return {"Out": torch.square(one(ins, "X"))}


@register_op("sqrt", inputs=("X",), outputs=("Out",))
def sqrt(ctx, ins, attrs):
    return {"Out": torch.sqrt(one(ins, "X"))}


@register_op("softmax", inputs=("X",), outputs=("Out",))
def softmax(ctx, ins, attrs):
    """Reference softmax_op.cc: softmax over the last dim.  Under amp a
    bf16 input is upcast to f32 (numerically sensitive)."""
    return {"Out": torch.softmax(amp_upcast(one(ins, "X")), dim=-1)}


@register_op("dropout", inputs=("X",), outputs=("Out", "Mask"),
             attrs={"dropout_prob": 0.5, "is_test": False, "seed": 0,
                    "fix_seed": False},
             diff_inputs=("X",), diff_outputs=("Out",), random=True)
def dropout(ctx, ins, attrs):
    """Paddle's "downgrade in infer" dropout: in training Out = X * Mask
    with no 1/(1-p) upscale, Mask a 0/1 tensor of X's dtype keeping each
    element with probability 1 - p; in test Out = X * (1 - p) and Mask
    is ones.  The draws come from the op's own stream (`ctx.generator`),
    or from `seed` when `fix_seed`; the JAX package's threefry row keys
    cannot be matched bit for bit, so the two agree in distribution."""
    x = one(ins, "X")
    p = float(attrs["dropout_prob"])
    if attrs.get("is_test"):
        keep = torch.full((), 1.0 - p, dtype=x.dtype, device=x.device)
        return {"Out": x * keep, "Mask": torch.ones_like(x)}
    gen = ctx.generator
    if attrs.get("fix_seed") and x.device.type != "meta":
        gen = torch.Generator(device=x.device)
        gen.manual_seed(int(attrs["seed"]))
    u = torch.rand(x.shape, generator=gen, device=x.device)
    mask = (u >= p).to(x.dtype)
    return {"Out": x * mask, "Mask": mask}


@register_op("dropout_grad", inputs=("Mask", "Out@GRAD"),
             outputs=("X@GRAD",))
def dropout_grad(ctx, ins, attrs):
    """The saved mask times the cotangent: the gradient never redraws."""
    return {"X@GRAD": one(ins, "Out@GRAD") * one(ins, "Mask")}
