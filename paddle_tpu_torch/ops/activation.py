"""relu, square, sqrt, softmax and dropout (counterpart of
paddle_tpu/ops/activation.py)."""
from __future__ import annotations

import math

import torch

from ..amp import amp_upcast
from ..core.execution import _M32, _mix, mix32_, one
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


# rows of one keyed draw at a time: at most 2^21 elements, so the hash's
# int64 state and its shifted temporary take 16 MiB each
_DRAW_CHUNK = 1 << 21


def keyed_uniform_mask(shape, p, seed, row_offset, dtype, device):
    """Paddle's keep mask (1 where u >= p, else 0, in `dtype`) from a
    counter-based uniform of (seed, global row, element index): row i of
    the result is keyed by row_offset + i and nothing else, so any split
    of the rows draws the same bits as the whole.  Plain integer ops, so
    the CPU and a CUDA device draw the same mask.  u is the hash's top
    24 bits times 2^-24: a float32 in [0, 1), never rounded up to 1."""
    rows = int(shape[0])
    cols = math.prod(shape[1:])
    mask = torch.empty((rows, cols), dtype=dtype, device=device)
    key = _mix(seed, 0)     # small user seeds too get 63 scrambled bits
    k0, k1 = key & _M32, key >> 32
    i64 = torch.int64
    col = mix32_(torch.arange(cols, dtype=i64, device=device) ^ k1)
    step = max(1, _DRAW_CHUNK // max(cols, 1))
    for r0 in range(0, rows, step):
        r = torch.arange(row_offset + r0, row_offset + min(rows, r0 + step),
                         dtype=i64, device=device)
        row = mix32_(mix32_((r & _M32) ^ k0) ^ k1)
        h = mix32_(row[:, None] ^ col[None, :])
        u = (h >> 8).to(torch.float32).mul_(2.0 ** -24)
        mask[r0:r0 + len(r)] = u >= p
    return mask.reshape(shape)


@register_op("dropout", inputs=("X",), outputs=("Out", "Mask"),
             attrs={"dropout_prob": 0.5, "is_test": False, "seed": 0,
                    "fix_seed": False},
             diff_inputs=("X",), diff_outputs=("Out",), random=True)
def dropout(ctx, ins, attrs):
    """Paddle's "downgrade in infer" dropout: in training Out = X * Mask
    with no 1/(1-p) upscale, Mask a 0/1 tensor of X's dtype keeping each
    element with probability 1 - p; in test Out = X * (1 - p) and Mask
    is ones.

    Batch-position-keyed masks, as the JAX package's: row i's mask
    depends only on (the op's seed, global row ctx.row_offset + i), so a
    dp-sharded step reproduces the serial masks bit for bit.  The op's
    seed is the context's (the step's seed mixed with the op's
    identity), or `seed` when `fix_seed`.  The JAX package draws its
    rows from threefry keys, which are not matched bit for bit: the two
    agree in distribution."""
    x = one(ins, "X")
    p = float(attrs["dropout_prob"])
    if attrs.get("is_test"):
        keep = torch.full((), 1.0 - p, dtype=x.dtype, device=x.device)
        return {"Out": x * keep, "Mask": torch.ones_like(x)}
    if x.device.type == "meta":
        mask = torch.empty_like(x)
    else:
        seed = int(attrs["seed"]) if attrs.get("fix_seed") else \
            (ctx.seed or 0)
        mask = keyed_uniform_mask(x.shape, p, seed, ctx.row_offset, x.dtype,
                                  x.device)
    return {"Out": x * mask, "Mask": mask}


@register_op("dropout_grad", inputs=("Mask", "Out@GRAD"),
             outputs=("X@GRAD",))
def dropout_grad(ctx, ins, attrs):
    """The saved mask times the cotangent: the gradient never redraws."""
    return {"X@GRAD": one(ins, "Out@GRAD") * one(ins, "Mask")}
