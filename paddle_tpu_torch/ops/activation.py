"""The activation table, softmax, prelu and dropout (counterpart of
paddle_tpu/ops/activation.py).

Gradients are the generic ones (autograd over the lowering), so each
lowering is written as the JAX package's is, where a tie or a kink
decides the gradient: `clip` is a maximum then a minimum (a tie sends
half the cotangent each way, as `jnp.clip`'s VJP does; `torch.clamp`
sends all of it), `abs` takes the positive branch at 0 (`jnp.abs`'s
derivative there is 1; `torch.abs`'s is 0), and a `where` keeps the
JAX package's comparison and branch order.
"""
from __future__ import annotations

import math

import torch

from ..amp import amp_upcast
from ..core.execution import (_M32, _mix, data_of, mix32_, one, scalar_like,
                              with_lod_of)
from ..core.registry import register_op


def clip(x, lo, hi):
    """min(max(x, lo), hi) with the bounds in x's dtype: at x == lo or
    x == hi the gradient is 1/2, as `jnp.clip`'s."""
    return torch.minimum(torch.maximum(x, scalar_like(x, lo)),
                         scalar_like(x, hi))


def abs_(x):
    """|x| whose derivative at 0 is 1, as `jnp.abs`'s."""
    return torch.where(x >= 0, x, -x)


def _zeros(x):
    return torch.zeros_like(x)


_UNARY = {
    "sigmoid": (lambda x, a: torch.sigmoid(x), {}),
    "logsigmoid": (lambda x, a: torch.nn.functional.logsigmoid(x), {}),
    "exp": (lambda x, a: torch.exp(x), {}),
    "relu": (lambda x, a: torch.relu(x), {}),
    "tanh": (lambda x, a: torch.tanh(x), {}),
    "tanh_shrink": (lambda x, a: x - torch.tanh(x), {}),
    "softshrink": (
        lambda x, a: torch.where(
            x > a["lambda"], x - a["lambda"],
            torch.where(x < -a["lambda"], x + a["lambda"], _zeros(x))),
        {"lambda": 0.5}),
    "sqrt": (lambda x, a: torch.sqrt(x), {}),
    "abs": (lambda x, a: abs_(x), {}),
    "ceil": (lambda x, a: torch.ceil(x), {}),
    "floor": (lambda x, a: torch.floor(x), {}),
    # half to even on both sides
    "round": (lambda x, a: torch.round(x), {}),
    "reciprocal": (lambda x, a: torch.reciprocal(x), {}),
    "log": (lambda x, a: torch.log(x), {}),
    "square": (lambda x, a: torch.square(x), {}),
    # jax.nn.softplus is logaddexp(x, 0): no linear cut-over
    "softplus": (lambda x, a: torch.logaddexp(x, _zeros(x)), {}),
    "softsign": (lambda x, a: x / (1 + abs_(x)), {}),
    "brelu": (lambda x, a: clip(x, a["t_min"], a["t_max"]),
              {"t_min": 0.0, "t_max": 24.0}),
    "leaky_relu": (lambda x, a: torch.where(x > 0, x, a["alpha"] * x),
                   {"alpha": 0.02}),
    "soft_relu": (
        lambda x, a: torch.log1p(torch.exp(
            clip(x, -a["threshold"], a["threshold"]))),
        {"threshold": 40.0}),
    "elu": (lambda x, a: torch.where(x > 0, x,
                                     a["alpha"] * torch.expm1(x)),
            {"alpha": 1.0}),
    "relu6": (lambda x, a: clip(x, 0.0, a["threshold"]),
              {"threshold": 6.0}),
    "pow": (lambda x, a: torch.pow(x, a["factor"]), {"factor": 1.0}),
    "stanh": (lambda x, a: a["scale_b"] * torch.tanh(a["scale_a"] * x),
              {"scale_a": 2.0 / 3.0, "scale_b": 1.7159}),
    "hard_shrink": (
        lambda x, a: torch.where(abs_(x) > a["threshold"], x, _zeros(x)),
        {"threshold": 0.5}),
    "thresholded_relu": (
        lambda x, a: torch.where(x > a["threshold"], x, _zeros(x)),
        {"threshold": 1.0}),
    "hard_sigmoid": (
        lambda x, a: clip(a["slope"] * x + a["offset"], 0.0, 1.0),
        {"slope": 0.2, "offset": 0.5}),
    "swish": (lambda x, a: x * torch.sigmoid(a["beta"] * x), {"beta": 1.0}),
}


def _unary(name, fn, attrs):
    @register_op(name, inputs=("X",), outputs=("Out",), attrs=attrs,
                 lod=True)
    def lower(ctx, ins, attrs, _fn=fn):
        xv = one(ins, "X")
        return {"Out": with_lod_of(xv, _fn(data_of(xv), attrs))}

    return lower


for _name, (_fn, _attrs) in _UNARY.items():
    _unary(_name, _fn, _attrs)


@register_op("softmax", inputs=("X",), outputs=("Out",), lod=True)
def softmax(ctx, ins, attrs):
    """Reference softmax_op.cc: softmax over the last dim.  Under amp a
    bf16 input is upcast to f32 (numerically sensitive)."""
    xv = one(ins, "X")
    return {"Out": with_lod_of(
        xv, torch.softmax(amp_upcast(data_of(xv)), dim=-1))}


@register_op("prelu", inputs=("X", "Alpha"), outputs=("Out",), lod=True)
def prelu(ctx, ins, attrs):
    """One learned slope for every negative element."""
    xv = one(ins, "X")
    x = data_of(xv)
    alpha = data_of(one(ins, "Alpha")).reshape(())
    return {"Out": with_lod_of(xv, torch.where(x > 0, x, alpha * x))}


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
    mask = torch.empty((rows, math.prod(shape[1:])), dtype=dtype,
                       device=device)
    for r0, h in _keyed_hashes(rows, mask.shape[1], seed, row_offset,
                               device):
        u = (h >> 8).to(torch.float32).mul_(2.0 ** -24)
        mask[r0:r0 + len(h)] = u >= p
    return mask.reshape(shape)


def keyed_randint(rows, cols, high, seed, row_offset, device):
    """[rows, cols] int64 in [0, high), uniform up to a bias below
    high / 2^32, from the hash of (seed, global row, column) that
    `keyed_uniform_mask` draws from: (h * high) >> 32."""
    out = torch.empty((rows, cols), dtype=torch.int64, device=device)
    for r0, h in _keyed_hashes(rows, cols, seed, row_offset, device):
        out[r0:r0 + len(h)] = (h * high) >> 32
    return out


def _keyed_hashes(rows, cols, seed, row_offset, device):
    """Yields (first row, [n, cols] int64 32-bit hashes of (seed, global
    row row_offset + i, column)) over the rows, a chunk at a time."""
    key = _mix(seed, 0)     # small user seeds too get 63 scrambled bits
    k0, k1 = key & _M32, key >> 32
    i64 = torch.int64
    col = mix32_(torch.arange(cols, dtype=i64, device=device) ^ k1)
    step = max(1, _DRAW_CHUNK // max(cols, 1))
    for r0 in range(0, rows, step):
        r = torch.arange(row_offset + r0, row_offset + min(rows, r0 + step),
                         dtype=i64, device=device)
        row = mix32_(mix32_((r & _M32) ^ k0) ^ k1)
        yield r0, mix32_(row[:, None] ^ col[None, :])


@register_op("dropout", inputs=("X",), outputs=("Out", "Mask"),
             attrs={"dropout_prob": 0.5, "is_test": False, "seed": 0,
                    "fix_seed": False},
             diff_inputs=("X",), diff_outputs=("Out",), random=True,
             lod=True)
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
    xv = one(ins, "X")
    x = data_of(xv)
    p = float(attrs["dropout_prob"])
    if attrs.get("is_test"):
        keep = scalar_like(x, 1.0 - p)
        return {"Out": with_lod_of(xv, x * keep), "Mask": torch.ones_like(x)}
    if x.device.type == "meta":
        mask = torch.empty_like(x)
    else:
        seed = int(attrs["seed"]) if attrs.get("fix_seed") else \
            (ctx.seed or 0)
        mask = keyed_uniform_mask(x.shape, p, seed, ctx.row_offset, x.dtype,
                                  x.device)
    return {"Out": with_lod_of(xv, x * mask), "Mask": mask}


@register_op("dropout_grad", inputs=("Mask", "Out@GRAD"),
             outputs=("X@GRAD",))
def dropout_grad(ctx, ins, attrs):
    """The saved mask times the cotangent: the gradient never redraws."""
    return {"X@GRAD": one(ins, "Out@GRAD") * one(ins, "Mask")}
