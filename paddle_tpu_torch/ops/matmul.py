"""Flatten-to-2D GEMM `mul` and its gradient, the batched `matmul` and
`bilinear_tensor_product` (counterpart of paddle_tpu/ops/matmul.py).
Under amp `mul` and `matmul` cast both operands to bfloat16 at the
input edge, so the product runs in bf16."""
from __future__ import annotations

import math

import torch

from ..amp import amp_cast
from ..core.execution import data_of, one, scalar_like, with_lod_of
from ..core.registry import register_grad_lower, register_op


def _operands(x, y, attrs):
    """X and Y flattened to 2-D as the product takes them, amp-cast."""
    xd, yd = attrs["x_num_col_dims"], attrs["y_num_col_dims"]
    x2 = x.reshape(math.prod(x.shape[:xd]), -1)
    y2 = y.reshape(math.prod(y.shape[:yd]), -1)
    return amp_cast(x2, y2)


@register_op("mul", inputs=("X", "Y"), outputs=("Out",),
             attrs={"x_num_col_dims": 1, "y_num_col_dims": 1}, lod=True,
             cost="matmul")
def mul(ctx, ins, attrs):
    xv = one(ins, "X")
    x = data_of(xv)
    y = data_of(one(ins, "Y"))
    out = torch.matmul(*_operands(x, y, attrs))
    xd, yd = attrs["x_num_col_dims"], attrs["y_num_col_dims"]
    return {"Out": with_lod_of(
        xv, out.reshape(tuple(x.shape[:xd]) + tuple(y.shape[yd:])))}


@register_grad_lower("mul")
def mul_grad(ctx, ins, attrs):
    """dX = dOut2 Y2^T and dY = X2^T dOut2 on the operands the forward
    multiplied (amp-cast), without re-running the forward product.  The
    cotangent is taken in the product's dtype and each result is cast
    back to its input's dtype (an f32 weight gets an f32 gradient, as
    the VJP of the input-edge cast gives it)."""
    x, y = one(ins, "X"), one(ins, "Y")
    x2, y2 = _operands(x, y, attrs)
    g2 = one(ins, "Out@GRAD").reshape(x2.shape[0], y2.shape[1])
    g2 = g2.to(torch.result_type(x2, y2))
    return {"X@GRAD": [torch.matmul(g2, y2.t()).reshape(x.shape)
                       .to(x.dtype)],
            "Y@GRAD": [torch.matmul(x2.t(), g2).reshape(y.shape)
                       .to(y.dtype)]}


@register_op("matmul", inputs=("X", "Y"), outputs=("Out",),
             attrs={"transpose_X": False, "transpose_Y": False,
                    "alpha": 1.0},
             cost="matmul")
def matmul(ctx, ins, attrs):
    """Reference matmul_op.h semantics: a 1-D operand is a row (X) or a
    column (Y) vector, squeezed out of the result; leading batch dims
    broadcast; `alpha` scales the product in its dtype."""
    x, y = amp_cast(one(ins, "X"), one(ins, "Y"))
    tx, ty = attrs["transpose_X"], attrs["transpose_Y"]
    squeeze_first = squeeze_last = False
    if x.dim() == 1:
        x = x[:, None] if tx else x[None, :]
        tx, squeeze_first = False, True
    if y.dim() == 1:
        y = y[None, :] if ty else y[:, None]
        ty, squeeze_last = False, True
    if tx:
        x = x.transpose(-1, -2)
    if ty:
        y = y.transpose(-1, -2)
    out = torch.matmul(x, y)
    alpha = attrs.get("alpha", 1.0)
    if alpha != 1.0:
        out = out * scalar_like(out, alpha)
    if squeeze_first:
        out = out.squeeze(-2)
    if squeeze_last:
        out = out.squeeze(-1)
    return {"Out": out}


@register_op("bilinear_tensor_product", inputs=("X", "Y", "Weight", "Bias"),
             outputs=("Out",))
def bilinear_tensor_product(ctx, ins, attrs):
    """out[b, k] = x[b] W[k] y[b] (+ bias)."""
    out = torch.einsum("bm,kmn,bn->bk", one(ins, "X"), one(ins, "Weight"),
                       one(ins, "Y"))
    b = one(ins, "Bias")
    return {"Out": out if b is None else out + b}
