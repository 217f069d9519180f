"""Flatten-to-2D GEMM `mul` and its gradient (counterpart of
paddle_tpu/ops/matmul.py).  Under amp both operands are cast to
bfloat16 at the input edge, so the product runs in bf16."""
from __future__ import annotations

import math

import torch

from ..amp import amp_cast
from ..core.execution import one
from ..core.registry import register_grad_lower, register_op


def _operands(x, y, attrs):
    """X and Y flattened to 2-D as the product takes them, amp-cast."""
    xd, yd = attrs["x_num_col_dims"], attrs["y_num_col_dims"]
    x2 = x.reshape(math.prod(x.shape[:xd]), -1)
    y2 = y.reshape(math.prod(y.shape[:yd]), -1)
    return amp_cast(x2, y2)


@register_op("mul", inputs=("X", "Y"), outputs=("Out",),
             attrs={"x_num_col_dims": 1, "y_num_col_dims": 1})
def mul(ctx, ins, attrs):
    x = one(ins, "X")
    y = one(ins, "Y")
    out = torch.matmul(*_operands(x, y, attrs))
    xd, yd = attrs["x_num_col_dims"], attrs["y_num_col_dims"]
    return {"Out": out.reshape(tuple(x.shape[:xd]) + tuple(y.shape[yd:]))}


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
