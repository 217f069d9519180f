"""Creation ops: the startup initializers, fill_zeros_like and assign
(counterpart of paddle_tpu/ops/creation.py).

Random draws use the ExecContext's `torch.Generator`: the values differ
from the JAX package's threefry streams by design, so parity tests copy
the JAX package's initial parameters in (core/scope.scope_from_numpy).
"""
from __future__ import annotations

import torch

from ..core.execution import one
from ..core.registry import register_op
from ..core.types import torch_dtype


@register_op("fill_constant", inputs=(), outputs=("Out",),
             attrs={"shape": [1], "value": 0.0, "dtype": "float32",
                    "force_cpu": False},
             not_differentiable=True)
def fill_constant(ctx, ins, attrs):
    return {"Out": torch.full(tuple(attrs["shape"]), attrs["value"],
                              dtype=torch_dtype(attrs["dtype"]),
                              device=ctx.device)}


@register_op("uniform_random", inputs=(), outputs=("Out",),
             attrs={"shape": [1], "min": -1.0, "max": 1.0, "seed": 0,
                    "dtype": "float32", "force_cpu": False},
             random=True, not_differentiable=True)
def uniform_random(ctx, ins, attrs):
    out = torch.empty(tuple(attrs["shape"]), dtype=torch.float32,
                      device=ctx.device)
    out.uniform_(attrs["min"], attrs["max"], generator=ctx.generator)
    return {"Out": out.to(torch_dtype(attrs["dtype"]))}


@register_op("gaussian_random", inputs=(), outputs=("Out",),
             attrs={"shape": [1], "mean": 0.0, "std": 1.0, "seed": 0,
                    "dtype": "float32", "force_cpu": False},
             random=True, not_differentiable=True)
def gaussian_random(ctx, ins, attrs):
    out = torch.empty(tuple(attrs["shape"]), dtype=torch.float32,
                      device=ctx.device)
    out.normal_(attrs["mean"], attrs["std"], generator=ctx.generator)
    return {"Out": out.to(torch_dtype(attrs["dtype"]))}


@register_op("fill_zeros_like", inputs=("X",), outputs=("Out",),
             not_differentiable=True)
def fill_zeros_like(ctx, ins, attrs):
    return {"Out": torch.zeros_like(one(ins, "X"))}


@register_op("assign", inputs=("X",), outputs=("Out",))
def assign(ctx, ins, attrs):
    return {"Out": one(ins, "X")}


@register_op("increment", inputs=("X",), outputs=("Out",),
             attrs={"step": 1.0}, inplace={"Out": "X"})
def increment(ctx, ins, attrs):
    x = one(ins, "X")
    return {"Out": x + torch.full((), attrs["step"], dtype=x.dtype,
                                  device=x.device)}
