"""Creation ops: the startup initializers, the batch-size-like fills,
fill_zeros_like, assign and assign_value, cast, one_hot, shape and
isfinite (counterpart of paddle_tpu/ops/creation.py).

Random draws use the ExecContext's `torch.Generator`: the values differ
from the JAX package's threefry streams by design, so parity tests copy
the JAX package's initial parameters in (core/scope.scope_from_numpy).
"""
from __future__ import annotations

import collections

import numpy as np
import torch

from ..core.execution import data_of, one, scalar_like, with_lod_of
from ..core.registry import register_op
from ..core.types import torch_dtype

# constants built from an op's attribute list, one per (list, dtype,
# shape, device): kept so a step does not rebuild them from Python
# lists (the LM's causal mask is 262,144 floats), and so a CUDA graph
# captures no host-to-device copy.  The list itself is held beside its
# tensor, so its id is not reused while the entry lives.
_CONSTANTS: "collections.OrderedDict" = collections.OrderedDict()
_CONSTANTS_MAX = 256


def attr_constant(ctx, values, dtype, shape):
    """The tensor of `values` (a list attribute) as `dtype` in `shape`
    on ctx's device, built at its first use there and reused after.
    The run's `ctx.tables` holds it as well: a cache entry of the
    Executor (and the CUDA graph it captures) keeps the tensor its
    eager run read, even once _CONSTANTS has dropped it."""
    dtype = torch_dtype(dtype)
    shape = tuple(int(s) for s in shape)
    device = ctx.device
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    key = (id(values), dtype, shape, device)
    hit = ctx.tables.get(("constant",) + key)
    if hit is None or hit[0] is not values:
        hit = _CONSTANTS.get(key)
        if hit is not None and hit[0] is values:
            _CONSTANTS.move_to_end(key)
        else:
            arr = np.asarray(values, dtype=np.float64
                             if dtype.is_floating_point else None)
            hit = (values, torch.as_tensor(arr.reshape(shape)).to(
                dtype=dtype, device=device))
            _CONSTANTS[key] = hit
            while len(_CONSTANTS) > _CONSTANTS_MAX:
                _CONSTANTS.popitem(last=False)
        ctx.tables[("constant",) + key] = hit
    return hit[1]


@register_op("fill_constant", inputs=(), outputs=("Out",),
             attrs={"shape": [1], "value": 0.0, "dtype": "float32",
                    "force_cpu": False},
             not_differentiable=True)
def fill_constant(ctx, ins, attrs):
    return {"Out": torch.full(tuple(attrs["shape"]), attrs["value"],
                              dtype=torch_dtype(attrs["dtype"]),
                              device=ctx.device)}


def _batch_size_like(ins, attrs):
    """`shape` with dim output_dim_idx taken from Input's input_dim_idx."""
    shape = [int(s) for s in attrs["shape"]]
    shape[attrs["output_dim_idx"]] = \
        one(ins, "Input").shape[attrs["input_dim_idx"]]
    return tuple(shape)


@register_op("fill_constant_batch_size_like", inputs=("Input",),
             outputs=("Out",),
             attrs={"shape": [1], "value": 0.0, "dtype": "float32",
                    "input_dim_idx": 0, "output_dim_idx": 0},
             not_differentiable=True)
def fill_constant_batch_size_like(ctx, ins, attrs):
    return {"Out": torch.full(_batch_size_like(ins, attrs), attrs["value"],
                              dtype=torch_dtype(attrs["dtype"]),
                              device=one(ins, "Input").device)}


@register_op("uniform_random", inputs=(), outputs=("Out",),
             attrs={"shape": [1], "min": -1.0, "max": 1.0, "seed": 0,
                    "dtype": "float32", "force_cpu": False},
             random=True, not_differentiable=True)
def uniform_random(ctx, ins, attrs):
    out = torch.empty(tuple(attrs["shape"]), dtype=torch.float32,
                      device=ctx.device)
    out.uniform_(attrs["min"], attrs["max"], generator=ctx.generator)
    return {"Out": out.to(torch_dtype(attrs["dtype"]))}


@register_op("uniform_random_batch_size_like", inputs=("Input",),
             outputs=("Out",),
             attrs={"shape": [1], "min": -1.0, "max": 1.0, "seed": 0,
                    "dtype": "float32", "input_dim_idx": 0,
                    "output_dim_idx": 0},
             random=True, not_differentiable=True)
def uniform_random_batch_size_like(ctx, ins, attrs):
    """U[min, max) in the batch-size-like shape, from the context's
    generator (as uniform_random)."""
    out = torch.empty(_batch_size_like(ins, attrs), dtype=torch.float32,
                      device=one(ins, "Input").device)
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
             not_differentiable=True, lod=True)
def fill_zeros_like(ctx, ins, attrs):
    """Zeros of X's shape and dtype, with X's LoD (a missing cotangent of
    a LoD output)."""
    xv = one(ins, "X")
    return {"Out": with_lod_of(xv, torch.zeros_like(data_of(xv)))}


@register_op("assign", inputs=("X",), outputs=("Out",), lod=True)
def assign(ctx, ins, attrs):
    return {"Out": one(ins, "X")}


@register_op("increment", inputs=("X",), outputs=("Out",),
             attrs={"step": 1.0}, inplace={"Out": "X"})
def increment(ctx, ins, attrs):
    x = one(ins, "X")
    return {"Out": x + scalar_like(x, attrs["step"])}


@register_op("assign_value", inputs=(), outputs=("Out",),
             attrs={"shape": [1], "dtype": "float32", "values": []},
             not_differentiable=True)
def assign_value(ctx, ins, attrs):
    """The `values` list in `shape` and `dtype`, built once per device
    (attr_constant); every run copies that tensor on the device, so an
    in-place write to the output (a persistable's write-back) never
    reaches the cached one."""
    return {"Out": attr_constant(ctx, attrs["values"], attrs["dtype"],
                                 attrs["shape"]).clone()}


@register_op("cast", inputs=("X",), outputs=("Out",),
             attrs={"out_dtype": "float32"})
def cast(ctx, ins, attrs):
    return {"Out": one(ins, "X").to(torch_dtype(attrs["out_dtype"]))}


@register_op("one_hot", inputs=("X",), outputs=("Out",),
             attrs={"depth": 1, "dtype": "float32"},
             not_differentiable=True)
def one_hot(ctx, ins, attrs):
    """[..., 1] or [...] ids -> [..., depth]; an id outside [0, depth)
    gives a zero row (jax.nn.one_hot)."""
    x = one(ins, "X")
    if x.dim() > 1 and x.shape[-1] == 1:
        x = x.squeeze(-1)
    depth = torch.arange(int(attrs["depth"]), device=x.device)
    return {"Out": (x[..., None] == depth).to(torch_dtype(attrs["dtype"]))}


@register_op("shape", inputs=("Input",), outputs=("Out",),
             not_differentiable=True)
def shape_op(ctx, ins, attrs):
    """Input's shape as an int64 vector."""
    x = one(ins, "Input")
    return {"Out": torch.tensor(list(x.shape), dtype=torch.int64,
                                device=x.device)}


@register_op("isfinite", inputs=("X",), outputs=("Out",),
             not_differentiable=True)
def isfinite(ctx, ins, attrs):
    """One bool: every element of every X is finite."""
    xs = [v for v in ins.get("X", []) if v is not None]
    ok = torch.ones((), dtype=torch.bool, device=xs[0].device if xs
                    else ctx.device)
    for x in xs:
        ok = ok & torch.all(torch.isfinite(x))
    return {"Out": ok}
