"""Miscellaneous ops: cos_sim, is_empty, print, sign, minus, fill,
label_smooth, multiplex, rnn_memory_helper, get_places, cond,
split_selected_rows and pruning_mask (counterpart of
paddle_tpu/ops/misc.py)."""
from __future__ import annotations

import torch

from ..core.execution import data_of, many, one, with_lod_of
from ..core.lod import SelectedRows
from ..core.registry import register_op
from ..core.types import canonical_dtype
from .creation import attr_constant


@register_op("cos_sim", inputs=("X", "Y"),
             outputs=("Out", "XNorm", "YNorm"),
             diff_outputs=("Out",), lod=True)
def cos_sim(ctx, ins, attrs):
    """Row-wise cosine similarity; a one-row Y broadcasts against every
    row of X (cos_sim_op.h)."""
    xv = one(ins, "X")
    x, y = data_of(xv), data_of(one(ins, "Y"))
    xn = torch.sqrt(torch.sum(torch.square(x), dim=-1, keepdim=True))
    yn = torch.sqrt(torch.sum(torch.square(y), dim=-1, keepdim=True))
    out = torch.sum(x * y, dim=-1, keepdim=True) / (xn * yn)
    return {"Out": with_lod_of(xv, out), "XNorm": xn, "YNorm": yn}


@register_op("is_empty", inputs=("X",), outputs=("Out",),
             not_differentiable=True)
def is_empty(ctx, ins, attrs):
    x = one(ins, "X")
    return {"Out": torch.full((), x.numel() == 0, dtype=torch.bool,
                              device=x.device)}


_PRINT_COUNTS: dict = {}


@register_op("print", inputs=("In",), outputs=("Out",),
             attrs={"first_n": -1, "message": "", "summarize": 20,
                    "print_tensor_name": True, "print_tensor_type": True,
                    "print_tensor_shape": True, "print_tensor_lod": True,
                    "print_phase": "BOTH"},
             not_differentiable=True, host=True)
def print_op(ctx, ins, attrs):
    """Debug print (reference print_op.cc), an identity pass-through, in
    the JAX package's format.  `first_n` > 0 prints only this op's first
    n runs; `print_phase` BACKWARD prints nothing (the op is not
    differentiated)."""
    v = one(ins, "In")
    if attrs.get("print_phase", "BOTH").upper() == "BACKWARD" \
            or v.device.type == "meta":
        return {"Out": v}
    first_n = int(attrs.get("first_n", -1))
    if first_n > 0:
        key = id(ctx.op)
        _PRINT_COUNTS[key] = _PRINT_COUNTS.get(key, 0) + 1
        if _PRINT_COUNTS[key] > first_n:
            return {"Out": v}
    x = v.detach().cpu()
    x = (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    parts = [attrs.get("message") or ""]
    if attrs.get("print_tensor_name", True) and ctx.op is not None:
        parts.append(f"name={ctx.op.input('In')[0]}")
    if attrs.get("print_tensor_shape", True):
        parts.append(f"shape={tuple(x.shape)}")
    if attrs.get("print_tensor_type", True):
        parts.append(f"dtype={canonical_dtype(v.dtype)}")
    n = int(attrs.get("summarize", 20))
    flat = x.reshape(-1)
    data = flat if (n < 0 or flat.size <= n) else flat[:n]
    print(" ".join(p for p in parts if p), "data:", data)
    return {"Out": v}


@register_op("sign", inputs=("X",), outputs=("Out",), lod=True)
def sign(ctx, ins, attrs):
    xv = one(ins, "X")
    return {"Out": with_lod_of(xv, torch.sign(data_of(xv)))}


@register_op("minus", inputs=("X", "Y"), outputs=("Out",), lod=True)
def minus(ctx, ins, attrs):
    """Out = X - Y (reference minus_op.cc; no axis broadcast)."""
    xv = one(ins, "X")
    return {"Out": with_lod_of(xv, data_of(xv) - data_of(one(ins, "Y")))}


@register_op("fill", inputs=(), outputs=("Out",),
             attrs={"shape": [], "value": [], "dtype": "float32",
                    "force_cpu": False},
             not_differentiable=True)
def fill(ctx, ins, attrs):
    """The flat `value` list in `shape` (reference fill_op.cc), built
    once per device as assign_value's."""
    return {"Out": attr_constant(ctx, attrs["value"],
                                 attrs.get("dtype", "float32"),
                                 attrs["shape"]).clone()}


@register_op("label_smooth", inputs=("X", "PriorDist"), outputs=("Out",),
             attrs={"epsilon": 0.0}, diff_inputs=("X",), lod=True)
def label_smooth(ctx, ins, attrs):
    """(1 - eps) X + eps prior (uniform 1/num_classes without PriorDist),
    reference label_smooth_op.h."""
    xv = one(ins, "X")
    x = data_of(xv)
    eps = attrs["epsilon"]
    prior = many(ins, "PriorDist")
    if prior:
        out = (1.0 - eps) * x + eps * data_of(prior[0]).reshape(
            (1,) * (x.dim() - 1) + (-1,))
    else:
        out = (1.0 - eps) * x + eps / x.shape[-1]
    return {"Out": with_lod_of(xv, out)}


@register_op("multiplex", inputs=("Ids", "X"), outputs=("Out",),
             dup_inputs=("X",), diff_inputs=("X",))
def multiplex(ctx, ins, attrs):
    """Out[i] = X[Ids[i]][i] (reference multiplex_op.h)."""
    ids = one(ins, "Ids").reshape(-1).long()
    xs = torch.stack(many(ins, "X"))                    # [K, N, ...]
    rows = torch.arange(xs.shape[1], device=xs.device)
    return {"Out": xs[ids, rows]}


@register_op("rnn_memory_helper", inputs=("X",), outputs=("Out",))
def rnn_memory_helper(ctx, ins, attrs):
    """Identity (the reference rnn_memory_helper_op.cc, which exists so
    an RNN memory always has a gradient slot; the generic gradient is
    the identity's)."""
    return {"Out": data_of(one(ins, "X"))}


@register_op("get_places", inputs=(), outputs=("Out",),
             attrs={"device_count": 0, "device_type": ""},
             not_differentiable=True, host=True)
def get_places_op(ctx, ins, attrs):
    """The places of the executing context's device kind, as a host
    value (the reference get_places_op.cc): every CUDA device under a
    CUDA place, `[CPUPlace()]` under a CPU one; `device_count` > 0 keeps
    the first that many."""
    from ..core.executor import CPUPlace, CUDAPlace

    if ctx.device.type == "cuda":
        places = [CUDAPlace(i) for i in range(torch.cuda.device_count())]
    else:
        places = [CPUPlace()]
    n = int(attrs.get("device_count") or 0)
    return {"Out": places[:n] if n else places}


@register_op("cond", inputs=("Cond",), outputs=(),
             not_differentiable=True, host=True)
def cond(ctx, ins, attrs):
    """Scalar-condition branch: run `sub_block` when Cond is true, else
    `else_block` when the op has one (the reference cond_op.cc, the
    scope-based predecessor of conditional_block)."""
    from .control_flow import _run_block, _truthy

    sub = ctx.op.sub_block("sub_block" if _truthy(one(ins, "Cond"))
                           else "else_block")
    if sub is not None:
        _run_block(ctx.root, sub.ops, ctx.env)
    return {}


@register_op("split_selected_rows", inputs=("X",), outputs=("Out",),
             dup_outputs=("Out",), attrs={"height_sections": []},
             not_differentiable=True, host=True, sparse=True)
def split_selected_rows(ctx, ins, attrs):
    """Route a SelectedRows' rows into one output per section of the
    height, by row range, each row made relative to its section's start
    and kept in its input order (split_selected_rows_op.h FindOutIdx):
    the sparse-gradient sharding step of the pserver transpiler.  A host
    op: the outputs' sizes depend on the rows' values."""
    x = one(ins, "X")
    rows = x.rows.reshape(-1)
    start, outs = 0, []
    for h in (int(s) for s in attrs["height_sections"]):
        keep = (rows >= start) & (rows < start + h)
        outs.append(SelectedRows(rows[keep] - start, x.value[keep], h))
        start += h
    return {"Out": outs}


@register_op("pruning_mask", inputs=("Param",), outputs=("Mask",),
             attrs={"sparsity_ratio": 0.6}, not_differentiable=True)
def pruning_mask(ctx, ins, attrs):
    """0/1 mask keeping the largest-magnitude (1-ratio) fraction of the
    parameter: |p| >= the ratio quantile of |p| (linear interpolation,
    as numpy's and jnp's default)."""
    p = one(ins, "Param")
    a = torch.abs(p.float()).reshape(-1)
    srt = torch.sort(a).values
    pos = min(max(float(attrs["sparsity_ratio"]), 0.0), 1.0) * (a.numel() - 1)
    lo = int(pos)
    hi = min(lo + 1, a.numel() - 1)
    thr = srt[lo] + (srt[hi] - srt[lo]) * (pos - lo)
    return {"Mask": (torch.abs(p.float()) >= thr).to(p.dtype)}
