"""Build-time shape inference on meta tensors.

Counterpart of paddle_tpu/core/shape_inference.py.  Where the JAX
package abstractly evaluates an op's lowering with `jax.eval_shape`,
this package runs the torch lowering on ``device="meta"`` tensors:
shapes and dtypes propagate, no storage is allocated and no arithmetic
runs, so a full-width model builds its Program in milliseconds.
Unknown (-1) dims are substituted by a sentinel size and mapped back
afterwards, exactly as in the JAX package.
"""
from __future__ import annotations

import torch

from . import registry
from .execution import ExecContext, data_of
from .framework import EMPTY_VAR_NAMES
from .types import canonical_dtype, torch_dtype

# sentinel for unknown dims; any output dim equal to it is mapped back to
# -1.  Chosen large & prime so arithmetic collisions are rare.
_SENTINEL = 8191

_META = torch.device("meta")


def default_infer_shape(op, block, report=None):
    """Infer output var shapes/dtypes of `op` by running its lowering on
    meta tensors.  `report(kind, **details)` (optional) receives:
      * kind="infer-fail",    error=exc     — the lowering raised;
      * kind="unknown-input", name=var_name — an input var has no
        declared shape/dtype yet, so nothing can be inferred;
      * kind="dtype-mismatch", name, declared, inferred — another op
        already declared this output with a different dtype.
    """
    info = registry.get_op_info(op.type)
    if info.type != op.type:
        return
    ins = {}
    for slot, names in op.inputs.items():
        vals = []
        for n in names:
            if n in EMPTY_VAR_NAMES:
                vals.append(None)
                continue
            v = block.var(n)
            if v.shape is None or v.dtype is None:
                if report is not None:
                    report("unknown-input", name=n)
                return
            shape = tuple(_SENTINEL if d < 0 else d for d in v.shape)
            vals.append(torch.empty(shape, dtype=torch_dtype(v.dtype),
                                    device=_META))
        ins[slot] = vals
    attrs = {**info.attrs, **op.attrs}
    try:
        outs = info.lower(ExecContext(_META), ins, attrs)
    except Exception as e:  # abstract eval of arbitrary lowerings
        if report is not None:
            report("infer-fail", error=e)
        return
    for slot, names in op.outputs.items():
        vals = outs.get(slot)
        if vals is None:
            continue
        if not isinstance(vals, (list, tuple)):
            vals = [vals]
        for name, val in zip(names, vals):
            val = data_of(val)   # a LoDTensor output: its data's shape
            if name in EMPTY_VAR_NAMES or not isinstance(val, torch.Tensor):
                continue
            var = block.vars.get(name)
            if var is None:
                continue
            var.shape = tuple(
                -1 if d == _SENTINEL else int(d) for d in val.shape)
            inferred = canonical_dtype(val.dtype)
            if (report is not None and var.dtype is not None
                    and var.dtype != inferred
                    and var.op is not None and var.op is not op):
                # a DIFFERENT op (the var's recorded producer) already
                # declared another dtype for this shared name; a lone
                # writer re-inferred under changed flags (amp) is not a
                # program bug
                report("dtype-mismatch", name=name, declared=var.dtype,
                       inferred=inferred)
            var.dtype = inferred


def set_output_shape(op, block, slot, shape, dtype=None):
    """Helper for explicit infer fns: declare shape/dtype for every var
    bound to output `slot` (sentinel/undeclared names skipped)."""
    for name in op.output(slot):
        if name in EMPTY_VAR_NAMES:
            continue
        var = block.vars.get(name)
        if var is None:
            continue
        var.shape = tuple(int(d) for d in shape)
        if dtype is not None and var.dtype is None:
            var.dtype = canonical_dtype(dtype)


def input_var(op, block, slot):
    """First var bound to input `slot`, or None (KeyError propagates for
    dangling names, as in default_infer_shape)."""
    names = op.input(slot)
    if not names or names[0] in EMPTY_VAR_NAMES:
        return None
    return block.var(names[0])


def infer_grad_shapes(op, block):
    """'<x>@GRAD' vars mirror their forward var's shape/dtype."""
    from .framework import GRAD_SUFFIX

    for name in op.output_names():
        if name.endswith(GRAD_SUFFIX):
            fwd = name[: -len(GRAD_SUFFIX)]
            var = block.vars.get(name)
            if var is not None and block.has_var(fwd):
                fv = block.var(fwd)
                var.shape = fv.shape
                if var.dtype is None:
                    var.dtype = fv.dtype
