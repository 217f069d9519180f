"""Autodiff by op-desc rewriting.

Counterpart of paddle_tpu/backward.py, which follows PaddlePaddle's
fluid backward.py: `append_backward` walks the op list backwards, asks
each op for its grad op desc, inserts `sum` ops where a forward var fans
out to several consumers and prunes no-grad branches.  An output with no
path to the loss gets a `fill_zeros_like` cotangent.

Grad ops ARE ops in the Program, so the Program a minimize() builds is
the JAX package's, field for field.  The default grad op is the generic
"<type>_grad" run by core/execution.generic_grad_lower (torch autograd
over the forward lowering); ops may register custom grad makers
(registry.register_grad_maker).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set

from .core import registry
from .core.framework import (
    EMPTY_VAR_NAMES,
    GRAD_SUFFIX,
    Parameter,
    Program,
    Variable,
    grad_var_name,
    unique_name,
)
from .core.types import is_float_dtype

__all__ = ["append_backward", "calc_gradient", "gradients"]


def _op_info(op):
    try:
        return registry.get_op_info(op.type)
    except KeyError:
        return None


def _relevant_ops(block, target_names: Set[str], stop_names: Set[str]):
    """Reverse reachability: indices of ops contributing to targets."""
    needed = set(target_names)
    relevant = []
    for i in reversed(range(len(block.ops))):
        op = block.ops[i]
        info = _op_info(op)
        outs = set(op.output_names())
        if not (outs & needed):
            continue
        if info is None or info.not_differentiable:
            continue
        relevant.append(i)
        for n in op.input_names():
            if n not in stop_names:
                needed.add(n)
    relevant.reverse()
    return relevant


def _var_needs_grad(block, name, no_grad: Set[str]) -> bool:
    if name in EMPTY_VAR_NAMES or name in no_grad:
        return False
    try:
        v = block.var(name)
    except KeyError:
        return False
    if v.stop_gradient:
        return False
    if v.dtype is not None and not is_float_dtype(v.dtype):
        return False
    return True


def _default_grad_op(op, block, out_grad_names: Dict[str, str],
                     no_grad: Set[str], partials: Dict[str, List[str]]):
    """Build the generic '<type>_grad' op desc for `op`.

    Grad-op I/O convention (consumed by generic_grad_lower):
      inputs  = forward input slots + forward output slots
                + '<out_slot>@GRAD' per differentiable output
      outputs = '<in_slot>@GRAD' per differentiable input, var names are
                partial-grad names registered into `partials`.
    """
    info = _op_info(op)
    g_inputs = {}
    for slot, names in op.inputs.items():
        g_inputs[slot] = list(names)
    for slot, names in op.outputs.items():
        g_inputs.setdefault(slot, list(names))
    # output cotangents
    diff_outs = (info.diff_outputs if info.diff_outputs is not None
                 else list(op.outputs.keys()))
    for slot in diff_outs:
        names = op.outputs.get(slot, [])
        if not names:
            continue
        g_names = []
        for n in names:
            gn = out_grad_names.get(n)
            if gn is None:
                # output with no path to the loss: zero cotangent
                gn = unique_name(grad_var_name(n) + "@ZERO")
                gv = block.create_var(name=gn, dtype=None)
                fv = block.var(n)
                gv.shape, gv.dtype = fv.shape, fv.dtype
                block.append_op("fill_zeros_like", {"X": [n]}, {"Out": [gn]})
            g_names.append(gn)
        g_inputs[slot + GRAD_SUFFIX] = g_names
    # input grads
    diff_ins = (info.diff_inputs if info.diff_inputs is not None
                else list(op.inputs.keys()))
    g_outputs = {}
    any_grad = False
    for slot in diff_ins:
        names = op.inputs.get(slot, [])
        if not names:
            continue
        out_names = []
        for n in names:
            if not _var_needs_grad(block, n, no_grad):
                out_names.append("@EMPTY@")
                continue
            plist = partials.setdefault(n, [])
            gn = (grad_var_name(n) if not plist
                  else unique_name(grad_var_name(n) + "@RENAME"))
            plist.append(gn)
            out_names.append(gn)
            any_grad = True
        g_outputs[slot + GRAD_SUFFIX] = out_names
    if not any_grad:
        return None
    grad_op = block.append_op(op.type + "_grad", g_inputs, g_outputs,
                              dict(op.attrs))
    # per-grad-op error clipping hook (reference backward.py invokes
    # error_clip_callback for every created grad op)
    from .clip import error_clip_callback

    error_clip_callback(block, grad_op)
    return True


def _resolve_total_grad(block, name, partials: Dict[str, List[str]]):
    """Collapse partial grads of `name` into one var (sum-insertion)."""
    plist = partials.get(name)
    if not plist:
        return None
    if len(plist) == 1:
        return plist[0]
    total = grad_var_name(name)
    if total in plist:
        # keep canonical name as the sum target; partials keep their renames
        out = unique_name(total + "@SUM")
    else:
        out = total
    block.append_op("sum", {"X": list(plist)}, {"Out": [out]})
    partials[name] = [out]
    return out


def append_backward(
    loss: Variable,
    parameter_list: Optional[Sequence[str]] = None,
    no_grad_set: Optional[Set[str]] = None,
):
    """Append grad ops for `loss` to its program; returns [(param, grad_var)]
    like reference backward.py:338."""
    block = loss.block
    program = block.program
    no_grad = set(no_grad_set or ())
    for v in program.list_vars():
        if v.stop_gradient:
            no_grad.add(v.name)

    relevant = _relevant_ops(block, {loss.name}, no_grad)

    # d(loss)/d(loss) = 1
    loss_grad = grad_var_name(loss.name)
    gv = block.create_var(name=loss_grad, dtype=loss.dtype)
    gv.shape = loss.shape
    block.append_op(
        "fill_constant",
        {},
        {"Out": [loss_grad]},
        {"shape": list(loss.shape or [1]), "value": 1.0,
         "dtype": loss.dtype or "float32"},
    )
    partials: Dict[str, List[str]] = {loss.name: [loss_grad]}

    for i in reversed(relevant):
        op = block.ops[i]
        info = _op_info(op)
        # total grads for this op's outputs
        out_grad_names = {}
        have_any = False
        for n in op.output_names():
            g = _resolve_total_grad(block, n, partials)
            if g is not None:
                out_grad_names[n] = g
                have_any = True
        if not have_any:
            continue
        if info.grad_maker is not None:
            info.grad_maker(op, block, out_grad_names, no_grad, partials)
        else:
            _default_grad_op(op, block, out_grad_names, no_grad, partials)

    # finalize parameter grads
    params_grads = []
    if parameter_list is not None:
        params = [block.var(p) if isinstance(p, str) else p
                  for p in parameter_list]
    else:
        params = [v for v in program.global_block().all_parameters()
                  if v.trainable]
    for p in params:
        g = _resolve_total_grad(block, p.name, partials)
        if g is None:
            continue
        gvar = block.var(g)
        if gvar.shape is None:
            gvar.shape, gvar.dtype = p.shape, p.dtype
        params_grads.append((p, gvar))
    return params_grads


def calc_gradient(targets, inputs, target_gradients=None, no_grad_set=None):
    """Gradients of `targets` wrt `inputs` (reference backward.py:464)."""
    targets = targets if isinstance(targets, (list, tuple)) else [targets]
    inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    block = targets[0].block
    no_grad = set(no_grad_set or ())
    for v in block.program.list_vars():
        if v.stop_gradient:
            no_grad.add(v.name)
    relevant = _relevant_ops(block, {t.name for t in targets}, no_grad)

    partials: Dict[str, List[str]] = {}
    if target_gradients is None:
        target_gradients = [None] * len(targets)
    for t, tg in zip(targets, target_gradients):
        gname = grad_var_name(t.name)
        if tg is None:
            gv = block.create_var(name=gname, dtype=t.dtype)
            gv.shape = t.shape
            block.append_op(
                "fill_constant", {}, {"Out": [gname]},
                {"shape": list(t.shape or [1]), "value": 1.0,
                 "dtype": t.dtype or "float32"})
        else:
            block.append_op("assign", {"X": [tg.name]}, {"Out": [gname]})
        partials[t.name] = [gname]

    for i in reversed(relevant):
        op = block.ops[i]
        info = _op_info(op)
        out_grad_names = {}
        have_any = False
        for n in op.output_names():
            g = _resolve_total_grad(block, n, partials)
            if g is not None:
                out_grad_names[n] = g
                have_any = True
        if not have_any:
            continue
        if info.grad_maker is not None:
            info.grad_maker(op, block, out_grad_names, no_grad, partials)
        else:
            _default_grad_op(op, block, out_grad_names, no_grad, partials)

    outs = []
    for x in inputs:
        g = _resolve_total_grad(block, x.name, partials)
        outs.append(block.var(g) if g is not None else None)
    return outs


gradients = calc_gradient
