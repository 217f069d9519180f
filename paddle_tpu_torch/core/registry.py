"""Operator registry: one lowering per op, written in PyTorch.

Counterpart of paddle_tpu/core/registry.py.  Every op registers ONE
`lower(ctx, ins, attrs) -> {output_slot: value}` function over torch
tensors.  The same function serves eager execution on any device and
build-time shape inference, which runs it on ``device="meta"`` tensors
(core/shape_inference.py).

Gradients: an op may register an explicit `grad_maker` or a lowering of
its own "<type>_grad" op (lookup_table_grad); otherwise "<type>_grad"
resolves to the forward op's info and runs the generic gradient
(core/execution.generic_grad_lower: torch autograd over the forward
lowering).  `diff_inputs`/`diff_outputs` name the slots it
differentiates.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence


@dataclasses.dataclass
class OpInfo:
    type: str
    # lower(ctx, ins, attrs) -> {output_slot: value or [values]}
    lower: Callable = None
    # infer_shape(op, block) -> None ; fills output var shapes at build time
    infer_shape: Callable = None
    # grad_maker(op, block, out_grad_names, no_grad_set, partials) ;
    # None = the generic "<type>_grad" op (backward.py)
    grad_maker: Callable = None
    # input/output slots that are differentiable (None = all)
    diff_inputs: Optional[Sequence[str]] = None
    diff_outputs: Optional[Sequence[str]] = None
    # declared slot names; duplicable slots accept a list of vars
    inputs: Sequence[str] = ()
    outputs: Sequence[str] = ()
    dup_inputs: Sequence[str] = ()
    dup_outputs: Sequence[str] = ()
    # attr defaults
    attrs: Dict = dataclasses.field(default_factory=dict)
    # in-place aliases {output_slot: input_slot}
    inplace: Dict[str, str] = dataclasses.field(default_factory=dict)
    # True if op is random (draws from ctx.generator)
    random: bool = False
    not_differentiable: bool = False


_REGISTRY: Dict[str, OpInfo] = {}


def register_op(
    type: str,
    inputs: Sequence[str] = (),
    outputs: Sequence[str] = (),
    attrs: Dict = None,
    diff_inputs: Optional[Sequence[str]] = None,
    diff_outputs: Optional[Sequence[str]] = None,
    inplace: Dict[str, str] = None,
    random: bool = False,
    not_differentiable: bool = False,
    dup_inputs: Sequence[str] = (),
    dup_outputs: Sequence[str] = (),
):
    """Decorator: register `fn` as the torch lowering for op `type`."""

    def deco(fn):
        info = _REGISTRY.get(type) or OpInfo(type=type)
        info.lower = fn
        info.inputs = tuple(inputs)
        info.outputs = tuple(outputs)
        info.dup_inputs = tuple(dup_inputs)
        info.dup_outputs = tuple(dup_outputs)
        info.attrs = dict(attrs or {})
        info.diff_inputs = diff_inputs
        info.diff_outputs = diff_outputs
        info.inplace = dict(inplace or {})
        info.random = random
        info.not_differentiable = not_differentiable
        _REGISTRY[type] = info
        return fn

    return deco


def register_infer_shape(type: str):
    def deco(fn):
        info = _REGISTRY.setdefault(type, OpInfo(type=type))
        info.infer_shape = fn
        return fn

    return deco


def register_grad_maker(type: str):
    def deco(fn):
        info = _REGISTRY.setdefault(type, OpInfo(type=type))
        info.grad_maker = fn
        return fn

    return deco


def get_op_info(type: str) -> OpInfo:
    info = _REGISTRY.get(type)
    if info is None or info.lower is None:
        # grad ops resolve generically: "<fwd>_grad" with no explicit lowering
        if type.endswith("_grad") and type[: -len("_grad")] in _REGISTRY:
            return _REGISTRY[type[: -len("_grad")]]
        raise KeyError(f"op '{type}' is not registered")
    return info


def has_op(type: str) -> bool:
    try:
        get_op_info(type)
        return True
    except KeyError:
        return False


def registered_ops() -> List[str]:
    return sorted(t for t, i in _REGISTRY.items() if i.lower is not None)
