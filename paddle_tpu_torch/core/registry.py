"""Operator registry: one lowering per op, written in PyTorch.

Counterpart of paddle_tpu/core/registry.py.  Every op registers ONE
`lower(ctx, ins, attrs) -> {output_slot: value}` function over torch
tensors.  The same function serves eager execution on any device and
build-time shape inference, which runs it on ``device="meta"`` tensors
(core/shape_inference.py).

Gradients: an op may register an explicit `grad_maker` or a lowering of
its own "<type>_grad" op (lookup_table_grad); otherwise "<type>_grad"
resolves to the forward op's info and runs its `grad_lower` when one is
registered (`register_grad_lower`: mul, flash_attention), else the
generic gradient (core/execution.generic_grad_lower: torch autograd over
the forward lowering).  Either way the grad op in the Program is the
generic one, as in the JAX package.  `diff_inputs`/`diff_outputs` name
the slots it differentiates.

`host` marks an op that must run on the host, eagerly, between the
compiled Executor's device segments (core/executor.py); `random` an op
that draws from its context's generator; `sparse` an op whose lowering
takes SelectedRows values (core/lod.py); `lod` an op whose lowering
takes LoDTensor values — it reads their LoD or hands it on (the
sequence and recurrent ops, and the dense ops the JAX package writes
with `with_lod_of`).  Any other lowering gets a LoDTensor's data.
`lowering_generation()` changes whenever any op's `lower` or `grad_lower` is set — by
`register_op`, `register_grad_lower` or a plain assignment — so the
Executor's cache never serves a plan (or a CUDA graph) resolved against
a lowering that was swapped since.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence


_generation = 0


def lowering_generation() -> int:
    """A number that changes whenever an op's lowering is (re)set."""
    return _generation


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
    # grad_lower(ctx, ins, attrs) -> {"<in_slot>@GRAD": [...]}: computes
    # the generic "<type>_grad" op (its slots) without re-running the
    # forward; None = core/execution.generic_grad_lower
    grad_lower: Callable = None
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
    # True if the op runs on the host (never inside a compiled segment)
    host: bool = False
    # True if the lowering takes SelectedRows inputs (sum, the optimizer
    # updates, split_selected_rows); any other op meeting one raises
    sparse: bool = False
    # True if the lowering takes LoDTensor inputs; any other op gets
    # their data (core/execution.resolve_op)
    lod: bool = False
    # static cost metadata (analysis/cost_model.py): `cost_kind` names the
    # estimator class ("matmul", "conv", "attention", "moe", "embedding",
    # "elementwise", "reduction", "norm", "data", "collective", "free");
    # `cost_fn(op, resolve)` (register_op_cost) overrides the class with an
    # exact per-op estimator.  Ops with neither report as cost-UNKNOWN —
    # the analyzer surfaces them instead of silently counting zero.
    cost_kind: Optional[str] = None
    cost_fn: Callable = None

    def __setattr__(self, name, value):
        if name in ("lower", "grad_lower"):
            global _generation
            _generation += 1
        object.__setattr__(self, name, value)


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
    host: bool = False,
    sparse: bool = False,
    lod: bool = False,
    cost: Optional[str] = None,
):
    """Decorator: register `fn` as the torch lowering for op `type`
    (`cost`: its estimator class for analysis/cost_model.py)."""

    def deco(fn):
        info = _REGISTRY.get(type) or OpInfo(type=type)
        info.lower = fn
        if cost is not None:
            info.cost_kind = cost
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
        info.host = host
        info.sparse = sparse
        info.lod = lod
        _REGISTRY[type] = info
        return fn

    return deco


def register_infer_shape(type: str):
    def deco(fn):
        info = _REGISTRY.setdefault(type, OpInfo(type=type))
        info.infer_shape = fn
        return fn

    return deco


def register_op_cost(type: str, kind: Optional[str] = None):
    """Attach static cost metadata to op `type`'s OpInfo.

    Used as a decorator, registers an exact estimator
    `fn(op, resolve) -> analysis.cost_model.OpCost` (`resolve(name)`
    returns the `(shape, dtype)` of a var with -1 dims already
    substituted).  Called bare — `register_op_cost("relu",
    kind="elementwise")` — it records just the estimator class.  Either
    form may target an op registered elsewhere (the analysis layer
    annotates the existing corpus without touching every lowering)."""
    info = _REGISTRY.setdefault(type, OpInfo(type=type))
    if kind is not None:
        info.cost_kind = kind

    def deco(fn):
        info.cost_fn = fn
        return fn

    return deco


def set_op_cost_kind(type: str, kind: str, overwrite: bool = False):
    """Record the estimator class for `type` (no-op for unregistered ops
    — cost metadata must never invent op types)."""
    info = _REGISTRY.get(type)
    if info is not None and (overwrite or info.cost_kind is None):
        info.cost_kind = kind


def register_grad_maker(type: str):
    def deco(fn):
        info = _REGISTRY.setdefault(type, OpInfo(type=type))
        info.grad_maker = fn
        return fn

    return deco


def register_grad_lower(type: str):
    """Decorator: `fn(ctx, ins, attrs)` runs op `type`'s generic
    "<type>_grad" op in place of the generic gradient; the grad op and
    its slots in the Program stay the generic ones."""

    def deco(fn):
        info = _REGISTRY.setdefault(type, OpInfo(type=type))
        info.grad_lower = fn
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
