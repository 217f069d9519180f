"""Tensor parallelism: a Program run op by op on local blocks.

Where the JAX package hands a sharded program to XLA's SPMD partitioner,
here each rank holds its blocks of the placed parameters (a weight
split over a model axis such as 'tp') and runs every op on local values
by explicit rules.  Each value is whole on every rank of the axis, or
split along one dim over one axis: its layout, (dim, axis) or None.  A
parameter's layout comes from its placement; a feed's from its
annotation; every other value's from the rule of the op that makes it,
and a gradient `x@GRAD...` always has x's.

The rules (`TensorParallel._rule`), Megatron's:

  * column-parallel `mul`/`matmul` (weight split (None, axis)) on a whole
    input: the product is split on its last dim, and dX, a partial sum
    on each rank, is all-reduced over the axis in the backward;
  * row-parallel (weight split (axis, None)) on an input split on the
    contraction dim (the spmd plan's `reduce_ops`): the partial products
    are all-reduced in the forward, and dX stays split; on a whole input,
    the input is first cut to this rank's block;
  * elementwise ops whose operands carry the same layout, a bias or any
    operand that broadcasts along the split dim (whose gradient is then
    all-reduced), the shard-local unary ops (`_UNARY_LOCAL`), `sum`,
    `transpose`, a `softmax`/`layer_norm` that does not reduce over the
    split dim, and the optimizer updates run locally;
  * `moe_ffn` with its expert weights split on dim 0 (over 'ep') runs
    the rank's experts (parallel/moe.py `moe_ep_local`): routing on
    every token, the combine of its experts' rows, one all-reduce of
    the output, and X's and the gate's gradients all-reduced;
  * `reshape` keeps a split of d as a split of h in [b, s, d] -> [b, s,
    h, d/h] when the split dim leads its group (h % axis size == 0) and
    the reverse merge; its `shape` attribute is global and is made
    local; `flash_attention` runs on local heads;
  * every other op with a split input all-gathers that input first and
    makes whole outputs (GSPMD's resharding; a correctness rule, not a
    speed path).

The spmd propagation's `_UNARY` set holds `softmax`, which reduces over
the last dim: a spec in the plan is a placement, not proof that an op
may run on a block, so the shard-local table here is its own.

Gradients.  An explicit gradient lowering (mul, flash_attention) runs on
local values, and the gradients of the inputs a local rule treats as
whole on a split computation (the column product's X, a broadcast
bias) are all-reduced after it.  The generic gradient re-runs the
forward under autograd: there the rule's collectives are the
`torch.autograd.Function`s of parallel/collective.py (copy_to,
reduce_from, gather_from, scatter_to), whose conjugate backwards give
each gradient its layout.  Any other gradient op with a split input
runs on gathered values and keeps this rank's block of each gradient.
"""
from __future__ import annotations

import math
import types
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from ..core import registry
from ..core.execution import (data_of, gather_inputs, generic_grad_lower,
                              op_context, resolve_op, scatter_outputs,
                              with_lod_of)
from ..core.framework import EMPTY_VAR_NAMES as _EMPTY
from ..core.lod import SelectedRows
from .collective import copy_to, gather_from, reduce_from, scatter_to

__all__ = ["TensorParallel", "grad_base", "megatron_placement"]

Layout = Optional[Tuple[int, str]]

_GRAD = "@GRAD"

_ELEMENTWISE = {
    "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "elementwise_max", "elementwise_min",
    "elementwise_pow",
}
# ops whose every output element is a function of the same element of
# their one input: a block in, the same block out
_UNARY_LOCAL = {
    "relu", "tanh", "sigmoid", "exp", "abs", "square", "softsign",
    "reciprocal", "sqrt", "log", "softplus", "scale", "cast", "clip",
    "leaky_relu", "elu", "relu6", "pow", "stanh", "hard_shrink",
    "soft_shrink", "brelu", "gelu", "swish", "hard_sigmoid", "logsigmoid",
    "tanh_shrink", "thresholded_relu", "sign", "floor", "ceil", "round",
    "assign", "fill_zeros_like",
}


def grad_base(name: str) -> Optional[str]:
    """The forward variable a gradient name belongs to (`x@GRAD`,
    `x@GRAD@RENAME_0`, `x@GRAD@SUM_0` -> `x`), else None."""
    i = name.find(_GRAD)
    return name[:i] if i > 0 else None


class Rule(NamedTuple):
    """How one op runs on local values.  `kind` "local" or "gather";
    `ins`: each input slot's layouts; `out`: each output name's layout;
    `attrs`: attributes made local; `copy`: (slot, i) of whole inputs
    whose gradient is a partial sum; `reduce`: output slots all-reduced
    in the forward; `scatter`: (slot, i, dim) of whole inputs cut to this
    rank's block."""

    kind: str
    ins: Dict[str, List[Layout]]
    out: Dict[str, Layout]
    attrs: Dict
    copy: Tuple = ()
    reduce: Tuple = ()
    scatter: Tuple = ()
    axis: Optional[str] = None


def _shape(v):
    v = data_of(v)
    return tuple(v.shape) if isinstance(v, torch.Tensor) else None


class TensorParallel:
    """The rules and their execution for one executor.

    `groups`: {model axis: AxisGroup}; `layouts`: the layouts of the
    states and feeds (what a step starts from); `count(kind)` is called
    once a collective the rules issue ("tp_all_reduce",
    "tp_all_gather")."""

    def __init__(self, groups, layouts: Dict[str, Layout], count):
        self.groups = groups
        self.base = dict(layouts)
        self.layouts = dict(layouts)
        self._count = count

    def start_step(self):
        self.layouts = dict(self.base)

    def layout(self, name: str) -> Layout:
        if name in self.layouts:
            return self.layouts[name]
        base = grad_base(name)
        return self.layouts.get(base) if base is not None else None

    # -- collectives (counted) ---------------------------------------------
    def _gather(self, v, lay: Layout):
        if lay is None or not isinstance(data_of(v), torch.Tensor):
            return v
        self._count("tp_all_gather")
        return with_lod_of(v, self.groups[lay[1]].all_gather(
            data_of(v).contiguous(), lay[0]))

    def _block(self, v, lay: Layout):
        if lay is None or v is None:
            return v
        return self.groups[lay[1]].block(v, lay[0]).contiguous()

    def _all_reduce(self, v, axis):
        self._count("tp_all_reduce")
        return self.groups[axis].all_reduce(v.contiguous())

    # -- the rules ------------------------------------------------------------
    def _rule(self, op_type, inputs, outputs, attrs, env) -> Rule:
        ins = {s: [self.layout(n) if n else None for n in names]
               for s, names in inputs.items()}
        split = [l for ls in ins.values() for l in ls if l is not None]
        outs = [n for names in outputs.values() for n in names if n]
        if not split:
            # nothing split: the op as the serial Executor runs it
            return Rule("local", ins, {n: None for n in outs}, {})
        axes = {l[1] for l in split}
        if len(axes) > 1:
            return self._gather_rule(ins, outs)
        axis = axes.pop()
        vals = {s: [env.get(n) if n else None for n in names]
                for s, names in inputs.items()}

        def local(out, **kw):
            return Rule("local", ins, out, kw.pop("attrs", {}), axis=axis,
                        **kw)

        def one(slot):
            return ins[slot][0] if ins.get(slot) else None

        if op_type in ("mul", "matmul"):
            return self._matmul_rule(op_type, ins, vals, outputs, attrs,
                                     axis, local) or \
                self._gather_rule(ins, outs)
        if op_type in _ELEMENTWISE:
            lx, ly = one("X"), one("Y")
            x, y = _shape(vals["X"][0]), _shape(vals["Y"][0])
            if lx is None or x is None or y is None or len(y) > len(x):
                return self._gather_rule(ins, outs)
            d = lx[0]
            a = attrs.get("axis", -1)
            a = len(x) - len(y) if a is None or a < 0 else a
            j = d - a
            covers = 0 <= j < len(y)
            if covers and ly == (j, axis) and y[j] == x[d]:
                return local({n: lx for n in outs})
            if ly is None and (not covers or y[j] == 1):
                return local({n: lx for n in outs}, copy=(("Y", 0),))
            return self._gather_rule(ins, outs)
        if op_type in _UNARY_LOCAL and set(ins) <= {"X"}:
            return local({n: one("X") for n in outs})
        if op_type == "softmax":
            lx, x = one("X"), _shape(vals["X"][0])
            if lx[0] != len(x) - 1:
                return local({n: lx for n in outs})
        elif op_type == "transpose":
            lx, x = one("X"), _shape(vals["X"][0])
            perm = list(attrs.get("axis") or []) or \
                list(range(len(x)))[::-1]
            return local({n: (perm.index(lx[0]), axis) for n in outs})
        elif op_type == "sum":
            ls = ins.get("X", [])
            if ls and all(l == ls[0] for l in ls) and not any(
                    isinstance(v, SelectedRows) for v in vals["X"]):
                return local({n: ls[0] for n in outs})
        elif op_type == "layer_norm":
            lx = one("X")
            if lx is not None and lx[0] < int(attrs.get("begin_norm_axis",
                                                        1)):
                return local({n: lx for n in outs},
                             copy=tuple((s, 0) for s in ("Scale", "Bias")
                                        if ins.get(s)))
        elif op_type == "reshape":
            r = self._reshape_rule(ins, vals, attrs, outputs, axis)
            if r is not None:
                return r
        elif op_type == "moe_ffn":
            # expert parallelism: the rank's experts (moe_ep_local), the
            # output summed over the axis; X's and the gate's gradients
            # all-reduced
            if (one("WIn") == (0, axis) and one("WOut") == (0, axis)
                    and one("X") is None and one("GateW") is None):
                return local({n: None for n in outs},
                             attrs={"ep_axis": axis},
                             copy=(("X", 0), ("GateW", 0)))
        elif op_type == "flash_attention":
            lq = one("Q")
            if lq is not None and lq[0] in (0, 2) and \
                    one("K") == lq and one("V") == lq:
                return local({n: lq for n in outs})
        elif "Param" in inputs and "ParamOut" in outputs:
            # an update: elementwise over the parameter's block
            if all(l == one("Param") for l in split):
                return local({n: self.layout(n) for n in outs})
        return self._gather_rule(ins, outs)

    def _gather_rule(self, ins, outs):
        return Rule("gather", ins, {n: (self.layout(n) if grad_base(n)
                                        else None) for n in outs}, {})

    def _matmul_rule(self, op_type, ins, vals, outputs, attrs, axis,
                     local):
        lx = ins["X"][0]
        ly = ins["Y"][0]
        x, y = _shape(vals["X"][0]), _shape(vals["Y"][0])
        if x is None or y is None:
            return None
        out = [n for n in outputs.get("Out", []) if n]
        if op_type == "mul":
            xd = int(attrs.get("x_num_col_dims", 1))
            if len(y) != 2 or int(attrs.get("y_num_col_dims", 1)) != 1:
                return None
        else:
            if attrs.get("transpose_X") or attrs.get("transpose_Y"):
                return None
            if len(y) != 2:
                # batched: both operands split on one leading dim
                if (len(x) == len(y) >= 3 and lx == ly and lx is not None
                        and lx[0] < len(x) - 2):
                    return local({n: lx for n in out})
                return None
            xd = len(x) - 1
        if ly == (1, axis) and lx is None:
            # column-parallel
            return local({n: (xd, axis) for n in out}, copy=(("X", 0),))
        if ly == (0, axis) and xd == len(x) - 1:
            # row-parallel: the contraction dim split on both operands
            if lx == (len(x) - 1, axis):
                return local({n: None for n in out}, reduce=("Out",))
            if lx is None:
                return local({n: None for n in out}, reduce=("Out",),
                             scatter=(("X", 0, len(x) - 1),))
        if ly is None and lx is not None and lx[0] < xd:
            return local({n: lx for n in out}, copy=(("Y", 0),))
        return None

    def _reshape_rule(self, ins, vals, attrs, outputs, axis):
        """[.., d, ..] -> [..] with the split dim leading its group of
        output dims (kept, split further, or merged with the dims after
        it) -> a local rule with the local `shape`, else None."""
        lx = ins["X"][0]
        x = data_of(vals["X"][0])
        n = self.groups[axis].size
        d = lx[0]
        g = list(x.shape)
        g[d] *= n
        shape = [int(s) for s in attrs.get("shape", [])]
        for i, s in enumerate(shape):
            if s == 0:
                shape[i] = g[i]
        if shape.count(-1) == 1:
            rest = math.prod(s for s in shape if s != -1)
            shape[shape.index(-1)] = math.prod(g) // max(rest, 1)
        if math.prod(shape) != math.prod(g):
            return None
        prefix, acc, e = math.prod(g[:d]), 1, 0
        while e < len(shape) and acc < prefix:
            acc *= shape[e]
            e += 1
        if acc != prefix or e >= len(shape):
            return None
        ok = shape[e] == g[d]
        k = 2
        while not ok and d + k <= len(g) and shape[e] > g[d]:
            ok = math.prod(g[d:d + k]) == shape[e]
            k += 1
        k = 2
        while not ok and e + k <= len(shape) and shape[e] < g[d]:
            ok = (math.prod(shape[e:e + k]) == g[d]
                  and shape[e] % n == 0)
            k += 1
        if not ok:
            return None
        local_shape = list(shape)
        local_shape[e] //= n
        out = [nm for nm in outputs.get("Out", []) if nm]
        return Rule("local", ins, {nm: (e, axis) for nm in out},
                    {"shape": local_shape}, axis=axis)

    # -- execution ------------------------------------------------------------
    def run(self, ctx, op, env):
        """Run `op` against `env` (local values) by its rule."""
        info = registry.get_op_info(op.type)
        is_grad = info.type != op.type
        if is_grad:
            rule = self._rule(
                info.type, {s: op.inputs[s] for s in info.inputs
                            if s in op.inputs},
                {s: op.inputs[s] for s in info.outputs if s in op.inputs},
                {**info.attrs, **op.attrs}, env)
            outs_layout = {}
            for slot, names in op.outputs.items():
                fwd = op.inputs.get(slot[:-len(_GRAD)], []) \
                    if slot.endswith(_GRAD) else []
                for i, n in enumerate(names):
                    outs_layout[n] = (self.layout(fwd[i]) if i < len(fwd)
                                      else self.layout(n))
        else:
            rule = self._rule(op.type, op.inputs, op.outputs,
                              {**info.attrs, **op.attrs}, env)
            outs_layout = rule.out
        ins = gather_inputs(op, env)
        fn, attrs, tag = resolve_op(op)
        attrs = {**attrs, **rule.attrs}
        octx = op_context(ctx, op, env, tag)
        if rule.kind == "local" and rule.axis is None:
            outs = fn(octx, ins, attrs)
        elif is_grad and info.grad_lower is None:
            # the generic gradient over the rule's forward, whose
            # collectives are autograd Functions with conjugate backwards
            outs = generic_grad_lower(octx, ins, attrs,
                                      fwd_info=self._shim(info, rule))
        elif rule.kind == "local" and not (is_grad and rule.scatter):
            if not is_grad:
                for slot, i, dim in rule.scatter:
                    ins[slot][i] = self._block(ins[slot][i], (dim,
                                                              rule.axis))
            outs = fn(octx, ins, attrs)
            if not is_grad:
                for slot in rule.reduce:
                    outs[slot] = [with_lod_of(v, self._all_reduce(
                        data_of(v), rule.axis))
                        for v in _as_list(outs[slot])]
            else:
                # the conjugate of the whole inputs' identity: their
                # gradients are partial sums over the axis
                for slot, i in rule.copy:
                    vs = _as_list(outs.get(slot + _GRAD, []))
                    names = op.outputs.get(slot + _GRAD, [])
                    if i < len(vs) and vs[i] is not None and \
                            i < len(names) and names[i] not in _EMPTY:
                        vs[i] = self._all_reduce(vs[i], rule.axis)
                        outs[slot + _GRAD] = vs
        else:
            for slot, vs in ins.items():
                lays = [self.layout(n) if n else None
                        for n in op.inputs[slot]]
                ins[slot] = [self._gather(v, lay) for v, lay in zip(vs,
                                                                     lays)]
            outs = fn(octx, ins, attrs)
            for slot, names in op.outputs.items():
                if slot not in outs:
                    continue
                vs = _as_list(outs[slot])
                outs[slot] = [with_lod_of(v, self._block(
                    data_of(v), outs_layout.get(n))) if v is not None
                    else v for v, n in zip(vs, names)]
        scatter_outputs(op, env, outs)
        for names in op.outputs.values():
            for n in names:
                if n:
                    self.layouts[n] = outs_layout.get(n)

    def _shim(self, info, rule):
        """An OpInfo-like view of `info` whose `lower` runs the forward
        under `rule` with the rule's collectives as autograd Functions
        (what generic_grad_lower differentiates)."""
        lower = info.lower

        def tp_lower(ctx, ins, attrs):
            ins = {s: list(vs) for s, vs in ins.items()}
            for slot, lays in rule.ins.items():
                for i, lay in enumerate(lays):
                    v = ins.get(slot, [None] * (i + 1))[i]
                    if v is None or not isinstance(data_of(v),
                                                   torch.Tensor):
                        continue
                    if rule.kind == "gather" and lay is not None:
                        self._count("tp_all_gather")
                        ins[slot][i] = with_lod_of(v, gather_from(
                            data_of(v), self.groups[lay[1]], lay[0]))
            for slot, i in rule.copy:
                v = ins[slot][i]
                if v is not None and data_of(v).is_floating_point():
                    ins[slot][i] = with_lod_of(v, copy_to(
                        data_of(v), self.groups[rule.axis]))
            for slot, i, dim in rule.scatter:
                v = ins[slot][i]
                ins[slot][i] = with_lod_of(v, scatter_to(
                    data_of(v), self.groups[rule.axis], dim))
            outs = lower(ctx, ins, {**attrs, **rule.attrs})
            for slot in rule.reduce:
                self._count("tp_all_reduce")
                outs[slot] = [reduce_from(data_of(v),
                                          self.groups[rule.axis])
                              for v in _as_list(outs[slot])]
            return outs

        return types.SimpleNamespace(
            type=info.type, inputs=info.inputs, outputs=info.outputs,
            diff_inputs=info.diff_inputs, diff_outputs=info.diff_outputs,
            lod=info.lod, lower=tp_lower)


def _as_list(v):
    return list(v) if isinstance(v, (list, tuple)) else [v]


def megatron_placement(program, axis: str = "tp"):
    """{parameter: spec} of Megatron's placement for a transformer
    Program, found by walking its `mul` ops (a Program of either
    package): in each block of six projections, q, k, v and the FFN's
    first fc column-split `(None, axis)` with their biases `(axis,)`,
    the attention output projection and the FFN's second fc row-split
    `(axis, None)`; the embeddings and the vocabulary head stay whole.
    An encoder-decoder block's cross attention is not recognised."""
    blk = program.global_block()
    params = {p.name for p in blk.all_parameters()}
    ops = blk.ops
    muls = []
    for i, op in enumerate(ops):
        if op.type != "mul" or op.input("Y")[0] not in params:
            continue
        out = op.output("Out")[0]
        bias = next((o.input("Y")[0] for o in ops[i + 1:]
                     if o.type == "elementwise_add"
                     and o.input("X")[0] == out
                     and o.input("Y")[0] in params), None)
        muls.append((op.input("Y")[0], bias))
    if len(muls) % 6 != 1:
        raise ValueError(f"{len(muls)} projections: not 6 a block and a "
                         "vocabulary head")
    specs = {}
    for k, (w, b) in enumerate(muls[:-1]):
        column = k % 6 in (0, 1, 2, 4)
        specs[w] = (None, axis) if column else (axis, None)
        if column and b is not None:
            specs[b] = (axis,)
    return specs
