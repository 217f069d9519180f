"""Shared op execution: contexts, dispatch and the generic gradient.

Counterpart of paddle_tpu/core/execution.py.  A lowering gets `ins` as
{slot: [tensor or None, ...]} and an `ExecContext` naming the device to
create new tensors on and the `torch.Generator` random ops draw from.

Gradient ops named "<type>_grad" with no lowering of their own run
`generic_grad_lower`: the forward lowering is re-run under torch
autograd with the differentiable inputs as leaves, and
`torch.autograd.grad` pulls the output cotangents back to them.  Every
registered op is differentiable by construction, as in the JAX package
(where the same role is played by `jax.vjp`).
"""
from __future__ import annotations

import zlib
from typing import Dict, List, Optional

import torch

from . import registry
from .framework import EMPTY_VAR_NAMES as _EMPTY

GRAD = "@GRAD"

_MASK63 = (1 << 63) - 1


def _mix(seed: int, tag: int) -> int:
    """splitmix64 of (seed, tag) -> a 63-bit generator seed."""
    z = (seed * 0x9E3779B97F4A7C15 + tag + 0x632BE59BD9B4E019) \
        & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return (z ^ (z >> 31)) & _MASK63


class ExecContext:
    """Device + random stream for one op run.

    `generator` is either given, or made at first use from `seed`, so
    ops that draw nothing make none.  `child(tag_hash)` derives the
    per-op context: its seed mixes the step's seed with a stable hash of
    the op's identity (`_op_rng_tag`), so draws do not depend on op
    order, and a generic grad op — which carries its FORWARD op's
    identity — redraws exactly the forward's numbers.  Shape inference
    passes ``torch.device("meta")`` and no seed."""

    def __init__(self, device=None, generator: Optional[torch.Generator] = None,
                 seed: Optional[int] = None):
        self.device = torch.device(device if device is not None else "cpu")
        self._generator = generator
        self.seed = seed

    @property
    def generator(self) -> Optional[torch.Generator]:
        if self._generator is None and self.seed is not None:
            g = torch.Generator(device=self.device)
            g.manual_seed(self.seed)
            self._generator = g
        return self._generator

    def child(self, tag_hash: int) -> "ExecContext":
        """Per-op context: the step seed mixed with the op's identity."""
        base = self.seed if self.seed is not None else 0
        return ExecContext(self.device, seed=_mix(base, tag_hash))

    def pure(self) -> "ExecContext":
        """Context for re-running a forward op inside its gradient: the
        same seed with a fresh generator, so the recomputation draws
        the forward's numbers."""
        return ExecContext(self.device, seed=self.seed)


# ---------------------------------------------------------------------------
# env protocol: the interpreter uses a Scope, tests may use a plain dict
# ---------------------------------------------------------------------------


class DictEnv:
    def __init__(self, init=None):
        self.d = dict(init or {})
        self.written = set()

    def get(self, name):
        return self.d.get(name)

    def set(self, name, value):
        self.d[name] = value
        self.written.add(name)

    def has(self, name):
        return name in self.d


class ScopeEnv:
    def __init__(self, scope):
        self.scope = scope
        self.written = set()

    def get(self, name):
        try:
            return self.scope.find_var(name)
        except KeyError:
            return None

    def set(self, name, value):
        self.scope.set_var(name, value)
        self.written.add(name)

    def has(self, name):
        return self.scope.has_var(name)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


def gather_inputs(op, env) -> Dict[str, List]:
    return {
        slot: [env.get(n) if n not in _EMPTY else None for n in names]
        for slot, names in op.inputs.items()
    }


def scatter_outputs(op, env, outs: Dict[str, List]):
    for slot, names in op.outputs.items():
        vals = outs.get(slot)
        if vals is None:
            continue
        if not isinstance(vals, (list, tuple)):
            vals = [vals]
        for name, val in zip(names, vals):
            if name not in _EMPTY:
                env.set(name, val)


def _op_rng_tag(op, info) -> str:
    """Stable op identity for random-stream derivation.  A generic grad
    op gets its FORWARD op's tag (forward output names appear among the
    grad op's input slots), so recomputation draws the same numbers."""
    if info.type != op.type:  # generic "<fwd>_grad"
        names = tuple(n for s in info.outputs for n in op.inputs.get(s, []))
        return f"{info.type}:{names}"
    return f"{op.type}:{tuple(op.output_names())}"


def run_op(ctx: ExecContext, op, env):
    """Execute one op desc against `env`."""
    ins = gather_inputs(op, env)
    t = op.type
    try:
        info = registry.get_op_info(t)
    except KeyError:
        raise NotImplementedError(f"op '{t}' has no lowering") from None
    op_ctx = ctx.child(zlib.crc32(_op_rng_tag(op, info).encode()))
    attrs = {**info.attrs, **op.attrs}
    if info.type == t:  # explicit lowering (fwd op, or an own grad op)
        outs = info.lower(op_ctx, ins, attrs)
    else:  # generic "<fwd>_grad" resolved to the forward info
        outs = generic_grad_lower(op_ctx, ins, attrs, info)
    scatter_outputs(op, env, outs)


# ---------------------------------------------------------------------------
# generic gradient
# ---------------------------------------------------------------------------


def _is_float_slot(vals) -> bool:
    leaves = [v for v in vals if v is not None]
    return bool(leaves) and all(
        isinstance(v, torch.Tensor) and v.is_floating_point()
        for v in leaves)


def generic_grad_lower(ctx, ins, attrs, fwd_info):
    """Grad-op convention (see backward.py): inputs = forward input slots
    + forward output slots + "<out_slot>@GRAD" cotangents; outputs =
    "<in_slot>@GRAD".  Missing cotangents must have been filled with
    fill_zeros_like by append_backward.

    Only the tensors of the differentiable input slots become autograd
    leaves; an input with no path to the chosen outputs gets zeros."""
    fwd_ins = {s: ins[s] for s in fwd_info.inputs if s in ins}
    if fwd_info.diff_inputs is not None:
        diff_slots = [s for s in fwd_info.diff_inputs if s in fwd_ins]
    else:
        diff_slots = [s for s in fwd_ins if _is_float_slot(fwd_ins[s])]
    if fwd_info.diff_outputs is not None:
        out_slots = [s for s in fwd_info.diff_outputs if s + GRAD in ins]
    else:
        out_slots = [s for s in fwd_info.outputs if s + GRAD in ins]
    if not diff_slots or not out_slots:
        return {}

    full = dict(fwd_ins)
    leaves = []  # (slot, index, leaf tensor)
    with torch.enable_grad():
        for s in diff_slots:
            vals = []
            for v in fwd_ins[s]:
                if isinstance(v, torch.Tensor) and v.is_floating_point():
                    v = v.detach().requires_grad_(True)
                    leaves.append((s, len(vals), v))
                vals.append(v)
            full[s] = vals
        outs = fwd_info.lower(ctx.pure(), full, attrs)
        ys, cots = [], []
        for s in out_slots:
            vs = outs[s]
            vs = list(vs) if isinstance(vs, (list, tuple)) else [vs]
            for y, g in zip(vs, ins[s + GRAD]):
                if y is None or g is None or not y.requires_grad:
                    continue
                ys.append(y)
                # a cotangent of another float type (a bf16 consumer of
                # an f32 output) is cast to the output's type
                cots.append(g if g.dtype == y.dtype else g.to(y.dtype))
        grads = (torch.autograd.grad(ys, [t for _, _, t in leaves], cots,
                                     allow_unused=True)
                 if ys and leaves else [None] * len(leaves))
    res = {s + GRAD: [None] * len(fwd_ins[s]) for s in diff_slots}
    for (s, i, leaf), g in zip(leaves, grads):
        res[s + GRAD][i] = torch.zeros_like(leaf) if g is None else g
    return res


# ---------------------------------------------------------------------------
# lowering helpers (imported by op modules)
# ---------------------------------------------------------------------------


def one(ins, slot):
    """First value bound to `slot`, or None."""
    vs = ins.get(slot)
    if not vs:
        return None
    return vs[0]


def many(ins, slot) -> List:
    return list(ins.get(slot) or [])
