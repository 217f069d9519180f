"""Shared op execution: contexts, dispatch and the generic gradient.

Counterpart of paddle_tpu/core/execution.py.  A lowering gets `ins` as
{slot: [tensor or None, ...]} and an `ExecContext` naming the device to
create new tensors on and the `torch.Generator` random ops draw from.

Gradient ops named "<type>_grad" with no lowering of their own run the
forward op's `grad_lower` where it registered one (mul and
flash_attention: their gradients without a forward recompute), else
`generic_grad_lower`: the forward lowering is re-run under torch
autograd with the differentiable inputs as leaves, and
`torch.autograd.grad` pulls the output cotangents back to them.  Every
registered op is differentiable by construction, as in the JAX package
(where the same role is played by `jax.vjp`).

LoDTensor values: a lowering registered `lod=True` gets them as they
are; any other gets their data.  Every gradient op hands each input
gradient back with its forward input's LoD, as the JAX package's pytree
cotangent carries it.
"""
from __future__ import annotations

import contextlib
import functools
import zlib
from typing import Dict, List, Optional

import torch

from . import registry
from .framework import EMPTY_VAR_NAMES as _EMPTY
from .lod import LoDTensor, SelectedRows

GRAD = "@GRAD"

_MASK63 = (1 << 63) - 1


def _mix(seed: int, tag: int) -> int:
    """splitmix64 of (seed, tag) -> a 63-bit generator seed."""
    z = (seed * 0x9E3779B97F4A7C15 + tag + 0x632BE59BD9B4E019) \
        & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return (z ^ (z >> 31)) & _MASK63


_M32 = 0xFFFFFFFF


def mix32_(x: torch.Tensor) -> torch.Tensor:
    """Bijective 32-bit integer hash, in place, on an int64 tensor holding
    values in [0, 2^32).  The multiplier stays below 2^31, so no product
    leaves int64's range and the CPU and a CUDA device compute the same
    bits."""
    for _ in range(2):
        x.bitwise_xor_(x >> 16)
        x.mul_(0x45D9F3B).bitwise_and_(_M32)
    return x.bitwise_xor_(x >> 16)


class ExecContext:
    """Device + random stream for one op run.

    `generator` is either given, or made at first use from `seed`, so
    ops that draw nothing make none.  `child(tag_hash)` derives the
    per-op context: its seed mixes the step's seed with a stable hash of
    the op's identity (`_op_rng_tag`), so draws do not depend on op
    order, and a generic grad op — which carries its FORWARD op's
    identity — redraws exactly the forward's numbers.  `row_offset` is
    the global batch row of this run's row 0 (a data-parallel rank's
    first row; 0 in the serial Executor): dropout keys its masks by
    global row, so a sharded step draws the serial masks.  Shape
    inference passes ``torch.device("meta")`` and no seed.  `op` is the
    op desc the context runs, `env` the values it runs against and
    `root` the context it was derived from (`op_context` sets the three
    in every mode: `print` names its input, a control-flow op runs its
    `op.sub_block()` against `env`, a loop draws each iteration's random
    stream from `root.child(i)`), else None.  `tables` holds what lowerings build on the
    host once and reuse (the sequence ops' index tables, attribute
    constants), shared by every context derived from this one: the
    Executor hands each cache entry's runs the entry's own dict, so a
    table lives exactly as long as the entry (and the CUDA graph) that
    reads it; any other context starts an empty one.  `sync_group` is
    the process group a data-parallel step's training-mode batch_norm
    all-reduces its statistics over (ParallelExecutor's sync-BN form;
    None everywhere else, and the lowerings then run as in the
    serial Executor).  `groups` maps each mesh axis the run spans to
    its collectives (`parallel.mesh.AxisGroup`): the c_* collective ops
    run over `groups[ring_id]`, and raise where the axis is not there,
    as the JAX package's do outside shard_map."""

    def __init__(self, device=None,
                 generator: Optional[torch.Generator] = None,
                 seed: Optional[int] = None, row_offset: int = 0,
                 tables: Optional[Dict] = None, sync_group=None,
                 groups: Optional[Dict] = None):
        self.device = torch.device(device if device is not None else "cpu")
        self._generator = generator
        self.seed = seed
        self.row_offset = row_offset
        self.tables = {} if tables is None else tables
        self.sync_group = sync_group
        self.groups = {} if groups is None else groups
        self.op = self.env = self.root = None

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
        return ExecContext(self.device, seed=_mix(base, tag_hash),
                           row_offset=self.row_offset, tables=self.tables,
                           sync_group=self.sync_group, groups=self.groups)

    def pure(self) -> "ExecContext":
        """Context for re-running a forward op inside its gradient: the
        same seed with a fresh generator, so the recomputation draws
        the forward's numbers, and the same op, env and root, so a
        lowering that runs a sub-block finds it."""
        c = ExecContext(self.device, seed=self.seed,
                        row_offset=self.row_offset, tables=self.tables,
                        sync_group=self.sync_group, groups=self.groups)
        c.op, c.env, c.root = self.op, self.env, self.root
        return c


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


def _checked(fn, op, sparse_ok, unwrap):
    """`fn` behind the value rules: a SelectedRows input raises unless
    `sparse_ok` (naming the op and the value, where the JAX package's
    raises from inside jax.numpy; nothing is made dense behind the
    caller's back), and with `unwrap` every LoDTensor input is passed as
    its data."""

    def run(ctx, ins, attrs):
        for slot, vals in ins.items():
            for i, v in enumerate(vals):
                if isinstance(v, SelectedRows) and not sparse_ok:
                    raise TypeError(
                        f"op {op.type!r} cannot take the SelectedRows "
                        f"{op.inputs[slot][i]!r} (input {slot}): only sum, "
                        "the optimizer updates and split_selected_rows "
                        "take a sparse gradient")
        return fn(ctx, _data_ins(ins) if unwrap else ins, attrs)

    return run


def _data_ins(ins):
    """`ins` with every LoDTensor replaced by its data."""
    return {s: [data_of(v) for v in vals] for s, vals in ins.items()}


def _forward_lowering(info):
    """The forward lowering as the dispatch runs it: with LoDTensor
    inputs passed as their data unless the op takes them."""
    if info.lod:
        return info.lower
    return lambda ctx, ins, attrs: info.lower(ctx, _data_ins(ins), attrs)


def _with_input_lods(grad_fn):
    """An explicit gradient lowering on the inputs' data, its
    "<slot>@GRAD" results re-wrapped with the forward inputs' LoDs."""

    def run(ctx, ins, attrs):
        return _rewrap_grads(grad_fn(ctx, _data_ins(ins), attrs), ins)

    return run


def _rewrap_grads(res, ins):
    for key, vals in res.items():
        fwd = ins.get(key[:-len(GRAD)]) if key.endswith(GRAD) else None
        if not fwd:
            continue
        vals = list(vals) if isinstance(vals, (list, tuple)) else [vals]
        res[key] = [with_lod_of(x, g) if g is not None else g
                    for x, g in zip(fwd, vals)]
    return res


def resolve_op(op):
    """-> (the callable that runs `op` as fn(ctx, ins, attrs), its merged
    attrs, its random-stream tag hash)."""
    try:
        info = registry.get_op_info(op.type)
    except KeyError:
        raise NotImplementedError(f"op '{op.type}' has no lowering") from None
    if info.type == op.type:  # explicit lowering (fwd op, or an own grad op)
        fn = _checked(info.lower, op, info.sparse, not info.lod)
    elif info.grad_lower is not None:  # "<fwd>_grad", explicit
        fn = _checked(_with_input_lods(info.grad_lower), op, False, False)
    else:  # generic "<fwd>_grad" resolved to the forward info
        fn = _checked(functools.partial(generic_grad_lower, fwd_info=info),
                      op, False, False)
    return (fn, {**info.attrs, **op.attrs},
            zlib.crc32(_op_rng_tag(op, info).encode()))


def op_context(ctx: ExecContext, op, env, tag: int) -> ExecContext:
    """The context op `op` (random-stream tag `tag`) runs in against
    `env`: derived from `ctx`, with its op, env and root set."""
    child = ctx.child(tag)
    child.op, child.env, child.root = op, env, ctx
    return child


# ---------------------------------------------------------------------------
# per-op scopes
# ---------------------------------------------------------------------------

# None (every run_op and plan step adds nothing), or while the profiler's
# device half or a scope-annotating export is on, a callable(name) -> a
# context manager each op runs inside: a torch.profiler range, or fx
# node metadata (profiler.py)
_scope_factory = None


def op_scope_name(op) -> str:
    """The JAX package's per-op named scope: "<type>:<first output>"."""
    outs = op.output_names()
    return f"{op.type}:{outs[0]}" if outs else op.type


def current_op_scopes():
    """The installed scope factory, or None."""
    return _scope_factory


@contextlib.contextmanager
def op_scopes(factory):
    """Run every op inside `factory(op_scope_name(op))` while the block
    is open (nested installs restore the outer one)."""
    global _scope_factory
    outer, _scope_factory = _scope_factory, factory
    try:
        yield
    finally:
        _scope_factory = outer


def run_op(ctx: ExecContext, op, env):
    """Execute one op desc against `env` (inside its scope while
    `op_scopes` is on)."""
    ins = gather_inputs(op, env)
    fn, attrs, tag = resolve_op(op)
    if _scope_factory is None:
        scatter_outputs(op, env, fn(op_context(ctx, op, env, tag), ins,
                                    attrs))
        return
    with _scope_factory(op_scope_name(op)):
        scatter_outputs(op, env, fn(op_context(ctx, op, env, tag), ins,
                                    attrs))


# ---------------------------------------------------------------------------
# generic gradient
# ---------------------------------------------------------------------------


def _is_float_slot(vals) -> bool:
    """Whether a slot's values are all float tensors (a LoDTensor's
    data): a SelectedRows (int rows) never is, so it never becomes an
    autograd leaf."""
    leaves = [data_of(v) for v in vals if v is not None]
    return bool(leaves) and all(
        isinstance(v, torch.Tensor) and v.is_floating_point()
        for v in leaves)


def generic_grad_lower(ctx, ins, attrs, fwd_info):
    """Grad-op convention (see backward.py): inputs = forward input slots
    + forward output slots + "<out_slot>@GRAD" cotangents; outputs =
    "<in_slot>@GRAD".  Missing cotangents must have been filled with
    fill_zeros_like by append_backward.

    Only the tensors of the differentiable input slots become autograd
    leaves (a LoDTensor's data); the forward is re-run on them with
    their LoDs, since the sequence ops read them, and its outputs and
    the cotangents are taken as their data.  An input with no path to
    the chosen outputs gets zeros; every gradient carries its input's
    LoD."""
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
                d = data_of(v)
                if isinstance(d, torch.Tensor) and d.is_floating_point():
                    d = d.detach().requires_grad_(True)
                    leaves.append((s, len(vals), d))
                    v = with_lod_of(v, d)
                vals.append(v)
            full[s] = vals
        outs = _forward_lowering(fwd_info)(ctx.pure(), full, attrs)
        ys, cots = [], []
        for s in out_slots:
            vs = outs[s]
            vs = list(vs) if isinstance(vs, (list, tuple)) else [vs]
            for y, g in zip(vs, ins[s + GRAD]):
                y, g = data_of(y), data_of(g)
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
        res[s + GRAD][i] = with_lod_of(
            fwd_ins[s][i], torch.zeros_like(leaf) if g is None else g)
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


def data_of(v):
    """The dense tensor behind a value (a LoDTensor's data)."""
    return v.data if isinstance(v, LoDTensor) else v


def with_lod_of(v, out_data):
    """`out_data` with v's LoD if v carries one."""
    return LoDTensor(out_data, v.lod) if isinstance(v, LoDTensor) \
        else out_data


def dense_of(v):
    """A dense value: a SelectedRows made dense, anything else as it is
    (the JAX package's `_dense_grad`)."""
    return v.to_dense() if isinstance(v, SelectedRows) else v


def scalar_like(x, v):
    """A 0-d tensor of x's dtype on x's device holding `v` rounded to that
    dtype: a device fill, not a host-to-device copy, so it neither waits
    for the stream nor breaks a CUDA graph capture."""
    return torch.full((), v, dtype=x.dtype, device=x.device)
