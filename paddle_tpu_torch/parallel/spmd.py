"""GSPMD-style sharding propagation over the Program IR.

Counterpart of paddle_tpu/parallel/spmd.py, which is pure IR and is
carried over as it is: given one annotated Program, complete a
per-variable sharding table by walking the forward ops, derive the
parameter placements (Megatron column/row alternation for matmuls,
bias-follows-activation, batch over the data axis), and report every
inconsistency as a structured finding.  `spec_to_partition` returns the
port's `parallel.mesh.PartitionSpec`.

ParallelExecutor folds the plan's placements under any explicit
`param_shardings` and runs a plan over a model axis (`SpmdPlan.model_axes`)
in its tensor-parallel "sharded" form (parallel/tensor_parallel.py).

The propagation is deliberately conservative: it understands the op
families the strategy implementations use (matmul, elementwise, LN,
row-wise losses, reshape/lookup plumbing) and degrades to "replicated /
batch-sharded dim 0" elsewhere — an unknown op never silently invents a
split.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from ..core.framework import (GRAD_SUFFIX, Parameter, normalize_sharding,
                              sharding_axes)

__all__ = ["SpmdPlan", "propagate_sharding", "spec_to_partition",
           "backward_start_index", "has_annotations"]


def has_annotations(block) -> bool:
    """True when any var or op desc in `block` carries a sharding
    annotation — the one predicate gating both the spmd derivation in
    ParallelExecutor and the sharding-consistency pass."""
    return (any(v.sharding is not None for v in block.vars.values())
            or any(op.dist_attr.get("sharding") for op in block.ops))


# op families for propagation (forward section only)
_ELEMENTWISE = {
    "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "elementwise_max", "elementwise_min",
    "elementwise_pow",
}
_UNARY = {
    "relu", "tanh", "sigmoid", "exp", "abs", "square", "softsign",
    "reciprocal", "sqrt", "log", "softplus", "softmax", "scale", "cast",
    "dropout", "clip", "leaky_relu", "elu", "relu6", "pow", "stanh",
    "hard_shrink", "soft_shrink", "brelu",
}
# row-wise ops: batch dim preserved, features consumed
_ROWWISE = {
    "cross_entropy", "softmax_with_cross_entropy", "square_error_cost",
    "sigmoid_cross_entropy_with_logits", "accuracy", "one_hot",
    "smooth_l1",
}


@dataclasses.dataclass
class Finding:
    """One propagation finding, Diagnostic-shaped but dependency-free
    (the analysis pass converts; the transpiler prints/raises)."""

    severity: str          # "error" | "warning" | "info"
    message: str
    op_idx: Optional[int] = None
    op_type: Optional[str] = None
    hint: str = ""


@dataclasses.dataclass
class SpmdPlan:
    """Output of propagate_sharding: the placement table the spmd
    transpiler hands the executors."""

    mesh_axes: Optional[Dict[str, int]]
    batch_axis: str
    var_specs: Dict[str, tuple]          # every var with a derived spec
    param_specs: Dict[str, tuple]        # Parameter subset (placements)
    feed_specs: Dict[str, tuple]         # feed vars (data shardings)
    reduce_ops: Dict[int, Tuple[str, ...]]  # op idx -> pending-psum axes
    findings: List[Finding] = dataclasses.field(default_factory=list)

    @property
    def model_axes(self) -> Tuple[str, ...]:
        """Mesh axes used by parameter placements (the tensor-parallel
        axes), in first-use order."""
        seen: List[str] = []
        for spec in self.param_specs.values():
            for a in sharding_axes(spec):
                if a != self.batch_axis and a not in seen:
                    seen.append(a)
        return tuple(seen)

    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == "error"]

    def check(self) -> "SpmdPlan":
        """Raise on error-severity findings (the memory layer's
        plan.check() convention) — the one gate both the transpiler and
        ParallelExecutor call before lowering."""
        errs = self.errors()
        if errs:
            raise ValueError(
                "sharding annotations are inconsistent:\n  "
                + "\n  ".join(f.message for f in errs))
        return self


def spec_to_partition(spec):
    """Normalized tuple spec -> the port's PartitionSpec."""
    from .mesh import PartitionSpec as P

    if spec is None:
        return P()
    return P(*[tuple(e) if isinstance(e, tuple) else e for e in spec])


def _static_spec_findings(v, spec, mesh_axes, out: List[Finding]):
    """Arity/axis checks for one annotated var (shared with the
    analysis pass via the plan's findings)."""
    ndim = v.ndim
    if ndim is not None and len(spec) > ndim:
        out.append(Finding(
            "error",
            f"sharding spec {spec} of {v.name!r} has {len(spec)} "
            f"entries but the variable is rank {ndim}",
            hint="one spec entry per tensor dim (trailing dims may be "
                 "omitted)"))
        return
    axes = sharding_axes(spec)
    dups = sorted({a for a in axes if axes.count(a) > 1})
    if dups:
        out.append(Finding(
            "error",
            f"sharding spec {spec} of {v.name!r} names mesh axis(es) "
            f"{dups} more than once",
            hint="an axis may shard at most one dim of a tensor"))
    if mesh_axes is not None:
        unknown = sorted({a for a in axes if a not in mesh_axes})
        if unknown:
            out.append(Finding(
                "error",
                f"sharding spec {spec} of {v.name!r} references "
                f"undeclared mesh axis(es) {unknown} "
                f"(mesh has {sorted(mesh_axes)})"))
        elif v.shape is not None:
            for i, e in enumerate(spec):
                if e is None:
                    continue
                size = 1
                for a in (e if isinstance(e, tuple) else (e,)):
                    size *= int(mesh_axes[a])
                dim = v.shape[i]
                if dim > 0 and dim % size:
                    out.append(Finding(
                        "warning",
                        f"{v.name!r} dim {i} ({dim}) is not divisible "
                        f"by the {e!r} axis size {size} — GSPMD will "
                        "pad (correct but wasteful)",
                        hint="size the dim to a multiple of its mesh "
                             "axes"))


def backward_start_index(block) -> int:
    """Index of the first backward op (the fill_constant seeding a
    @GRAD), or len(ops) for inference programs — same detection as
    PipelineExecutor._partition."""
    for i, op in enumerate(block.ops):
        outs = op.output_names()
        if (op.type == "fill_constant" and len(outs) == 1
                and outs[0].endswith(GRAD_SUFFIX)):
            return i
    return len(block.ops)


def _desc_annotations(block, out: List[Finding]) -> Dict[str, tuple]:
    """Explicit annotations: Variable.sharding plus op-level dist_attr
    riders (deserialized programs may carry either); a var-vs-desc
    mismatch is the textbook contradictory-spec error."""
    explicit: Dict[str, tuple] = {}
    for v in block.vars.values():
        if v.sharding is not None:
            explicit[v.name] = v.sharding
    for idx, op in enumerate(block.ops):
        for name, spec in (op.dist_attr.get("sharding") or {}).items():
            spec = normalize_sharding(spec)
            if spec is None:
                continue
            if name in explicit and explicit[name] != spec:
                out.append(Finding(
                    "error",
                    f"contradictory sharding specs for {name!r}: "
                    f"variable annotation {explicit[name]} vs op "
                    f"dist_attr {spec}",
                    op_idx=idx, op_type=op.type,
                    hint="re-annotate through layers.shard (it rejects "
                         "conflicts at build time)"))
            else:
                explicit.setdefault(name, spec)
    return explicit


def _batch_entry(spec):
    return spec[0] if spec else None


def _merge(explicit, prop):
    """Merge a user annotation with a propagated spec: a None entry in
    either is an unconstrained dim the other side may fill (users
    annotate the model-parallel dims; the batch dim rides along from
    propagation).  Returns (merged, conflict_dims)."""
    n = max(len(explicit), len(prop))
    e = tuple(explicit) + (None,) * (n - len(explicit))
    p = tuple(prop) + (None,) * (n - len(prop))
    out, conflicts = [], []
    for i, (a, b) in enumerate(zip(e, p)):
        if a is None:
            out.append(b)
        elif b is None or a == b:
            out.append(a)
        else:
            out.append(a)  # the user's word wins (intentional reshard)
            conflicts.append(i)
    return tuple(out), conflicts


def _feature_entry(spec, ndim=None):
    """The trailing (feature) entry of a spec padded to ndim."""
    if not spec:
        return None
    if ndim is not None and len(spec) < ndim:
        return None  # trailing dims implicitly replicated
    return spec[-1]


def propagate_sharding(program, mesh_axes: Optional[Dict[str, int]] = None,
                       batch_axis: str = "dp") -> SpmdPlan:
    """Complete the sharding table for `program`'s global block.

    Seeds: explicit annotations (Variable.sharding / op dist_attr).
    Unannotated FEED vars (leading -1 dim, not persistable, no producer)
    default to batch-over-`batch_axis` — the dp strategy every mesh run
    uses.  The walk covers the forward section only: backward specs
    mirror forward ones and the executors/XLA derive them.

    Rules (the Megatron discipline, pipeline_program._derive_tp_specs
    generalized to explicit specs):
      * mul: a column-split weight (None, a) makes the output
        feature-sharded over `a`; a row-split weight (a, None) consumes
        a feature-sharded input and emits a pending psum over `a`
        (recorded in plan.reduce_ops; XLA inserts the all-reduce).  A
        feature-sharded input meeting an UNannotated weight infers the
        row split; an annotated output feature spec back-infers the
        column split.
      * elementwise: specs join; a rank-1 parameter operand (bias)
        inherits the activation's feature entry.
      * layer_norm / row-wise losses: full-feature ops — feature
        sharding is consumed (a sharded input is flagged as a reshard),
        batch sharding passes through.
      * everything else: dim-0 batch sharding propagates when the
        output keeps a leading batch dim; feature specs do not (no
        silent invention of splits).
    """
    block = program.global_block()
    mesh_axes = dict(mesh_axes) if mesh_axes is not None \
        else (dict(program.mesh_axes) if program.mesh_axes else None)
    findings: List[Finding] = []
    explicit = _desc_annotations(block, findings)

    for name, spec in explicit.items():
        if name in block.vars:
            _static_spec_findings(block.vars[name], spec, mesh_axes,
                                  findings)

    produced = {n for op in block.ops for n in op.output_names()}
    specs: Dict[str, tuple] = dict(explicit)
    feed_specs: Dict[str, tuple] = {}
    for v in block.vars.values():
        if v.persistable or v.name in produced:
            continue
        if v.name in explicit:
            # annotated feed (e.g. a replicated shared table)
            feed_specs[v.name] = explicit[v.name]
        elif v.shape and v.shape[0] == -1:
            specs[v.name] = (batch_axis,)
            feed_specs[v.name] = specs[v.name]

    param_specs: Dict[str, tuple] = {
        n: s for n, s in explicit.items()
        if n in block.vars and isinstance(block.vars[n], Parameter)}
    reduce_ops: Dict[int, Tuple[str, ...]] = {}

    def is_param(n):
        v = block.vars.get(n)
        return v is not None and isinstance(v, Parameter)

    def ndim_of(n):
        v = block.vars.get(n)
        return v.ndim if v is not None else None

    stop = backward_start_index(block)
    # reverse pre-pass: a user annotates the activation they HOLD (the
    # post-bias/post-activation fc output); push that intent backward
    # through the feature-preserving chain so the producing matmul can
    # back-infer its column split
    goals: Dict[str, tuple] = dict(explicit)
    for op in reversed(block.ops[:stop]):
        if op.type not in _UNARY and op.type not in _ELEMENTWISE:
            continue
        outs = op.outputs.get("Out") or op.outputs.get("Y") or []
        x = op.inputs.get("X", [None])[0]
        if not (outs and x) or x in goals:
            continue
        g = goals.get(outs[0])
        if g is not None:
            goals[x] = g

    def set_spec(name, spec, idx, op):
        """Record a propagated spec, merging with any explicit
        annotation; a hard per-dim disagreement keeps the user's word
        and is flagged as an intentional reshard."""
        spec = spec if spec is None or any(e is not None for e in spec) \
            else None
        if spec is None:
            return
        if name in explicit:
            merged, conflicts = _merge(explicit[name], spec)
            if conflicts:
                findings.append(Finding(
                    "warning",
                    f"{op.type} output {name!r} propagates as {spec} "
                    f"but is annotated {explicit[name]} (dims "
                    f"{conflicts} disagree) — GSPMD will reshard here",
                    op_idx=idx, op_type=op.type,
                    hint="intentional reshards are fine; otherwise "
                         "align the annotation with its producer"))
            specs[name] = merged
            return
        specs.setdefault(name, spec)

    def batch_through(idx, op):
        """Default rule: leading batch sharding follows any output that
        keeps a leading -1 batch dim."""
        b = None
        for n in op.input_names():
            e = _batch_entry(specs.get(n))
            if e is not None:
                b = e
                break
        if b is None:
            return
        for n in op.output_names():
            v = block.vars.get(n)
            if v is not None and v.shape and v.shape[0] == -1:
                set_spec(n, (b,), idx, op)

    for idx, op in enumerate(block.ops[:stop]):
        t = op.type
        if t == "mul" or (t == "matmul"
                          and not op.attrs.get("transpose_X")
                          and not op.attrs.get("transpose_Y")):
            x = op.inputs.get("X", [None])[0]
            y = op.inputs.get("Y", [None])[0]
            out = op.outputs.get("Out", [None])[0]
            if not (x and y and out):
                continue
            xs, ys = specs.get(x), specs.get(y)
            x_feat = _feature_entry(xs, ndim_of(x))
            y_nd = ndim_of(y) or 2
            # back-infer a column split from an annotated output (the
            # annotation may sit downstream past bias/activation ops —
            # the reverse `goals` pre-pass carried it here)
            goal = goals.get(out)
            if ys is None and is_param(y) and goal is not None:
                o_feat = _feature_entry(goal, ndim_of(out))
                if o_feat is not None and x_feat is None:
                    ys = (None,) * (y_nd - 1) + (o_feat,)
                    param_specs[y] = ys
                    specs[y] = ys
            # infer a row split from a feature-sharded input
            if ys is None and is_param(y) and x_feat is not None:
                ys = (x_feat,) + (None,) * (y_nd - 1)
                param_specs[y] = ys
                specs[y] = ys
            if ys is not None:
                y_contract = ys[0] if ys else None
                y_out = _feature_entry(ys, y_nd)
                if x_feat is not None and y_contract is None:
                    findings.append(Finding(
                        "warning",
                        f"{t} at op {idx}: input {x!r} is "
                        f"feature-sharded ({xs}) but weight {y!r} "
                        f"({ys}) does not split the contraction dim — "
                        "GSPMD will all-gather the activation",
                        op_idx=idx, op_type=t,
                        hint="row-split the weight (axis, None) to "
                             "contract locally with one psum"))
                if (x_feat is not None and y_contract is not None
                        and x_feat != y_contract):
                    findings.append(Finding(
                        "error",
                        f"{t} at op {idx}: contraction dim of {x!r} is "
                        f"sharded over {x_feat!r} but weight {y!r} "
                        f"splits it over {y_contract!r} — "
                        "contradictory specs for one contraction",
                        op_idx=idx, op_type=t))
                if y_contract is not None and x_feat == y_contract:
                    # row-parallel matmul: local contraction + psum
                    reduce_ops[idx] = tuple(
                        y_contract if isinstance(y_contract, tuple)
                        else (y_contract,))
                    y_out = None if y_out == y_contract else y_out
                b = _batch_entry(xs)
                o_nd = ndim_of(out) or 2
                o_spec = (b,) + (None,) * max(o_nd - 2, 0) + (y_out,)
                set_spec(out, o_spec, idx, op)
            else:
                batch_through(idx, op)
        elif t in _ELEMENTWISE:
            x = op.inputs.get("X", [None])[0]
            y = op.inputs.get("Y", [None])[0]
            out = op.outputs.get("Out", [None])[0]
            xs = specs.get(x)
            x_feat = _feature_entry(xs, ndim_of(x))
            if (y and is_param(y) and ndim_of(y) == 1
                    and y not in param_specs and x_feat is not None):
                # bias follows its activation's feature sharding
                param_specs[y] = (x_feat,)
                specs[y] = (x_feat,)
            ysp = specs.get(y)
            if (xs is not None and ysp is not None
                    and ndim_of(x) == ndim_of(y) and xs != ysp):
                findings.append(Finding(
                    "warning",
                    f"{t} at op {idx}: operands {x!r} {xs} and {y!r} "
                    f"{ysp} carry different shardings — GSPMD will "
                    "reshard one side (resharding hotspot)",
                    op_idx=idx, op_type=t,
                    hint="annotate both operands alike"))
            if out and xs is not None:
                set_spec(out, xs, idx, op)
        elif t in _UNARY:
            x = op.inputs.get("X", [None])[0]
            xs = specs.get(x)
            if xs is not None:
                for n in op.outputs.get("Out", []):
                    set_spec(n, xs, idx, op)
        elif t in ("layer_norm", "batch_norm"):
            x = op.inputs.get("X", [None])[0]
            xs = specs.get(x)
            x_feat = _feature_entry(xs, ndim_of(x))
            if x_feat is not None:
                findings.append(Finding(
                    "warning",
                    f"{t} at op {idx}: input {x!r} is feature-sharded "
                    f"({xs}) but normalization needs the full feature "
                    "dim — GSPMD will all-gather (resharding hotspot)",
                    op_idx=idx, op_type=t,
                    hint="keep the residual stream replicated between "
                         "Megatron-split sublayers"))
            if xs is not None:
                out = (op.outputs.get("Y") or op.outputs.get("Out")
                       or [None])[0]
                if out:
                    nd = ndim_of(x)
                    # clear the FEATURE entry only when the spec
                    # actually reaches it; a short batch-only spec
                    # passes through unchanged (batch sharding must
                    # survive normalization layers)
                    if nd is not None and len(xs) >= nd and xs:
                        o_spec = tuple(xs[:-1]) + (None,)
                    else:
                        o_spec = xs
                    set_spec(out, o_spec, idx, op)
        elif t in _ROWWISE:
            # per-row losses/metrics consume the full feature dim: a
            # feature-sharded input forces a gather (the docstring's
            # "feature sharding is consumed" rule)
            x = (op.inputs.get("X", [None])[0]
                 or op.inputs.get("Logits", [None])[0])
            xs = specs.get(x)
            x_feat = _feature_entry(xs, ndim_of(x))
            if x_feat is not None:
                findings.append(Finding(
                    "warning",
                    f"{t} at op {idx}: input {x!r} is feature-sharded "
                    f"({xs}) but the op reduces over the full feature "
                    "dim — GSPMD will all-gather (resharding hotspot)",
                    op_idx=idx, op_type=t,
                    hint="psum the row-parallel matmul before the "
                         "loss (keep the logits replicated)"))
            batch_through(idx, op)
        else:
            batch_through(idx, op)

    # parameters never inferred stay replicated — by design
    plan = SpmdPlan(mesh_axes=mesh_axes, batch_axis=batch_axis,
                    var_specs=specs, param_specs=param_specs,
                    feed_specs=feed_specs, reduce_ops=reduce_ops,
                    findings=findings)
    return plan
