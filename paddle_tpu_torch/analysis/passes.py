"""Built-in analysis passes over the Program IR (counterpart of
paddle_tpu/analysis/passes.py, at the same pass ids and orders).

Each pass checks one class of build-time invariant that would otherwise
surface (if at all) as a cryptic runtime failure deep inside a step on
the card.  Pass ids are stable API — tests pin them, `verify(passes=
[...])` filters by them, and docs/analysis.md catalogs them.  The
shape-inference pass re-runs this package's inference (the op's torch
lowering on meta tensors, core/shape_inference.py).

Severity conventions (see docs/analysis.md):
  * error   — the program cannot execute correctly (dangling name,
    invalid sub-block index, malformed distributed attrs);
  * warning — legal to execute but almost certainly a bug (undeclared
    in-place clobber with a later reader, dtype conflict on a shared
    var, non-duplicable slot bound to several vars);
  * info    — hygiene / performance observations (dead ops without
    fetch context, data-dependent -1 dims that trigger recompiles).
"""
from __future__ import annotations

import re
from typing import Dict, List, Set

from ..core import shape_inference
from ..core.framework import EMPTY_VAR_NAMES, GRAD_SUFFIX, Parameter
from .registry import register_pass

_GRAD = "_grad"


def _lookup_var(block, name):
    try:
        return block.var(name)
    except KeyError:
        return None


def _safe_parent(program, block):
    """block.parent, but tolerant of corrupt parent_idx (a deserialized
    bad program must produce diagnostics, not an IndexError inside the
    verifier — the control-flow pass reports the broken link itself)."""
    if not 0 <= block.parent_idx < len(program.blocks):
        return None
    return program.blocks[block.parent_idx]


def _fwd_info_of_grad(ctx, op):
    """OpInfo of the forward op for a '<fwd>_grad' op desc, else None."""
    if not op.type.endswith(_GRAD):
        return None
    from ..core import registry as op_registry

    try:
        return op_registry.get_op_info(op.type[: -len(_GRAD)])
    except KeyError:
        return None


# ---------------------------------------------------------------------------
# 1. def-before-use / dangling inputs
# ---------------------------------------------------------------------------


@register_pass("def-before-use", order=10)
def check_def_before_use(ctx):
    """Every op input must resolve to a variable in the op's block or an
    ancestor block (`@EMPTY@` / '' sentinels excepted).  In the global
    block, additionally warn when a value is read before the op that
    first produces it (feed vars — never produced — are exempt, as are
    loop-state vars also written from sub-blocks)."""
    # names written from inside any sub-block: loop/branch state whose
    # global-block read order is not a straight-line data dependency
    sub_written: Set[str] = set()
    for block in ctx.program.blocks[1:]:
        for op in block.ops:
            sub_written.update(op.output_names())

    for block in ctx.program.blocks:
        first_write: Dict[str, int] = {}
        for idx, op in enumerate(block.ops):
            for n in op.output_names():
                first_write.setdefault(n, idx)
        for idx, op in enumerate(block.ops):
            for n in op.input_names():
                if n in EMPTY_VAR_NAMES:
                    continue
                if not ctx.resolvable(block, n):
                    yield ctx.diag(
                        "error",
                        f"input {n!r} of op {op.type!r} does not resolve "
                        "to any variable in this block or its ancestors",
                        block, idx, op,
                        hint="the var was never created (renamed grad? "
                             "pruned producer?) — create it or fix the "
                             "op's input name",
                    )
                    continue
                if block.idx != 0:
                    continue  # ordering only checked on the global block
                w = first_write.get(n)
                if (w is not None and w > idx and n not in sub_written
                        and (ctx.feed_names is None
                             or n not in ctx.feed_names)):
                    v = _lookup_var(block, n)
                    if v is not None and v.persistable:
                        continue  # scope-carried state (params, counters)
                    yield ctx.diag(
                        "warning",
                        f"op {op.type!r} reads {n!r} at position {idx} "
                        f"but its first producer runs later (op {w})",
                        block, idx, op,
                        hint="reorder the ops, or feed the value "
                             "explicitly",
                    )


# ---------------------------------------------------------------------------
# 2. slot arity + duplicability vs registry OpInfo
# ---------------------------------------------------------------------------


@register_pass("op-arity", order=20)
def check_op_arity(ctx):
    """Every Operator's slots must match its registry OpInfo: no unknown
    slots, and only slots declared duplicable may bind several vars.
    Unregistered op types are errors (the executor cannot lower them)."""
    for block, idx, op in ctx.iter_ops():
        info = ctx.op_info(op)
        if info is None:
            yield ctx.diag(
                "error",
                f"op type {op.type!r} is not registered — it has no "
                "lowering and will raise at execution",
                block, idx, op,
                hint="register it with core.registry.register_op, or "
                     "fix the op type",
            )
            continue
        fwd = _fwd_info_of_grad(ctx, op)
        if fwd is not None:
            # generic grad desc carries fwd inputs + fwd outputs +
            # '<out>@GRAD' cotangents; outputs are '<in>@GRAD'
            in_ok = (set(fwd.inputs) | set(fwd.outputs)
                     | {s + GRAD_SUFFIX for s in fwd.outputs})
            out_ok = {s + GRAD_SUFFIX for s in fwd.inputs}
            dup_in = (set(fwd.dup_inputs) | set(fwd.dup_outputs)
                      | {s + GRAD_SUFFIX for s in fwd.dup_outputs})
            dup_out = {s + GRAD_SUFFIX for s in fwd.dup_inputs}
            if info.type == op.type:  # explicitly registered grad op
                in_ok |= set(info.inputs)
                out_ok |= set(info.outputs)
                dup_in |= set(info.dup_inputs)
                dup_out |= set(info.dup_outputs)
        elif info.type != op.type:
            continue  # grad of an unregistered fwd: arity unknowable
        else:
            in_ok, out_ok = set(info.inputs), set(info.outputs)
            dup_in, dup_out = set(info.dup_inputs), set(info.dup_outputs)
        for slot in op.inputs:
            if slot not in in_ok:
                yield ctx.diag(
                    "error",
                    f"op {op.type!r} binds undeclared input slot "
                    f"{slot!r} (declared: {sorted(in_ok)})",
                    block, idx, op,
                    hint="declare the slot in the register_op call or "
                         "drop it from the op desc",
                )
            elif len(op.inputs[slot]) > 1 and slot not in dup_in:
                yield ctx.diag(
                    "warning",
                    f"op {op.type!r} binds {len(op.inputs[slot])} vars "
                    f"to non-duplicable input slot {slot!r}",
                    block, idx, op,
                    hint="mark the slot with dup_inputs=(...) in "
                         "register_op if multi-var is intended",
                )
        for slot in op.outputs:
            if slot not in out_ok:
                yield ctx.diag(
                    "error",
                    f"op {op.type!r} binds undeclared output slot "
                    f"{slot!r} (declared: {sorted(out_ok)})",
                    block, idx, op,
                    hint="declare the slot in the register_op call or "
                         "drop it from the op desc",
                )
            elif len(op.outputs[slot]) > 1 and slot not in dup_out:
                yield ctx.diag(
                    "warning",
                    f"op {op.type!r} binds {len(op.outputs[slot])} vars "
                    f"to non-duplicable output slot {slot!r}",
                    block, idx, op,
                    hint="mark the slot with dup_outputs=(...) in "
                         "register_op if multi-var is intended",
                )


# ---------------------------------------------------------------------------
# 3. full shape/dtype propagation
# ---------------------------------------------------------------------------


@register_pass("shape-inference", order=30)
def check_shape_inference(ctx):
    """Re-run build-time shape inference over every op of every block and
    report what the old code silently dropped: ops whose default
    inference fails (so their output shapes stay unknown), inputs with
    no declared shape, and dtype conflicts between writers of a shared
    var.  Also flags data-dependent (-1) non-leading dims — the classic
    cause of hot-loop cache misses: every distinct size is a fresh plan
    and CUDA graph in the Executor (docs/performance.md).

    Verification must not mutate the program: declared shapes/dtypes
    are snapshotted first and restored afterwards (re-inference under
    different build-time flags, e.g. amp_bf16, would otherwise rewrite
    them)."""
    snapshot = [
        (v, v.shape, v.dtype)
        for block in ctx.program.blocks for v in block.vars.values()
    ]
    try:
        yield from _run_shape_inference(ctx)
    finally:
        for v, shape, dtype in snapshot:
            v.shape, v.dtype = shape, dtype


def _run_shape_inference(ctx):
    for block, idx, op in ctx.iter_ops():
        info = ctx.op_info(op)
        if info is None:
            continue  # op-arity reports unregistered types
        if info.host:
            continue  # host ops (save/load/send/print) do IO, not shapes
        reports: List = []

        def report(kind, **kw):
            reports.append((kind, kw))

        try:
            if info.infer_shape is not None and info.type == op.type:
                info.infer_shape(op, block)
            elif op.type.endswith(_GRAD):
                shape_inference.infer_grad_shapes(op, block)
            else:
                shape_inference.default_infer_shape(op, block,
                                                    report=report)
        except KeyError:
            continue  # dangling input name: def-before-use reports it
        except Exception as e:
            yield ctx.diag(
                "warning",
                f"explicit infer_shape for {op.type!r} raised "
                f"{type(e).__name__}: {e}",
                block, idx, op,
            )
            continue
        for kind, kw in reports:
            if kind == "infer-fail":
                yield ctx.diag(
                    "warning",
                    f"shape inference failed for op {op.type!r}: "
                    f"{type(kw['error']).__name__}: {kw['error']}",
                    block, idx, op,
                    hint="register an explicit inference fn via "
                         "core.registry.register_infer_shape"
                         f"({op.type!r})",
                )
            elif kind == "dtype-mismatch":
                yield ctx.diag(
                    "warning",
                    f"op {op.type!r} writes {kw['name']!r} as "
                    f"{kw['inferred']} but the var is already declared "
                    f"{kw['declared']} by an earlier writer",
                    block, idx, op,
                    hint="two ops share one output name with "
                         "conflicting dtypes — rename one output or "
                         "insert a cast",
                )
            elif kind == "unknown-input":
                yield ctx.diag(
                    "info",
                    f"op {op.type!r}: input {kw['name']!r} has no "
                    "declared shape/dtype, so output shapes were not "
                    "inferred",
                    block, idx, op,
                )

    # -1 sentinels beyond the leading (batch) dim: every distinct value
    # of such a dim is a fresh executable (recompile on the hot path)
    for block in ctx.program.blocks:
        flagged = [
            name for name, v in block.vars.items()
            if v.shape is not None and any(d < 0 for d in v.shape[1:])
        ]
        if flagged:
            show = ", ".join(sorted(flagged)[:5])
            more = len(flagged) - min(5, len(flagged))
            yield ctx.diag(
                "info",
                f"{len(flagged)} var(s) have data-dependent (-1) "
                f"non-leading dims ({show}"
                + (f", +{more} more" if more else "") + ")",
                block,
                hint="dynamic dims recompile per distinct size — "
                     "bucket/pad lengths (docs/performance.md, "
                     "'recompiles')",
            )


# ---------------------------------------------------------------------------
# 4. dead ops (outputs never consumed)
# ---------------------------------------------------------------------------


@register_pass("dead-op", order=40)
def check_dead_ops(ctx):
    """Flag ops whose outputs are never read by any later op, are not
    persistable/parameters, and (when the fetch list is known) are not
    fetched.  Host/side-effect ops and control-flow ops are exempt.
    Without fetch context the finding is informational — a leaf output
    may well be the value the user fetches."""
    read_anywhere: Set[str] = set()
    for _, _, op in ctx.iter_ops():
        read_anywhere.update(op.input_names())
    if ctx.fetch_names:
        read_anywhere |= ctx.fetch_names

    for block, idx, op in ctx.iter_ops():
        info = ctx.op_info(op)
        if info is None or info.host:
            continue
        if any(a.endswith("block") for a in op.attrs):
            continue  # control flow: sub-block dataflow is indirect
        outs = [n for n in op.output_names() if n not in EMPTY_VAR_NAMES]
        if not outs:
            continue  # pure side-effect op (send barrier, cond assert)
        live = False
        for n in outs:
            if n in read_anywhere:
                live = True
                break
            v = _lookup_var(block, n)
            if v is not None and (v.persistable or isinstance(v, Parameter)):
                live = True
                break
        if not live:
            yield ctx.diag(
                "warning" if ctx.fetch_names is not None else "info",
                f"op {op.type!r} is dead: outputs {outs} are never "
                "read, fetched, or persisted",
                block, idx, op,
                hint="remove the op, or fetch/persist its result",
            )


# ---------------------------------------------------------------------------
# 5. variable shadowing across nested blocks
# ---------------------------------------------------------------------------


@register_pass("var-shadowing", order=50)
def check_var_shadowing(ctx):
    """A var name redeclared in a nested block with a DIFFERENT
    shape/dtype than an ancestor's var of the same name: ancestor-chain
    lookup (Block.var) silently resolves to whichever is nearer, so the
    two declarations are one runtime slot with two conflicting types."""
    for block in ctx.program.blocks[1:]:
        for name, v in block.vars.items():
            b = _safe_parent(ctx.program, block)
            seen = {block.idx}
            while b is not None and b.idx not in seen:
                seen.add(b.idx)
                other = b.vars.get(name)
                if other is None:
                    b = _safe_parent(ctx.program, b)
                    continue
                mismatch = []
                if (v.shape is not None and other.shape is not None
                        and tuple(v.shape) != tuple(other.shape)):
                    mismatch.append(
                        f"shape {list(v.shape)} vs "
                        f"{list(other.shape)}")
                if (v.dtype is not None and other.dtype is not None
                        and v.dtype != other.dtype):
                    mismatch.append(f"dtype {v.dtype} vs {other.dtype}")
                if mismatch:
                    yield ctx.diag(
                        "warning",
                        f"var {name!r} in block {block.idx} shadows "
                        f"block {b.idx}'s var with mismatched "
                        + " and ".join(mismatch),
                        block,
                        hint="rename the inner var (unique_name) or "
                             "align the declarations",
                    )
                break  # nearest ancestor declaration wins the lookup


# ---------------------------------------------------------------------------
# 6. control-flow integrity
# ---------------------------------------------------------------------------


def _block_refs(op):
    """(attr_name, block_idx) for every sub-block reference on `op`."""
    refs = []
    for a, v in op.attrs.items():
        if isinstance(v, dict) and "__block__" in v:
            refs.append((a, v["__block__"]))
        elif a.endswith("block") and isinstance(v, int):
            refs.append((a, v))
    return refs


@register_pass("control-flow", order=60)
def check_control_flow(ctx):
    """Sub-block references must index real blocks whose parent chain
    reaches the op's own block (captured vars resolve along it); block
    parent links must be valid and acyclic; a '<t>_grad' op carrying a
    grad sub-block needs its paired forward '<t>' op in the program."""
    n = len(ctx.program.blocks)
    # parent link sanity first: a broken chain breaks every other check
    for block in ctx.program.blocks[1:]:
        if not 0 <= block.parent_idx < n:
            yield ctx.diag(
                "error",
                f"block {block.idx} has invalid parent_idx "
                f"{block.parent_idx} (program has {n} blocks)",
                block,
            )
            continue
        seen = {block.idx}
        b = block
        while 0 <= b.parent_idx < n:
            if b.parent_idx in seen:
                yield ctx.diag(
                    "error",
                    f"block {block.idx}'s parent chain cycles at block "
                    f"{b.parent_idx}",
                    block,
                )
                break
            seen.add(b.parent_idx)
            b = ctx.program.blocks[b.parent_idx]
            # an ancestor's own bad parent_idx is reported when the
            # outer loop reaches that block; stop walking here

    referenced: Set[int] = set()
    fwd_types = {op.type for _, _, op in ctx.iter_ops()
                 if not op.type.endswith(_GRAD)}
    for block, idx, op in ctx.iter_ops():
        for attr, tidx in _block_refs(op):
            if not isinstance(tidx, int) or not 0 <= tidx < n:
                yield ctx.diag(
                    "error",
                    f"op {op.type!r} attr {attr!r} references block "
                    f"{tidx!r}, but the program has {n} blocks",
                    block, idx, op,
                    hint="sub-block indices break when blocks are "
                         "copied between programs — rebuild via "
                         "Program.from_dict/clone",
                )
                continue
            referenced.add(tidx)
            if tidx == block.idx:
                yield ctx.diag(
                    "error",
                    f"op {op.type!r} attr {attr!r} references its own "
                    f"block {tidx} as a sub-block",
                    block, idx, op,
                )
                continue
            # captured names resolve through the sub-block's parent
            # chain — that chain must pass through the op's block
            sub = ctx.program.blocks[tidx]
            chain = set()
            b = sub
            while b is not None and b.idx not in chain:
                chain.add(b.idx)
                b = (ctx.program.blocks[b.parent_idx]
                     if 0 <= b.parent_idx < n else None)
            if block.idx not in chain:
                yield ctx.diag(
                    "warning",
                    f"sub-block {tidx} of op {op.type!r} does not have "
                    f"block {block.idx} on its parent chain — captured "
                    "vars will not resolve to this block's scope",
                    block, idx, op,
                )
        if op.type.endswith(_GRAD) and _block_refs(op):
            fwd_type = op.type[: -len(_GRAD)]
            if fwd_type not in fwd_types:
                yield ctx.diag(
                    "warning",
                    f"grad op {op.type!r} carries a grad sub-block but "
                    f"no forward {fwd_type!r} op exists in the program",
                    block, idx, op,
                )
    for block in ctx.program.blocks[1:]:
        if block.idx not in referenced:
            yield ctx.diag(
                "info",
                f"block {block.idx} is not referenced by any op's "
                "sub-block attr (orphaned by a rewrite?)",
                block,
            )


# ---------------------------------------------------------------------------
# 7. distributed lint
# ---------------------------------------------------------------------------

_ENDPOINT_RE = re.compile(r"^[\w.\-]+:\d+$")


def _effective_attrs(ctx, op):
    """Attrs as dispatch sees them: registered defaults overlaid by the
    op desc ({**info.attrs, **op.attrs}, core/execution.run_op) — a lint
    on raw op.attrs would flag ops that legally rely on defaults."""
    info = ctx.op_info(op)
    if info is not None and info.type == op.type:
        return {**info.attrs, **op.attrs}
    return op.attrs


def _check_endpoint(ctx, block, idx, op, attr, value):
    if not isinstance(value, str) or not _ENDPOINT_RE.match(value):
        return ctx.diag(
            "error",
            f"op {op.type!r} attr {attr!r} is {value!r}, not a "
            "'host:port' endpoint",
            block, idx, op,
            hint="endpoints come from the transpiler config "
                 "(trainer/pserver endpoint lists)",
        )
    return None


@register_pass("distributed-lint", order=70)
def check_distributed(ctx):
    """Distributed attrs checked before anything hits the network:
    send/recv/listen_and_serv endpoints well-formed and consistently
    paired, epmap arity matching the var list, pipeline_stage
    annotations monotone and contiguous per block, parallel_do ops
    agreeing on the participant count."""
    listen_eps: Set[str] = set()
    send_eps: Set[str] = set()
    num_places_seen: Dict[int, int] = {}  # num_places -> first op idx
    bucketed_sends: List[int] = []    # op idx: per-var epmap present
    unbucketed_sends: List[int] = []  # op idx: endpoints only

    for block, idx, op in ctx.iter_ops():
        attrs = _effective_attrs(ctx, op)
        if op.type == "send":
            endpoints = list(attrs.get("endpoints") or ())
            epmap = list(attrs.get("epmap") or ())
            out_epmap = list(attrs.get("out_epmap") or ())
            if not endpoints and not epmap:
                yield ctx.diag(
                    "error",
                    "send op has neither 'endpoints' nor 'epmap' — "
                    "there is nowhere to send to",
                    block, idx, op,
                )
                continue
            (bucketed_sends if epmap else unbucketed_sends).append(idx)
            n_in = len(op.input("X"))
            if epmap and len(epmap) != n_in:
                yield ctx.diag(
                    "error",
                    f"send op epmap has {len(epmap)} endpoints for "
                    f"{n_in} input vars — per-var mapping must match "
                    "1:1",
                    block, idx, op,
                )
            n_out = len(op.output("Out"))
            if out_epmap and len(out_epmap) != n_out:
                yield ctx.diag(
                    "error",
                    f"send op out_epmap has {len(out_epmap)} endpoints "
                    f"for {n_out} output vars — per-var mapping must "
                    "match 1:1",
                    block, idx, op,
                )
            for ep in endpoints + epmap + out_epmap:
                d = _check_endpoint(ctx, block, idx, op, "endpoints", ep)
                if d is not None:
                    yield d
                else:
                    send_eps.add(ep)
            if endpoints and (epmap or out_epmap):
                stray = sorted((set(epmap) | set(out_epmap)) -
                               set(endpoints))
                if stray:
                    yield ctx.diag(
                        "warning",
                        f"send op epmap routes to {stray} which are not "
                        "in its 'endpoints' list",
                        block, idx, op,
                    )
        elif op.type == "recv":
            ep = attrs.get("endpoint", "")
            if not ep:
                yield ctx.diag(
                    "error",
                    "recv op has an empty 'endpoint' attr",
                    block, idx, op,
                )
            else:
                d = _check_endpoint(ctx, block, idx, op, "endpoint", ep)
                if d is not None:
                    yield d
                else:
                    send_eps.add(ep)
        elif op.type == "listen_and_serv":
            ep = attrs.get("endpoint", "")
            d = _check_endpoint(ctx, block, idx, op, "endpoint", ep)
            if d is not None:
                yield d
            else:
                listen_eps.add(ep)
        elif op.type.startswith("c_"):
            ring = attrs.get("ring_id")
            if not isinstance(ring, str) or not ring:
                yield ctx.diag(
                    "error",
                    f"collective op {op.type!r} has invalid ring_id "
                    f"{ring!r} — expected a mesh axis name",
                    block, idx, op,
                )
        elif op.type == "parallel_do":
            np_ = int(attrs.get("num_places", 0) or 0)
            if np_:
                num_places_seen.setdefault(np_, idx)

    if bucketed_sends and unbucketed_sends:
        yield ctx.diag(
            "warning",
            "program mixes bucketed send ops (per-var epmap, ops "
            f"{bucketed_sends}) with unbucketed ones (endpoints only, "
            f"ops {unbucketed_sends}) — rounds behind the unbucketed "
            "ops cannot fuse transfers or overlap endpoints",
            ctx.program.blocks[0],
            hint="give every send op a per-var epmap (+ out_epmap for "
                 "the pulls) — the transpiler emits one fused send per "
                 "program in exactly that shape",
        )
    if len(num_places_seen) > 1:
        yield ctx.diag(
            "warning",
            "parallel_do ops disagree on participant count "
            f"(num_places values: {sorted(num_places_seen)})",
            ctx.program.blocks[0],
            hint="all replicas of one program must shard over the same "
                 "device count",
        )
    if listen_eps and send_eps:
        unmatched = sorted(send_eps - listen_eps)
        if unmatched:
            yield ctx.diag(
                "warning",
                f"send/recv endpoints {unmatched} have no "
                "listen_and_serv peer in this program",
                ctx.program.blocks[0],
                hint="trainer and pserver programs are usually "
                     "separate; ignore if the server runs elsewhere",
            )

    # pipeline stages: monotone non-decreasing and contiguous per block.
    # Grad ops inherit their forward op's stage and run in REVERSE stage
    # order by construction (backward.py copies attrs) — only the
    # forward trunk must be monotone.
    for block in ctx.program.blocks:
        staged = [(i, int(op.attrs["pipeline_stage"]))
                  for i, op in enumerate(block.ops)
                  if "pipeline_stage" in op.attrs
                  and not op.type.endswith(_GRAD)]
        if not staged:
            continue
        prev_i, prev_s = staged[0]
        for i, s in staged[1:]:
            if s < prev_s:
                op = block.ops[i]
                yield ctx.diag(
                    "warning",
                    f"pipeline_stage decreases from {prev_s} (op "
                    f"{prev_i}) to {s} (op {i}) — the GPipe trunk "
                    "expects stages in execution order",
                    block, i, op,
                    hint="build staged layers in stage order under "
                         "fluid.pipeline_stage(i)",
                )
                break
            prev_i, prev_s = i, s
        stages = sorted({s for _, s in staged})
        if stages and (stages[0] != 0
                       or stages != list(range(len(stages)))):
            yield ctx.diag(
                "info",
                f"pipeline stages in block {block.idx} are "
                f"{stages} — not a contiguous 0..{len(stages) - 1} "
                "range",
                block,
                hint="PipelineExecutor maps stages onto the 'pp' mesh "
                     "axis positionally",
            )


# ---------------------------------------------------------------------------
# 8. in-place aliasing hazards
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# 7b. collective safety (deadlock class of the mesh lowerings)
# ---------------------------------------------------------------------------

# the pipeline schedule's own hop primitive — the one legitimate user of
# the stage axis's ring from inside a staged region
_PIPELINE_HOPS = ("c_ppermute",)
_STAGE_AXIS = "pp"
# control-flow ops whose sub-block executes on a data-dependent subset
# of ranks (branch predicates can differ per rank)
_BRANCH_OPS = ("cond", "conditional_block")
_LOOP_OPS = ("while", "recurrent", "dynamic_rnn")


@register_pass("collective-safety", order=73)
def check_collective_safety(ctx):
    """Static deadlock analysis of the program's collective structure —
    the class of bug the ep x dp x tp composition hits at RUNTIME as a
    silent all-rank hang, caught here from the op descs.

    Rank model: `ring_id` names one communicator spanning every rank
    that references it; ops carrying a `pipeline_stage` attr are issued
    only by that stage's ranks, unstaged ops by all ranks.  Under SPMD
    every participating rank must issue an IDENTICAL sequence of
    collectives per ring, so the pass errors on:

      * cross-rank ordering mismatch — two stages issue the same ring's
        collectives in different orders (every rank blocks inside a
        different collective; none completes);
      * pipeline-stage collective imbalance — stages disagree on HOW
        MANY collectives they issue on one ring (some ranks wait at a
        collective their peers never reach);
      * ring_id reuse across overlapping groups — a staged collective
        (other than the schedule's own `c_ppermute` hops) over the
        stage axis's ring: the per-stage subgroup overlaps the
        schedule's full-axis group on one communicator;
      * a collective inside a data-dependent branch sub-block (cond):
        ranks disagreeing on the predicate deadlock the ring; inside a
        loop sub-block it is a warning (trip counts must match on every
        rank, which the IR cannot prove).

    Programs with no collective ops skip the pass entirely."""
    program = ctx.program
    n_blocks = len(program.blocks)

    # who owns each sub-block (for the control-flow context of a ring)
    owner: Dict[int, object] = {}
    for block, idx, op in ctx.iter_ops():
        for _attr, tidx in _block_refs(op):
            if isinstance(tidx, int) and 0 <= tidx < n_blocks:
                owner.setdefault(tidx, op)

    def enclosing_control(block):
        """Nearest control-flow op owning `block` or an ancestor, or
        None for trunk blocks."""
        b = block
        seen = set()
        while b is not None and b.idx not in seen:
            seen.add(b.idx)
            op = owner.get(b.idx)
            if op is not None and op.type in _BRANCH_OPS + _LOOP_OPS:
                return op
            b = _safe_parent(program, b)
        return None

    any_collective = False
    ring_scopes: Dict[str, Set[int]] = {}  # ring -> block idxs using it
    staged: Dict[int, List] = {}   # stage -> [(op_idx, type, ring)]
    all_stages: Set[int] = set()   # every stage any op runs under
    for block, idx, op in ctx.iter_ops():
        if "pipeline_stage" in op.attrs and not op.type.endswith(_GRAD):
            all_stages.add(int(op.attrs["pipeline_stage"]))
        if not op.type.startswith("c_"):
            continue
        any_collective = True
        attrs = _effective_attrs(ctx, op)
        ring = attrs.get("ring_id")
        if not isinstance(ring, str) or not ring:
            continue  # distributed-lint reports the malformed ring_id
        ring_scopes.setdefault(ring, set()).add(block.idx)

        ctl = enclosing_control(block)
        if ctl is not None:
            if ctl.type in _BRANCH_OPS:
                yield ctx.diag(
                    "error",
                    f"collective {op.type!r} (ring {ring!r}) sits in "
                    f"the sub-block of a {ctl.type!r} op — ranks taking "
                    "different branches deadlock the ring",
                    block, idx, op,
                    hint="hoist the collective out of the branch, or "
                         "make the predicate provably rank-uniform")
            else:
                yield ctx.diag(
                    "warning",
                    f"collective {op.type!r} (ring {ring!r}) sits in "
                    f"the body of a {ctl.type!r} op — every rank must "
                    "run the same trip count or the ring deadlocks",
                    block, idx, op,
                    hint="prefer a fixed trip count shared by all "
                         "ranks")

        stage = op.attrs.get("pipeline_stage")
        if stage is not None:
            stage = int(stage)
            staged.setdefault(stage, []).append((idx, op.type, ring))
            if ring == _STAGE_AXIS and op.type not in _PIPELINE_HOPS:
                yield ctx.diag(
                    "error",
                    f"staged collective {op.type!r} at stage {stage} "
                    f"reuses ring {_STAGE_AXIS!r} — the stage axis's "
                    "communicator belongs to the pipeline schedule's "
                    "permutes; a per-stage reduction over it overlaps "
                    "the schedule's full-axis group",
                    block, idx, op,
                    hint="reduce over a dedicated axis (dp/tp) or "
                         "after the pipeline epilogue")

    if not any_collective:
        return

    # ring used from both the trunk and a control-flow sub-block: the
    # scopes execute under different schedules on one communicator
    for ring, scopes in sorted(ring_scopes.items()):
        sub = sorted(i for i in scopes if i != 0)
        if 0 in scopes and sub:
            yield ctx.diag(
                "warning",
                f"ring {ring!r} is used from the global block AND from "
                f"sub-block(s) {sub} — one communicator under two "
                "control-flow scopes is an overlapping-group hazard",
                program.blocks[0],
                hint="give control-flow-scoped collectives their own "
                     "ring (mesh axis)")

    # per-rank sequences: every stage the program runs ops under (a
    # stage with NO collectives on a shared ring is the imbalance case)
    # must issue identical (type) sequences per ring
    if not staged or len(all_stages) < 2:
        return
    stages = sorted(all_stages | set(staged))
    per_ring: Dict[str, Dict[int, List[str]]] = {}
    for s in stages:
        for _idx, typ, ring in staged.get(s, ()):
            per_ring.setdefault(ring, {}).setdefault(s, []).append(typ)
    # unstaged collectives run on all ranks uniformly — no check needed
    for ring, by_stage in sorted(per_ring.items()):
        if ring == _STAGE_AXIS:
            continue  # hop/reuse handled above
        seqs = {s: tuple(by_stage.get(s, ())) for s in stages}
        baseline_stage = min(s for s in stages if seqs[s])
        base = seqs[baseline_stage]
        for s in stages:
            if seqs[s] == base:
                continue
            if len(seqs[s]) != len(base):
                yield ctx.diag(
                    "error",
                    f"pipeline-stage collective imbalance on ring "
                    f"{ring!r}: stage {baseline_stage} issues "
                    f"{len(base)} collective(s) {list(base)} but stage "
                    f"{s} issues {len(seqs[s])} {list(seqs[s])} — ranks "
                    "wait at a collective their peers never reach",
                    program.blocks[0],
                    hint="every stage must issue the same collectives "
                         "on a shared ring (SPMD discipline)")
            else:
                yield ctx.diag(
                    "error",
                    f"cross-rank collective ordering mismatch on ring "
                    f"{ring!r}: stage {baseline_stage} issues "
                    f"{list(base)} but stage {s} issues "
                    f"{list(seqs[s])} — each rank blocks inside a "
                    "different collective and none completes",
                    program.blocks[0],
                    hint="issue collectives in one canonical order on "
                         "every rank")


@register_pass("sharding-consistency", order=72)
def check_sharding_consistency(ctx):
    """Multichip sharding annotations (layers.shard /
    data(sharding=...) / op dist_attr) validated at build time by
    re-running the spmd propagation (parallel/spmd.py) and re-emitting
    its findings: contradictory specs for one var and mesh-axis arity
    mismatches (spec longer than the tensor's rank, an axis naming two
    dims, an axis missing from the declared Program.mesh_axes) are
    errors; resharding hotspots (operands that force an all-gather or
    a reshard mid-graph) and non-divisible dims are
    warnings.  Programs with no sharding annotations skip the pass
    entirely (docs/performance.md 'Multichip sharding')."""
    program = ctx.program
    block = program.global_block()
    from ..parallel.spmd import has_annotations, propagate_sharding

    if not has_annotations(block):
        return

    plan = propagate_sharding(program)
    for f in plan.findings:
        op = (block.ops[f.op_idx]
              if f.op_idx is not None and f.op_idx < len(block.ops)
              else None)
        yield ctx.diag(f.severity, f.message, block, f.op_idx, op,
                       hint=f.hint)


@register_pass("donation-safety", order=75)
def check_donation_safety(ctx):
    """Vars hinted `donate=True` (layers.data(donate=True)) hand their
    device buffer to the step for reuse — which is only legal
    when the buffer is provably dead once the step returns.  A donated
    fetch target (the caller reads that buffer after the call) or a
    read-only persistable (the next step reads it again) is flagged as
    an error HERE, at build time; the executors enforce the same plan
    via memory_optimization_transpiler.plan_donation and raise
    DonationError before the first op runs (docs/performance.md
    'Memory')."""
    consumed: Set[str] = set()
    for _, _, op in ctx.iter_ops():
        consumed.update(op.input_names())
    for block in ctx.program.blocks:
        for name, v in block.vars.items():
            if not getattr(v, "donate", False):
                continue
            if isinstance(v, Parameter) or v.persistable:
                yield ctx.diag(
                    "error",
                    f"var {name!r} is hinted donate=True but is "
                    "persistable state — donating it would hand the "
                    "next step a deleted buffer",
                    block,
                    hint="drop the donate hint; read-write state is "
                         "already donated by the executor's plan",
                )
                continue
            if ctx.fetch_names and name in ctx.fetch_names:
                yield ctx.diag(
                    "error",
                    f"var {name!r} is hinted donate=True but is a fetch "
                    "target — the caller reads this buffer after the "
                    "step returns",
                    block,
                    hint="remove it from fetch_list, or drop the "
                         "donate hint",
                )
                continue
            if name not in consumed:
                yield ctx.diag(
                    "warning",
                    f"var {name!r} is hinted donate=True but no op "
                    "consumes it — the donation cannot be fulfilled",
                    block,
                    hint="feed the var to an op or drop the hint",
                )


@register_pass("inplace-alias", order=80)
def check_inplace_alias(ctx):
    """An op that binds the SAME var name as input and output mutates the
    value in place.  That is only safe when the registry declares the
    alias (optimizer Param->ParamOut etc.).  Undeclared aliasing with a
    later reader silently hands that reader the mutated value."""
    for block, idx, op in ctx.iter_ops():
        info = ctx.op_info(op)
        if info is None:
            continue
        in_names = set(op.input_names()) - set(EMPTY_VAR_NAMES)
        out_names = set(op.output_names()) - set(EMPTY_VAR_NAMES)
        shared = in_names & out_names
        if not shared:
            continue
        declared = set()
        for out_slot, in_slot in info.inplace.items():
            declared.update(
                set(op.output(out_slot)) & set(op.input(in_slot)))
        for n in sorted(shared - declared):
            has_later_reader = any(
                n in later.input_names()
                for later in block.ops[idx + 1:]
            )
            yield ctx.diag(
                "warning" if has_later_reader else "info",
                f"op {op.type!r} reads AND writes {n!r} without a "
                "declared in-place alias"
                + (" — a later op reads the mutated value"
                   if has_later_reader else ""),
                block, idx, op,
                hint="declare inplace={...} on the register_op call, "
                     "or write to a fresh output name",
            )
