"""PipelineExecutor: a `fluid.Program` trained under dp x pp x tp x sp
pipeline parallelism.

Counterpart of paddle_tpu/parallel/pipeline_program.py.  The user tags
the Program's repeated trunk with `fluid.pipeline_stage(i)`; the
executor partitions its ops:

  * "pre" (the forward ops before the first staged op, the embedding)
    and "post" (the ops after the last, the classifier and the loss) run
    on this data-parallel rank's whole rows, as the serial interpreter
    runs them: pre on stage 0, post on the last stage;
  * the staged trunk is validated structurally homogeneous, with one
    activation crossing each stage boundary, and stage s's ops run on
    the ranks of stage s only, one microbatch at a time, through the
    GPipe or 1F1B schedule of parallel/pipeline.py;
  * the backward is the Program's own gradient ops, partitioned the
    same way (a gradient op belongs to the section of its forward op; a
    `sum` of partial gradients to the section that made them), run per
    microbatch on each stage from the cotangent the next stage sends;
  * the Program's own optimizer ops update each parameter on the ranks
    that hold it, their attrs validated identical across stages.

Where the JAX package runs one lockstep SPMD program over [pp]-stacked
parameters, here a process is one mesh position: a stage rank holds its
own stage's parameters under their Program names (pre's on stage 0,
post's on the last stage, every other persistable on every rank), and
waits where the JAX package computes a bubble.  `state(name)` answers for
every state on every rank (its holder broadcasts it over pp).

Tensor parallelism (`tp_axis`): every staged weight is Megatron-split by
the alternation rule (`_derive_tp_specs`), and the stage's ops run on
local blocks by parallel/tensor_parallel.py's rules (column- and
row-parallel products, local heads), as ParallelExecutor's sharded form
runs them.  Sequence parallelism (`sp_axis`): the trunk activations are
split on the sequence dim (dim 1); every stage op runs on its local
block, and the flash_attention op rings K/V over the sp axis
(parallel/ring_attention.py) when its context's root carries
`sp_axis`.  Pre and post run on the whole sequence (stage 0 cuts its
block, the last stage all-gathers the blocks), and the staged
parameters' gradients, partial over the sequence blocks, are summed
over sp with their dp mean.

Dropout: masks are keyed by global batch row (ops/activation.py), the
ops run under their own serial identities, and each microbatch's
context carries its rows' global offset, so a pipelined run draws the
serial run's masks bit for bit.  Under sp the draw also folds the rank's
sequence block (the distribution of the serial draw, as in the JAX
package).

Constraints (explicit errors, the JAX package's): the stages build the
same layer stack with one activation in and one out; the stage count
equals the 'pp' axis; the trunk is stateless (no persistable writes) and
its only random op is dropout; grad-transform ops on staged parameters
are refused; schedule "1f1b" refuses a stateful post section and a
float pre value read by post, and under sp a post input without the
trunk's sequence dim.  The port adds one: no value of the pre section
but the trunk input may be read by the post section (it would have to
cross every stage).
"""
from __future__ import annotations

import copy
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.execution import (DictEnv, ExecContext, _mix, gather_inputs,
                              op_context, resolve_op, run_op,
                              scatter_outputs)
from ..core.executor import (CUDAPlace, Executor, _to_device_value,
                             _to_numpy, resolve_place)
from ..core.framework import (EMPTY_VAR_NAMES, GRAD_SUFFIX, Parameter,
                              Variable, default_startup_program,
                              grad_var_name)
from ..core.scope import Scope
from ..observability import metrics as obs_metrics
from ..observability import tracing as obs_tracing
from .checkpoint import ShardedCheckpointMixin
from .mesh import PartitionSpec as P
from .mesh import count_collectives, make_mesh
from .pipeline import pipeline_schedule
from .tensor_parallel import TensorParallel, grad_base

__all__ = ["PipelineExecutor"]

_PRE, _POST = "pre", "post"


def _attr_sig(attrs: Dict) -> tuple:
    """Hashable attr signature (pipeline_stage excluded) for comparing
    ops across stages."""
    def enc(v):
        if isinstance(v, np.ndarray):
            return ("nd", v.shape, str(v.dtype), v.tobytes())
        if isinstance(v, (list, tuple)):
            return tuple(enc(x) for x in v)
        if isinstance(v, dict):
            return tuple(sorted((k, enc(x)) for k, x in v.items()))
        return v
    return tuple(sorted((k, enc(v)) for k, v in attrs.items()
                        if k != "pipeline_stage"))


_CODES = (torch.float32, torch.bfloat16, torch.float16, torch.float64,
          torch.int64, torch.int32, torch.bool)


def _broadcast(group, t, root, device):
    """`t` (held by axis index `root` of `group`) on every rank of it, on
    `device`: a header (ndim, dtype, shape) then the payload; only the
    payload is recorded."""
    if group is None or group.size == 1:
        return t
    head = torch.zeros(10, dtype=torch.int64,
                       device="cpu" if group.gloo else device)
    if group.index == root:
        head[0], head[1] = t.dim(), _CODES.index(t.dtype)
        head[2:2 + t.dim()] = torch.tensor(t.shape)
    rec, group.record = group.record, None
    head = group.broadcast(head, root)
    group.record = rec
    shape = tuple(int(d) for d in head[2:2 + int(head[0])])
    buf = t if group.index == root else torch.empty(
        shape, dtype=_CODES[int(head[1])], device=device)
    return group.broadcast(buf.contiguous(), root)


class PipelineExecutor(ShardedCheckpointMixin):
    """Pipeline-parallel executor of a staged training Program over
    `mesh` ({"dp": d, "pp": p, ...} or a `Mesh`); the feed is the
    GLOBAL batch on every rank.  `place` is this rank's device:
    CUDAPlace(0) unless told otherwise (raising without a card);
    `CPUPlace()` runs on the CPU, with gloo between ranks."""

    def __init__(
        self,
        program,
        feed_names: Sequence[str],
        fetch_list: Sequence,
        mesh,
        startup_program=None,
        n_micro: int = 4,
        batch_axis: str = "dp",
        stage_axis: str = "pp",
        tp_axis: Optional[str] = None,
        sp_axis: Optional[str] = None,
        param_shardings: Optional[Dict] = None,
        shard_optimizer_states: bool = False,
        schedule: str = "gpipe",
        seed: int = 0,
        place=None,
    ):
        if schedule not in ("gpipe", "1f1b"):
            raise ValueError(
                f"schedule must be 'gpipe' or '1f1b', got {schedule!r}")
        self.schedule = schedule
        axes = ({str(k): int(v) for k, v in mesh.items()}
                if isinstance(mesh, dict) else dict(mesh.shape))
        self.batch_axis = batch_axis
        self.stage_axis = stage_axis
        for ax, what in ((tp_axis, "tp_axis"), (sp_axis, "sp_axis")):
            if ax is not None and ax not in axes:
                raise ValueError(f"{what}={ax!r} is not a mesh axis "
                                 f"(mesh has {tuple(axes)})")
        if stage_axis not in axes:
            raise ValueError(f"stage_axis={stage_axis!r} is not a mesh "
                             f"axis (mesh has {tuple(axes)})")
        self._axes = axes
        self.tp_axis = tp_axis if (tp_axis and axes[tp_axis] > 1) else None
        self.sp_axis = sp_axis if (sp_axis and axes[sp_axis] > 1) else None
        self.dp = int(axes.get(batch_axis, 1))
        self._param_shardings = dict(param_shardings or {})
        self.n_micro = int(n_micro)
        self.program = program
        self.feed_names = list(feed_names)
        self.fetch_names = [
            v.name if isinstance(v, Variable) else str(v)
            for v in fetch_list
        ]
        self._seed = seed
        self._step = 0
        self.place = CUDAPlace(0) if place is None else place
        self.device = resolve_place(self.place)

        # PADDLE_TPU_VERIFY pre-flight, gated inside preflight (the
        # distributed lint checks the pipeline_stage annotations this
        # executor is about to trust)
        from ..analysis import preflight

        preflight(program, feed_names=self.feed_names,
                  fetch_names=self.fetch_names)
        block = program.global_block()
        self._persistable = {v.name for v in program.list_vars()
                             if v.persistable}
        self._partition(block)
        self.tp_param_specs = (self._derive_tp_specs(block)
                               if self.tp_axis else {})
        if self.sp_axis:
            shp = tuple(block.var(self._trunk_in).shape or ())
            if (len(shp) >= 2 and shp[1] > 0
                    and shp[1] % axes[self.sp_axis]):
                raise ValueError(
                    f"trunk activation {self._trunk_in!r} sequence dim "
                    f"{shp[1]} does not divide the '{self.sp_axis}' axis "
                    f"({axes[self.sp_axis]})")
            if any(op.type == "softmax" for op in self._stage_ops[0]):
                raise NotImplementedError(
                    "the staged trunk contains a softmax op — composed "
                    "(score-materializing) attention computes over the "
                    "LOCAL sequence block under sequence parallelism "
                    "and would silently truncate the context; use the "
                    "flash_attention path (no attention-weight dropout) "
                    "in an sp trunk")
        self._plan_update(block)
        if self.schedule == "1f1b":
            self._validate_1f1b(block)
        self._plan_backward(block)
        self._plan_fetches(block)

        self.mesh = make_mesh(axes) if isinstance(mesh, dict) else mesh
        self._init_runtime(block)
        startup = startup_program or default_startup_program()
        scope = Scope()
        Executor(self.place).run(startup, scope=scope)
        self._init_states(block, scope, shard_optimizer_states)

    # ------------------------------------------------------------------
    # program partitioning
    # ------------------------------------------------------------------
    def _partition(self, block):
        pp = self._axes[self.stage_axis]
        ops = block.ops
        bwd_start = None
        for i, op in enumerate(ops):
            outs = op.output_names()
            if (op.type == "fill_constant" and len(outs) == 1
                    and outs[0].endswith(GRAD_SUFFIX)):
                bwd_start = i
                break
        if bwd_start is None:
            raise ValueError(
                "PipelineExecutor needs a training program: call "
                "optimizer.minimize(loss) before constructing it")
        self._bwd_start = bwd_start
        self._loss_name = ops[bwd_start].output_names()[0][
            : -len(GRAD_SUFFIX)]

        pre, post = [], []
        stages: Dict[int, list] = {}
        self._trunk_has_random = False
        mode = "pre"
        for op in ops[:bwd_start]:
            s = op.attrs.get("pipeline_stage")
            if s is None:
                if mode == "pre":
                    pre.append(op)
                else:
                    mode = "post"
                    post.append(op)
            else:
                if mode == "post":
                    raise ValueError(
                        f"op {op.type} tagged pipeline_stage={s} appears "
                        "after unstaged post-trunk ops — the staged trunk "
                        "must be contiguous")
                mode = "stage"
                stages.setdefault(int(s), []).append(op)
        if not stages:
            raise ValueError(
                "no ops tagged with fluid.pipeline_stage(i) — annotate "
                "the repeated trunk blocks to pipeline this program")
        idxs = sorted(stages)
        if idxs != list(range(len(idxs))):
            raise ValueError(f"stage indices must be 0..S-1, got {idxs}")
        if len(idxs) != pp:
            raise ValueError(
                f"{len(idxs)} pipeline stages but mesh axis "
                f"'{self.stage_axis}' has {pp} devices — they must match "
                "(fold several layers into one stage to reduce the count)")
        self._pre_ops, self._post_ops = pre, post
        self._stage_ops = [stages[i] for i in idxs]
        self._validate_stages(block)

        # persistable writes by pre/post (BN stats, counters) are carried
        # as state of the section's stage; staged ops must be stateless
        self._aux_writes = sorted({
            n for op in pre + post for n in op.output_names()
            if n in self._persistable})
        from ..core import registry as op_registry
        for s, sops in enumerate(self._stage_ops):
            bad = [n for op in sops for n in op.output_names()
                   if n in self._persistable]
            if bad:
                raise NotImplementedError(
                    f"stage {s} writes persistable var(s) {bad}: staged "
                    "trunk ops must be stateless (keep BN/counters in the "
                    "pre/post sections)")
            for op in sops:
                try:
                    info = op_registry.get_op_info(op.type)
                except KeyError:
                    continue
                if info.random and not op.attrs.get("is_test", False):
                    if op.type == "dropout":
                        # batch-position-keyed masks under the op's own
                        # serial identity: the serial draw
                        self._trunk_has_random = True
                        continue
                    raise NotImplementedError(
                        f"stage {s} contains stochastic op {op.type!r}: "
                        "only dropout has the batch-position-keyed "
                        "derivation that keeps one traced stage body "
                        "consistent with serial execution — run other "
                        "stochastic ops in the pre/post sections (or "
                        "set is_test)")
        # the section each forward value and parameter belongs to
        self._where: Dict[str, object] = {}
        for sec, sops in ([(_PRE, pre)]
                          + list(enumerate(self._stage_ops))
                          + [(_POST, post)]):
            for op in sops:
                for n in op.output_names():
                    self._where.setdefault(n, sec)
        pre_reads = {n for op in pre for n in op.input_names()}
        post_reads = {n for op in post for n in op.input_names()}
        self._outer_params = {}
        for p in block.all_parameters():
            if p.name in self._stage_param_set:
                continue
            if p.name in pre_reads and p.name in post_reads:
                raise NotImplementedError(
                    f"parameter {p.name!r} is read by both the pre and the "
                    "post section (a tied embedding): each section runs "
                    "on its own stage here, and a parameter lives on one")
            sec = _PRE if p.name in pre_reads else _POST
            self._outer_params[p.name] = sec
            self._where[p.name] = sec
        for s, names in enumerate(self._stage_params):
            for n in names:
                self._where[n] = s
        side = sorted(n for n in post_reads
                      if self._where.get(n) == _PRE
                      and n not in self._persistable and n)
        if side:
            raise NotImplementedError(
                f"pre-section value(s) {side} are read by the post section: "
                "only the trunk activation crosses the stages (compute "
                "them in the post section)")

    def _stage_io(self, ops, block):
        """(ordered external activation reads, ordered Parameter reads,
        set of names written) for one stage's op list."""
        written, ext, params = set(), [], []
        for op in ops:
            for n in op.input_names():
                if not n or n in written or n in ext or n in params:
                    continue
                if n in self._persistable:
                    v = block.var(n)
                    if not isinstance(v, Parameter):
                        raise NotImplementedError(
                            f"stage op {op.type} reads persistable "
                            f"non-parameter {n!r}: staged trunks may only "
                            "read activations and their own parameters")
                    params.append(n)
                else:
                    ext.append(n)
            written.update(op.output_names())
        return ext, params, written

    def _validate_stages(self, block):
        pp = len(self._stage_ops)
        sigs, ios = [], []
        for sops in self._stage_ops:
            sigs.append([
                (op.type, _attr_sig(op.attrs),
                 tuple(sorted((k, len(v)) for k, v in op.inputs.items())),
                 tuple(sorted((k, len(v)) for k, v in op.outputs.items())))
                for op in sops])
            ios.append(self._stage_io(sops, block))
        for s in range(1, pp):
            if sigs[s] != sigs[0]:
                raise ValueError(
                    f"pipeline stage {s} is not structurally identical to "
                    "stage 0 (op sequence/attrs differ) — every stage must "
                    "build the same layer stack")
        self._stage_params: List[List[str]] = [io[1] for io in ios]
        for s in range(1, pp):
            if len(self._stage_params[s]) != len(self._stage_params[0]):
                raise ValueError("per-stage parameter counts differ")
            for a, b in zip(self._stage_params[0], self._stage_params[s]):
                va, vb = block.var(a), block.var(b)
                if tuple(va.shape or ()) != tuple(vb.shape or ()):
                    raise ValueError(
                        f"stage param shape mismatch: {a} {va.shape} vs "
                        f"{b} {vb.shape}")
        self._stage_param_set = {n for names in self._stage_params
                                 for n in names}

        # activation plumbing: one in, one out, chained stage to stage
        consumed_later: Dict[int, set] = {}
        later = {n for op in self._post_ops for n in op.input_names()}
        later |= set(self.fetch_names)
        for s in reversed(range(pp)):
            consumed_later[s] = set(later)
            later |= {n for op in self._stage_ops[s]
                      for n in op.input_names()}
        self._trunk_in = None
        self._stage_in: List[str] = []
        self._stage_out: List[str] = []
        prev_out = None
        for s in range(pp):
            ext, _, written = ios[s]
            if len(ext) != 1:
                raise ValueError(
                    f"stage {s} reads {len(ext)} external activations "
                    f"({ext}): exactly one [batch, ...] activation may "
                    "cross a stage boundary")
            outs = sorted(written & consumed_later[s])
            if len(outs) != 1:
                raise ValueError(
                    f"stage {s} emits {len(outs)} activations consumed "
                    f"downstream ({outs}): exactly one may cross the "
                    "boundary")
            if s == 0:
                self._trunk_in = ext[0]
            elif ext[0] != prev_out:
                raise ValueError(
                    f"stage {s} input {ext[0]!r} is not stage {s-1}'s "
                    f"output {prev_out!r}")
            self._stage_in.append(ext[0])
            prev_out = outs[0]
            self._stage_out.append(prev_out)
        self._trunk_out = self._stage_out[-1]

    def _validate_1f1b(self, block):
        """Under 1F1B the post section runs per microbatch on the last
        stage, right after the microbatch's forward, so its backward can
        start while later microbatches are in flight: the post section
        may not write persistables (they would be applied n_micro
        times), and no float pre value may reach it around the pipeline.
        The loss is taken to be a batch MEAN: each microbatch's gradient
        is seeded with 1/n_micro, which gives the serial gradient."""
        post_reads = {n for op in self._post_ops for n in
                      op.input_names()}
        post_writes = {n for op in self._post_ops for n in
                       op.output_names()}
        post_aux = sorted(post_writes & set(self._persistable))
        if post_aux:
            raise NotImplementedError(
                f"schedule='1f1b': post section writes persistable "
                f"var(s) {post_aux} — per-microbatch post execution "
                "would apply them n_micro times (keep BN/counters in "
                "pre, or use schedule='gpipe')")
        pre_written = {n for op in self._pre_ops for n in
                       op.output_names()}
        side = sorted(
            n for n in post_reads
            if n in pre_written and n not in self._persistable
            and n != self._trunk_out and n)
        bad = [n for n in side
               if str(block.var(n).dtype).startswith(("float",
                                                      "bfloat"))]
        if bad:
            raise NotImplementedError(
                f"schedule='1f1b': float pre-section output(s) {bad} "
                "are consumed by the post section — their gradient "
                "would bypass the pipeline (not supported; use "
                "schedule='gpipe' or restructure)")
        if self.sp_axis:
            # the JAX package shards the post inputs with the trunk
            # output's sequence blocks; the same inputs are required
            out_shape = tuple(block.var(self._trunk_out).shape or ())
            seq = out_shape[1] if len(out_shape) > 1 else None
            y_like = ([n for n in self.feed_names if n in post_reads]
                      + side)
            bad = []
            for n in y_like:
                shp = tuple(block.var(n).shape or ())
                if len(shp) < 2 or shp[1] != seq:
                    bad.append((n, shp))
            if bad:
                raise NotImplementedError(
                    f"schedule='1f1b' with sp_axis: post-section "
                    f"input(s) {bad} lack the trunk output's sequence "
                    f"dim {seq} at position 1, so they cannot shard "
                    "with the sequence-parallel trunk output — use "
                    "schedule='gpipe' (post on the gathered full batch)")

    # ------------------------------------------------------------------
    # tensor-parallel spec derivation (Megatron alternation)
    # ------------------------------------------------------------------
    def _derive_tp_specs(self, block) -> Dict[str, P]:
        """Walk stage 0's ops and give each staged parameter a
        tensor-parallel PartitionSpec by the Megatron alternation rule:
        a matmul on a feature-whole activation splits its weight by
        columns (the activation becomes feature-split), a matmul on a
        feature-split activation splits it by rows (the contraction over
        tp, all-reduced; the activation returns whole).  Biases follow
        their activation; layer_norm parameters stay whole.  On the DSL
        transformer block: q, k, v and FFN-1 column, out and FFN-2 row;
        on a plain fc trunk, column and row alternate.  Stage s's
        parameters take stage 0's specs by position."""
        tp = self.tp_axis
        specs: Dict[str, P] = {}
        tagged = set()  # activations whose feature dim is tp-split
        param0 = set(self._stage_params[0])
        for op in self._stage_ops[0]:
            outs = op.output_names()
            if op.type == "mul":
                x = op.inputs["X"][0]
                y = op.inputs["Y"][0]
                if y in param0:
                    if y in specs:
                        raise NotImplementedError(
                            f"staged param {y!r} is read by two matmuls "
                            "— tp auto-split needs a single role per "
                            "weight (pass tp_axis=None or restructure)")
                    if x in tagged:
                        specs[y] = P(tp, None)      # row-parallel
                    else:
                        specs[y] = P(None, tp)      # column-parallel
                        tagged.update(outs)
                    continue
            elif op.type == "elementwise_add":
                x = op.inputs.get("X", [None])[0]
                y = op.inputs.get("Y", [None])[0]
                if y in param0:                     # bias
                    new = P(tp) if x in tagged else P()
                    if y in specs and specs[y] != new:
                        raise NotImplementedError(
                            f"staged bias {y!r} is consumed by adds with "
                            "different feature shardings — tp auto-split "
                            "needs a single role per param (pass "
                            "tp_axis=None or restructure)")
                    specs[y] = new
                    if x in tagged:
                        tagged.update(outs)
                    continue
            elif op.type == "layer_norm":
                continue
            # feature splits propagate through elementwise, reshape,
            # transpose and attention ops
            if any(n in tagged for n in op.input_names()):
                tagged.update(outs)
        return specs

    # ------------------------------------------------------------------
    # update planning (the Program's own optimizer ops)
    # ------------------------------------------------------------------
    def _plan_update(self, block):
        """The update section: the ops from the first consumer of a raw
        trainable-parameter gradient on.  Each optimizer op runs on the
        stage holding its parameter, every other op (a learning-rate
        schedule) on every rank; a staged parameter's op must equal
        stage 0's twin."""
        ops = block.ops
        self._trainable = [p.name for p in block.all_parameters()
                           if p.trainable]
        self._grad_of = {n: self._total_grad(n) for n in self._trainable}
        grad_names = set(self._grad_of.values())
        split = next((i for i in range(self._bwd_start, len(ops))
                      if set(ops[i].input_names()) & grad_names), None)
        if split is None:
            raise ValueError("the program has no optimizer ops for its "
                             "parameters' gradients")
        late = sorted({n for op in ops[split:] for n in op.output_names()
                       if n in grad_names})
        if late:
            raise NotImplementedError(
                f"gradient(s) {late} are produced after their first "
                "consumer")
        self._split = split
        stage0 = set(self._stage_params[0])
        k_of, s_of = {}, {}
        for s, names in enumerate(self._stage_params):
            for k, n in enumerate(names):
                k_of[n], s_of[n] = k, s
        self._update: List[tuple] = []      # (op, owner stage or None)
        self._acc_owner: Dict[str, str] = {}
        sig0, twins = {}, []
        produced = set()
        for op in ops[split:]:
            is_opt = "Param" in op.inputs and "ParamOut" in op.outputs
            if is_opt:
                pname = op.inputs["Param"][0]
                owner = self._owner_of_param(pname)
                if pname in s_of:
                    sig = (op.type, _attr_sig(op.attrs))
                    if pname in stage0:
                        sig0[k_of[pname]] = sig
                    else:
                        twins.append((pname, sig))
                for slot, names in op.inputs.items():
                    if slot in ("Param", "Grad", "LearningRate"):
                        continue
                    for n in names:
                        if n in self._persistable:
                            if self._acc_owner.get(n, pname) != pname:
                                raise NotImplementedError(
                                    "optimizer accumulators shared across "
                                    "staged params are not supported")
                            self._acc_owner[n] = pname
                self._update.append((op, owner))
                produced.update(op.output_names())
                continue
            reads = [n for n in op.input_names()
                     if n and n not in EMPTY_VAR_NAMES]
            staged = [n for n in reads if grad_base(n) in
                      self._stage_param_set]
            fwd = [n for n in reads if n not in self._persistable
                   and grad_base(n) is None and n not in produced]
            if staged or fwd:
                raise NotImplementedError(
                    f"update-section op {op.type} ({op.output_names()}) "
                    "depends on forward activations or unstacked stage "
                    "state — not supported under PipelineExecutor "
                    "(grad-transform ops on staged params, per-param "
                    "hooks)")
            owners = {self._owner_of_param(grad_base(n)) for n in reads
                      if grad_base(n) in self._outer_params}
            self._update.append((op, owners.pop() if len(owners) == 1
                                 else None))
            produced.update(op.output_names())
        for pname, sig in twins:
            if sig0.get(k_of[pname]) != sig:
                raise ValueError(
                    f"optimizer op for staged param {pname} differs from "
                    "stage 0's (type/attrs) — the stages' updates would "
                    "differ")
        have = {op.inputs["Param"][0] for op, _ in self._update
                if "Param" in op.inputs}
        missing = [n for n in self._stage_params[0] if n not in have]
        if missing:
            raise ValueError(
                f"staged params {missing} have no optimizer op")

    def _total_grad(self, var):
        """The name of `var`'s whole gradient: `var@GRAD`, or the output
        of the `sum` op(s) that add its partial gradients."""
        name = grad_var_name(var)
        for op in self.program.global_block().ops[self._bwd_start:]:
            if op.type == "sum" and name in op.input_names():
                out = op.output_names()[0]
                if grad_base(out) == var:
                    name = out
        return name

    def _owner_of_param(self, name):
        """The stage holding parameter `name`."""
        w = self._where.get(name)
        if w == _PRE:
            return 0
        if w == _POST:
            return len(self._stage_ops) - 1
        return w

    # ------------------------------------------------------------------
    # the backward ops' sections
    # ------------------------------------------------------------------
    def _plan_backward(self, block):
        """Give every op of the backward section (from the loss@GRAD seed
        to the update section) its section: a gradient op its forward
        op's (the section of the value whose cotangent it reads), a
        `fill_zeros_like` its value's, any other op (a `sum` of partial
        gradients) the latest, in backward order, of the sections that
        made its inputs."""
        n_st = len(self._stage_ops)

        def order(sec):
            if sec == _POST:
                return 0
            if sec == _PRE:
                return n_st + 1
            return n_st - sec

        made: Dict[str, object] = {}
        sections: Dict[object, list] = {_POST: [], _PRE: []}
        for s in range(n_st):
            sections[s] = []
        ops = block.ops
        for i in range(self._bwd_start, self._split):
            op = ops[i]
            if i == self._bwd_start:
                sec = _POST
            elif "pipeline_stage" in op.attrs:
                sec = int(op.attrs["pipeline_stage"])
            else:
                cots = [n for slot, ns in op.inputs.items()
                        if slot.endswith(GRAD_SUFFIX) for n in ns if n]
                cands = []
                if op.type.endswith("_grad") and cots:
                    cands = [self._where[grad_base(n)] for n in cots
                             if grad_base(n) in self._where]
                elif op.type == "fill_zeros_like":
                    cands = [self._where[n] for n in op.input_names()
                             if n in self._where]
                if not cands:
                    cands = [made[n] for n in op.input_names() if n in made]
                    cands += [self._where[n] for n in op.input_names()
                              if n in self._where]
                if not cands:
                    raise NotImplementedError(
                        f"backward op {op.type} ({op.output_names()}) "
                        "belongs to no section")
                sec = max(cands, key=order)
            sections[sec].append(op)
            for n in op.output_names():
                made[n] = sec
        self._bwd_ops = sections
        self._seed_op = ops[self._bwd_start]

    def _plan_fetches(self, block):
        """Each fetch's section (pre or post) and how it combines over
        dp: rows ("batch") or a mean ("mean")."""
        self._fetch = {}
        for n in self.fetch_names:
            sec = self._where.get(n)
            if sec not in (_PRE, _POST):
                raise ValueError(
                    f"fetch {n!r} is not made by the pre or the post "
                    "section: a pipelined step fetches values of those")
            v = block.vars.get(n)
            if v is not None and v.shape and v.shape[0] == -1:
                kind = "batch"
            elif v is not None and v.op is not None and v.op.type in (
                    "mean", "accuracy"):
                kind = "mean"
            elif self.dp == 1:
                kind = "whole"
            else:
                raise ValueError(
                    f"fetch {n!r} is not a per-row output or a batch mean "
                    "— its per-rank values cannot be combined over dp")
            self._fetch[n] = (sec, kind)

    # ------------------------------------------------------------------
    # this rank's runtime and states
    # ------------------------------------------------------------------
    def _init_runtime(self, block):
        mesh = self.mesh
        coord = {a: (mesh.axis_index(a) if mesh.group is not None else 0)
                 for a in mesh.axis_names}
        self._coord = coord
        self.stage = coord[self.stage_axis]
        self.n_stages = len(self._stage_ops)
        self.collective_calls = {}
        self.collective_record = []
        self._record = []
        self._groups = {}
        if mesh.group is not None:
            for a in mesh.axis_names:
                g = mesh.axis_group(a)
                g.record = self._record
                self._groups[a] = g
        self._pp = self._groups.get(self.stage_axis)
        self._dpg = self._groups.get(self.batch_axis)
        self._spg = self._groups.get(self.sp_axis) if self.sp_axis else None
        s = self.stage
        fwd = list(self._stage_ops[s])
        bwd = list(self._bwd_ops[s])
        if self.sp_axis:
            fwd, bwd = self._sp_local(fwd), self._sp_local(bwd)
        self._my_fwd, self._my_bwd = fwd, bwd
        self._my_update = [op for op, owner in self._update
                           if owner is None or owner == s]
        self._tp = None
        if self.tp_axis:
            lays = {}
            for k, p0 in enumerate(self._stage_params[0]):
                spec = self.tp_param_specs.get(p0)
                d = next((i for i, e in enumerate(spec or ())
                          if e == self.tp_axis), None)
                if d is None:
                    continue
                shape = block.var(p0).shape
                if shape[d] % self._axes[self.tp_axis]:
                    continue            # not divisible: stays whole
                n = self._stage_params[s][k]
                lays[n] = (d, self.tp_axis)
            self._tp_layouts = lays
            self._tp = TensorParallel({self.tp_axis:
                                       self._groups[self.tp_axis]}, lays,
                                      self._count)
        else:
            self._tp_layouts = {}

    def _sp_local(self, ops):
        """The ops with a `reshape`'s global sequence length made local
        (dim 1 of its `shape` attr)."""
        n = self._axes[self.sp_axis]
        seq = tuple(self.program.global_block().var(self._trunk_in).shape
                    or ())
        seq = seq[1] if len(seq) > 1 else -1
        out = []
        for op in ops:
            shape = list(op.attrs.get("shape") or ())
            if (op.type in ("reshape", "reshape_grad") and len(shape) > 1
                    and seq > 0 and shape[1] == seq):
                op = copy.copy(op)
                shape[1] = seq // n
                op.attrs = dict(op.attrs, shape=shape)
            out.append(op)
        return out

    def _count(self, kind):
        self.collective_calls[kind] = self.collective_calls.get(kind, 0) + 1

    def _owner(self, name):
        """The stage holding state `name`, None for every stage."""
        if name in self._acc_owner:
            return self._owner_of_param(self._acc_owner[name])
        if name in self._where and (name in self._stage_param_set
                                    or name in self._outer_params):
            return self._owner_of_param(name)
        if name in self._aux_writes:
            return 0 if self._where.get(name) == _PRE else \
                self.n_stages - 1
        return None

    def _init_states(self, block, scope, shard_opt):
        unknown = sorted(k for k in self._param_shardings
                         if k not in self._persistable)
        if unknown:
            raise ValueError(
                f"param_shardings names {unknown} are not persistable "
                "vars of this program (typo?)")
        staged = self._stage_param_set | {
            a for a, p in self._acc_owner.items()
            if p in self._stage_param_set}
        staged_keys = sorted(k for k in self._param_shardings
                             if k in staged)
        if staged_keys:
            raise ValueError(
                f"param_shardings entries {staged_keys} name STAGED "
                "params — staged weights are sharded by the tp_axis "
                "derivation (tp_param_specs), not per-name specs")
        for n, spec in self._param_shardings.items():
            if any(e not in (None, self.batch_axis) for e in tuple(spec)):
                raise NotImplementedError(
                    f"{n!r} is placed {spec}: the pipeline executor keeps "
                    "the pre and post parameters whole on their stage")
        self._meta: Dict[str, tuple] = {}
        self._states: Dict[str, torch.Tensor] = {}
        self._zero: Dict[str, int] = {}     # state -> its ZeRO-1 dim
        for n in sorted(self._persistable):
            v = scope.find_var(n) if scope.has_var(n) else None
            if isinstance(v, torch.Tensor):
                self._meta[n] = (tuple(v.shape), v.dtype)
        for n in self._meta:
            v = scope.find_var(n)
            if self._owner(n) not in (None, self.stage):
                continue
            lay = self._tp_layouts.get(self._acc_owner.get(n, n))
            if lay is not None and (v.dim() <= lay[0] or
                                    tuple(v.shape) != tuple(
                                        self._meta_param_shape(n))):
                lay = None
            if lay is not None:
                self._tp_layouts[n] = lay
                v = self._groups[self.tp_axis].block(v, lay[0]).clone()
            if shard_opt and self.dp > 1 and n in self._acc_owner:
                pshape = self._meta_param_shape(n)
                if tuple(self._meta[n][0]) == tuple(pshape):
                    for d in range(v.dim()):
                        if (lay is None or d != lay[0]) and \
                                v.shape[d] % self.dp == 0 and \
                                v.shape[d] >= self.dp:
                            self._zero[n] = d
                            v = self._dpg.block(v, d).clone()
                            break
            self._states[n] = v
        if self._tp is not None:
            self._tp.base.update(self._tp_layouts)
            self._tp.start_step()
        # ops that read a ZeRO-1 split accumulator
        self._zero_ops = {id(op) for op in self._my_update
                          if set(op.input_names()) & set(self._zero)}

    def _meta_param_shape(self, acc):
        p = self._acc_owner.get(acc, acc)
        return self._meta.get(p, ((),))[0]

    # ------------------------------------------------------------------
    # the step
    # ------------------------------------------------------------------
    def _ctx(self, seed, row_offset):
        ctx = ExecContext(self.device, seed=seed, row_offset=row_offset,
                          groups=self._groups)
        if self.sp_axis:
            ctx.sp_axis = self.sp_axis
        return ctx

    def _run_ops(self, ctx, ops, env, tp=False):
        for op in ops:
            if tp and self._tp is not None:
                self._tp.run(ctx, op, env)
            else:
                run_op(ctx, op, env)

    def _local_feeds(self, feed):
        out = {}
        i = self._coord.get(self.batch_axis, 0)
        for n, v in feed.items():
            rows = len(v)
            if rows % self.n_micro:
                raise ValueError(
                    f"batch {rows} not divisible by n_micro {self.n_micro}")
            if (rows // self.n_micro) % self.dp:
                raise ValueError(
                    f"microbatch {rows // self.n_micro} not divisible by "
                    f"the '{self.batch_axis}' axis ({self.dp})")
            bl = rows // self.dp
            out[n] = _to_device_value(v[i * bl:(i + 1) * bl], self.device)
        return out

    def _sp_block(self, t):
        return self._spg.block(t, 1).contiguous() if self._spg else t

    def _sp_whole(self, t):
        return self._spg.all_gather(t.contiguous(), 1) if self._spg else t

    def _step_impl(self, feed):
        s, last = self.stage, self.stage == self.n_stages - 1
        M = self.n_micro
        feeds = self._local_feeds(feed)
        bl = len(next(iter(feeds.values()))) if feeds else 0
        mb = bl // M if bl else 0
        row0 = self._coord.get(self.batch_axis, 0) * bl
        seed = _mix(self.program.seed or self._seed, self._step)
        self._step += 1
        states = self._states
        grads: Dict[str, torch.Tensor] = {}
        aux: Dict[str, torch.Tensor] = {}
        fetch_env = {}

        def add_grads(env, names):
            for p in names:
                g = self._grad_of.get(p)
                if p in self._states and g is not None and env.has(g):
                    v = env.get(g)
                    grads[p] = v if p not in grads else grads[p] + v

        # pre, on stage 0 over its rows (the whole sequence)
        x_mb = None
        if s == 0:
            env_pre = DictEnv({**states, **feeds})
            ctx_pre = self._ctx(seed, row0)
            self._run_ops(ctx_pre, self._pre_ops, env_pre)
            x = self._sp_block(env_pre.get(self._trunk_in))
            x_mb = list(x.split(mb)) if mb else [x]
            for n in self._aux_writes:
                if self._where.get(n) == _PRE and env_pre.has(n):
                    aux[n] = env_pre.get(n)
        stage_params = self._stage_params[s]
        s_in, s_out = self._stage_in[s], self._stage_out[s]
        saved = {}
        stage_seed = (_mix(seed, 1 + self._spg.index)
                      if self._spg is not None and self._trunk_has_random
                      else seed)

        def forward(m, h):
            env = DictEnv(dict(states))
            env.set(s_in, h)
            ctx = self._ctx(stage_seed, row0 + m * mb)
            self._run_ops(ctx, self._my_fwd, env, tp=True)
            saved[m] = (env, ctx)
            return env.get(s_out)

        seed_name, dx_name = (self._total_grad(s_out),
                              self._total_grad(s_in))

        def backward(m, g):
            env, ctx = saved.pop(m)
            env.set(seed_name, g)
            self._run_ops(ctx, self._my_bwd, env, tp=True)
            add_grads(env, stage_params)
            return env.get(dx_name) if env.has(dx_name) else None

        post_params = [p for p, sec in self._outer_params.items()
                       if sec == _POST]
        out_grad = self._total_grad(self._trunk_out)
        post_bwd = self._bwd_ops[_POST]

        def run_post(h, feeds_rows, row_offset, scale=None):
            env = DictEnv({**states, **feeds_rows})
            env.set(self._trunk_out, self._sp_whole(h))
            ctx = self._ctx(seed, row_offset)
            self._run_ops(ctx, self._post_ops, env)
            for op in post_bwd:
                run_op(ctx, op, env)
                if op is self._seed_op and scale is not None:
                    n = op.output_names()[0]
                    env.set(n, env.get(n) * scale)
            add_grads(env, post_params)
            return env

        def last_seeds(outs):
            env = run_post(torch.cat(outs), feeds, row0)
            fetch_env.update(env.d)
            for n in self._aux_writes:
                if self._where.get(n) == _POST and env.has(n):
                    aux[n] = env.get(n)
            d = self._sp_block(env.get(out_grad))
            return list(d.split(mb)) if mb else [d]

        def last_seed(m, out):
            rows = {n: v[m * mb:(m + 1) * mb] for n, v in feeds.items()}
            env = run_post(out, rows, row0 + m * mb, 1.0 / M)
            return self._sp_block(env.get(out_grad))

        outs, dxs = pipeline_schedule(
            self._pp if self.n_stages > 1 else None, M, self.schedule,
            forward=forward, backward=backward,
            first_input=lambda m: x_mb[m], last_seeds=last_seeds,
            last_seed=last_seed, device=self.device)
        if last and self.schedule == "1f1b":
            # the fetches: the post forward on every row at once (the
            # serial values; dropout keys make the draw the same)
            env = DictEnv({**states, **feeds})
            env.set(self._trunk_out, self._sp_whole(torch.cat(outs)))
            self._run_ops(self._ctx(seed, row0), self._post_ops, env)
            fetch_env.update(env.d)
        if s == 0:
            env_pre.set(self._total_grad(self._trunk_in),
                        self._sp_whole(torch.cat(dxs)))
            self._run_ops(ctx_pre, self._bwd_ops[_PRE], env_pre)
            add_grads(env_pre, [p for p, sec in self._outer_params.items()
                                if sec == _PRE])
            fetch_env.update({n: env_pre.get(n) for n in self.fetch_names
                              if self._fetch[n][0] == _PRE})
        self._reduce_grads(grads)
        new_states = self._apply_update(grads, aux, seed)
        fetches = self._gather_fetches(fetch_env)
        return fetches, new_states

    def _reduce_grads(self, grads):
        """This rank's gradients averaged over dp and, for the staged
        parameters, summed over the sequence blocks (one flat bucket a
        dtype an axis)."""
        def bucket(names, group, scale=None):
            by_dt = {}
            for n in names:
                by_dt.setdefault(grads[n].dtype, []).append(n)
            for dt, ns in by_dt.items():
                flat = torch.cat([grads[n].reshape(-1) for n in ns])
                self._count("grad_all_reduce")
                group.all_reduce_(flat)
                if scale is not None:
                    flat = flat * scale
                off = 0
                for n in ns:
                    k = grads[n].numel()
                    grads[n] = flat[off:off + k].view(grads[n].shape)
                    off += k

        names = sorted(grads)
        if self._spg is not None:
            bucket([n for n in names if n in self._stage_param_set],
                   self._spg)
        if self.dp > 1:
            bucket(names, self._dpg, 1.0 / self.dp)

    def _apply_update(self, grads, aux, seed):
        states = {**self._states, **aux}
        env = DictEnv(dict(states))
        for p, g in grads.items():
            env.set(self._grad_of[p], g)
        ctx = self._ctx(_mix(seed, 1), 0)
        for op in self._my_update:
            if id(op) in self._zero_ops:
                self._run_zero(ctx, op, env)
            elif "Param" in op.inputs and \
                    op.inputs["Param"][0] not in grads:
                continue        # a parameter with no gradient this step
            else:
                run_op(ctx, op, env)
        return {n: env.d.get(n, v) for n, v in states.items()}

    def _run_zero(self, ctx, op, env):
        """An update op under ZeRO-1: on this rank's rows (along the
        split dim of its accumulators) of the parameter, then the new
        rows all-gathered over dp into the whole parameter."""
        ins = gather_inputs(op, env)
        pshape = tuple(ins["Param"][0].shape)
        d = next(self._zero[n] for n in op.input_names() if n in self._zero)
        g, m = self._dpg, pshape[d] // self.dp
        lo = g.index * m
        for slot, names in op.inputs.items():
            for i, n in enumerate(names):
                v = ins[slot][i]
                if n not in self._zero and isinstance(
                        v, torch.Tensor) and tuple(v.shape) == pshape:
                    ins[slot][i] = v.narrow(d, lo, m)
        fn, attrs, tag = resolve_op(op)
        outs = fn(op_context(ctx, op, env, tag), ins, attrs)
        for slot, names in op.outputs.items():
            if slot not in outs:
                continue
            vs = outs[slot] if isinstance(outs[slot], (list, tuple)) \
                else [outs[slot]]
            whole = []
            for n, v in zip(names, vs):
                if n not in self._zero and isinstance(v, torch.Tensor) \
                        and v.dim() > d and v.shape[d] == m and \
                        tuple(v.shape) != pshape:
                    self._count("zero_all_gather")
                    v = g.all_gather(v.contiguous(), d)
                whole.append(v)
            outs[slot] = whole
        scatter_outputs(op, env, outs)

    def _gather_fetches(self, env):
        out = {}
        last = self.n_stages - 1
        for n in self.fetch_names:
            sec, kind = self._fetch[n]
            root = 0 if sec == _PRE else last
            v = env.get(n) if self.stage == root else None
            if v is not None and self.dp > 1:
                if kind == "batch":
                    self._count("fetch_all_gather")
                    v = self._dpg.all_gather(v.contiguous(), 0)
                else:
                    self._count("fetch_all_reduce")
                    v = self._dpg.all_reduce(v.contiguous()) / self.dp
            if self.n_stages > 1:
                v = _broadcast(self._pp, v, root, self.device)
            out[n] = v
        return out

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def run(self, feed: Dict, fetch_list=None, return_numpy=True):
        """One training step on the global batch `feed` -> the values of
        the construction-time fetch list, on every rank."""
        t0 = time.perf_counter()
        fetch_names = ([v.name if isinstance(v, Variable) else str(v)
                        for v in fetch_list]
                       if fetch_list is not None else self.fetch_names)
        if fetch_names != self.fetch_names:
            raise ValueError("fetch_list must match the construction-time "
                             "fetch_list")
        with obs_tracing.span("executor.run", mode="pipeline"), \
                torch.no_grad():
            self._record.clear()
            if self._tp is not None:
                self._tp.start_step()
            fetches, self._states = self._step_impl(feed)
            self.collective_record = list(self._record)
            out = [fetches[n] for n in fetch_names]
            if return_numpy:
                out = [_to_numpy(v) for v in out]
        if obs_metrics.enabled():
            if not hasattr(self, "_m_run"):
                from .executor import _M_RUN_SECONDS, _PE_IDS
                self._m_run_id = f"pipe{next(_PE_IDS)}"
                self._m_run = _M_RUN_SECONDS.labels(
                    exe=self._m_run_id, mode="pipeline")
            self._m_run.observe(time.perf_counter() - t0)
        return out

    def close(self):
        """Reclaim this instance's registry series (the executor stays
        usable)."""
        if hasattr(self, "_m_run"):
            from .executor import _M_RUN_SECONDS
            _M_RUN_SECONDS.remove(exe=self._m_run_id, mode="pipeline")

    def _whole_here(self, name):
        """State `name` whole on this rank (it holds it): its ZeRO-1 rows
        and tensor-parallel blocks gathered."""
        v = self._states[name]
        if name in self._zero:
            v = self._dpg.all_gather(v.contiguous(), self._zero[name])
        lay = self._tp_layouts.get(name)
        if lay is not None:
            v = self._groups[lay[1]].all_gather(v.contiguous(), lay[0])
        return v

    def state(self, name, return_numpy=True):
        """State `name` whole, on every rank (a collective: every rank
        calls it, in one order): its holder gathers its blocks and
        broadcasts it over pp."""
        if name not in self._meta:
            raise KeyError(f"{name!r} is not a state of this executor")
        owner = self._owner(name)
        v = self._whole_here(name) if owner in (None, self.stage) else None
        if owner is not None and self.n_stages > 1:
            v = _broadcast(self._pp, v, owner, self.device)
        if not return_numpy:
            return v.clone()
        return _to_numpy(v).copy() if v.device.type == "cpu" \
            else _to_numpy(v)

    def set_state(self, name, value):
        """Replace a state's value (whole; a rank keeps its block of it,
        a rank that does not hold it ignores it)."""
        if name not in self._meta:
            raise KeyError(f"{name!r} is not a state of this executor")
        if name not in self._states:
            return
        value = _to_device_value(
            value if isinstance(value, torch.Tensor) else np.asarray(value),
            self.device).to(self._meta[name][1])
        lay = self._tp_layouts.get(name)
        if lay is not None:
            value = self._groups[lay[1]].block(value, lay[0])
        if name in self._zero:
            value = self._dpg.block(value, self._zero[name])
        self._states[name] = value.contiguous().clone()

    def compiled_collectives(self, feed: Dict) -> Dict[str, int]:
        """{kind: count} of the collectives one step issues for `feed`
        (the JAX package counts its train step's optimized HLO; here a
        step runs on copies of the states and its collective record is
        counted: collective-permute = the stage hops and the ring's K/V
        shifts, all-reduce = gradient, tensor-parallel and fetch sums).
        Every rank calls it."""
        saved = {n: v.clone() for n, v in self._states.items()}
        step, calls = self._step, dict(self.collective_calls)
        try:
            self.run(feed)
            return count_collectives(self.collective_record)
        finally:
            self._states = saved
            self._step, self.collective_calls = step, calls

    # -- checkpoint layout (parallel/checkpoint.py) ---------------------------
    def _ckpt_names(self):
        return {n: m[0] for n, m in self._meta.items()}

    def _ckpt_blocks(self):
        out = []
        for n, v in self._states.items():
            shape = self._meta[n][0]
            idx = [(0, d) for d in shape]
            split = set()
            if self._owner(n) is not None:
                split.add(self.stage_axis)
            if n in self._zero:
                d, k = self._zero[n], v.shape[self._zero[n]]
                i = self._coord[self.batch_axis]
                idx[d] = (idx[d][0] + i * k, idx[d][0] + (i + 1) * k)
                split.add(self.batch_axis)
            lay = self._tp_layouts.get(n)
            if lay is not None:
                i = self._coord[lay[1]]
                k = shape[lay[0]] // self._axes[lay[1]]
                idx[lay[0]] = (i * k, (i + 1) * k)
                split.add(lay[1])
            primary = all(c == 0 for a, c in self._coord.items()
                          if a not in split)
            out.append((n, v, shape, idx, primary))
        return out

    def _ckpt_place(self, data):
        for n, v in data.items():
            self.set_state(n, v)
