"""ParallelExecutor: data- and tensor-parallel training of a Program
over a mesh.

Counterpart of paddle_tpu/parallel/executor.py.  Each process of a
`torch.distributed` group drives one device and holds a full copy of
the parameters (its blocks of those placed over a model axis, in the
"sharded" form below); the feed is the GLOBAL batch, and each rank runs
the program on its own rows of it.

The data-parallel step is the JAX package's bucketed overlap step
(`overlap="bucketed"`, or "auto" where the program allows it).  The
ops up to the first consumer of a raw parameter gradient — forward and
backward — are interpreted op by op on this rank's rows.  The
parameter gradients are concatenated, in production order, into
size-capped buckets (`overlap_bucket_bytes`, one stream per dtype), and
each bucket's flat gradient gets ONE asynchronous all-reduce the moment
the op that produces its last gradient has run, so NCCL reduces early
buckets while the rest of the backward still runs: the DDP overlap that
XLA's scheduler gave the JAX step.  After every handle is waited on,
the update section (gradient clipping and the optimizer ops) runs on
the reduced gradients, identically on every rank.  When that section
is a chain of plain dense `sgd` ops, one hand-written CUDA kernel per
bucket applies it (kernels/fused_update.py, selected through
kernels/registry.py as "fused_bucket_update"): the parameters of such a
bucket are views of one flat buffer, made when the plan is built, and
the kernel updates that buffer in place.  `state` hands out copies and
`set_state` writes into the buffer, so the views never part from it.

With a batch-mean loss, the mean over the global batch equals the mean
over ranks of the per-rank means, so the step is the serial step up to
float associativity; at world 1 it is the serial step bit for bit.

Where the overlap is off (asked for, or ruled out by the program), the
JAX package runs its GSPMD step: one `jax.jit` of the serial program
over sharded inputs, in which XLA inserts the collectives.  Here, with a
process group (at dp 1 too), that step takes one of three forms, named
in `gspmd_form`; `overlap_info` keeps the JAX package's report:

  * "sync_bn", for a program whose only blocker is training-mode
    `batch_norm` (or none): the overlap step's shape — local rows,
    bucketed gradient all-reduce, the update outside — with each
    training-mode batch_norm all-reducing its statistics over the group
    (`ExecContext.sync_group`, ops/norm.py), so the batch statistics,
    the running statistics and every gradient are the serial ones;
  * "replicated", for every other program the overlap refuses (control
    flow, LoD feeds, random ops other than dropout, a loss that is not
    a mean, a sparse embedding gradient): every rank runs the whole
    program over the global batch and calls no collective.  No
    scaling, but the serial result on every rank;
  * "sharded", for a program with placements over a model axis (the
    spmd plan's, from `layers.shard` annotations, or explicit
    `param_shardings`): tensor parallelism.  Each rank holds its blocks
    of the placed parameters and its rows of the batch, and runs the
    ops on local blocks by the rules of parallel/tensor_parallel.py
    (Megatron's column- and row-parallel products, local elementwise
    ops, reshapes and attention heads; an all-gather before any other
    op); the gradients are all-reduced over the batch axis's group in
    buckets, as in the overlap step, whose shape this form keeps where
    the program allows it (else every rank runs the global batch).
    `overlap="auto"` stands down for it with the JAX package's reason,
    and `overlap="bucketed"` raises.

Each mesh axis has its own process group (`Mesh.axis_group`): the
gradient, statistics and fetch collectives run over the batch axis's,
the tensor-parallel ones over the model axis's.

ZeRO-1 (`shard_optimizer_states=True`, every form): an optimizer
accumulator `<param>_<name>_acc` whose dim 0 divides by dp is split
over the batch axis (one that follows its parameter's placement keeps
that instead, as the JAX package's `_spec_for` decides).  The
gradients still reach every rank reduced; each rank updates the rows it
owns, and an all-gather over dp restores the whole parameter.  `state`
of a split state returns the whole array (a collective: every rank of
the mesh calls it), `set_state` writes this rank's block.

Every collective a step issues is recorded (`collective_record`: kind,
dtype, shape, axis), and `compiled_collectives(feed)` counts one step's
record by the JAX package's kind names.

Without a process group (a mesh of one) the whole program runs as in the
serial Executor.

Expert parallelism: a `moe_ffn` op whose expert weights are placed
P("ep") runs its rank's experts by the tensor-parallel rule
(parallel/tensor_parallel.py).  A mesh axis that no placement names
(a 'pp', 'sp' or 'ep' axis of an unannotated program) runs replicated
over its ranks, as the JAX package's.  The pipeline executor is
parallel/pipeline_program.py's `PipelineExecutor`, to which
`ShardingTranspiler.build_executor` dispatches a program with
`pipeline_stage` annotations over a 'pp' axis.  `save_checkpoint` /
`restore_checkpoint` come from parallel/checkpoint.py.

`DistributeTranspiler`'s pserver mode (`pservers="h:p,h:p"`) rewrites
the trainer program as the JAX package's does (optimizer ops out, one
fused `send` in) and builds each endpoint's `listen_and_serv` program;
the pservers run on the host (parallel/pserver.py).
"""
from __future__ import annotations

import itertools
import math
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..core.execution import (DictEnv, ExecContext, _mix, gather_inputs,
                              op_context, resolve_op, run_op,
                              scatter_outputs)
from ..core.executor import (CUDAPlace, Executor, _to_device_value,
                             _to_numpy, resolve_place)
from ..core.framework import Variable, default_startup_program
from ..core.lod import SelectedRows
from ..core.scope import Scope
from ..core.types import torch_dtype
from ..observability import metrics as obs_metrics
from ..observability import tracing as obs_tracing
from .checkpoint import ShardedCheckpointMixin
from .mesh import PartitionSpec, count_collectives, make_mesh
from .tensor_parallel import TensorParallel, grad_base

__all__ = ["ParallelExecutor", "DistributeTranspiler",
           "SimpleDistributeTranspiler", "ShardingTranspiler"]

# same series as core.executor's run histogram (get-or-create by name),
# with a "pe<N>" instance label and mode="parallel"
_PE_IDS = itertools.count()
_M_RUN_SECONDS = obs_metrics.histogram(
    "paddle_tpu_executor_run_seconds",
    "Executor.run wall latency by execution mode", ("exe", "mode"))


def _spec_axes(spec):
    """The axis names a placement spec mentions."""
    for e in tuple(spec or ()):
        for a in (e if isinstance(e, tuple) else (e,)):
            if a is not None:
                yield a


def _plan_flags() -> tuple:
    """Flags the overlap plan is built from (the bucket cap and the
    kernel tier); a change rebuilds the plan at the next run, as a
    change re-traces the JAX package's step."""
    from ..core.flags import get_flag
    from ..kernels.registry import kernels_mode

    return int(get_flag("overlap_bucket_bytes")), kernels_mode()


def _bucket_grad(t, name, dtype):
    """A gradient flattened into its bucket, which holds `dtype` (its
    parameter's): another dtype (a bf16 gradient of an f32 master
    weight) raises rather than being promoted by the concatenation, and
    a SelectedRows (an is_sparse embedding's) raises as the JAX
    package's overlap step does."""
    if isinstance(t, SelectedRows):
        raise TypeError(
            f"gradient {name!r} is a SelectedRows (an is_sparse "
            "embedding's): the bucketed overlap step takes dense "
            "gradients only, as the JAX package's does; build the "
            "embedding with is_sparse=False, or pass overlap='off' (every "
            "rank then runs the global batch)")
    if t.dtype != torch_dtype(dtype):
        raise TypeError(f"gradient {name!r} is {t.dtype}, but its bucket "
                        f"holds {dtype} (its parameter's dtype)")
    return t.reshape(-1)


class _StatGroup:
    """The batch-norm statistics group (`ExecContext.sync_group`, read by
    ops/norm.py's batch_norm): `all_reduce(t)` sums `t` in place over
    the batch axis's ranks, counted in the executor's
    `collective_calls["stat_all_reduce"]`; `size` is the rank count."""

    def __init__(self, pe):
        self._pe = pe
        self.size = pe.dp

    def all_reduce(self, t):
        self._pe._count("stat_all_reduce")
        self._pe._dp_group.all_reduce_(t)
        return t


class ParallelExecutor(ShardedCheckpointMixin):
    """Data-parallel executor over `mesh` ({"dp": n} or a `Mesh`).

    `place` is this rank's device: CUDAPlace(0) unless told otherwise
    (raising without a card); `CPUPlace()` runs on the CPU, with gloo
    between ranks."""

    def __init__(
        self,
        program,
        feed_names: Sequence[str],
        fetch_list: Sequence,
        mesh,
        startup_program=None,
        batch_axis: str = "dp",
        param_shardings: Optional[Dict] = None,
        shard_optimizer_states: bool = False,
        seed: int = 0,
        overlap: str = "off",
        spmd_plan=None,
        place=None,
    ):
        if isinstance(mesh, dict):
            mesh = make_mesh(mesh)
        if overlap not in ("off", "auto", "bucketed"):
            raise ValueError(
                f"overlap must be 'off', 'auto' or 'bucketed', got "
                f"{overlap!r}")
        self.mesh = mesh
        self.batch_axis = batch_axis
        self.dp = int(mesh.shape.get(batch_axis, 1))
        self.place = CUDAPlace(0) if place is None else place
        self.device = resolve_place(self.place)
        self.program = program
        self.feed_names = list(feed_names)
        self.fetch_names = [
            v.name if isinstance(v, Variable) else str(v)
            for v in fetch_list
        ]
        # PADDLE_TPU_VERIFY pre-flight, same contract as Executor.run
        # (gated inside preflight): a bad graph fails here, before the
        # first step
        from ..analysis import preflight

        preflight(program, feed_names=self.feed_names,
                  fetch_names=self.fetch_names)
        from .spmd import has_annotations, propagate_sharding, \
            spec_to_partition

        blk = program.global_block()
        if spmd_plan is None and has_annotations(blk):
            spmd_plan = propagate_sharding(
                program, mesh_axes=dict(mesh.shape), batch_axis=batch_axis)
        self._spmd_plan = spmd_plan
        if spmd_plan is not None:
            spmd_plan.check()
            # the plan's placements under the explicit ones (explicit
            # names win), as the JAX package folds them
            derived = {n: spec_to_partition(s)
                       for n, s in spmd_plan.param_specs.items()}
            derived.update(param_shardings or {})
            param_shardings = derived
        self._param_shardings = dict(param_shardings or {})
        for n, spec in self._param_shardings.items():
            for a in _spec_axes(spec):
                if a not in mesh.shape:
                    raise ValueError(
                        f"placement {spec} of {n!r}: axis {a!r} is not "
                        f"found in mesh {tuple(mesh.axis_names)}")
        self._feed_specs = dict(spmd_plan.feed_specs) if spmd_plan \
            else {}
        # explicit `donate=True` var hints fail HERE (build time) when
        # unsafe — a donated feed that is also fetched — not mid-train
        hinted = [n for n in self.feed_names
                  if getattr(blk.vars.get(n), "donate", False)]
        if hinted:
            from ..memory_optimization_transpiler import plan_donation

            reads, writes = self._analyze_states(program, blk)
            plan_donation(program, self.feed_names, self.fetch_names,
                          state_rw_names=[n for n in reads if n in writes],
                          requested=hinted).check()
        self._frees_by_op = None
        self._seed = seed
        self._step = 0
        # collectives this executor issued (none without a process
        # group): one all-reduce per gradient bucket, the fetches'
        # all-reduce (means) or all-gather (per-row values), and the
        # sync-BN form's batch-norm statistics (forward and backward);
        # the tensor-parallel and ZeRO-1 collectives join under their
        # own keys ("tp_all_reduce", "tp_all_gather", "zero_all_gather")
        # once issued
        self.collective_calls = {"grad_all_reduce": 0,
                                 "fetch_all_reduce": 0,
                                 "fetch_all_gather": 0,
                                 "stat_all_reduce": 0}
        # every collective of the last step (mesh.Collective entries)
        self.collective_record = []
        self._record = []
        self._dp_group = mesh.axis_group(batch_axis) \
            if batch_axis in mesh.shape else None
        # the model axes a placement splits a tensor over (size > 1)
        self._model_axes = sorted({
            e for spec in self._param_shardings.values()
            for e in _spec_axes(spec)
            if e != batch_axis and mesh.shape.get(e, 1) > 1})
        self._model_groups = {a: mesh.axis_group(a)
                              for a in self._model_axes}

        # compute/collective overlap: 'auto' falls back to the plain step
        # (reason kept in overlap_info) where the program shape rules the
        # overlap out; explicit 'bucketed' raises instead
        self.overlap_info = {"mode": "off",
                             "reason": "overlap='off' requested"}
        self._overlap_cfg = None
        from ..kernels import registry as _kernel_registry

        self._kernel_selection = _kernel_registry.Selection()
        # the GSPMD step's form with a process group (module docstring):
        # "sync_bn" runs the overlap step's shape with synced batch-norm
        # statistics, "replicated" the whole program on every rank,
        # "sharded" the tensor-parallel step; None where the overlap
        # step runs, or without a group (gspmd_info: the replicated
        # form's reason, or the buckets as overlap_info gives the
        # overlap step's)
        self.gspmd_form = None
        self.gspmd_info = {}
        self._stat_group = None
        if overlap != "off" or mesh.group is not None:
            cfg, reason, blocker = self._analyze_overlap(program, blk)
            if overlap != "off":
                if reason is None:
                    self._overlap_cfg = cfg
                    self.overlap_info = {"mode": "bucketed"}
                elif overlap == "bucketed":
                    raise ValueError(
                        f"overlap='bucketed' is not applicable to this "
                        f"program: {reason}")
                else:
                    self.overlap_info = {"mode": "off", "reason": reason}
            if self._overlap_cfg is None and mesh.group is not None:
                if self._model_axes:
                    sub = sorted({op.type for op in blk.ops if any(
                        isinstance(v, dict) and "__block__" in v
                        for v in op.attrs.values())})
                    if sub:
                        raise NotImplementedError(
                            f"placements over {self._model_axes} with "
                            f"sub-block ops {sub}: the tensor-parallel "
                            "step runs ops on local blocks, and a "
                            "sub-block's ops would read them whole; not "
                            "supported")
                    self.gspmd_form = "sharded"
                    self.gspmd_info = {"model_axes": self._model_axes}
                    if blocker is None:
                        self._overlap_cfg = cfg
                    else:
                        self.gspmd_info["reason"] = blocker
                elif blocker is not None:
                    self.gspmd_form = "replicated"
                    self.gspmd_info = {"reason": blocker}
                else:
                    self._overlap_cfg = cfg
                    self.gspmd_form = "sync_bn"
            if self._overlap_cfg is not None and self.gspmd_form in (
                    "sync_bn", "sharded"):
                self._stat_group = _StatGroup(self)
        # --- states from the startup program, on this rank's device ------
        startup = startup_program or default_startup_program()
        scope = Scope()
        Executor(self.place).run(startup, scope=scope)
        self._state_in, self._state_out = self._analyze_states(program, blk)
        # each state's placement (the JAX package's NamedSharding spec),
        # its model-axis layout and whether ZeRO-1 splits its rows
        self.state_specs: Dict[str, PartitionSpec] = {}
        layouts = {}
        self._zero_states = set()
        zero = bool(shard_optimizer_states)
        self._states = {}
        for n in self._state_in:
            if not scope.has_var(n):
                raise RuntimeError(
                    f"state var {n!r} not produced by the startup program")
            val = scope.find_var(n)
            spec, by_zero = self._spec_for(n, val, zero)
            self.state_specs[n] = spec
            if by_zero and self.dp > 1:
                self._zero_states.add(n)
                val = self._dp_group.block(val, 0).clone()
            lay = self._layout_of(n, spec, val)
            if lay is not None:
                layouts[n] = lay
                val = self._model_groups[lay[1]].block(val, lay[0]).clone()
            self._states[n] = val
        del scope
        # the update ops that read a ZeRO-1 split accumulator
        self._zero_ops = {id(op) for op in blk.ops
                          if "Param" in op.inputs and "ParamOut" in op.outputs
                          and set(op.input_names()) & self._zero_states}
        self._tp = None
        if self.gspmd_form == "sharded":
            for n in self.feed_names:
                lay = self._layout_of(n, self._feed_specs.get(n), None)
                if lay is not None:
                    layouts[n] = lay
            self._tp = TensorParallel(self._model_groups, layouts,
                                      self._count)
            if self._overlap_cfg is not None:
                # the buckets hold this rank's blocks of the gradients
                cfg = self._overlap_cfg
                self._overlap_cfg = dict(cfg, grad_meta=[
                    (g, self._local_shape(grad_base(g), shape, layouts), dt)
                    for g, shape, dt in cfg["grad_meta"]])
        # every axis's collectives (an op context's `groups`: the c_*
        # ops name them by ring_id), each recorded in the step's record
        self._axis_groups = {}
        if mesh.group is not None:
            for a in mesh.axis_names:
                g = (self._dp_group if a == batch_axis
                     else self._model_groups.get(a) or mesh.axis_group(a))
                g.record = self._record
                self._axis_groups[a] = g
        self._plan = None
        self._plan_state = None
        self._flat_storages = frozenset()
        self._refresh_plan()

    def _count(self, kind):
        self.collective_calls[kind] = self.collective_calls.get(kind, 0) + 1

    # -- placements ------------------------------------------------------------
    def _spec_for(self, name, val, zero):
        """-> (the state's PartitionSpec, whether ZeRO-1 gave it): the
        JAX package's `_spec_for` — an explicit placement wins (a
        parameter's, and its accumulators' `<param>_<name>_acc`), then
        ZeRO-1 splits an accumulator's dim 0 over the batch axis where
        it divides."""
        shape = tuple(val.shape) if isinstance(val, torch.Tensor) else ()
        for pname, spec in self._param_shardings.items():
            spec = PartitionSpec(*tuple(spec or ()))
            if name == pname:
                return spec, False
            if name.startswith(pname + "_") and name.endswith("_acc"):
                if shape and len(spec) <= len(shape):
                    return spec, False
        if zero and name.endswith("_acc") and len(shape) >= 1:
            if shape[0] % self.dp == 0 and shape[0] >= self.dp:
                return PartitionSpec(self.batch_axis), True
        return PartitionSpec(), False

    def _layout_of(self, name, spec, val):
        """The model-axis layout (dim, axis) a spec gives a value, or
        None: the port splits a tensor along one dim over one model
        axis; a batch-axis entry keeps the dim whole (XLA would shard
        and gather it: the same numbers)."""
        if not spec:
            return None
        found = []
        for d, e in enumerate(spec):
            for a in (e if isinstance(e, tuple) else (e,)):
                if a in self._model_groups:
                    found.append((d, a))
        if not found:
            return None
        if len(found) > 1 or any(isinstance(spec[d], tuple)
                                 for d, _ in found):
            raise ValueError(
                f"{name!r} is placed {spec}: the port splits a tensor "
                "along one dim over one model axis")
        d, a = found[0]
        if val is not None and (val.dim() <= d or val.shape[d]
                                % self.mesh.shape[a]):
            raise ValueError(
                f"{name!r} {tuple(val.shape)} is placed {spec}: dim {d} "
                f"does not divide by the {a!r} axis size "
                f"{self.mesh.shape[a]}")
        return found[0]

    def _local_shape(self, name, shape, layouts):
        lay = layouts.get(name)
        if lay is None:
            return shape
        shape = list(shape)
        shape[lay[0]] //= self.mesh.shape[lay[1]]
        return tuple(shape)

    @staticmethod
    def _analyze_states(program, block):
        """Persistable vars read (before being written) and written by
        the block's ops."""
        persistable = {v.name for v in program.list_vars() if v.persistable}
        reads, writes = set(), set()
        for op in block.ops:
            for n in op.input_names():
                if n in persistable and n not in writes:
                    reads.add(n)
            for n in op.output_names():
                if n in persistable:
                    writes.add(n)
        return sorted(reads), sorted(writes)

    # -- compute/collective overlap (bucketed grad all-reduce) --------------
    def _analyze_overlap(self, program, block):
        """Validate the program for the overlapped step and extract its
        structure -> (cfg, reason, blocker): `reason` is None where the
        overlap step runs the program, else the JAX package's reason;
        `blocker` is None where the GSPMD step's sync-BN form runs it,
        for which batch_norm may be what `reason` names, else the form's
        own reason; `cfg` is the structure where either runs, else None.

        The overlapped step runs every op up to the first gradient
        consumer on this rank's rows, reduces the parameter gradients
        with bucketed all-reduces, and runs the update section (grad
        clip + optimizer ops) on the reduced values.

        The sync-BN form all-reduces training-mode batch_norm's statistics
        and carries its running statistics out of the section; it
        refuses a sparse embedding gradient, which a bucket cannot carry
        (the overlap step raises at its first run, as the JAX package's
        does).  Any blocker found after the first batch_norm leaves the
        JAX package's reason that batch_norm's."""
        from ..core import registry as op_registry
        from ..core.framework import (EMPTY_VAR_NAMES, GRAD_SUFFIX,
                                      Parameter, grad_var_name)
        from .spmd import backward_start_index

        # the first reason only batch_norm gives, which the JAX package's
        # analysis stops at, and the sync-BN form's own blocker; the
        # model-parallel placements' reason, which the sharded form lifts
        bn_reason = sparse = placed = None

        def refuse(blocker):
            return None, placed or bn_reason or blocker, blocker

        ops = block.ops
        opt_ops = [op for op in ops
                   if "Param" in op.inputs and "ParamOut" in op.outputs]
        if not opt_ops:
            return refuse("no optimizer ops — the overlap lowers a "
                          "training step")
        # the reduction point is the first consumer of any RAW parameter
        # gradient — NOT the optimizer's Grad input, which may be a
        # clipped/regularized derivative of it: grad-clip (e.g.
        # global-norm) must see the REDUCED full-batch gradients, so
        # clip/regularizer ops belong to the update section
        all_produced = {n for op in ops for n in op.output_names()}
        grad_of = {}
        for v in block.vars.values():
            if isinstance(v, Parameter) and getattr(v, "trainable", True):
                g = grad_var_name(v.name)
                if g in all_produced:
                    grad_of[g] = v.name
        if not grad_of:
            return refuse("no parameter gradients in the program")
        grad_names = set(grad_of)
        split = next((i for i, op in enumerate(ops)
                      if set(op.input_names()) & grad_names), None)
        if split is None:
            return refuse("no op consumes the parameter gradients")
        produced = set()
        last_prod = {}
        for i, op in enumerate(ops[:split]):
            for n in op.output_names():
                produced.add(n)
                if n in grad_names:
                    last_prod[n] = i
        if not grad_names <= produced:
            missing = sorted(grad_names - produced)
            return refuse(f"gradient(s) {missing} are produced after "
                          "their first consumer")
        names = sorted(n for n, sp in self._param_shardings.items()
                       if sp is not None and any(e is not None
                                                 for e in tuple(sp)))
        if self._spmd_plan is not None and self._spmd_plan.model_axes:
            placed = (f"model-parallel placements over "
                      f"{self._spmd_plan.model_axes} — the GSPMD step keeps "
                      "them sharded; the manual-dp overlap would gather "
                      "them")
        elif names:
            placed = (f"explicit param_shardings on {names} — the GSPMD "
                      "step keeps them sharded; the manual-dp overlap would "
                      "gather them")

        # the grad reduction is a mean over ranks, which equals the
        # serial gradient ONLY for a batch-MEAN loss
        seed_idx = backward_start_index(block)
        if seed_idx >= split:
            return refuse("no backward section (loss@GRAD seed) found")
        seed_out = ops[seed_idx].output_names()[0]
        loss_name = seed_out[:-len(GRAD_SUFFIX)]
        loss_var = block.vars.get(loss_name)
        if loss_var is None or loss_var.op is None or \
                loss_var.op.type != "mean":
            return refuse(
                f"loss {loss_name!r} is not produced by a mean op — "
                "per-shard gradients averaged over dp only equal the "
                "serial gradient for a batch-mean loss")

        persistable = {v.name for v in program.list_vars()
                       if v.persistable}
        for i, op in enumerate(ops):
            if any(isinstance(v, dict) and "__block__" in v
                   for v in op.attrs.values()):
                return refuse(f"control-flow op {op.type!r} (sub-blocks)")
            try:
                info = op_registry.get_op_info(op.type)
            except KeyError:
                return refuse(f"unregistered op {op.type!r}")
            if info.random and not op.attrs.get("is_test", False):
                if i >= split:
                    return refuse(
                        f"stochastic op {op.type!r} in the update "
                        "section — its draws would differ from serial")
                if op.type != "dropout":
                    return refuse(
                        f"stochastic op {op.type!r}: only dropout has "
                        "the batch-position-keyed PRNG that keeps "
                        "per-shard draws equal to serial")
            if i >= split:
                continue
            writes = any(n and n in persistable for n in op.output_names())
            if op.type == "batch_norm":
                # what batch_norm alone blocks, the sync-BN form lifts
                if bn_reason is None and not op.attrs.get("is_test", False):
                    bn_reason = ("training-mode batch_norm couples rows "
                                 "across the dp shards")
                elif bn_reason is None and writes:
                    bn_reason = ("op 'batch_norm' writes persistable "
                                 "state inside the sharded section")
            elif writes:
                return refuse(f"op {op.type!r} writes persistable state "
                              "inside the sharded section")
            elif op.type == "lookup_table" and op.attrs.get("is_sparse") \
                    and grad_var_name(op.input("W")[0]) in grad_names:
                sparse = "sparse embedding gradient: a SelectedRows is " \
                    "not bucketed"

        # the update section may read only persistables, the reduced
        # grads, and its own intermediates
        upd_prod = set()
        for op in ops[split:]:
            for n in op.input_names():
                if (not n or n in EMPTY_VAR_NAMES or n in grad_names
                        or n in upd_prod or n in persistable):
                    continue
                return refuse(
                    f"update-section op {op.type} reads forward value "
                    f"{n!r} (e.g. a per-example regularizer input)")
            upd_prod.update(op.output_names())

        for n in self.feed_names:
            v = block.vars.get(n)
            if v is None:
                continue
            if v.lod_level:
                return refuse(f"LoD feed {n!r} (host-side metadata)")
            if not v.shape or v.shape[0] != -1:
                return refuse(f"feed {n!r} has no leading batch dim")
            spec = self._feed_specs.get(n)
            if spec is not None and (
                    not spec or spec[0] != self.batch_axis):
                return refuse(
                    f"feed {n!r} is annotated {spec}, not sharded over "
                    f"the '{self.batch_axis}' batch axis")

        fetch_kinds = {}
        for n in self.fetch_names:
            if n not in produced:
                return refuse(f"fetch {n!r} is produced by the update "
                              "section (not supported under overlap)")
            v = block.vars.get(n)
            if v is not None and v.shape and v.shape[0] == -1:
                fetch_kinds[n] = "batch"
                continue
            # non-batch fetches are averaged over dp — only correct for
            # batch-mean quantities, so require a mean-semantics producer
            if v is None or v.op is None or v.op.type not in (
                    "mean", "accuracy"):
                return refuse(
                    f"fetch {n!r} is not a per-row output or a batch "
                    "mean — its per-shard values cannot be combined")
            fetch_kinds[n] = "mean"

        inside_state = sorted({
            n for op in ops[:split] for n in op.input_names()
            if n in persistable})
        # the running statistics batch_norm writes (no other op may
        # write a persistable here)
        inside_writes = sorted({
            n for op in ops[:split] for n in op.output_names()
            if n in persistable})
        # production order, and an op's own output order among the
        # gradients one op makes (layer_norm_grad's, batch_norm_grad's):
        # every rank must lay its buckets out alike, so no tie may fall
        # to the iteration order of a set (Python's per-process hash)
        grad_order = sorted(grad_names, key=lambda g: (
            last_prod[g], ops[last_prod[g]].output_names().index(g)))
        grad_meta = []
        for g in grad_order:
            pv = block.vars.get(grad_of[g])
            if pv is None or pv.shape is None or any(
                    d < 0 for d in pv.shape):
                return refuse(f"parameter {grad_of[g]!r} has no static shape")
            grad_meta.append((g, tuple(pv.shape), pv.dtype or "float32"))
        if sparse and (bn_reason or self._model_axes):
            return refuse(sparse)
        return {
            "split": split,
            "inside": tuple(ops[:split]),
            "update": tuple(ops[split:]),
            "grad_meta": grad_meta,
            "last_prod": last_prod,
            "inside_state": inside_state,
            "inside_writes": inside_writes,
            "fetch_kinds": fetch_kinds,
        }, placed or bn_reason, sparse

    def _refresh_plan(self):
        """(Re)build the buckets and the fused-update plan when the flags
        they are made from changed since the last build."""
        if self._overlap_cfg is None or self._plan_state == _plan_flags():
            return
        self._plan_state = _plan_flags()
        cfg = self._overlap_cfg
        # size-capped buckets in gradient PRODUCTION (backward) order,
        # one stream per dtype (a bucket is one concatenated all-reduce)
        cap = self._plan_state[0]
        buckets, cur, cur_bytes, cur_dt = [], [], 0, None
        for g, shape, dtype in cfg["grad_meta"]:
            nbytes = math.prod(shape) * torch_dtype(dtype).itemsize
            if cur and (dtype != cur_dt
                        or (cap > 0 and cur_bytes + nbytes > cap)
                        or cap <= 0):
                buckets.append(tuple(cur))
                cur, cur_bytes = [], 0
            cur.append((g, shape, dtype))
            cur_dt, cur_bytes = dtype, cur_bytes + nbytes
        if cur:
            buckets.append(tuple(cur))
        # each bucket's all-reduce is issued right after the op that
        # produces the last of its gradients
        issue_after = {}
        for b, bucket in enumerate(buckets):
            at = max(cfg["last_prod"][g] for g, _, _ in bucket)
            issue_after.setdefault(at, []).append(b)
        fused_plan = self._plan_fused_update(buckets, cfg["update"])
        if fused_plan is not None:
            fused_plan = [(entries, lr_name, kern,
                           *self._flatten_params(entries))
                          for entries, lr_name, kern in fused_plan]
        # the storages of the flat parameter buffers, to tell a live
        # view of one from any other tensor
        self._flat_storages = frozenset(
            () if fused_plan is None else
            (flat.untyped_storage().data_ptr()
             for _, _, _, flat, _ in fused_plan))
        self._plan = (buckets, issue_after, fused_plan)
        # the sync-BN form keeps overlap_info the JAX package's report
        (self.overlap_info if self.gspmd_form is None
         else self.gspmd_info).update(
            buckets=len(buckets), grads=len(cfg["grad_meta"]),
            split=cfg["split"],
            update=("fused" if fused_plan is not None else
                    self._kernel_selection.chosen.get(
                        "fused_bucket_update", "per_op")))

    def _flatten_params(self, entries):
        """-> (flat, views): one flat float32 buffer for a fused bucket's
        parameters, filled once from their current values, and each
        parameter's view of its slice, which becomes its state; the
        kernel updates the buffer in place."""
        flat = torch.cat([self._states[p].reshape(-1)
                          for p, _, _ in entries])
        views, off = [], 0
        for p, _, shape in entries:
            size = math.prod(shape)
            views.append(flat[off:off + size].view(shape))
            self._states[p] = views[-1]
            off += size
        return flat, views

    def _in_bucket(self, v):
        """Whether tensor `v` is a view of a fused bucket's flat
        parameter buffer."""
        return (bool(self._flat_storages) and isinstance(v, torch.Tensor)
                and v.untyped_storage().data_ptr() in self._flat_storages)

    def _plan_fused_update(self, buckets, update_ops):
        """Map the overlap buckets onto the fused bucket update: one
        kernel per bucket replaces the per-parameter sgd op chain WHEN
        the chain's shape allows it — every update op a plain dense
        `sgd` writing its param in place, fed the raw reduced bucket
        grad, all params of a bucket sharing one learning-rate scalar.
        Anything fancier (momentum/adam, clipping chains, per-param LR)
        keeps the op chain — the program's own update ops — and the
        executor records that verdict in the fallback registry itself.

        On a CUDA device a chain of that shape always runs the kernel
        (no flag disarms it) and a bucket the kernel does not take
        raises; on the CPU the `serving_kernels` flag decides, as in
        the JAX package.

        Returns [(entries, lr_name, kern)] with entries
        [(param, grad, shape)] in bucket order, or None; `_refresh_plan`
        adds each bucket's flat parameter buffer and its views."""
        platform = self.device.type
        sel = self._kernel_selection
        structure = None
        grad_to_op = {}
        for op in update_ops:
            if op.type != "sgd":
                structure = "op_mix"
                break
            ps, gs = op.input("Param"), op.input("Grad")
            ls, pouts = op.input("LearningRate"), op.output("ParamOut")
            if len(ps) != 1 or len(gs) != 1 or len(ls) != 1 \
                    or pouts != ps:
                structure = "op_shape"
                break
            grad_to_op[gs[0]] = (ps[0], ls[0])

        plan = []
        if structure is None:
            for bucket in buckets:
                entries, lr_names = [], set()
                for g, shape, dtype in bucket:
                    if g not in grad_to_op:
                        # the op chain reads something other than the
                        # raw reduced grad (e.g. a clip rewrote it)
                        structure = "clipped_grads"
                        break
                    pname, lr_name = grad_to_op[g]
                    entries.append((pname, g, shape))
                    lr_names.add(lr_name)
                if structure is not None:
                    break
                if len(lr_names) != 1:
                    structure = "lr_mismatch"
                    break
                lr_name = lr_names.pop()
                if lr_name not in self._states:
                    structure = "lr_missing"
                    break
                ctx = dict(numel=sum(math.prod(s) for _, _, s in entries),
                           dtype=str(bucket[0][2]))
                kern = (sel.require("fused_bucket_update", **ctx)
                        if platform == "cuda" else
                        sel.pick("fused_bucket_update", platform=platform,
                                 **ctx))
                if kern is None:
                    return None
                plan.append((tuple(entries), lr_name, kern))
            if structure is None:
                return plan

        # the chain's shape ruled the fusion out: counted (when armed)
        # like a context the kernel does not take
        sel.decline("fused_bucket_update", structure, platform=platform)
        return None

    # -- execution -----------------------------------------------------------
    def _local_feeds(self, feed):
        """This rank's rows of the global feed, on its device (the
        overlap analysis has checked that every feed is batch-major);
        the whole feed where every rank runs the global batch.  A feed
        placed over a model axis gets this rank's block of it."""
        out = {}
        split = self.dp > 1 and self._overlap_cfg is not None
        for n, v in feed.items():
            if split:
                rows = len(v)
                if rows % self.dp:
                    raise ValueError(
                        f"feed {n!r}: batch {rows} is not divisible by "
                        f"dp {self.dp}")
                mb = rows // self.dp
                i = self._dp_group.index
                v = v[i * mb:(i + 1) * mb]
            v = _to_device_value(v, self.device)
            lay = self._tp.base.get(n) if self._tp is not None else None
            if lay is not None:
                v = self._model_groups[lay[1]].block(v, lay[0]).contiguous()
            out[n] = v
        return out

    def _all_reduce(self, t, kind):
        """An asynchronous all-reduce of `t` over the batch axis (None:
        no group there)."""
        if self._dp_group is None or self._dp_group.group is None:
            return None
        self._count(kind)
        return self._dp_group.all_reduce_(t, async_op=True)

    def _gather_rows(self, v):
        self._count("fetch_all_gather")
        return self._dp_group.all_gather(v, 0)

    def _whole(self, n, v):
        """A fetched value whole over the model axes (an all-gather of
        its blocks where it is split)."""
        lay = self._tp.layout(n) if self._tp is not None else None
        return v if lay is None else self._tp._gather(v, lay)

    def _dead_frees(self):
        """{id(op): names dead after it} under the `memory_optimize`
        flag (plan_dead_frees over the whole block: a step drops each
        value after its last op, the port's counterpart of the JAX
        package's donated feed buffers), else {}."""
        from ..core.flags import get_flag

        if not get_flag("memory_optimize"):
            return {}
        if self._frees_by_op is None:
            from ..memory_optimization_transpiler import plan_dead_frees

            ops = self.program.global_block().ops
            self._frees_by_op = {
                id(ops[i]): names for i, names in plan_dead_frees(
                    self.program, self.fetch_names).items()}
        return self._frees_by_op

    def _run_freeing(self, ctx, op, env, frees):
        if id(op) in self._zero_ops:
            self._run_zero(ctx, op, env)
        elif self._tp is not None:
            self._tp.run(ctx, op, env)
        else:
            run_op(ctx, op, env)
        for n in frees.get(id(op), ()):
            env.d.pop(n, None)

    def _run_zero(self, ctx, op, env):
        """An update op under ZeRO-1: on this rank's rows of the
        parameter (its split accumulators hold only those), then the
        new rows all-gathered over the batch axis into the whole
        parameter."""
        ins = gather_inputs(op, env)
        pshape = tuple(ins["Param"][0].shape)
        g = self._dp_group
        m = pshape[0] // self.dp
        for slot, names in op.inputs.items():
            for i, n in enumerate(names):
                v = ins[slot][i]
                if n not in self._zero_states and isinstance(
                        v, torch.Tensor) and tuple(v.shape) == pshape:
                    ins[slot][i] = v[g.index * m:(g.index + 1) * m]
        fn, attrs, tag = resolve_op(op)
        outs = fn(op_context(ctx, op, env, tag), ins, attrs)
        for slot, names in op.outputs.items():
            if slot not in outs:
                continue
            vs = outs[slot] if isinstance(outs[slot], (list, tuple)) \
                else [outs[slot]]
            whole = []
            for n, v in zip(names, vs):
                if n not in self._zero_states and isinstance(
                        v, torch.Tensor) and v.dim() and \
                        tuple(v.shape) == (m,) + pshape[1:]:
                    self._count("zero_all_gather")
                    v = g.all_gather(v, 0)
                whole.append(v)
            outs[slot] = whole
        scatter_outputs(op, env, outs)

    def _overlap_step(self, feeds, ctx):
        cfg = self._overlap_cfg
        buckets, issue_after, fused_plan = self._plan
        env = DictEnv({**{n: self._states[n] for n in cfg["inside_state"]},
                       **feeds})
        grouped = self._dp_group is not None and \
            self._dp_group.group is not None
        pending = []
        frees = self._dead_frees()
        for i, op in enumerate(cfg["inside"]):
            self._run_freeing(ctx, op, env, frees)
            for b in issue_after.get(i, ()):
                # a fresh flat buffer per bucket: the all-reduce writes
                # in place, and a gradient may alias a value the rest of
                # the backward still reads
                flat = torch.cat([_bucket_grad(env.get(g), g, dtype)
                                  for g, _, dtype in buckets[b]])
                pending.append((b, flat,
                                self._all_reduce(flat, "grad_all_reduce")))
        # the running statistics the section wrote (the sync-BN form's
        # batch_norm: the same serial values on every rank)
        states = {**self._states,
                  **{n: env.get(n) for n in cfg["inside_writes"]}}
        flats, grads = {}, {}
        for b, flat, handle in pending:
            if handle is not None:
                handle.wait()
            if self.dp > 1:
                flat = flat / self.dp
            flats[b] = flat
            off = 0
            for g, shape, _ in buckets[b]:
                size = math.prod(shape)
                grads[g] = flat[off:off + size].view(shape)
                off += size
        fetches = {}
        for n, kind in cfg["fetch_kinds"].items():
            v = self._whole(n, env.get(n))
            if grouped and kind == "batch":
                v = self._gather_rows(v)
            elif grouped:
                v = v.clone()
                self._all_reduce(v, "fetch_all_reduce").wait()
                v = v / self.dp
            fetches[n] = v

        if fused_plan is not None:
            # a fetch that is (a view of) a parameter keeps the value it
            # had when the step read it: the update below is in place
            for n, v in fetches.items():
                if self._in_bucket(v):
                    fetches[n] = v.clone()
            # one launch per bucket applies the whole bucket's
            # p -= lr * g in place over its flat buffer, of which every
            # parameter state is a view; a state that was replaced by
            # another tensor since the plan was made is copied back in
            for b, (entries, lr_name, kern, flat_p, views) in enumerate(
                    fused_plan):
                for (p, _, _), view in zip(entries, views):
                    if states[p] is not view:
                        view.copy_(states[p])
                        states[p] = view
                kern(flat_p, flats[b], states[lr_name])
            return fetches, states
        env = DictEnv({**states, **grads})
        for op in cfg["update"]:
            self._run_freeing(ctx, op, env, frees)
        return fetches, {n: env.d.get(n, states[n]) for n in states}

    def _plain_step(self, feeds, ctx):
        """The whole program over the feed: a mesh of one with the
        overlap off, or every rank of the replicated form (and of the
        sharded form where the overlap's shape does not apply)."""
        env = DictEnv({**self._states, **feeds})
        frees = self._dead_frees()
        for op in self.program.global_block().ops:
            self._run_freeing(ctx, op, env, frees)
        missing = [n for n in self.fetch_names if not env.has(n)]
        if missing:
            raise KeyError(f"fetch variable(s) {missing} were never "
                           "produced by the program")
        new_states = {n: env.d.get(n, v) for n, v in self._states.items()}
        for n in self._state_out:
            new_states[n] = env.d[n]
        return ({n: self._whole(n, env.get(n)) for n in self.fetch_names},
                new_states)

    def run(self, feed: Dict, fetch_list=None, return_numpy=True):
        """One training step on the global batch `feed` -> the values of
        the construction-time fetch list."""
        t0 = time.perf_counter()
        fetch_names = ([v.name if isinstance(v, Variable) else str(v)
                        for v in fetch_list]
                       if fetch_list is not None else self.fetch_names)
        if fetch_names != self.fetch_names:
            raise ValueError("fetch_list must match the construction-time "
                             "fetch_list")
        self._refresh_plan()
        with obs_tracing.span("executor.run", mode="parallel"), \
                torch.no_grad():
            self._record.clear()
            if self._tp is not None:
                self._tp.start_step()
            feeds = self._local_feeds(feed)
            seed = _mix(self.program.seed or self._seed, self._step)
            self._step += 1
            # dropout masks are batch-position keyed: offset this rank's
            # rows (_local_feeds' slice) so the composed draw is serial's
            split = self.dp > 1 and self._overlap_cfg is not None
            mb = len(next(iter(feeds.values()))) if feeds and split else 0
            ctx = ExecContext(
                self.device, seed=seed,
                row_offset=self._dp_group.index * mb if split else 0,
                sync_group=self._stat_group, groups=self._axis_groups)
            step = (self._overlap_step if self._overlap_cfg is not None
                    else self._plain_step)
            fetches, self._states = step(feeds, ctx)
            self.collective_record = list(self._record)
            out = [fetches[n] for n in fetch_names]
            if return_numpy:
                out = [_to_numpy(v) for v in out]
        if obs_metrics.enabled():
            if not hasattr(self, "_m_run"):
                self._m_run_id = f"pe{next(_PE_IDS)}"
                self._m_run = _M_RUN_SECONDS.labels(
                    exe=self._m_run_id, mode="parallel")
            self._m_run.observe(time.perf_counter() - t0)
        return out

    def close(self):
        """Reclaim this instance's registry series.  The executor stays
        usable."""
        if hasattr(self, "_m_run"):
            _M_RUN_SECONDS.remove(exe=self._m_run_id, mode="parallel")
        self._kernel_selection.close()

    def compiled_collectives(self, feed: Dict) -> Dict[str, int]:
        """{kind: count} of the collectives one step issues for `feed`
        (the JAX package's kind names; where it counts the collectives
        of the step's optimized HLO, here the step is run on copies of
        the states and its collective record counted, the states left
        as they were).  Every rank of the mesh calls it, as every rank
        runs a step: dp-N gives all-reduces only, a mesh of one {}."""
        saved = {n: v.clone() for n, v in self._states.items()}
        step, calls = self._step, dict(self.collective_calls)
        try:
            self.run(feed)
            return count_collectives(self.collective_record)
        finally:
            for n, v in saved.items():
                if self._in_bucket(self._states[n]):
                    self._states[n].copy_(v)
                else:
                    self._states[n] = v
            self._step, self.collective_calls = step, calls

    def _split_of(self, name):
        """How state `name` is split: (model-axis layout or None,
        whether ZeRO-1 splits its rows)."""
        lay = self._tp.base.get(name) if self._tp is not None else None
        return lay, name in self._zero_states

    def state(self, name, return_numpy=True):
        """The state's current value, as a copy that later steps do not
        change (a fused parameter is a view of its bucket's flat buffer,
        which every step updates in place): a numpy array, or with
        return_numpy=False a tensor on the device.  A state split over
        the mesh is gathered whole (every rank calls this together)."""
        v = self._states[name]
        lay, rows = self._split_of(name)
        if rows:
            v = self._dp_group.all_gather(v, 0)
        if lay is not None:
            v = self._model_groups[lay[1]].all_gather(v, lay[0])
        if not return_numpy:
            return v.clone()
        # a CPU tensor's array shares its memory
        return _to_numpy(v).copy() if v.device.type == "cpu" \
            else _to_numpy(v)

    # -- checkpoint layout (parallel/checkpoint.py) ---------------------------
    def _ckpt_names(self):
        """{state: its global shape}."""
        out = {}
        for n, v in self._states.items():
            shape = list(v.shape)
            lay, rows = self._split_of(n)
            if rows:
                shape[0] *= self.dp
            if lay is not None:
                shape[lay[0]] *= self.mesh.shape[lay[1]]
            out[n] = tuple(shape)
        return out

    def _ckpt_blocks(self):
        """[(name, this rank's block, global shape, its index slices,
        whether this rank writes it: coordinate 0 on every axis that
        does not split it)]."""
        coord = {a: (self.mesh.axis_index(a) if self.mesh.group is not None
                     else 0) for a in self.mesh.axis_names}
        shapes = self._ckpt_names()
        out = []
        for n, v in self._states.items():
            lay, rows = self._split_of(n)
            idx = [(0, d) for d in shapes[n]]
            split = set()
            if rows:
                m = v.shape[0]
                idx[0] = (coord[self.batch_axis] * m,
                          (coord[self.batch_axis] + 1) * m)
                split.add(self.batch_axis)
            if lay is not None:
                m = v.shape[lay[0]]
                i = coord[lay[1]]
                idx[lay[0]] = (i * m, (i + 1) * m)
                split.add(lay[1])
            primary = all(c == 0 for a, c in coord.items() if a not in split)
            out.append((n, v, shapes[n], idx, primary))
        return out

    def _ckpt_place(self, data):
        for n, v in data.items():
            self.set_state(n, v.to(self._states[n].dtype))

    def set_state(self, name, value):
        """Replace a state's value (whole; a split state keeps this
        rank's block of it); a fused parameter's is written into its
        slice of the bucket's flat buffer."""
        if name not in self._states:
            raise KeyError(f"{name!r} is not a state of this executor")
        value = _to_device_value(
            value if isinstance(value, torch.Tensor) else np.asarray(value),
            self.device)
        lay, rows = self._split_of(name)
        if lay is not None:
            value = self._model_groups[lay[1]].block(value, lay[0])
        if rows:
            value = self._dp_group.block(value, 0)
        value = value.contiguous()
        view = self._states[name]
        if not self._in_bucket(view):
            self._states[name] = value
            return
        if tuple(value.shape) != tuple(view.shape):
            raise ValueError(f"set_state({name!r}): shape "
                             f"{tuple(value.shape)}, the parameter is "
                             f"{tuple(view.shape)}")
        view.copy_(value)


class DistributeTranspiler:
    """The reference's transpiler workflow (reference
    distribute_transpiler.py:133), in its two modes:

    * pserver (`pservers="h:p,h:p"`): the trainer program loses its
      optimizer ops and gains ONE fused `send` (grads out by `epmap`,
      params back by `out_epmap`, whole-param placement by
      `split_method`, default `balanced_split`); each endpoint's
      `get_pserver_program` is one `listen_and_serv` op whose sub-block
      holds the optimizer ops of the params placed there.  The trainer
      program and the pserver programs are the JAX package's, op for op
      and attribute for attribute.  The port's one addition: the
      trainer's startup program ends with one `recv` op a pserver,
      pulling the parameters it owns, so a trainer on a card starts
      from the pservers' parameters (parallel/pserver.py says why);
      `get_startup_program(endpoint)` is the startup program without
      them.
    * spmd (the default without pservers): records the mesh layout and
      completes the program's sharding annotations;
      `get_trainer_program` returns the ORIGINAL program, and
      `build_executor` yields a ParallelExecutor over the mesh (dp x
      tp, with ZeRO-1 unless `shard_optimizer_states=False`, as in the
      JAX package)."""

    def __init__(self):
        self._mesh_axes = None
        self._program = None
        self._startup = None
        self._pserver_startup = None
        self._shard_opt = True
        self._mode = None
        self._plan = None
        self._overlap = "auto"
        self._batch_axis = "dp"
        self._endpoints = []
        self._assign = {}
        self._pairs_by_ep = {}
        self._optimize_ops = []
        self._trainers = 1
        self._sync_mode = True

    def transpile(self, optimize_ops=None, params_grads=None,
                  trainers=1, pservers: str = "", program=None,
                  startup_program=None,
                  mesh_axes: Optional[Dict[str, int]] = None,
                  mesh=None,
                  mode: Optional[str] = None,
                  shard_optimizer_states: bool = True,
                  split_method=None, sync_mode: bool = True,
                  overlap: str = "auto", batch_axis: str = "dp"):
        """Prepare `program` for distributed execution.  `mode`
        "pserver" is implied by a non-empty `pservers` list; "spmd"
        (the default otherwise) records `mesh_axes` (alias `mesh`;
        default {"dp": trainers}) on the program, completes its
        sharding annotations, and raises on inconsistent specs here, at
        transpile time.  `overlap` is the ParallelExecutor overlap
        mode; `sync_mode=False` makes the pservers apply each grad on
        arrival (ASGD)."""
        from ..core.framework import default_main_program

        self._program = program or default_main_program()
        self._startup = startup_program or default_startup_program()
        if mesh_axes is None and mesh is not None:
            mesh_axes = mesh
        if mesh_axes is None:
            mesh_axes = {"dp": trainers}
        self._mesh_axes = mesh_axes
        self._shard_opt = shard_optimizer_states
        self._endpoints = [e.strip() for e in (pservers or "").split(",")
                           if e.strip()]
        self._optimize_ops = list(optimize_ops or [])
        self._trainers = trainers
        self._sync_mode = sync_mode
        self._overlap = overlap
        self._batch_axis = batch_axis
        if mode is None:
            mode = "pserver" if self._endpoints else "spmd"
        if mode not in ("pserver", "spmd"):
            raise ValueError(f"mode must be 'pserver' or 'spmd', "
                             f"got {mode!r}")
        self._mode = mode
        if mode == "pserver":
            if self._endpoints and params_grads:
                self._transpile_pserver(list(params_grads), split_method)
            return
        self._transpile_spmd()

    def _transpile_spmd(self):
        from .spmd import propagate_sharding

        self._program.mesh_axes = {str(k): int(v)
                                   for k, v in self._mesh_axes.items()}
        self._program.bump_version()
        self._plan = propagate_sharding(
            self._program, mesh_axes=self._program.mesh_axes,
            batch_axis=self._batch_axis).check()

    # -- pserver mode (host-side pservers, trainers on their cards) ---------
    def _transpile_pserver(self, params_grads, split_method=None):
        """Rewrite the trainer program: optimizer ops out, ONE fused
        send op in (reference distribute_transpiler.py:134-231;
        whole-param placement per a distributed_spliter policy, default
        balanced_split — size-weighted so no pserver owns nearly all
        the bytes; round_robin/hash_name stay selectable); then end the
        trainer's startup program with one recv a pserver."""
        from . import distributed_spliter

        if split_method is None:
            split_method = distributed_spliter.balanced_split
        eps = self._endpoints
        self._pairs_by_ep = {ep: [] for ep in eps}
        placement = split_method([p for p, _ in params_grads], eps)
        for (p, g), ep in zip(params_grads, placement):
            self._assign[p.name] = ep
            self._pairs_by_ep[ep].append((p, g))

        block = self._program.global_block()
        drop = set(id(op) for op in self._optimize_ops)
        block.ops[:] = [op for op in block.ops if id(op) not in drop]
        if params_grads:
            # one bucketed send across ALL endpoints: per-var epmap for
            # the grads, out_epmap for the param pulls.  The runtime
            # (ops/distributed.py + parallel/comm.py) packs each
            # endpoint's grads into arrival-order buckets and overlaps
            # endpoints
            block.append_op(
                "send",
                {"X": [g.name for _, g in params_grads]},
                {"Out": [p.name for p, _ in params_grads]},
                {"endpoints": list(eps),
                 "epmap": [self._assign[p.name]
                           for p, _ in params_grads],
                 "out_epmap": [self._assign[p.name]
                               for p, _ in params_grads]})
        self._program.bump_version()
        # the pservers initialize with the startup program as given;
        # the trainer's then pulls what they drew (parallel/pserver.py)
        self._pserver_startup = self._startup.clone()
        sblock = self._startup.global_block()
        for ep in eps:
            names = [p.name for p, _ in self._pairs_by_ep[ep]]
            if not names:
                continue
            for n in names:
                if not sblock.has_var(n):
                    src = self._find_var(n)
                    sblock.create_var(name=n, shape=src.shape,
                                      dtype=src.dtype, persistable=True)
            sblock.append_op("recv", {"X": []}, {"Out": names},
                             {"endpoint": ep})
        self._startup.bump_version()

    def get_trainer_program(self):
        return self._program

    def get_pserver_program(self, endpoint=None):
        """Build the per-endpoint pserver program: one listen_and_serv op
        whose sub-block holds the optimizer ops of the params assigned to
        this endpoint (reference distribute_transpiler.py:523-618).

        In the spmd mode (no `pservers` given) there is no pserver role
        and the original program is returned for API parity."""
        if not self._endpoints:
            return self._program
        from ..core.framework import Program, program_guard
        from ..layers.io import ListenAndServ

        pairs = self._pairs_by_ep.get(endpoint, [])
        mine = {p.name for p, _ in pairs}
        prog, startup = Program(), Program()
        with program_guard(prog, startup):
            serv = ListenAndServ(endpoint, fan_in=self._trainers,
                                 sync_mode=self._sync_mode)
            with serv.do():
                sub = prog.current_block
                for op in self._optimize_ops:
                    param_in = op.inputs.get("Param", [])
                    if param_in and param_in[0] not in mine:
                        continue
                    for n in (op.input_names() + op.output_names()):
                        if not sub.has_var(n):
                            src = self._find_var(n)
                            sub.create_var(
                                name=n,
                                shape=src.shape if src else None,
                                dtype=src.dtype if src else "float32",
                                persistable=True)
                    sub.append_op(op.type, dict(op.inputs),
                                  dict(op.outputs), dict(op.attrs))
        return prog

    def _find_var(self, name):
        for blk in self._program.blocks:
            if blk.has_var(name):
                return blk.var(name)
        return None

    def get_startup_program(self, endpoint=None, pserver_program=None):
        """The startup program a pserver initializes its params,
        accumulators and learning rates with: the trainer's, without the
        recv ops the pserver mode appended to it (reference
        get_startup_program :620)."""
        if self._pserver_startup is not None:
            return self._pserver_startup
        return self._startup or default_startup_program()

    def build_executor(self, feed_names, fetch_list, startup_program=None,
                       **kw):
        """Lower the transpiled program onto the mesh (pass
        `place=CPUPlace()` to run on the CPU): `pipeline_stage`
        annotations and a 'pp' axis go to PipelineExecutor (dp x pp x
        tp x sp, GPipe or 1F1B), everything else to ParallelExecutor,
        as the JAX package dispatches."""
        startup_program = startup_program or self._startup
        if self._mode == "spmd" and self._uses_pipeline():
            from .pipeline_program import PipelineExecutor

            mesh = dict(self._mesh_axes)
            kw.setdefault("tp_axis",
                          "tp" if mesh.get("tp", 1) > 1 else None)
            kw.setdefault("sp_axis",
                          "sp" if mesh.get("sp", 1) > 1 else None)
            kw.setdefault("batch_axis", self._batch_axis)
            kw.setdefault("shard_optimizer_states", self._shard_opt)
            return PipelineExecutor(
                self._program, feed_names, fetch_list, mesh=mesh,
                startup_program=startup_program, **kw)
        if self._mode == "spmd":
            kw.setdefault("overlap", self._overlap)
            kw.setdefault("spmd_plan", self._plan)
            kw.setdefault("batch_axis", self._batch_axis)
        kw.setdefault("shard_optimizer_states", self._shard_opt)
        return ParallelExecutor(
            self._program, feed_names, fetch_list,
            mesh=self._mesh_axes, startup_program=startup_program, **kw)

    def _uses_pipeline(self) -> bool:
        if not self._program or self._mesh_axes.get("pp", 1) <= 1:
            return False
        return any("pipeline_stage" in op.attrs
                   for op in self._program.global_block().ops)


class ShardingTranspiler(DistributeTranspiler):
    """The annotation entry point: `transpile(program=..., mesh={'dp':
    n})` + `build_executor(...)` (always mode='spmd')."""

    def transpile(self, *args, **kw):
        kw.setdefault("mode", "spmd")
        if kw["mode"] != "spmd":
            raise ValueError("ShardingTranspiler is spmd-only — use "
                             "DistributeTranspiler for the pserver path")
        return super().transpile(*args, **kw)


class SimpleDistributeTranspiler(DistributeTranspiler):
    """Whole-variable placement variant (reference
    distribute_transpiler_simple.py), kept so both entry points exist."""
