"""Pipeline parallelism over a 'pp' mesh axis: the GPipe and 1F1B
schedules.

Counterpart of paddle_tpu/parallel/pipeline.py.  There every stage runs
one traced program in lockstep under `shard_map`, the bubble ticks on
recirculated microbatches, and autodiff derives the reverse schedule.
Here a process is one mesh position and runs its own stage only: it
holds its stage's parameters, receives each microbatch's activation
from the stage before (`AxisGroup.recv`), sends its output to the stage
after (`AxisGroup.send`, without waiting), and waits where the JAX
package computes a bubble.  The backward is an explicit schedule: the
cotangents travel the other way, stage by stage.

  * GPipe (`schedule="gpipe"`): every forward microbatch, then the
    backwards in reverse order.  Activation memory: the saved tensors
    of every microbatch.
  * 1F1B: stage s runs min(pp - s - 1, n_micro) forwards (warm-up), then
    alternates one forward and one backward, then the remaining
    backwards (cool-down): at most pp - s microbatches' saved tensors
    are live on stage s.  The last stage seeds each microbatch's
    backward right after its forward (`last_fn`).

Sends never wait for their receiver and each link carries its messages
in schedule order, so the p2p pattern of either schedule cannot
deadlock on gloo.  `pipeline_schedule` is the driver; PipelineExecutor
(parallel/pipeline_program.py) runs a Program's own forward and
backward ops through it, and `spmd_pipeline` / `spmd_pipeline_1f1b`
run Python stage functions through it with torch autograd.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import torch

from .collective import gather_from, scatter_to
from .mesh import PartitionSpec

__all__ = ["spmd_pipeline", "spmd_pipeline_1f1b", "stack_stage_params",
           "microbatch", "unmicrobatch", "schedule_steps",
           "bubble_fraction", "pipeline_schedule", "pipeline_local"]


# -- pytrees -----------------------------------------------------------------

def _is_node(t) -> bool:
    """A list or tuple to descend into (a PartitionSpec is a leaf)."""
    return isinstance(t, (list, tuple)) and not isinstance(t, PartitionSpec)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if _is_node(tree):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _unflatten(tree, leaves):
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if _is_node(t):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(tree)


def _map(fn, tree):
    return _unflatten(tree, [fn(x) for x in _leaves(tree)])


def stack_stage_params(per_stage: Sequence[Any]):
    """Stack a list of per-stage parameter pytrees along a new leading
    [pp] dim."""
    cols = list(zip(*[_leaves(p) for p in per_stage]))
    return _unflatten(per_stage[0], [torch.stack(c) for c in cols])


def microbatch(x, n_micro: int):
    """[batch, ...] -> [n_micro, batch/n_micro, ...]"""
    if x.shape[0] % n_micro:
        raise ValueError(
            f"batch {x.shape[0]} not divisible by n_micro {n_micro}")
    return x.reshape(n_micro, x.shape[0] // n_micro, *x.shape[1:])


def unmicrobatch(y):
    """[n_micro, mb, ...] -> [n_micro*mb, ...]"""
    return y.reshape(y.shape[0] * y.shape[1], *y.shape[2:])


def schedule_steps(n_micro: int, pp: int, schedule: str = "gpipe") -> int:
    """Schedule ticks holding one stage computation each, as the JAX
    package counts them: GPipe runs n_micro + pp - 1 forward ticks
    (mirrored backward); its lockstep 1F1B n_micro + 2pp - 1 combined
    forward + backward steps."""
    if schedule == "gpipe":
        return n_micro + pp - 1
    if schedule == "1f1b":
        return n_micro + 2 * pp - 1
    raise ValueError(f"unknown schedule {schedule!r}")


def bubble_fraction(n_micro: int, pp: int, schedule: str = "gpipe") -> float:
    """Fraction of the JAX package's schedule steps a stage spends idle:
    gpipe (pp-1)/(n_micro+pp-1), 1f1b (2pp-1)/(n_micro+2pp-1)."""
    total = schedule_steps(n_micro, pp, schedule)
    return (total - n_micro) / total


# -- stage hops ----------------------------------------------------------------

_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64,
           torch.int64, torch.int32)
_HEADER = 10


class _Hops:
    """A stage's sends and receives over the pp axis group: each message
    a header (ndim, dtype, shape) then the payload; sends are collected
    and waited on at `close`."""

    def __init__(self, group, device):
        self.group, self.device = group, torch.device(device)
        self.pending = []

    def send(self, t: torch.Tensor, to: int):
        head = torch.zeros(_HEADER, dtype=torch.int64)
        head[0], head[1] = t.dim(), _DTYPES.index(t.dtype)
        head[2:2 + t.dim()] = torch.tensor(t.shape, dtype=torch.int64)
        rec, self.group.record = self.group.record, None
        self.pending.append(self.group.send(head, to))   # not recorded
        self.group.record = rec
        self.pending.append(self.group.send(t.detach(), to))

    def recv(self, frm: int) -> torch.Tensor:
        head = self.group.recv((_HEADER,), torch.int64, frm, "cpu")
        shape = tuple(int(d) for d in head[2:2 + int(head[0])])
        return self.group.recv(shape, _DTYPES[int(head[1])], frm,
                               self.device)

    def close(self):
        for h in self.pending:
            h.wait()
        self.pending = []


def _position(group):
    """(pp, this rank's stage) of the pp group (None: one stage)."""
    pp = 1 if group is None else group.size
    return pp, (0 if pp == 1 else group.index)


def _forward_half(group, n_micro, first_input, forward, device):
    """GPipe's forwards, every microbatch in order -> the last stage's
    outputs (None elsewhere)."""
    pp, s = _position(group)
    hops = _Hops(group, device) if pp > 1 else None
    outs = [None] * n_micro
    try:
        for m in range(n_micro):
            out = forward(m, first_input(m) if s == 0 else hops.recv(s - 1))
            if s == pp - 1:
                outs[m] = out
            else:
                hops.send(out, s + 1)
    finally:
        if hops is not None:
            hops.close()
    return outs


def _backward_half(group, n_micro, seeds, backward, device):
    """GPipe's backwards, the microbatches in reverse -> the first
    stage's input cotangents (None elsewhere)."""
    pp, s = _position(group)
    hops = _Hops(group, device) if pp > 1 else None
    dxs = [None] * n_micro
    try:
        for m in reversed(range(n_micro)):
            dx = backward(m, seeds[m] if s == pp - 1 else hops.recv(s + 1))
            if s == 0:
                dxs[m] = dx
            elif dx is not None:
                hops.send(dx, s - 1)
    finally:
        if hops is not None:
            hops.close()
    return dxs


def pipeline_schedule(group, n_micro: int, schedule: str, *, forward,
                      backward, first_input=None, last_seeds=None,
                      last_seed=None, device="cpu"):
    """Run this rank's stage of a pipeline schedule over `group` (the pp
    AxisGroup; None or size 1: one stage).

    forward(m, h) -> out:  the stage's forward on microbatch m;
    backward(m, g) -> dx:  its backward from the output cotangent g, the
                           input cotangent (None: nothing to send);
    first_input(m):        microbatch m's input (the first stage);
    last_seeds(outs):      GPipe, the last stage: every microbatch's
                           output cotangent, from all the outputs;
    last_seed(m, out):     1F1B, the last stage: microbatch m's output
                           cotangent, right after its forward.

    -> (outs, dxs): the last stage's outputs, the first stage's input
    cotangents, by microbatch (None elsewhere)."""
    if schedule not in ("gpipe", "1f1b"):
        raise ValueError(f"unknown schedule {schedule!r}")
    pp, s = _position(group)
    last = s == pp - 1
    if schedule == "gpipe":
        outs = _forward_half(group, n_micro, first_input, forward, device)
        seeds = last_seeds(outs) if last else [None] * n_micro
        return outs, _backward_half(group, n_micro, seeds, backward, device)
    hops = _Hops(group, device) if pp > 1 else None
    outs = [None] * n_micro
    dxs = [None] * n_micro
    seeds = [None] * n_micro

    def fwd(m):
        out = forward(m, first_input(m) if s == 0 else hops.recv(s - 1))
        if last:
            outs[m] = out
            seeds[m] = last_seed(m, out)
        else:
            hops.send(out, s + 1)

    def bwd(m):
        g = seeds[m] if last else hops.recv(s + 1)
        seeds[m] = None
        dx = backward(m, g)
        if s == 0:
            dxs[m] = dx
        elif dx is not None:
            hops.send(dx, s - 1)

    try:
        warm = min(pp - s - 1, n_micro)
        for m in range(warm):
            fwd(m)
        for i in range(n_micro - warm):
            fwd(warm + i)
            bwd(i)
        for m in range(n_micro - warm, n_micro):
            bwd(m)
    finally:
        if hops is not None:
            hops.close()
    return outs, dxs


# -- Python stage functions through the schedules --------------------------------

def _stage_of(mesh, axis):
    g = mesh.axis_group(axis)
    return g, (g.index if g.size > 1 else 0)


def _local_params(stage_params, mesh, axis, pp, stage, param_specs=None):
    """This stage's row of each stacked [pp, ...] leaf, then its blocks
    over the spec's other axes (differentiable slices)."""
    leaves = _leaves(stage_params)
    specs = (_leaves(param_specs) if isinstance(param_specs, dict)
             or _is_node(param_specs) else [param_specs] * len(leaves))
    out = []
    for leaf, spec in zip(leaves, specs):
        if leaf.shape[0] != pp:
            raise ValueError(
                f"stage_params leading dim {leaf.shape[0]} != pipeline "
                f"axis size {pp}: one stacked stage per '{axis}' rank "
                "(a mismatch would silently drop stages)")
        if spec is not None and (not len(spec) or spec[0] != axis):
            raise ValueError(
                f"param_specs leaf {spec} must lead with the pipeline "
                f"axis {axis!r} (stacked stage dim)")
        v = leaf[stage]
        for d, e in enumerate(tuple(spec or ())[1:]):
            for a in (e if isinstance(e, tuple) else (e,)):
                if a is not None:
                    v = scatter_to(v, mesh.axis_group(a), d)
        out.append(v)
    return _unflatten(stage_params, out)


def _replica_groups(mesh, batch_axis, seq_axis):
    return [mesh.axis_group(a) for a in (batch_axis, seq_axis)
            if a and mesh.shape[a] > 1]


def _blocks_of(x, mesh, batch_axis, seq_axis):
    if batch_axis and mesh.shape[batch_axis] > 1:
        x = scatter_to(x, mesh.axis_group(batch_axis), 1)
    if seq_axis and mesh.shape[seq_axis] > 1:
        x = scatter_to(x, mesh.axis_group(seq_axis), 2)
    return x


def _assembled(y, mesh, batch_axis, seq_axis):
    if seq_axis and mesh.shape[seq_axis] > 1:
        y = gather_from(y, mesh.axis_group(seq_axis), 2)
    if batch_axis and mesh.shape[batch_axis] > 1:
        y = gather_from(y, mesh.axis_group(batch_axis), 1)
    return y


def _from_stage(group, t, root, like):
    """`t` (held by stage `root`) on every stage of the pp group."""
    if group.size == 1:
        return t
    buf = t if group.index == root else torch.empty_like(like)
    return group.broadcast(buf.contiguous(), root)


class _GPipe(torch.autograd.Function):
    """The GPipe schedule as one autograd node: the forward runs every
    microbatch through this rank's stage (its graph kept) and the last
    stage's outputs are broadcast over pp; the backward runs the
    microbatches in reverse, the parameter gradients summed over the
    replica axes and the input cotangent broadcast from the first
    stage."""

    @staticmethod
    def forward(ctx, run, x, *leaves):
        group, stage_fn, tree, with_tick, replicas = run
        pp, stage = _position(group)
        params = [p.detach().requires_grad_(True) for p in leaves]
        ptree = _unflatten(tree, params)
        saved = {}

        def forward_m(m, h):
            h = h.detach().requires_grad_(True)
            with torch.enable_grad():
                out = (stage_fn(ptree, h, stage + m) if with_tick
                       else stage_fn(ptree, h))
            saved[m] = (h, out)
            return out.detach()

        outs = _forward_half(group, x.shape[0], lambda m: x[m], forward_m,
                             x.device)
        ctx.run, ctx.params, ctx.saved, ctx.x_like = run, params, saved, x
        y = torch.stack(outs) if stage == pp - 1 else None
        return _from_stage(group, y, pp - 1, x)

    @staticmethod
    def backward(ctx, g_y):
        group, replicas = ctx.run[0], ctx.run[4]
        pp, stage = _position(group)
        saved = ctx.saved

        def backward_m(m, g):
            h, out = saved.pop(m)
            torch.autograd.backward(out, g)
            return h.grad

        dxs = _backward_half(group, len(g_y), g_y, backward_m, g_y.device)
        dx = _from_stage(group, torch.stack(dxs) if stage == 0 else None,
                         0, ctx.x_like)
        grads = []
        for p in ctx.params:
            gp = p.grad if p.grad is not None else torch.zeros_like(p)
            for r in replicas:
                gp = r.all_reduce(gp.contiguous())
            grads.append(gp)
        return (None, dx, *grads)


def spmd_pipeline(stage_fn: Callable, stage_params, x, mesh,
                  axis: str = "pp", batch_axis: Optional[str] = None,
                  param_specs=None, auto_axes: Sequence[str] = (),
                  seq_axis: Optional[str] = None, with_tick: bool = False):
    """Run `stage_fn` as a pp-stage GPipe pipeline.

    stage_fn:     (params, activation[mb, ...]) -> activation[mb, ...]
                  (with_tick: (params, h, tick), tick = stage + m, the
                  JAX package's forward tick of microbatch m)
    stage_params: pytree of stacked [pp, ...] leaves (this rank uses its
                  stage's row); param_specs, specs leading with `axis`
                  whose other entries split a leaf's dims over other
                  axes (the stage_fn then issues their collectives)
    x:            [n_micro, mb, ...] microbatched input, global
    batch_axis / seq_axis: axes splitting dim 1 / dim 2 of x (dp / sp)
    returns       [n_micro, mb, ...] last-stage outputs, global on every
                  rank.

    Differentiable with torch autograd: a backward through the result
    runs the reverse schedule on every rank (each rank's loss must be
    the same function of the result), the stage parameters' gradients
    summed over the replica axes.  `auto_axes` is taken for the JAX
    surface: the port has no auto axes, tensor parallelism goes through
    `param_specs` and the stage_fn's collectives."""
    group, stage = _stage_of(mesh, axis)
    params = _local_params(stage_params, mesh, axis, group.size, stage,
                           param_specs)
    y = pipeline_local(stage_fn, params,
                       _blocks_of(x, mesh, batch_axis, seq_axis), group,
                       _replica_groups(mesh, batch_axis, seq_axis),
                       with_tick)
    return _assembled(y, mesh, batch_axis, seq_axis)


def pipeline_local(stage_fn: Callable, params, x, group, replicas=(),
                   with_tick: bool = False):
    """GPipe on this rank's own stage parameters (a pytree of local
    tensors) and its input blocks x [n_micro, mb_loc, ...] over the pp
    AxisGroup `group` -> the last stage's outputs on every stage,
    differentiable; the parameter gradients are summed over the
    `replicas` groups (the axes splitting the batch or the sequence)."""
    return _GPipe.apply((group, stage_fn, params, with_tick,
                         list(replicas)), x, *_leaves(params))


def spmd_pipeline_1f1b(stage_fn: Callable, last_fn: Callable,
                       stage_params, last_params, x, y, mesh,
                       axis: str = "pp", batch_axis: Optional[str] = None,
                       auto_axes: Sequence[str] = (),
                       seq_axis: Optional[str] = None,
                       with_tick: bool = False):
    """The 1F1B training schedule (module docstring).

    stage_fn:    (params, h[, tick]) -> h, as spmd_pipeline's
    last_fn:     (last_params, h_mb, y_mb, m) -> scalar loss CONTRIBUTION
                 of microbatch m (normalised over the GLOBAL batch), run
                 on the last stage right after its forward; its gradient
                 seeds the backward
    stage_params: stacked [pp, ...] pytree; last_params: pytree
    x:           [n_micro, mb, ...]; y: pytree of [n_micro, ...] leaves
                 split like x
    returns (loss_sum, outs, stage_grads, last_grads, dx), each on every
    rank: the sum of last_fn over microbatches and replicas; the
    last-stage outputs [n_micro, mb, ...]; THIS rank's stage's
    parameter gradients (row `stage` of the JAX package's stacked
    ones); last_params' gradients; the cotangents of x."""
    group, stage = _stage_of(mesh, axis)
    pp = group.size
    replicas = _replica_groups(mesh, batch_axis, seq_axis)
    with torch.no_grad():
        params = [p.detach().requires_grad_(True) for p in _leaves(
            _local_params(stage_params, mesh, axis, pp, stage))]
        lparams = [p.detach().requires_grad_(True)
                   for p in _leaves(last_params)]
        x_loc = _blocks_of(x, mesh, batch_axis, seq_axis)
        y_loc = _map(lambda v: _blocks_of(v, mesh, batch_axis, seq_axis), y)
    ptree = _unflatten(stage_params, params)
    ltree = _unflatten(last_params, lparams)
    saved = {}
    loss = torch.zeros((), dtype=torch.float32, device=x.device)

    def forward(m, h):
        h = h.detach().requires_grad_(True)
        with torch.enable_grad():
            out = (stage_fn(ptree, h, stage + m) if with_tick
                   else stage_fn(ptree, h))
        saved[m] = (h, out)
        return out.detach()

    def last_seed(m, out):
        nonlocal loss
        o = out.detach().requires_grad_(True)
        with torch.enable_grad():
            lm = last_fn(ltree, o, _map(lambda v: v[m], y_loc), m)
            lm.backward()
        loss = loss + lm.detach().float()
        return o.grad

    def backward(m, g):
        h, out = saved.pop(m)
        torch.autograd.backward(out, g)
        return h.grad

    outs, dxs = pipeline_schedule(
        group if pp > 1 else None, x_loc.shape[0], "1f1b", forward=forward,
        backward=backward, first_input=lambda m: x_loc[m],
        last_seed=last_seed, device=x.device)
    with torch.no_grad():
        last = stage == pp - 1
        out_t = torch.stack(outs) if last else None
        dx_t = torch.stack(dxs) if stage == 0 else None
        g_stage = [p.grad if p.grad is not None else torch.zeros_like(p)
                   for p in params]
        g_last = [p.grad if p.grad is not None else torch.zeros_like(p)
                  for p in lparams] if last else [torch.zeros_like(p)
                                                 for p in lparams]
        for r in replicas:
            g_stage = [r.all_reduce(g.contiguous()) for g in g_stage]
            g_last = [r.all_reduce(g.contiguous()) for g in g_last]
            loss = r.all_reduce(loss)
        if pp > 1:
            out_t = _from_stage(group, out_t, pp - 1, x_loc)
            dx_t = _from_stage(group, dx_t, 0, x_loc)
            g_last = [_from_stage(group, g, pp - 1, g) for g in g_last]
            loss = _from_stage(group, loss, pp - 1, loss)
        out_t = _assembled(out_t, mesh, batch_axis, seq_axis)
        dx_t = _assembled(dx_t, mesh, batch_axis, seq_axis)
    return (loss, out_t, _unflatten(stage_params, g_stage),
            _unflatten(last_params, g_last), dx_t)
